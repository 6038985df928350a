"""Input specs for every (architecture x shape) dry-run cell.

The port of `repro.launch.specs`.  Shape/dtype stand-ins only: every leaf
is a fake tensor (`torch._subclasses.FakeTensorMode`), made under the
caller's fake mode when one is active (the dry-run's), else under a
fresh one.  Parameters come from `transformer.init_params` run under
that mode, so no draw is made and nothing is allocated (llava-next-34b's
train state alone is hundreds of GB).  The shape set:

    train_4k     seq=4096    gb=256   runs train_step
    prefill_32k  seq=32768   gb=32    runs prefill
    decode_32k   seq=32768   gb=128   runs decode_step (1 token, full cache)
    long_500k    seq=524288  gb=1     runs decode_step (sub-quadratic only)

Skips: long_500k is only legal for configs whose serve state is O(1) in
context (`cfg.sub_quadratic`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import train_lib as TL

PyTree = Any

SHAPES = {
    "train_4k":    dict(seq_len=4096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288, global_batch=1,   kind="decode"),
}

# the device the stand-ins claim (the dry-run's mesh is a host mesh)
DEVICE = "cpu"


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention KV cache at 524k tokens is neither "
                       "sub-quadratic nor HBM-feasible; skipped per the "
                       "assignment rule (runs only for ssm/hybrid)")
    return True, ""


def _stand_ins():
    """The active fake mode's scope, or a fresh fake mode."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def _sds(shape, dtype) -> torch.Tensor:
    with _stand_ins():
        return torch.empty(shape, dtype=dtype, device=DEVICE)


def batch_specs(cfg: ModelConfig, seq: int, gb: int) -> Dict[str, Any]:
    dt = L.torch_dtype(cfg.dtype)
    b: Dict[str, Any] = {"tokens": _sds((gb, seq), torch.int32)}
    if cfg.frontend == "patches":
        b["patches"] = _sds((gb, cfg.num_patches, cfg.d_model), dt)
    if cfg.frontend == "frames":
        b["frames"] = _sds((gb, cfg.encoder_seq, cfg.d_model), dt)
    return b


def params_specs(cfg: ModelConfig) -> PyTree:
    """The parameter tree's stand-ins (`init_params` under a fake mode:
    no draw, no allocation)."""
    with _stand_ins():
        return T.init_params(cfg, torch.Generator().manual_seed(0),
                             device=DEVICE)


def train_state_specs(cfg: ModelConfig, tcfg: TL.TrainConfig) -> PyTree:
    with _stand_ins():
        return TL.init_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device=DEVICE)


def cache_specs_abstract(cfg: ModelConfig, gb: int, seq: int) -> PyTree:
    with _stand_ins():
        return SV.init_cache(cfg, gb, seq, device=DEVICE)


def input_specs(cfg: ModelConfig, shape: str,
                tcfg: Optional[TL.TrainConfig] = None, *,
                global_batch: Optional[int] = None) -> Dict[str, Any]:
    """-> {"kind", "args": tuple of stand-in trees} (at `global_batch`
    rows where given, else the shape's)."""
    meta = SHAPES[shape]
    seq, kind = meta["seq_len"], meta["kind"]
    gb = global_batch or meta["global_batch"]
    if kind == "train":
        tcfg = tcfg or TL.TrainConfig()
        return {"kind": "train",
                "args": (train_state_specs(cfg, tcfg),
                         batch_specs(cfg, seq, gb))}
    if kind == "prefill":
        return {"kind": "prefill",
                "args": (params_specs(cfg), batch_specs(cfg, seq, gb))}
    # decode: one token against a cache of length seq
    return {"kind": "decode",
            "args": (params_specs(cfg), cache_specs_abstract(cfg, gb, seq),
                     _sds((gb,), torch.int32))}
