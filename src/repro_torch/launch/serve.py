"""Serving driver: batched prefill + greedy decode over a request queue.

The port of `repro.launch.serve`.  Requests are grouped into fixed-size
batches (the tail batch padded with copies of its first prompt, so every
batch has one shape); each batch runs prefill once, then decodes
greedily.  The CLI serves the architecture's reduced config, as the
reference does; `serve_requests` takes any supported config (the dense
GQA family) and parameter tree.

Usage (on the card; `--device cpu` runs on the host):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --requests 8 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.ring import resolve_device
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_requests(cfg: ModelConfig, params, prompts: np.ndarray, *,
                   batch: int, gen: int) -> Dict:
    """Serve `prompts` [R, S] in batches of `batch`: prefill, then `gen`
    greedy tokens each (the first from the prefill logits).  Returns the
    generated tokens [R, gen] (host), the last batch's final logits, and
    the prefill and decode walls (device work synchronized)."""
    device = params["embed"].device
    R, S = prompts.shape
    T_max = S + gen
    outputs, prefill_s, decode_s = [], 0.0, 0.0
    for i in range(0, R, batch):
        chunk = prompts[i:i + batch]
        if len(chunk) < batch:                 # pad the tail batch
            chunk = np.concatenate(
                [chunk, chunk[:1].repeat(batch - len(chunk), 0)])
        tokens = torch.as_tensor(chunk, dtype=torch.int32, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = SV.prefill(cfg, params, {"tokens": tokens},
                                   T_max=T_max)
        tok = torch.argmax(logits, -1).to(torch.int32)
        _sync(device)
        t1 = time.perf_counter()
        gen_toks = [tok]
        for _ in range(gen - 1):
            logits, cache = SV.decode_step(cfg, params, cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            gen_toks.append(tok)
        out = torch.stack(gen_toks, 1).cpu().numpy()
        t2 = time.perf_counter()
        prefill_s += t1 - t0
        decode_s += t2 - t1
        outputs.append(out[:len(prompts[i:i + batch])])
    return {"tokens": np.concatenate(outputs), "logits": logits,
            "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None) -> dict:
    """CLI: random prompts through `serve_requests`; prints one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    gen = torch.Generator().manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.requests, args.prompt_len))
    t0 = time.perf_counter()
    out = serve_requests(cfg, params, prompts, batch=args.batch,
                         gen=args.gen)
    dt = time.perf_counter() - t0
    result = {"arch": cfg.name, "device": str(device),
              "requests": args.requests,
              "tokens_generated": int(args.gen * args.requests),
              "prefill_s": round(out["prefill_s"], 3),
              "decode_s": round(out["decode_s"], 3),
              "wall_s": round(dt, 3),
              "tok_per_s": round(args.gen * args.requests / dt, 2)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
