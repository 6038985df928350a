"""Checkpointing: atomic, device-agnostic, async-capable.

The port of `repro.train.checkpoint`, with its on-disk layout, so a
checkpoint written by either package restores in the other (one
directory per step):
    <dir>/step_000123.tmp/...   (write)
    <dir>/step_000123/          (atomic rename on completion)
        manifest.json           {step, leaves: [{name, shape, dtype}]}
        <leaf name>.npy         one file per tree leaf

A leaf's name joins its key path with "__" in JAX's flatten order
(`transformer.named_leaves`): `params__groups__b0__attn__wq`,
`opt__step`, `opt__mu__embed`, ...; a `compressor` of None has no leaf.
A bfloat16 leaf is written as the reference's numpy writes JAX's
bfloat16 (descr '<V2': the raw 2-byte words) with "bfloat16" in the
manifest; the port reads those words as int16 and views them as
bfloat16.  (The reference's own `restore` cannot cast '<V2' back to
bfloat16, so its bf16 checkpoints restore only in the port.)  The rename
is the commit point: a crash mid-write leaves a .tmp directory that
`latest_step` ignores and `clean_incomplete` removes.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.transformer import named_leaves

Tree = Any
_BF16_DESCR = "<V2"


def _leaf_paths(tree: Tree):
    """(names, leaves) of a tree, in the order and with the names the
    reference gives them."""
    flat = named_leaves(tree)
    return ["__".join(map(str, path)) for path, _ in flat], \
        [leaf for _, leaf in flat]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _write_npy(path: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(t.shape)})
        f.write(t.contiguous().view(torch.int16).numpy().tobytes())


def _read_npy(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Tree,
         async_: bool = False) -> Optional[threading.Thread]:
    """Write checkpoint for `step`. async_=True returns the writer thread
    (the device-to-host copy happens synchronously; disk IO in the
    background)."""
    names, leaves = _leaf_paths(tree)
    host_leaves = [x.detach().cpu() for x in leaves]

    def write():
        tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for name, t in zip(names, host_leaves):
            _write_npy(os.path.join(tmp, name + ".npy"), t)
            manifest["leaves"].append(
                {"name": name, "shape": list(t.shape),
                 "dtype": _dtype_name(t)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # commit point

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _rebuild(like: Tree, leaves) -> Tree:
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    return next(leaves)


def restore(ckpt_dir: str, step: int, like: Tree) -> Tree:
    """Load `step` into the structure of `like`, each leaf cast to the
    dtype and placed on the device of `like`'s leaf."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {e["name"]: e["dtype"] for e in json.load(f)["leaves"]}
    names, refs = _leaf_paths(like)
    out = []
    for name, ref in zip(names, refs):
        t = _read_npy(os.path.join(path, name + ".npy"), dtypes[name])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: ckpt {tuple(t.shape)} != model "
                             f"{tuple(ref.shape)}")
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(out))


def clean_incomplete(ckpt_dir: str) -> int:
    """Remove .tmp dirs left by crashes. Returns count removed."""
    if not os.path.isdir(ckpt_dir):
        return 0
    n = 0
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d))
            n += 1
    return n


def keep_last(ckpt_dir: str, k: int) -> None:
    """Retention policy: keep the newest k complete checkpoints."""
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m:
            steps.append(int(m.group(1)))
    for s in sorted(steps)[:-k]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
