"""Data pipeline: counter-based synthetic token stream + tokenized-file
loader.

The port of `repro.train.data`.  Counter-based = stateless: batch `i` is
a pure function of (seed, i), so a restarted run replays the exact batch
sequence and a checkpoint holds no loader state.  The reference draws
its synthetic stream with `jax.random`, which torch cannot reproduce;
the port draws the same structure (a Zipf-ish unigram mixture, every
other token a fixed function of the one before it) from a CPU
`torch.Generator` seeded by (seed, index), so a batch is the same on
every device.  `FileDataset` draws its windows with
`np.random.default_rng(seed + index)`, as the reference does, so its
batches equal the reference's.  Batches are CPU tensors; the caller
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None     # tokenized .npy (1-D int32) — optional


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded by a 64-bit mix of `words`."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = ((h ^ (w & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return torch.Generator().manual_seed(h)


def _zipf_logits(vocab: int, gen: torch.Generator) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    return -1.1 * torch.log(ranks) + 0.3 * torch.randn((vocab,),
                                                       generator=gen)


def synthetic_batch(cfg: DataConfig, index: int) -> Dict[str, torch.Tensor]:
    """Batch `index`, deterministically. tokens: [B, S] int32 (CPU)."""
    probs = torch.softmax(_zipf_logits(cfg.vocab_size,
                                       _generator(cfg.seed + 1)), dim=0)
    toks = torch.multinomial(
        probs, cfg.global_batch * cfg.seq_len, replacement=True,
        generator=_generator(cfg.seed, index)).reshape(
            cfg.global_batch, cfg.seq_len)
    # order-1 structure: every other token is a deterministic fn of the prev
    shifted = (toks[:, :-1] * 31 + 7) % cfg.vocab_size
    mask = torch.arange(cfg.seq_len - 1) % 2 == 1
    toks[:, 1:] = torch.where(mask, shifted, toks[:, 1:])
    return {"tokens": toks.to(torch.int32)}


class FileDataset:
    """Fixed-stride windows over a tokenized 1-D array (memory-mapped)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.arr = np.load(cfg.path, mmap_mode="r")
        self.n_windows = (len(self.arr) - 1) // cfg.seq_len

    def batch(self, index: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + index)
        starts = rng.integers(0, self.n_windows, size=cfg.global_batch)
        toks = np.stack([
            self.arr[s * cfg.seq_len:(s + 1) * cfg.seq_len]
            for s in starts]).astype(np.int32)
        return {"tokens": torch.from_numpy(toks)}


def batches(cfg: DataConfig, start_index: int = 0
            ) -> Iterator[Dict[str, torch.Tensor]]:
    ds = FileDataset(cfg) if cfg.path else None
    i = start_index
    while True:
        yield (ds.batch(i) if ds else synthetic_batch(cfg, i))
        i += 1
