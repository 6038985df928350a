"""Encrypted merge networks over equal-length sorted runs.

The part of `repro.db.shard.merge` that delta compaction needs:

  * `pad_shard_blocks` stacks (ciphertext run, global ids) lists into one
    flattened `[num_blocks·block]` column, padding each list with
    encrypted sentinels (id -1; stripping is by id, never by value);
  * `merge_sorted_runs` merges equal-length ascending runs pairwise
    (half-cleaner + bitonic merge, L·(1 + log2 L) compares per pair of
    runs of length L), every stage one batched compare-exchange.

Both run on `core.compare`'s compare-exchange machinery, so stage
semantics (FAE tie outcomes, id-based sentinel stripping) are those of
`encrypted_sort`.  The per-shard sorts, the top-k tournament and the
shard-level entry points wait for the shard slice.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import compare as C
from repro_torch.core import encrypt as E
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db.table import fold_seed

# seed of the sentinel rows that pad a block (folded with the block
# index); they carry no secret
_BLOCK_PAD_SEED = 0x5A4D


def _obs_stage(site: str, glo) -> None:
    """Launch accounting for one compare-exchange stage (one batched
    Eval over `len(glo)` lanes); no-op unless obs is enabled."""
    if not obs.is_enabled():
        return
    obs.jit_launch(site, (int(glo.shape[0]),))
    obs.count("eval.launches")
    obs.count("eval.lanes", int(glo.shape[0]))


def merge_sorted_runs(ks: KeySet, cmp: Callable, c0: torch.Tensor,
                      c1: torch.Tensor, ids: torch.Tensor, *,
                      run: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, int]:
    """Merge equal-length ascending runs pairwise until ONE ascending run
    remains (log2(n/run) rounds).  c0/c1/ids are updated in place (the
    caller owns them) and returned with the compare count.

    Round structure per pair of runs (a, b) of length L: the half-cleaner
    compare-exchanges a[i] against b[L-1-i], then each half
    bitonic-merges in log2 L strides."""
    n = c0.shape[0]
    if n % run or n // run != C.next_pow2(n // run):
        raise ValueError(f"{n} rows are not a power-of-two count of "
                         f"runs of {run}")
    compares = 0
    while run < n:
        with obs.span("merge.round", run=int(run), rows=int(n)):
            pairs = n // (2 * run)
            i = np.arange(run)
            glo, ghi, gasc = C._block_pairs(pairs, 2 * run, i,
                                            2 * run - 1 - i,
                                            np.ones(run, bool))
            _obs_stage("merge.round", glo)
            C._compare_swap(ks, cmp, c0, c1, ids, glo, ghi, gasc)
            compares += int(glo.shape[0])
            stride = run // 2
            while stride >= 1:
                within = np.arange(run)
                p = within[(within & stride) == 0]
                glo, ghi, gasc = C._block_pairs(2 * pairs, run, p,
                                                p + stride,
                                                np.ones(p.shape[0], bool))
                _obs_stage("merge.round", glo)
                C._compare_swap(ks, cmp, c0, c1, ids, glo, ghi, gasc)
                compares += int(glo.shape[0])
                stride //= 2
            run *= 2
    return c0, c1, ids, compares


def pad_shard_blocks(ks: KeySet, per_shard: list, *, block: int,
                     pad_value: int, num_blocks: int
                     ) -> Tuple[Ciphertext, np.ndarray]:
    """Stack per-shard (Ciphertext, global-id array) lists into one
    flattened `[num_blocks·block]` column, written in place into one
    preallocated stack.

    Each list pads to `block` rows with encrypted `pad_value` sentinels
    (encrypted under a seed folded from `_BLOCK_PAD_SEED` and the block
    index); missing lists become all-sentinel blocks.  Pad slots carry
    id -1."""
    K, n = ks.params.num_towers, ks.params.n
    shape = (num_blocks * block, K, n)
    c0 = torch.empty(shape, dtype=torch.int64, device=ks.device)
    c1 = torch.empty_like(c0)
    ids = []
    for s in range(num_blocks):
        ct, gids = (per_shard[s] if s < len(per_shard)
                    else (None, np.zeros(0, np.int64)))
        m = int(np.asarray(gids).shape[0])
        if m > block:
            raise ValueError(f"list {s} holds {m} rows > block {block}")
        lo = s * block
        if m:
            c0[lo:lo + m], c1[lo:lo + m] = ct.c0, ct.c1
        if m < block:
            pad = E.encrypt(ks, torch.full((block - m,), int(pad_value),
                                           dtype=torch.int64),
                            fold_seed(_BLOCK_PAD_SEED, s))
            c0[lo + m:lo + block], c1[lo + m:lo + block] = pad.c0, pad.c1
            del pad
        ids.append(np.concatenate([np.asarray(gids, np.int64),
                                   np.full(block - m, -1, np.int64)]))
    return Ciphertext(c0, c1), np.concatenate(ids)
