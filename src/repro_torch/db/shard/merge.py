"""Cross-shard encrypted merge networks (sort / top-k over shard blocks).

The port of `repro.db.shard.merge`.  A sharded `OrderBy`/`TopK` never
gathers all rows to one sort: each shard first resolves its own
candidates with a LOCAL bitonic network (all shards riding the same
batched Eval stages over the flattened `[S·M, ...]` stack), then a
log2 S-depth cross-shard merge combines the per-shard results:

  * top-k:  per-shard partial bitonic top-k down to one descending
    kp-block per shard, then the max-merge TOURNAMENT continues across
    shard boundaries — (S-1)·(kp + kp/2·log2 kp) merge compares,
    independent of n;
  * sort:   per-shard full bitonic sort, then log2 S pairwise sorted-run
    merges (half-cleaner + bitonic merge, L·(1 + log2 L) compares per
    pair of runs of length L).

Delta compaction and the sort-merge join use `pad_shard_blocks` and
`merge_sorted_runs` directly.  Everything runs on `core.compare`'s
compare-exchange machinery, so stage semantics (FAE tie outcomes,
id-based sentinel stripping) are those of `encrypted_sort`.  Each
function updates the caller's c0/c1/ids in place where it can and
returns them with its compare count(s).
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


def shard_block_sort(ks: KeySet, cmp: Callable, c0: torch.Tensor,
                     c1: torch.Tensor, ids: torch.Tensor, *, block: int,
                     descending: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                int]:
    """Sort each contiguous `block`-sized run independently; every stage
    of the tiled bitonic network is ONE batched Eval across all runs."""
    n = c0.shape[0]
    if n % block:
        raise ValueError(f"{n} rows are not whole blocks of {block}")
    compares = 0
    with obs.span("merge.block_sort", rows=int(n), block=int(block)):
        for lo, hi, asc in C._bitonic_pairs(block):
            flags = ~asc if descending else asc
            glo, ghi, gasc = C._block_pairs(n // block, block, lo, hi, flags)
            _obs_stage("merge.block_sort", glo)
            C._compare_swap(ks, cmp, c0, c1, ids, glo, ghi, gasc)
            compares += int(glo.shape[0])
    return c0, c1, ids, compares


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


def topk_tournament(ks: KeySet, cmp: Callable, c0: torch.Tensor,
                    c1: torch.Tensor, ids: torch.Tensor, *, kp: int,
                    stop_blocks: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               int]:
    """`encrypted_topk`'s max-merge tournament over descending kp-blocks,
    run until `stop_blocks` blocks survive.

    With stop_blocks = S it is the per-shard phase (blocks pair only
    within their shard: shard regions are contiguous with a power-of-two
    block count); continuing with stop_blocks = 1 is the cross-shard
    merge phase."""
    n_live = c0.shape[0]
    if n_live % kp:
        raise ValueError(f"{n_live} rows are not whole blocks of {kp}")
    compares = 0
    while n_live > stop_blocks * kp:
        with obs.span("merge.topk_round", live=int(n_live), kp=int(kp)):
            blocks = n_live // kp
            j = np.arange(blocks // 2)
            i = np.arange(kp)
            lo_idx = ((2 * j * kp)[:, None] + i[None, :]).ravel()
            hi_idx = (((2 * j + 1) * kp)[:, None]
                      + (kp - 1 - i)[None, :]).ravel()
            _obs_stage("merge.topk_round", lo_idx)
            C._compare_swap(ks, cmp, c0, c1, ids, lo_idx, hi_idx,
                            np.zeros(lo_idx.shape[0], bool))
            compares += int(lo_idx.shape[0])
            keep = torch.as_tensor(lo_idx, device=c0.device)
            c0, c1, ids = c0[keep], c1[keep], ids[keep]
            n_live //= 2
            stride = kp // 2
            while stride >= 1:
                within = np.arange(kp)
                p = within[(within & stride) == 0]
                glo, ghi, gasc = C._block_pairs(n_live // kp, kp, p,
                                                p + stride,
                                                np.zeros(p.shape[0], bool))
                _obs_stage("merge.topk_round", glo)
                C._compare_swap(ks, cmp, c0, c1, ids, glo, ghi, gasc)
                compares += int(glo.shape[0])
                stride //= 2
    return c0, c1, ids, compares


def sharded_topk(ks: KeySet, cmp: Callable, ct: Ciphertext,
                 ids: np.ndarray, *, num_blocks: int,
                 k: int) -> Tuple[np.ndarray, int, int]:
    """Global descending top-k over per-shard candidate blocks.

    ct/ids: the flattened `[num_blocks·M]` stack of `pad_shard_blocks` (M
    a power-of-two multiple of kp = next_pow2(k)); it is sorted in place.
    Returns (the top-k global ids — -1 if a sentinel tied its way in,
    which the caller re-resolves through the tie-robust sort path —,
    per-shard-phase compares, cross-shard merge compares)."""
    n = ct.c0.shape[0]
    M = n // num_blocks
    kp = C.next_pow2(k)
    if M % kp or M != C.next_pow2(M):
        raise ValueError(f"block {M} is not a power-of-two multiple of {kp}")
    c0, c1 = ct.c0, ct.c1
    gid = torch.as_tensor(ids, device=c0.device)
    # per-shard phase: descending kp-block sorts, then the tournament down
    # to ONE block per shard, every stage batched across all shards
    c0, c1, gid, n_sort = shard_block_sort(ks, cmp, c0, c1, gid, block=kp,
                                           descending=True)
    c0, c1, gid, n_tour = topk_tournament(ks, cmp, c0, c1, gid, kp=kp,
                                          stop_blocks=num_blocks)
    # cross-shard merge: the same tournament, now pairing across shards
    c0, c1, gid, n_merge = topk_tournament(ks, cmp, c0, c1, gid, kp=kp,
                                           stop_blocks=1)
    return gid[:k].cpu().numpy(), n_sort + n_tour, n_merge


def sharded_sort(ks: KeySet, cmp: Callable, ct: Ciphertext,
                 ids: np.ndarray, *, num_blocks: int
                 ) -> Tuple[np.ndarray, int, int]:
    """Globally ascending row ids via per-shard sorts + log-depth merge.

    ct/ids: the flattened `[num_blocks·M]` stack of `pad_shard_blocks`
    with ascending sentinels (+max_operand//2); it is sorted in place.
    Returns (real row ids ascending by value — sentinels stripped BY ID —,
    per-shard-phase compares, cross-shard merge compares)."""
    n = ct.c0.shape[0]
    M = n // num_blocks
    c0, c1 = ct.c0, ct.c1
    gid = torch.as_tensor(ids, device=c0.device)
    c0, c1, gid, n_sort = shard_block_sort(ks, cmp, c0, c1, gid, block=M)
    c0, c1, gid, n_merge = merge_sorted_runs(ks, cmp, c0, c1, gid, run=M)
    gid = gid.cpu().numpy()
    return gid[gid >= 0], n_sort, n_merge
