"""`ShardedTable`: an encrypted column-store partitioned across shards.

The port of `repro.db.shard.table`.  Rows split into S contiguous,
balanced chunks; every chunk pads to ONE common power-of-two block size
N_sp, so each column is a single stacked ciphertext `[S, N_sp, K, n]`.
Uneven partitions mean shards carry different validity masks over the
same block size.

PLACEMENT.  A table is built on its HOME device (its keys'), and
`ShardSpec.place` splits every stack's leading dim over the spec's
mesh: each column half is a `parallel.sharding.ShardStack` of d slabs
`[S/d, N_sp, K, n]`, slab j on mesh position j (d = 1: one slab, the
whole stack on the home device).  Every reader works on the slabs, one
code path for every d: `shard`, `gather`, `gather_global`,
`decrypt_column` answer on the home device, `scan_stack` gives per-slab
union stacks, and only the Eval launches (`db.shard.executor`,
`db.shard.join`) run on the slabs' own devices.  Delta runs are plain
`Table`s on the home device.

Global row ids are the original ingest order: at construction shard s
owns the contiguous id range [offsets[s], offsets[s+1]), so `from_table`
— which re-partitions an existing `Table`'s ciphertext ROWS without
touching plaintext — gives bit-identical per-row ciphertexts.

WRITE PATH.  `insert` routes new rows to the least-loaded shards and
appends them to a per-shard DELTA RUN (a plain `Table`); `delete`
tombstones global ids host-side; `update` is delete + insert.  New rows
take ids past the end of the id space, and compaction
(`db.delta.compact`) folds each shard's delta rows onto the end of that
shard's base block, after which shard ownership is no longer contiguous
in id space.  The table therefore keeps an EXPLICIT id map (`_gid_shard`
/ `_gid_pos` / `_gid_in_delta`, plus the per-shard slot -> id map
`_slot_gid`); all row-id algebra reads the map, never the offsets.

Randomness, as in `Table`: shard s of `from_arrays` and of an insert
encrypts under `fold_seed(seed, s)` (or pre-drawn `samples`), and the
encryptions of 0 that pad a block come from `pad_rows(ks, column,
count, salt)` (re-partitioning, salt ci·1024 + s with ci the column's
position) and `fold_pad_rows` (compaction, salt ci·65536 + s·256 +
version mod 256), each seeded by default; a test can hand in the
reference's rows instead.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import encrypt as E
from repro_torch.core.compare import next_pow2
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet
from repro_torch.db.shard.spec import ShardSpec
from repro_torch.db.table import (Table, ZeroPadRows, _zero_pad_rows,
                                  append_rows, fold_seed)
from repro_torch.parallel.sharding import ShardStack

# seeds of the encryptions of 0 that pad a re-partitioned shard and a
# compaction fold; they carry no secret
_PARTITION_PAD_SEED = 0x5AAD
_FOLD_PAD_SEED = 0xC0FD


def _seeded_zeros(seed: int) -> ZeroPadRows:
    def pads(ks: KeySet, _cname: str, count: int, salt: int) -> Ciphertext:
        return E.encrypt(ks, torch.zeros(count, dtype=torch.int64),
                         fold_seed(seed, salt))
    return pads


def partition_offsets(n_rows: int, num_shards: int) -> np.ndarray:
    """[S+1] contiguous balanced split boundaries (the first n % S chunks
    get the extra row)."""
    if not (1 <= num_shards <= n_rows):
        raise ValueError(
            f"num_shards {num_shards} outside [1, {n_rows}] rows")
    base, extra = divmod(n_rows, num_shards)
    sizes = np.full(num_shards, base, np.int64)
    sizes[:extra] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def _stack_empty(S: int, n_sp: int, like: torch.Tensor) -> Ciphertext:
    shape = (S, n_sp) + tuple(like.shape[-2:])
    return Ciphertext(torch.empty(shape, dtype=like.dtype, device=like.device),
                      torch.empty(shape, dtype=like.dtype, device=like.device))


class ShardedTable:
    """Stacked encrypted columns `[S, N_sp, ...]` (placed per the spec) +
    partition bookkeeping."""

    def __init__(self, name: str, columns: Dict[str, Ciphertext],
                 offsets: np.ndarray, spec: ShardSpec, *,
                 zero_pad_rows: Optional[ZeroPadRows] = None,
                 fold_pad_rows: Optional[ZeroPadRows] = None):
        if not columns:
            raise ValueError("sharded table needs at least one column")
        spec = spec.on(next(iter(columns.values())).c0.device)
        shapes = {c: tuple(ct.c0.shape[:2]) for c, ct in columns.items()}
        S, n_sp = next(iter(shapes.values()))
        if any(v != (S, n_sp) for v in shapes.values()):
            raise ValueError(f"ragged column stacks: {shapes}")
        if S != spec.num_shards:
            raise ValueError(f"stack has {S} shards, spec {spec.num_shards}")
        if n_sp != next_pow2(n_sp):
            raise ValueError(f"per-shard block {n_sp} not a power of two")
        self.name = name
        self.spec = spec
        self.columns = self._place(columns)
        self.offsets = np.asarray(offsets, np.int64)
        self.zero_pad_rows = zero_pad_rows or _zero_pad_rows
        self.fold_pad_rows = fold_pad_rows or _seeded_zeros(_FOLD_PAD_SEED)
        self.shard_rows = np.diff(self.offsets)          # [S] valid counts
        # empty shards are legal (a shard can drain through deletes);
        # only overflow is a geometry error
        if int(self.shard_rows.max()) > n_sp or int(self.shard_rows.min()) < 0:
            raise ValueError(
                f"shard sizes {self.shard_rows} outside [0, {n_sp}]")
        # -- id map: starts contiguous, stays authoritative ------------
        n = int(self.offsets[-1])
        self._n_base = n
        self._gid_shard = np.repeat(np.arange(S, dtype=np.int64),
                                    self.shard_rows)
        self._gid_pos = np.concatenate(
            [np.arange(int(c), dtype=np.int64) for c in self.shard_rows]
            or [np.zeros(0, np.int64)])
        self._gid_in_delta = np.zeros(n, bool)
        slot_gid = np.full((S, n_sp), -1, np.int64)
        for s in range(S):
            c = int(self.shard_rows[s])
            slot_gid[s, :c] = np.arange(int(self.offsets[s]),
                                        int(self.offsets[s]) + c)
        self._slot_gid = slot_gid
        # -- write-path state ------------------------------------------
        self.deltas: List[Optional[Table]] = [None] * S
        self._delta_gids: List[np.ndarray] = [np.zeros(0, np.int64)
                                              for _ in range(S)]
        self._dead = np.zeros(n, bool)
        self.version = 0
        self._delta_index_cache: Dict[tuple, tuple] = {}

    def _place(self, columns: Dict[str, Ciphertext]
               ) -> Dict[str, Ciphertext]:
        """Stacks built on the home device, placed per the spec: every
        column half a `ShardStack`."""
        return {c: Ciphertext(ShardStack.of(ct.c0), ShardStack.of(ct.c1))
                for c, ct in self.spec.place(dict(columns)).items()}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(cls, ks: KeySet, name: str,
                    data: Dict[str, np.ndarray], seed: int = 0, *,
                    spec: ShardSpec,
                    samples: Optional[Dict[int, Dict[str, tuple]]] = None,
                    ) -> "ShardedTable":
        """Encrypt host arrays straight into the sharded layout: shard s's
        chunk encrypts via `Table.from_arrays` under `fold_seed(seed, s)`
        (or `samples[s]`, that shard's pre-drawn per-column samples),
        padded to the common N_sp block, on the keys' device; then the
        stacks are placed (`ShardSpec.place`)."""
        n_rows = len(next(iter(data.values())))
        offsets = partition_offsets(n_rows, spec.num_shards)
        n_sp = next_pow2(int(np.diff(offsets).max()))
        columns: Dict[str, Ciphertext] = {}
        for s in range(spec.num_shards):
            lo, hi = int(offsets[s]), int(offsets[s + 1])
            chunk = {c: np.asarray(v)[lo:hi] for c, v in data.items()}
            t = Table.from_arrays(ks, f"{name}.s{s}", chunk, fold_seed(seed, s),
                                  n_padded=n_sp,
                                  samples=(samples or {}).get(s))
            for c, ct in t.columns.items():
                if c not in columns:
                    columns[c] = _stack_empty(spec.num_shards, n_sp, ct.c0)
                columns[c].c0[s], columns[c].c1[s] = ct.c0, ct.c1
            del t
        return cls(name, columns, offsets, spec)

    @classmethod
    def from_table(cls, ks: KeySet, table: Table, *, spec: ShardSpec,
                   pad_rows: Optional[ZeroPadRows] = None,
                   ) -> "ShardedTable":
        """Re-partition an existing `Table`'s ciphertext rows (server-side:
        slices existing encryptions, pads with public-key encryptions of 0
        from `pad_rows`, no plaintext access).  Tombstones carry over; a
        pending delta run is refused (compact first).  The new table's
        delta runs re-pad with `table.zero_pad_rows`."""
        if table.has_delta:
            raise ValueError(
                f"table {table.name!r} has {table.n_delta} uncompacted "
                "delta rows — compact before re-partitioning "
                "(repro_torch.db.delta.compact)")
        pads = pad_rows or _seeded_zeros(_PARTITION_PAD_SEED)
        offsets = partition_offsets(table.n_rows, spec.num_shards)
        n_sp = next_pow2(int(np.diff(offsets).max()))
        columns = {}
        for ci, (cname, ct) in enumerate(table.columns.items()):
            stack = _stack_empty(spec.num_shards, n_sp, ct.c0)
            for s in range(spec.num_shards):
                lo, hi = int(offsets[s]), int(offsets[s + 1])
                stack.c0[s, :hi - lo] = ct.c0[lo:hi]
                stack.c1[s, :hi - lo] = ct.c1[lo:hi]
                if hi - lo < n_sp:
                    pad = pads(ks, cname, n_sp - (hi - lo), ci * 1024 + s)
                    stack.c0[s, hi - lo:] = pad.c0
                    stack.c1[s, hi - lo:] = pad.c1
                    del pad
            columns[cname] = stack
        st = cls(table.name, columns, offsets, spec,
                 zero_pad_rows=table.zero_pad_rows)
        st._dead = table._dead.copy()
        return st

    # -- geometry ----------------------------------------------------------

    @property
    def num_shards(self) -> int:
        """Logical shard count S (the stacks' leading dim)."""
        return int(self.spec.num_shards)

    @property
    def n_rows(self) -> int:
        """Total BASE rows across all shards (pending delta rows
        excluded; see `n_total`)."""
        return self._n_base

    @property
    def n_padded_per_shard(self) -> int:
        """The common power-of-two per-shard block size N_sp."""
        return next(iter(self.columns.values())).c0.shape[1]

    @property
    def home(self) -> torch.device:
        """The device the table was built on and answers on (the mesh's
        position 0)."""
        return next(iter(self.columns.values())).c0.device

    @property
    def column_names(self) -> tuple:
        """Names of the encrypted columns."""
        return tuple(self.columns)

    def shard_valid(self, s: int) -> np.ndarray:
        """[N_sp] bool — BASE data slots of shard s."""
        return np.arange(self.n_padded_per_shard) < int(self.shard_rows[s])

    def ciphertext_bytes(self) -> int:
        """Storage footprint of all encrypted column stacks + deltas."""
        total = sum(ct.c0.nbytes + ct.c1.nbytes
                    for ct in self.columns.values())
        for d in self.deltas:
            if d is not None:
                total += d.ciphertext_bytes()
        return total

    # -- write path --------------------------------------------------------

    def delta_rows(self, s: int) -> int:
        """Rows pending in shard s's delta run."""
        d = self.deltas[s]
        return 0 if d is None else d.n_rows

    @property
    def n_delta(self) -> int:
        """Total pending delta rows across all shards."""
        return sum(self.delta_rows(s) for s in range(self.num_shards))

    @property
    def n_total(self) -> int:
        """Size of the global row-id space: base + delta rows."""
        return self._n_base + self.n_delta

    @property
    def has_delta(self) -> bool:
        """True while any shard holds an uncompacted delta run."""
        return self.n_delta > 0

    @property
    def alive(self) -> np.ndarray:
        """[n_total] bool — False exactly on tombstoned global ids."""
        return ~self._dead

    @property
    def is_mutated(self) -> bool:
        """True while delta rows or tombstones are outstanding."""
        return self.has_delta or bool(self._dead.any())

    @property
    def delta_block(self) -> int:
        """Common scan-block size for the shards' delta runs: the largest
        run's padded size (smaller or missing runs zero-fill their scan
        lanes, which are invalid and never decoded)."""
        return max((d.n_padded for d in self.deltas if d is not None),
                   default=0)

    def route_counts(self, m: int) -> np.ndarray:
        """[S] rows each shard receives of `m` inserted rows: one at a
        time to the least-loaded shard (base + delta rows), so the
        partition stays balanced without moving any row.  An insert's
        first counts[0] rows go to shard 0, the next counts[1] to shard
        1, and so on."""
        loads = self.shard_rows.astype(np.int64).copy()
        loads += np.asarray([self.delta_rows(s)
                             for s in range(self.num_shards)])
        counts = np.zeros(self.num_shards, np.int64)
        for _ in range(m):
            s = int(np.argmin(loads))
            loads[s] += 1
            counts[s] += 1
        return counts

    def insert(self, ks: KeySet, data: Dict[str, np.ndarray], seed: int = 0,
               *, samples: Optional[Dict[int, Dict[str, tuple]]] = None,
               ) -> np.ndarray:
        """Append new rows, routed to the least-loaded shards; returns
        their global ids.  Each receiving shard s encrypts its chunk into
        its own delta run under `fold_seed(seed, s)` (or `samples[s]`)."""
        if set(data) != set(self.columns):
            raise ValueError(
                f"insert columns {sorted(data)} != table columns "
                f"{sorted(self.columns)}")
        m = len(next(iter(data.values())))
        if m == 0:
            return np.zeros(0, np.int64)
        S = self.num_shards
        counts = self.route_counts(m)
        offs = np.concatenate([[0], np.cumsum(counts)])
        start = self.n_total
        new_pos = np.zeros(m, np.int64)
        for s in range(S):
            c = int(counts[s])
            if c == 0:
                continue
            sl = slice(int(offs[s]), int(offs[s + 1]))
            chunk = {cn: np.asarray(v)[sl] for cn, v in data.items()}
            dt = Table.from_arrays(ks, f"{self.name}.s{s}.delta", chunk,
                                   fold_seed(seed, s),
                                   samples=(samples or {}).get(s))
            prev = self.delta_rows(s)
            self.deltas[s] = (dt if self.deltas[s] is None
                              else append_rows(ks, self.deltas[s], dt,
                                               self.zero_pad_rows))
            gids = start + np.arange(sl.start, sl.stop, dtype=np.int64)
            self._delta_gids[s] = np.concatenate([self._delta_gids[s], gids])
            new_pos[sl] = prev + np.arange(c)
        self._gid_shard = np.concatenate(
            [self._gid_shard, np.repeat(np.arange(S, dtype=np.int64),
                                        counts)])
        self._gid_pos = np.concatenate([self._gid_pos, new_pos])
        self._gid_in_delta = np.concatenate(
            [self._gid_in_delta, np.ones(m, bool)])
        self._dead = np.concatenate([self._dead, np.zeros(m, bool)])
        self._invalidate()
        return start + np.arange(m, dtype=np.int64)

    def delete(self, rows) -> int:
        """Tombstone the given GLOBAL row ids; returns the number of
        newly-dead rows."""
        idx = np.asarray(rows, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_total):
            raise IndexError(f"row ids outside [0, {self.n_total}): {idx}")
        newly = int((~self._dead[idx]).sum())
        self._dead[idx] = True
        self._invalidate()
        return newly

    def update(self, ks: KeySet, rows, data: Dict[str, np.ndarray],
               seed: int = 0, *,
               samples: Optional[Dict[int, Dict[str, tuple]]] = None,
               ) -> np.ndarray:
        """Tombstone `rows` and insert their new versions; returns the
        replacement rows' global ids."""
        self.delete(rows)
        return self.insert(ks, data, seed, samples=samples)

    def _invalidate(self) -> None:
        self.version += 1
        self._delta_index_cache.clear()

    def delta_index(self, ks: KeySet, column: str, s: int):
        """Per-shard `SortedIndex` over shard s's CURRENT delta run
        (lazily built, cached until the next mutation); None when shard s
        has no pending rows."""
        if self.delta_rows(s) == 0:
            return None
        from repro_torch.db.index import SortedIndex
        hit = self._delta_index_cache.get((column, s))
        if hit is not None and hit[0] == self.version:
            return hit[1]
        idx = SortedIndex.build(ks, self.deltas[s], column)
        self._delta_index_cache[(column, s)] = (self.version, idx)
        return idx

    def _fold_deltas(self, ks: KeySet) -> None:
        """Compaction fold (called by `db.delta.compact` AFTER the index
        merges): append each shard's delta rows onto the end of its base
        block, growing the common block to the next power of two if any
        shard overflows; `fold_pad_rows` encryptions of 0 pad the slack
        and no row is re-encrypted.  Each new stack is built on the home
        device and placed, and the old one frees as it is replaced,
        before the next column's stack is built.  Global ids are
        unchanged; the id map flips the folded rows from delta to base
        ownership."""
        if not self.has_delta:
            return
        S, n_sp = self.num_shards, self.n_padded_per_shard
        d = np.asarray([self.delta_rows(s) for s in range(S)], np.int64)
        new_rows = self.shard_rows + d
        new_sp = next_pow2(int(new_rows.max()))
        for ci, cname in enumerate(list(self.columns)):
            ct = self.columns[cname]
            stack = _stack_empty(S, new_sp, ct.c0.slabs[0])
            for s in range(S):
                b, ds = int(self.shard_rows[s]), int(d[s])
                stack.c0[s, :b] = ct.c0.shard(s)[:b]
                stack.c1[s, :b] = ct.c1.shard(s)[:b]
                if ds:
                    dct = self.deltas[s].columns[cname]
                    stack.c0[s, b:b + ds] = dct.c0[:ds]
                    stack.c1[s, b:b + ds] = dct.c1[:ds]
                if b + ds < new_sp:
                    salt = ci * 65536 + s * 256 + self.version % 256
                    pad = self.fold_pad_rows(ks, cname, new_sp - b - ds, salt)
                    stack.c0[s, b + ds:] = pad.c0
                    stack.c1[s, b + ds:] = pad.c1
                    del pad
            self.columns[cname] = self._place({cname: stack})[cname]
            del ct, stack                      # the old stack frees here
        slot_gid = np.full((S, new_sp), -1, np.int64)
        slot_gid[:, :n_sp] = self._slot_gid
        for s in range(S):
            gids = self._delta_gids[s]
            b = int(self.shard_rows[s])
            slot_gid[s, b:b + gids.size] = gids
            self._gid_in_delta[gids] = False
            self._gid_pos[gids] = b + np.arange(gids.size)
        self._slot_gid = slot_gid
        self.shard_rows = new_rows
        self._n_base = int(new_rows.sum())
        self.deltas = [None] * S
        self._delta_gids = [np.zeros(0, np.int64) for _ in range(S)]
        self._invalidate()

    # -- row-id algebra ----------------------------------------------------

    def global_ids(self, s: int) -> np.ndarray:
        """[N_sp] global row id per BASE slot of shard s (-1 on pads)."""
        return self._slot_gid[s]

    @property
    def shard_scan_width(self) -> int:
        """Uniform per-shard scan width: base block + delta block."""
        return self.n_padded_per_shard + self.delta_block

    def shard_slot_gids(self, s: int) -> np.ndarray:
        """[shard_scan_width] global id per UNION scan slot of shard s
        (-1 on pads and on the unused share of the delta block)."""
        ids = np.full(self.shard_scan_width, -1, np.int64)
        ids[:self.n_padded_per_shard] = self._slot_gid[s]
        gids = self._delta_gids[s]
        ids[self.n_padded_per_shard:self.n_padded_per_shard + gids.size] = gids
        return ids

    def shard_slot_valid(self, s: int) -> np.ndarray:
        """[shard_scan_width] bool — live union slots of shard s (pads AND
        tombstones excluded)."""
        gids = self.shard_slot_gids(s)
        ok = gids >= 0
        ok[ok] &= self.alive[gids[ok]]
        return ok

    def shard_of(self, global_rows) -> np.ndarray:
        """Owning shard per global row id (base and delta rows alike)."""
        return self._gid_shard[np.asarray(global_rows, np.int64)]

    def locate(self, global_rows) -> tuple:
        """global ids -> (shard idx, position) arrays.  The position is a
        BASE slot for base rows and a delta-run-local index for rows
        still pending in a delta; `gather_global` handles both."""
        gids = np.asarray(global_rows, np.int64)
        return self._gid_shard[gids], self._gid_pos[gids]

    # -- access ------------------------------------------------------------

    def shard(self, s: int) -> Table:
        """Shard s's BASE block as a plain `Table` on the home device (a
        view when it lies there)."""
        cols = {c: Ciphertext(ct.c0.shard(s), ct.c1.shard(s))
                for c, ct in self.columns.items()}
        return Table(f"{self.name}.s{s}", cols, int(self.shard_rows[s]))

    def gather(self, name: str, s: int, local_rows) -> Ciphertext:
        """Ciphertext rows of shard s's BASE block at local slots, on the
        home device."""
        ct = self.columns[name]
        slots = np.asarray(local_rows, np.int64)
        shards = np.full(slots.shape, s, np.int64)
        return Ciphertext(ct.c0.rows(shards, slots),
                          ct.c1.rows(shards, slots))

    def scan_stack(self, name: str) -> Ciphertext:
        """The named column over the UNION scan: `[S, shard_scan_width,
        ...]` per slab — each shard's base block then its delta run
        (moved to the slab's device), zero-filled to the common delta
        block (those lanes are never decoded).  With no pending delta
        this is the base stack itself."""
        ct = self.columns[name]
        D = self.delta_block
        if D == 0:
            return ct
        N = self.n_padded_per_shard

        def union(stack: ShardStack, half: str) -> ShardStack:
            slabs = []
            for j, slab in enumerate(stack.slabs):
                out = slab.new_zeros((slab.shape[0], N + D)
                                     + tuple(slab.shape[2:]))
                out[:, :N] = slab
                for i in range(slab.shape[0]):
                    d = self.deltas[j * stack.per_slab + i]
                    if d is not None:
                        rows = getattr(d.columns[name], half)
                        out[i, N:N + rows.shape[0]] = rows.to(slab.device)
                slabs.append(out)
            return ShardStack(slabs)
        return Ciphertext(union(ct.c0, "c0"), union(ct.c1, "c1"))

    def gather_global(self, name: str, global_rows) -> Ciphertext:
        """Ciphertext rows at GLOBAL row ids (base slots and pending delta
        rows alike), on the home device."""
        gids = np.asarray(global_rows, np.int64)
        ct = self.columns[name]
        dev = ct.c0.device
        s, pos = self._gid_shard[gids], self._gid_pos[gids]
        in_delta = self._gid_in_delta[gids]
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        if not in_delta.any():
            return Ciphertext(ct.c0.rows(s, pos), ct.c1.rows(s, pos))
        shape = (gids.size,) + tuple(ct.c0.shape[2:])
        c0 = torch.zeros(shape, dtype=ct.c0.dtype, device=dev)
        c1 = torch.zeros_like(c0)
        bi = np.nonzero(~in_delta)[0]
        if bi.size:
            c0[t(bi)] = ct.c0.rows(s[bi], pos[bi])
            c1[t(bi)] = ct.c1.rows(s[bi], pos[bi])
        for sh in np.unique(s[in_delta]):
            di = np.nonzero(in_delta & (s == sh))[0]
            dct = self.deltas[int(sh)].columns[name]
            c0[t(di)] = dct.c0[t(pos[di])]
            c1[t(di)] = dct.c1[t(pos[di])]
        return Ciphertext(c0, c1)

    def decrypt_column(self, ks: KeySet, name: str) -> np.ndarray:
        """Client-side helper (tests / verification only — needs sk): ALL
        rows of the global id space in id order (pending delta rows and
        tombstoned rows included — filter with `alive`)."""
        ct = self.columns[name]
        step, home = E.enc_chunk_rows(ks.params), self.home
        chunks = []
        for x0, x1 in zip(ct.c0.slabs, ct.c1.slabs):    # each slab's rows
            f0 = x0.reshape((-1,) + tuple(x0.shape[2:]))
            f1 = x1.reshape((-1,) + tuple(x1.shape[2:]))
            chunks += [E.decrypt(ks, Ciphertext(
                f0[lo:lo + step].to(home), f1[lo:lo + step].to(home))
            ).cpu().numpy() for lo in range(0, f0.shape[0], step)]
        vals = np.concatenate(chunks).reshape(self.num_shards,
                                              self.n_padded_per_shard)
        out = np.zeros(self.n_total, vals.dtype)
        base = ~self._gid_in_delta
        g = np.nonzero(base)[0]
        out[g] = vals[self._gid_shard[g], self._gid_pos[g]]
        for s in range(self.num_shards):
            if self.delta_rows(s):
                out[self._delta_gids[s]] = (
                    self.deltas[s].decrypt_column(ks, name))
        return out

    def __repr__(self) -> str:
        return (f"ShardedTable({self.name!r}, rows={self.n_rows}, "
                f"shards={self.num_shards}x{self.n_padded_per_shard}, "
                f"cols={list(self.columns)}, spec={self.spec}"
                + (f", delta={self.n_delta}" if self.has_delta else "")
                + ")")
