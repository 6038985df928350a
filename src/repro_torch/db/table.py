"""Encrypted column-store `Table`, read and write side.

The port of `repro.db.table`.  A table owns named `Ciphertext` columns
over the same logical rows, padded to the next power of two at ingest,
with the pad slots excluded from every result.  The pad rows are real
encryptions of 0.

Ingest encrypts each column in one `encrypt` call, which runs in row
chunks on the card (`core.encrypt.enc_chunk_rows`).  Per-column streams
come from `column_seed(seed, name)`, the counterpart of the reference's
crc32-folded `column_key`: the column NAME, not its dict position, picks
the stream.  Where a test must reproduce the reference's ciphertexts it
passes the samples instead (`samples={column: (u, e0, e1)}`, and for a
FAE column `(u, e0, e1, pert, e_m)`).

WRITE PATH.  A table is mutable through `insert` / `update` / `delete`:

  * `insert` encrypts the new rows into a small DELTA RUN, a plain
    pow2-padded `Table` hanging off the base (`self.delta`).  Growing an
    existing run concatenates ciphertext rows and re-pads with fresh
    encryptions of 0 (`append_rows`); base rows are never re-encrypted.
    New rows take global ids past the end of the current id space.
  * `delete` records a host-side TOMBSTONE over global row ids; the
    ciphertext rows stay in place and every read path masks them out.
  * `update` is tombstone + re-insert.

Readers answer over base ∪ delta: the SCAN VIEW (`scan_column`,
`slot_valid`, `slot_global_ids`) presents the base block and the delta
block as one slot space, so one fused filter pass covers both.
`db.delta.compact` folds the delta run back into the base and merges it
into any `SortedIndex`.

The fresh encryptions of 0 that re-pad a grown run come from the
table's `zero_pad_rows(ks, column, count, salt)`; by default they are
encrypted under a seed folded from `_APPEND_PAD_SEED`, the column name
and the salt, and a test can hand in the reference's rows instead.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import encrypt as E
from repro_torch.core.compare import next_pow2
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet

# seed of the encryptions of 0 that re-pad a grown run (delta growth,
# compaction); they carry no secret
_APPEND_PAD_SEED = 0xDE17A

# (ks, column, count, salt) -> `count` encryptions of 0
ZeroPadRows = Callable[[KeySet, str, int, int], Ciphertext]


def rows_to_mask(rows, n_padded: int) -> np.ndarray:
    """Row-id list -> [n_padded] bool mask."""
    mask = np.zeros(n_padded, bool)
    mask[np.asarray(rows, dtype=np.int64)] = True
    return mask


def fold_seed(seed: int, x: int) -> int:
    """A seed derived from `seed` and the integer `x`."""
    return (int(seed) * 0x9E3779B1 + int(x)) % (1 << 63)


def column_seed(seed: int, cname: str) -> int:
    """Per-column encryption seed: `seed` folded with crc32 of the
    column NAME, so ingest order does not change any column's stream."""
    return fold_seed(seed, zlib.crc32(cname.encode()))


def pad_rows_pow2(arr: np.ndarray, *, n_target: Optional[int] = None,
                  pad_value: float = 0) -> np.ndarray:
    """Pad a host column to a power-of-two row count (default
    `next_pow2(len(arr))`; an empty column pads to one slot)."""
    arr = np.asarray(arr)
    n_rows = arr.shape[0]
    n_padded = next_pow2(n_rows) if n_target is None else int(n_target)
    if n_padded < max(n_rows, 1) or n_padded != next_pow2(n_padded):
        raise ValueError(
            f"n_target {n_padded} must be a power of two >= {n_rows}")
    is_float = np.issubdtype(arr.dtype, np.floating)
    padded = np.full((n_padded,), pad_value,
                     np.float64 if is_float else np.int64)
    padded[:n_rows] = arr
    return padded


def concat_ct_rows(*cts: Ciphertext) -> Ciphertext:
    """Concatenate ciphertext row stacks along the leading (row) dim."""
    return Ciphertext(torch.cat([ct.c0 for ct in cts]),
                      torch.cat([ct.c1 for ct in cts]))


def _zero_pad_rows(ks: KeySet, cname: str, n_pad: int,
                   salt: int) -> Ciphertext:
    """`n_pad` fresh public-key encryptions of 0 (append-path padding)."""
    return E.encrypt(ks, torch.zeros(n_pad, dtype=torch.int64),
                     fold_seed(column_seed(_APPEND_PAD_SEED, cname), salt))


class Table:
    """Named encrypted columns + row-count bookkeeping + delta-run state."""

    def __init__(self, name: str, columns: Dict[str, Ciphertext],
                 n_rows: int, *, zero_pad_rows: Optional[ZeroPadRows] = None):
        if not columns:
            raise ValueError("table needs at least one column")
        shapes = {c: ct.c0.shape[0] for c, ct in columns.items()}
        n_padded = next(iter(shapes.values()))
        if any(v != n_padded for v in shapes.values()):
            raise ValueError(f"ragged columns: {shapes}")
        if n_padded < 1 or n_padded & (n_padded - 1):
            raise ValueError(f"padded row count {n_padded} not a power of two")
        if not (0 <= n_rows <= n_padded):
            raise ValueError(f"n_rows {n_rows} outside [0, {n_padded}]")
        self.name = name
        self.columns = dict(columns)
        self.n_rows = int(n_rows)
        self.zero_pad_rows = zero_pad_rows or _zero_pad_rows
        # -- write-path state (all host-side) --------------------------
        self.delta: Optional["Table"] = None     # pending insert run
        self._dead = np.zeros(self.n_rows, bool)  # tombstones, global ids
        self.version = 0                          # bumped per mutation
        self._delta_index_cache: Dict[str, tuple] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(cls, ks: KeySet, name: str,
                    data: Dict[str, np.ndarray], seed: int = 0, *,
                    fae: bool = False, n_padded: Optional[int] = None,
                    samples: Optional[Dict[str, tuple]] = None,
                    ) -> "Table":
        """Encrypt host arrays into a padded column-store on the KeySet's
        device.

        data: {column: [n_rows] int (bfv) or float (ckks)}.  Under BFV,
        float input with fractional values is rejected (it would
        truncate).  `fae=True` uses perturbation-aware encryption
        (Alg. 3), which gives up exact Eq semantics by design.
        `samples` gives a column's pre-drawn (u, e0, e1) for all its
        padded rows in place of its seeded stream; under `fae=True` a
        5-tuple (u, e0, e1, pert, e_m) also gives Alg. 3's perturbation
        and payload noise (u, e0, e1 may then be None: drawn from the
        stream).  Zero-length arrays build an empty table (one all-pad
        slot)."""
        lengths = {c: len(v) for c, v in data.items()}
        n_rows = next(iter(lengths.values()))
        if any(v != n_rows for v in lengths.values()):
            raise ValueError(f"ragged input columns: {lengths}")
        enc = E.encrypt_fae if fae else E.encrypt
        is_float = ks.params.profile.scheme == "ckks"
        columns = {}
        for cname, arr in data.items():
            arr = np.asarray(arr)
            if (not is_float and np.issubdtype(arr.dtype, np.floating)
                    and not np.array_equal(arr, np.trunc(arr))):
                raise ValueError(
                    f"column {cname!r}: fractional float values under a "
                    f"{ks.params.profile.scheme} profile would truncate — "
                    "use a ckks profile for float columns")
            padded = pad_rows_pow2(
                arr.astype(np.float64 if is_float else np.int64),
                n_target=n_padded)
            drawn = tuple((samples or {}).get(cname, (None,) * 3))
            if len(drawn) != (5 if fae and len(drawn) > 3 else 3):
                raise ValueError(
                    f"column {cname!r}: samples are (u, e0, e1)"
                    + (" or (u, e0, e1, pert, e_m)" if fae else "")
                    + f", got {len(drawn)} operands")
            u, e0, e1, *fae_ops = drawn
            columns[cname] = enc(ks, padded, column_seed(seed, cname),
                                 u=u, e0=e0, e1=e1,
                                 **dict(zip(("pert", "e_m"), fae_ops)))
        return cls(name, columns, n_rows)

    @classmethod
    def empty(cls, ks: KeySet, name: str, columns: Iterable[str],
              seed: int = 0) -> "Table":
        """A 0-row table over the named columns (one encrypted all-pad
        slot each), which `insert` grows like any other table."""
        return cls.from_arrays(ks, name,
                               {c: np.zeros(0, np.int64) for c in columns},
                               seed)

    @classmethod
    def from_ciphertexts(cls, name: str, columns: Dict[str, Ciphertext],
                         n_rows: int, *,
                         zero_pad_rows: Optional[ZeroPadRows] = None,
                         ) -> "Table":
        """A table over existing padded ciphertext columns (e.g. a
        reference table's columns through `Ciphertext.from_numpy`)."""
        return cls(name, columns, n_rows, zero_pad_rows=zero_pad_rows)

    # -- geometry ----------------------------------------------------------

    @property
    def n_padded(self) -> int:
        """Power-of-two padded row count of the BASE (every base
        column's leading dim; the delta run pads separately)."""
        return next(iter(self.columns.values())).c0.shape[0]

    @property
    def valid(self) -> np.ndarray:
        """[n_padded] bool — True on BASE data rows, False on pad rows."""
        return np.arange(self.n_padded) < self.n_rows

    @property
    def column_names(self) -> tuple:
        """Names of the encrypted columns."""
        return tuple(self.columns)

    def ciphertext_bytes(self) -> int:
        """Storage footprint of all encrypted columns (base + delta)."""
        total = sum(ct.c0.nbytes + ct.c1.nbytes
                    for ct in self.columns.values())
        if self.delta is not None:
            total += self.delta.ciphertext_bytes()
        return total

    # -- write path --------------------------------------------------------

    @property
    def n_delta(self) -> int:
        """Rows currently pending in the delta run."""
        return 0 if self.delta is None else self.delta.n_rows

    @property
    def n_total(self) -> int:
        """Size of the global row-id space: base rows + delta rows
        (tombstoned rows included — ids are never reused)."""
        return self.n_rows + self.n_delta

    @property
    def has_delta(self) -> bool:
        return self.n_delta > 0

    @property
    def alive(self) -> np.ndarray:
        """[n_total] bool — False exactly on tombstoned global ids."""
        return ~self._dead

    @property
    def is_mutated(self) -> bool:
        """True while delta rows or tombstones are outstanding."""
        return self.has_delta or bool(self._dead.any())

    def insert(self, ks: KeySet, data: Dict[str, np.ndarray], seed: int = 0,
               *, samples: Optional[Dict[str, tuple]] = None) -> np.ndarray:
        """Append new rows to the delta run; returns their global ids.

        One batched encrypt per column for the NEW rows only (under
        `seed`, or the pre-drawn `samples` of `from_arrays`); growing an
        existing run concatenates ciphertext rows and re-pads to the
        next power of two."""
        if set(data) != set(self.columns):
            raise ValueError(
                f"insert columns {sorted(data)} != table columns "
                f"{sorted(self.columns)}")
        new = Table.from_arrays(ks, f"{self.name}.delta", data, seed,
                                samples=samples)
        start = self.n_total
        if new.n_rows == 0:
            return np.zeros(0, np.int64)
        if self.delta is None:
            self.delta = new
        else:
            self.delta = append_rows(ks, self.delta, new, self.zero_pad_rows)
        self._dead = np.concatenate(
            [self._dead, np.zeros(new.n_rows, bool)])
        self._invalidate()
        return start + np.arange(new.n_rows, dtype=np.int64)

    def delete(self, rows) -> int:
        """Tombstone the given GLOBAL row ids; returns the number of
        newly-dead rows."""
        idx = np.asarray(rows, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_total):
            raise IndexError(
                f"row ids outside [0, {self.n_total}): {idx}")
        newly = int((~self._dead[idx]).sum())
        self._dead[idx] = True
        self._invalidate()
        return newly

    def update(self, ks: KeySet, rows, data: Dict[str, np.ndarray],
               seed: int = 0, *,
               samples: Optional[Dict[str, tuple]] = None) -> np.ndarray:
        """Tombstone `rows` and insert their new versions; returns the
        replacement rows' global ids."""
        self.delete(rows)
        return self.insert(ks, data, seed, samples=samples)

    def _invalidate(self) -> None:
        self.version += 1
        self._delta_index_cache.clear()

    # -- scan view (base ∪ delta as one slot space) ------------------------

    @property
    def scan_width(self) -> int:
        """Width of the union scan: base block + delta block slots."""
        return self.n_padded + (0 if self.delta is None
                                else self.delta.n_padded)

    def scan_column(self, name: str) -> Ciphertext:
        """The named column over the union slot space: base block then
        delta block (the base column itself while there is no delta)."""
        ct = self.columns[name]
        if self.delta is None:
            return ct
        return concat_ct_rows(ct, self.delta.columns[name])

    @property
    def slot_global_ids(self) -> np.ndarray:
        """[scan_width] global row id per scan slot (-1 on pad slots).
        Base slot i -> id i; delta slot j -> id n_rows + j."""
        ids = np.full(self.scan_width, -1, np.int64)
        ids[:self.n_rows] = np.arange(self.n_rows)
        if self.delta is not None:
            d = self.delta.n_rows
            ids[self.n_padded:self.n_padded + d] = self.n_rows + np.arange(d)
        return ids

    @property
    def slot_valid(self) -> np.ndarray:
        """[scan_width] bool — True on live data slots: pad slots AND
        tombstoned rows excluded."""
        gids = self.slot_global_ids
        ok = gids >= 0
        ok[ok] &= self.alive[gids[ok]]
        return ok

    def delta_index(self, ks: KeySet, column: str):
        """Per-run `SortedIndex` over the CURRENT delta run, built
        lazily and cached until the next mutation (None without a
        pending delta)."""
        if not self.has_delta:
            return None
        from repro_torch.db.index import SortedIndex   # index imports table
        hit = self._delta_index_cache.get(column)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        idx = SortedIndex.build(ks, self.delta, column)
        self._delta_index_cache[column] = (self.version, idx)
        return idx

    # -- access ------------------------------------------------------------

    def column(self, name: str) -> Ciphertext:
        """The named column's stacked BASE ciphertext rows (see
        `scan_column` for the base ∪ delta view)."""
        return self.columns[name]

    def gather(self, name: str, rows: Iterable[int]) -> Ciphertext:
        """Ciphertext rows of `name` at GLOBAL row ids — ids past
        `n_rows` resolve into the delta run."""
        idx = np.ascontiguousarray(rows, dtype=np.int64)
        ct = self.columns[name]
        dev = ct.c0.device
        if self.delta is None or idx.size == 0 or (idx < self.n_rows).all():
            t = torch.as_tensor(idx, device=dev)
            return Ciphertext(ct.c0[t], ct.c1[t])
        dct = self.delta.columns[name]
        in_base = idx < self.n_rows
        bi = torch.as_tensor(np.nonzero(in_base)[0], device=dev)
        di = torch.as_tensor(np.nonzero(~in_base)[0], device=dev)
        brow = torch.as_tensor(idx[in_base], device=dev)
        drow = torch.as_tensor(idx[~in_base] - self.n_rows, device=dev)
        c0 = torch.empty((idx.size,) + ct.c0.shape[1:], dtype=ct.c0.dtype,
                         device=dev)
        c1 = torch.empty_like(c0)
        c0[bi], c1[bi] = ct.c0[brow], ct.c1[brow]
        c0[di], c1[di] = dct.c0[drow], dct.c1[drow]
        return Ciphertext(c0, c1)

    def decrypt_column(self, ks: KeySet, name: str, *,
                       include_padding: bool = False) -> np.ndarray:
        """Client-side helper (tests / verification only — needs sk):
        ALL rows of the global id space in id order (base rows then
        delta rows; tombstoned rows included — filter with `alive`),
        decrypted in row chunks."""
        if include_padding and self.delta is not None:
            raise ValueError("include_padding only applies to a table "
                             "without a pending delta run")
        ct = self.columns[name]
        n = self.n_padded if include_padding else self.n_rows
        step = E.enc_chunk_rows(ks.params)
        parts = [E.decrypt(ks, Ciphertext(ct.c0[lo:lo + step],
                                          ct.c1[lo:lo + step])
                           ).cpu().numpy()
                 for lo in range(0, n, step)]
        vals = np.concatenate(parts)[:n] if parts else np.zeros(0)
        if self.delta is not None:
            vals = np.concatenate(
                [vals, self.delta.decrypt_column(ks, name)])
        return vals

    def __repr__(self) -> str:
        return (f"Table({self.name!r}, rows={self.n_rows}"
                f" (padded {self.n_padded}), cols={list(self.columns)}"
                + (f", delta={self.n_delta}" if self.has_delta else "")
                + (f", dead={int(self._dead.sum())}"
                   if self._dead.any() else "") + ")")


def append_rows(ks: KeySet, base: Table, new: Table,
                zero_pad_rows: ZeroPadRows = _zero_pad_rows) -> Table:
    """Ciphertext-level append: `base`'s valid rows + `new`'s valid
    rows, re-padded to the next power of two with `zero_pad_rows`
    encryptions of 0 (salted by the new row count).  No row is
    re-encrypted.  Grows a delta run, and folds a delta run into the
    base at compaction.  Each column's pad rows are freed before the
    next column's are encrypted (at paper-ckks a fold's pad is up to
    8 GiB a column)."""
    if set(base.columns) != set(new.columns):
        raise ValueError("column mismatch between runs")
    n_total = base.n_rows + new.n_rows
    n_pad = next_pow2(n_total)

    def fold(cname: str, ct: Ciphertext) -> Ciphertext:
        nct = new.columns[cname]
        parts = [Ciphertext(ct.c0[:base.n_rows], ct.c1[:base.n_rows]),
                 Ciphertext(nct.c0[:new.n_rows], nct.c1[:new.n_rows])]
        if n_total < n_pad:
            pad = zero_pad_rows(ks, cname, n_pad - n_total, n_total)
            parts.append(Ciphertext(pad.c0.to(ct.c0.device),
                                    pad.c1.to(ct.c1.device)))
        return concat_ct_rows(*parts)
    columns = {cname: fold(cname, ct) for cname, ct in base.columns.items()}
    return Table(base.name, columns, n_total, zero_pad_rows=zero_pad_rows)
