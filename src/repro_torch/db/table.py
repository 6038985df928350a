"""Encrypted column-store `Table` (read side).

The port of `repro.db.table` for the served path.  A table owns named
`Ciphertext` columns over the same logical rows, padded to the next
power of two at ingest, with the pad slots excluded from every result.
The pad rows are real encryptions of 0.

Ingest encrypts each column in one `encrypt` call, which runs in row
chunks on the card (`core.encrypt.ENC_CHUNK_ROWS`).  Per-column streams
come from `column_seed(seed, name)`, the counterpart of the reference's
crc32-folded `column_key`: the column NAME, not its dict position, picks
the stream.

The write path (insert/delete/update, delta runs, compaction) is not
ported yet: a table here has no delta, so the scan view is the base
block and every global row id is a base slot.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import encrypt as E
from repro_torch.core.compare import next_pow2
from repro_torch.core.encrypt import Ciphertext
from repro_torch.core.keys import KeySet


def rows_to_mask(rows, n_padded: int) -> np.ndarray:
    """Row-id list -> [n_padded] bool mask."""
    mask = np.zeros(n_padded, bool)
    mask[np.asarray(rows, dtype=np.int64)] = True
    return mask


def column_seed(seed: int, cname: str) -> int:
    """Per-column encryption seed: `seed` folded with crc32 of the
    column NAME, so ingest order does not change any column's stream."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(cname.encode())) % (1 << 63)


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


class Table:
    """Named encrypted columns + row-count bookkeeping."""

    def __init__(self, name: str, columns: Dict[str, Ciphertext],
                 n_rows: int):
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

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(cls, ks: KeySet, name: str,
                    data: Dict[str, np.ndarray], seed: int = 0, *,
                    fae: bool = False,
                    n_padded: Optional[int] = None) -> "Table":
        """Encrypt host arrays into a padded column-store on the KeySet's
        device.

        data: {column: [n_rows] int (bfv) or float (ckks)}.  Under BFV,
        float input with fractional values is rejected (it would
        truncate).  `fae=True` uses perturbation-aware encryption
        (Alg. 3), which gives up exact Eq semantics by design."""
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
            columns[cname] = enc(ks, padded, column_seed(seed, cname))
        return cls(name, columns, n_rows)

    @classmethod
    def from_ciphertexts(cls, name: str, columns: Dict[str, Ciphertext],
                         n_rows: int) -> "Table":
        """A table over existing padded ciphertext columns (e.g. a
        reference table's columns through `Ciphertext.from_numpy`)."""
        return cls(name, columns, n_rows)

    # -- geometry ----------------------------------------------------------

    @property
    def n_padded(self) -> int:
        """Power-of-two padded row count (every column's leading dim)."""
        return next(iter(self.columns.values())).c0.shape[0]

    @property
    def n_total(self) -> int:
        """Size of the global row-id space (base rows; no delta yet)."""
        return self.n_rows

    def ciphertext_bytes(self) -> int:
        """Storage footprint of all encrypted columns."""
        return sum(ct.c0.nbytes + ct.c1.nbytes
                   for ct in self.columns.values())

    # -- scan view ---------------------------------------------------------

    @property
    def scan_width(self) -> int:
        """Width of the fused scan: the padded base block."""
        return self.n_padded

    def scan_column(self, name: str) -> Ciphertext:
        """The named column as the fused filter launch scans it."""
        return self.columns[name]

    @property
    def slot_global_ids(self) -> np.ndarray:
        """[scan_width] global row id per scan slot (-1 on pad slots)."""
        ids = np.full(self.scan_width, -1, np.int64)
        ids[:self.n_rows] = np.arange(self.n_rows)
        return ids

    @property
    def slot_valid(self) -> np.ndarray:
        """[scan_width] bool — True on data slots, False on pad slots."""
        return self.slot_global_ids >= 0

    # -- access ------------------------------------------------------------

    def gather(self, name: str, rows: Iterable[int]) -> Ciphertext:
        """Ciphertext rows of `name` at the given global row ids."""
        ct = self.columns[name]
        idx = torch.as_tensor(np.ascontiguousarray(rows, dtype=np.int64),
                              device=ct.c0.device)
        return Ciphertext(ct.c0[idx], ct.c1[idx])

    def decrypt_column(self, ks: KeySet, name: str, *,
                       include_padding: bool = False) -> np.ndarray:
        """Client-side helper (tests / verification only — needs sk):
        the column's values in row-id order, decrypted in row chunks."""
        ct = self.columns[name]
        n = self.n_padded if include_padding else self.n_rows
        parts = [E.decrypt(ks, Ciphertext(ct.c0[lo:lo + E.ENC_CHUNK_ROWS],
                                          ct.c1[lo:lo + E.ENC_CHUNK_ROWS])
                           ).cpu().numpy()
                 for lo in range(0, n, E.ENC_CHUNK_ROWS)]
        vals = np.concatenate(parts) if parts else np.zeros(0)
        return vals[:n]

    def __repr__(self) -> str:
        return (f"Table({self.name!r}, rows={self.n_rows}"
                f" (padded {self.n_padded}), cols={list(self.columns)})")
