"""The least time the card could take for a kernel's work: the bounds of
the roofline shares, from the operation's logical shapes alone.

A bound is the larger of two times:

  * bytes over the card's published memory rate, where every input byte
    is read once and every output byte written once;
  * operations over the card's densest published integer rate (the
    dense INT8 tensor-core rate), one operation per residue
    multiply-add.

Both counts come from what the operation is, never from how a kernel
splits it: a residue is below 2^31 (`core/params.py::ntt_primes`), so it
takes 4 bytes, whatever width an implementation stores it in; and a
multiply-add of a digit or a residue by a residue is one operation,
though the densest rate counts an 8-bit multiply-add as two and no
implementation does a 31-bit residue product in one 8-bit operation.  So
no implementation of the same operation can take less time than the
bound, and a share of it cannot pass 100 % unless the count or the
device time leaves part of the work out.
"""
from __future__ import annotations

RESIDUE_BYTES = 4

# Published peaks, by the name `torch.cuda.get_device_name()` gives.
# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": 1979e12},
}


def gadget_eval_work(atoms: int, rows: int, towers: int, n: int,
                     digits: int, per_lane_bounds: bool,
                     columns: int) -> tuple:
    """(bytes, operations) of the gadget Eval over `atoms` x `rows`
    lanes (Alg. 2 with a digit-decomposed CEK, coefficient 0 only).

    Reads each of the `columns` distinct column tiles' c1 ([rows, K, n])
    and c0's coefficient 0 ([rows, K]), the bounds (one [K, n] + [K] per
    atom, or per lane), and the key ([K, digits, K, n]); writes [atoms,
    rows, K].  Each lane is the dot product of its K x digits digit
    polynomials with the key's rows for each of the K output towers."""
    k, d = towers, digits
    bound_polys = atoms * (rows if per_lane_bounds else 1)
    residues = (columns * rows * (k * n + k) + bound_polys * (k * n + k)
                + k * d * k * n + atoms * rows * k)
    ops = atoms * rows * k * d * k * n
    return residues * RESIDUE_BYTES, ops


def key_mul_work(rows: int, towers: int, n: int) -> tuple:
    """(bytes, operations) of `rows` negacyclic products against one
    fixed key polynomial: read a ([rows, K, n]) and the key once, write
    [rows, K, n]; rows x K x n log2 n multiply-adds (the transforms)."""
    log_n = n.bit_length() - 1
    residues = 2 * rows * towers * n + towers * n
    return residues * RESIDUE_BYTES, rows * towers * n * log_n


def bound_s(nbytes: float, ops: float, peaks: dict) -> float:
    """The least seconds for `nbytes` and `ops` on a card with `peaks`."""
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["ops_per_s"])
