"""The plain reference and the comparison that decides `correct`.

The reference answers each read on the plaintext column with NumPy: the
rows a request's tree (`traffic._tree`) selects among the rows that
exist when the read is admitted, that is the column as made plus every
insert admitted before the read, in admission order.  It imports nothing
of the program and takes nothing the program made: only the values and
constants that the benchmark drew itself.

The program's answers are judged by these numbers, each with limit 0
(the configurations promise exact answers, and that every read sees
exactly the writes admitted before it):

  wrong_reads      answered reads whose row ids differ from the
                   reference's (the read-back after the window counts)
  lost_reads       reads of the window that never came back OK
  lost_writes      inserts of the window that were never acknowledged
  wrong_write_ids  acknowledged inserts whose row ids are not the next
                   ids in admission order

The control is this reference computed one bit coarser (`coarsen`:
every value and constant floored to twice the column's step: 16 of the
17 bits of a BFV coordinate, half the lattice's resolution on a float
column), put in the program's place; it has to fail `wrong_reads`.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"wrong_reads": 0, "lost_reads": 0, "lost_writes": 0,
          "wrong_write_ids": 0}


def mask(tree: tuple, x: np.ndarray, q=None) -> np.ndarray:
    """The rows of `x` that `tree` selects; `q` (optional) maps every
    value and constant first."""
    q = q or (lambda v: v)
    kind = tree[0]
    if kind == "range":
        xq = q(x)
        return (xq >= q(tree[1])) & (xq <= q(tree[2]))
    if kind == "eq":
        xq, v, eps = q(x), q(tree[1]), tree[2]
        return xq == v if eps is None else np.abs(xq - v) <= eps
    if kind == "not":
        return ~mask(tree[1], x, q)
    parts = [mask(t, x, q) for t in tree[1]]
    out = parts[0]
    for p in parts[1:]:
        out = out & p if kind == "and" else out | p
    return out


def coarsen(step: float):
    """The control's quantizer: values floored to twice `step`."""
    width = 2 * step
    return lambda v: np.floor(np.asarray(v) / width) * width


class Reference:
    """Answers over a column that grows by admitted inserts."""

    def __init__(self, base: np.ndarray, inserts: list, q=None):
        self.values = np.concatenate([base, *inserts]) if inserts else base
        self.ends = np.cumsum([len(base)] + [len(v) for v in inserts])
        self.q = q
        self._memo: dict = {}

    def answer(self, tree: tuple, admitted_inserts: int) -> np.ndarray:
        """Row ids that `tree` selects after the first
        `admitted_inserts` inserts."""
        key = (id(tree), admitted_inserts)
        if key not in self._memo:
            x = self.values[:self.ends[admitted_inserts]]
            self._memo[key] = np.nonzero(mask(tree, x, self.q))[0]
        return self._memo[key]

    def insert_ids(self, i: int) -> np.ndarray:
        """The global row ids insert i takes."""
        return np.arange(self.ends[i], self.ends[i + 1])


def judge(reads: list, writes: list, reference: Reference,
          answers=None) -> dict:
    """{name: [number, limit]} over the window's records; `answers`
    (optional) replaces the program's row ids, read by read (the
    control)."""
    wrong = lost = 0
    for i, r in enumerate(reads):
        if r.status != "OK":
            lost += 1
            continue
        got = r.row_ids if answers is None else answers[i]
        want = reference.answer(r.tree, r.admitted_inserts)
        wrong += int(not np.array_equal(np.sort(got), want))
    out = {"wrong_reads": wrong, "lost_reads": lost}
    if writes:
        out["lost_writes"] = sum(w.status != "OK" for w in writes)
        out["wrong_write_ids"] = sum(
            w.status == "OK" and not np.array_equal(
                w.row_ids, reference.insert_ids(w.index)) for w in writes)
    return {k: [v, LIMITS[k]] for k, v in out.items()}


def control_answers(reads: list, reference_base: np.ndarray,
                    inserts: list, step: float) -> list:
    """The control's row ids for each read: the reference one bit
    coarser, in the program's place."""
    coarse = Reference(reference_base, inserts, coarsen(step))
    return [coarse.answer(r.tree, r.admitted_inserts) for r in reads]


def is_correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
