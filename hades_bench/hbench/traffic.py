"""The general traffic generator: a traffic file's parameters -> a pool
of read requests and a stream of inserts, all from the seed.

A traffic file (`hades_bench/traffic/<name>.json`) holds:

  readers, batch, pool   closed-loop reader clients, the loop's batch
                         cap, and how many distinct read requests are
                         made (once, at set-up: client-side work) and
                         cycled through
  reads                  the request shapes: [{"weight": w, "where":
                         tree}], each shape getting its share of the pool
  index                  true: a SortedIndex on the column, so every
                         read's leaves ride it
  insert_rate, insert_rows   inserts a second, evenly spaced from the
                         window's open (an open loop: a faster program
                         admits no more of them), and the rows of each
                         (no insert_rate: a read-only mix)
  compact_threshold      delta rows that trigger compaction (null: never)
  warm_reads, warm_inserts   the set-up's warm-up traffic (its
                         inserts one after another)

A `where` tree is {"range": {"width": [w0, w1], "offset": o}},
{"eq": {"eps": e}}, {"and": [t, ...]}, {"or": [t, ...]} or {"not": t}.
A range's width is log-uniform in [w0, w1] (stratified over the pool,
so every seed gets the same spread of widths in another order), snapped
to the column's step, and placed uniformly in the column's domain; its
bounds move out by `offset` (off the lattice of a float column).  An eq
takes the value of a uniformly drawn row, duplicates included; `eps`
makes it the band |x - v| <= eps.

The plaintext of each request is a tree of tuples (`reference.mask`
reads it); the program gets the same tree as a `db.plan` predicate over
client-encrypted constants.
"""
from __future__ import annotations

import numpy as np


def fold(seed: int, *xs: int) -> int:
    """A 63-bit seed derived from `seed` and the integers `xs`."""
    out = int(seed)
    for x in xs:
        out = (out * 0x9E3779B97F4A7C15 + int(x) + 1) % (1 << 63)
    return out


def shares(total: int, weights) -> list:
    """`total` split by `weights`, largest remainders first: the same
    counts for every seed."""
    w = np.asarray(weights, dtype=np.float64)
    exact = total * w / w.sum()
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[:total
                                                          - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def _range_leaves(where: dict) -> int:
    (kind, arg), = where.items()
    if kind == "range":
        return 1
    if kind == "eq":
        return 0
    if kind == "not":
        return _range_leaves(arg)
    return sum(_range_leaves(t) for t in arg)


def _tree(where: dict, column, rng, widths) -> tuple:
    """One plaintext request tree; `widths` yields each range leaf's
    stratified uniform in [0, 1)."""
    (kind, arg), = where.items()
    step = column.step
    d0, d1 = column.domain
    if kind == "range":
        w0, w1 = arg["width"]
        w = np.exp(np.log(w0) + next(widths) * (np.log(w1) - np.log(w0)))
        w = min(max(step, round(w / step) * step), d1 - d0)
        lo = d0 + step * int(rng.integers(0, round((d1 - d0 - w) / step) + 1))
        off = float(arg.get("offset", 0))
        return ("range", lo - off, lo + w + off)
    if kind == "eq":
        v = column.values[int(rng.integers(len(column.values)))]
        return ("eq", v, arg.get("eps"))
    if kind == "not":
        return ("not", _tree(arg, column, rng, widths))
    if kind in ("and", "or"):
        return (kind, tuple(_tree(t, column, rng, widths) for t in arg))
    raise ValueError(f"unknown request node {kind!r}")


def read_pool(traffic: dict, column, rng: np.random.Generator) -> list:
    """The pool's plaintext request trees, shapes in their shares, in an
    order drawn from `rng`."""
    shapes = traffic["reads"]
    pool = []
    for spec, count in zip(shapes, shares(traffic["pool"],
                                          [s["weight"] for s in shapes])):
        leaves = _range_leaves(spec["where"])
        # stratified: leaf j of the count requests takes one uniform
        # from each of `count` equal strata, in a drawn order
        u = (np.argsort(rng.random((leaves, count)), axis=1)
             + rng.random((leaves, count))) / max(count, 1)
        for i in range(count):
            pool.append(_tree(spec["where"], column, rng, iter(u[:, i])))
    return [pool[i] for i in rng.permutation(len(pool))]


def _constants(tree: tuple, out: list) -> None:
    kind = tree[0]
    if kind == "range":
        out += [tree[1], tree[2]]
    elif kind == "eq":
        out.append(tree[1])
    elif kind == "not":
        _constants(tree[1], out)
    else:
        for t in tree[1]:
            _constants(t, out)


def encrypt_pool(ks, trees: list, column_name: str, seed: int) -> list:
    """Each tree as a `Query` over its constants, encrypted client-side
    in one batched call (each constant its own ciphertext row)."""
    import torch

    from repro_torch.core import encrypt as E
    from repro_torch.core.encrypt import Ciphertext
    from repro_torch.db import plan as P

    consts: list = []
    for t in trees:
        _constants(t, consts)
    ckks = ks.params.profile.scheme == "ckks"
    vals = torch.tensor(consts, dtype=torch.float64 if ckks else torch.int64)
    cts = E.encrypt(ks, vals, seed)
    slot = iter(range(len(consts)))

    def ct():
        i = next(slot)
        return Ciphertext(cts.c0[i], cts.c1[i])

    def pred(tree):
        kind = tree[0]
        if kind == "range":
            return P.Range(column_name, ct(), ct())
        if kind == "eq":
            return P.Eq(column_name, ct(), eps=tree[2])
        if kind == "not":
            return P.Not(pred(tree[1]))
        parts = [pred(t) for t in tree[1]]
        return P.And(*parts) if kind == "and" else P.Or(*parts)
    return [P.Query(where=pred(t)) for t in trees]


def insert_values(column, seed: int, i: int, rows: int) -> np.ndarray:
    """Insert i's rows: the same rows for a seed whatever else ran."""
    return column.draw(np.random.default_rng(fold(seed, 11, i)), rows)
