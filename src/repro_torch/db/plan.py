"""Logical query plan IR for the encrypted query engine.

The reference's IR (`repro.db.plan`) unchanged, over the port's
`Ciphertext`.  `Join` and `compile_join` are part of the IR; executing a
join arrives with the join slice.

A query against an encrypted `Table` is a small tree of predicate nodes
over named columns plus optional ordering / truncation stages:

    predicates : Range(col, ct_lo, ct_hi[, eps]) | Eq(col, ct_value[, eps])
                 And(...) | Or(...) | Not(p)
    stages     : OrderBy(col, descending) | TopK(col, k) | Limit(count)
    two-table  : Join(left, right, on[, kind, eps]) — the engine's only
                 multi-table node; see `Join` and `compile_join`

Float (CKKS) columns carry an optional per-predicate tolerance `eps`
(plaintext units): `Eq(col, v, eps)` is the ε-band |col - v| <= ε rather
than exact match, and `Range` bounds become ε-inclusive.  The ε rides
the IR down to the executor's fused eval launch, where it resolves to a
per-atom decode threshold (`ckks.eps_to_tau`) applied host-side on the
shared raw eval values — so mixed-ε plans still fuse into ONE launch.
`eps=None` keeps the profile's native semantics (exact on BFV,
`ckks.equality_tolerance` precision on CKKS).

Predicate *constants* are client-encrypted `Ciphertext` trapdoors — the
server combines HADES comparison outcomes but never sees a plaintext
bound.  `compile_plan` lowers a `Query` to a `CompiledPlan`: the deduped
list of comparison leaves plus a boolean combination tree over leaf
indices.  The executor then resolves every leaf either through a
`SortedIndex` (O(log n) compares) or through one fused linear scan — all
scan comparisons of a plan stage ride in a single batched raw-eval
pass (Mazzone et al.'s batched-comparison lesson applied to query
plans).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core.encrypt import Ciphertext


class Predicate:
    """Base class for filter-tree nodes."""

    def __and__(self, other: "Predicate") -> "And":
        return And(self, other)

    def __or__(self, other: "Predicate") -> "Or":
        return Or(self, other)

    def __invert__(self) -> "Not":
        return Not(self)


@dataclasses.dataclass(frozen=True)
class Range(Predicate):
    """lo <= column <= hi (both bounds encrypted, inclusive).  `eps`
    makes the bounds ε-inclusive on float columns (rows within ε of a
    bound count as inside).

    Compare cost: lowers to 2 scan atoms (`>= lo`, `<= hi`), i.e. 2·n
    Eval lanes in the fused linear scan, or ~2·log2 n binary-search
    probes when the column has a `SortedIndex` (2 boundary lanes riding
    one batched search)."""
    column: str
    lo: Ciphertext
    hi: Ciphertext
    eps: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Eq(Predicate):
    """column == value (encrypted; requires EncBasic operands — FAE
    deliberately obfuscates equality, Alg. 3).  `eps` turns exact match
    into the ε-band |column - value| <= ε (the equality semantics float
    CKKS columns need; `eps=None` uses the profile's native τ).

    Compare cost: 1 scan atom — n Eval lanes in the fused linear scan —
    or ~2·log2 n probes through a `SortedIndex` (the band's two
    boundaries resolve as 2 lanes of one batched search, for exact and
    ε-band alike)."""
    column: str
    value: Ciphertext
    eps: Optional[float] = None


class And(Predicate):
    """All children hold.  Free at the compare level: children's leaf
    masks AND host-side on trapdoor outcomes (0 extra Eval lanes)."""

    def __init__(self, *children: Predicate):
        self.children: Tuple[Predicate, ...] = tuple(children)

    def __repr__(self) -> str:
        return f"And{self.children!r}"


class Or(Predicate):
    """Any child holds.  Free at the compare level (host-side mask OR —
    0 extra Eval lanes)."""

    def __init__(self, *children: Predicate):
        self.children: Tuple[Predicate, ...] = tuple(children)

    def __repr__(self) -> str:
        return f"Or{self.children!r}"


@dataclasses.dataclass(frozen=True)
class Not(Predicate):
    """Child does not hold.  Free at the compare level (host-side mask
    complement over the valid rows — 0 extra Eval lanes)."""
    child: Predicate


@dataclasses.dataclass(frozen=True)
class OrderBy:
    """Sort matched rows by `column`.  Cost: one full bitonic network
    over the m matched rows — `bitonic_compare_count(m)` = O(m log² m)
    compare-exchanges, each network stage ONE batched Eval."""
    column: str
    descending: bool = False


@dataclasses.dataclass(frozen=True)
class TopK:
    """Largest k matched rows by `column`, descending.  Cost: partial
    bitonic tournament, O(m log² kp) compares (kp = next_pow2(k)) over
    the m matched rows — every stage one batched Eval."""
    column: str
    k: int


@dataclasses.dataclass(frozen=True)
class Limit:
    """Truncate to the first `count` row ids.  Host-side slice —
    0 Eval lanes."""
    count: int


@dataclasses.dataclass(frozen=True)
class Query:
    """A complete logical plan: filter -> order/top-k -> limit -> project.

    `select` names the columns whose ciphertexts the result should carry
    (row ids are always returned; gathering ciphertexts is optional).
    """
    where: Optional[Predicate] = None
    order_by: Optional[OrderBy] = None
    top_k: Optional[TopK] = None
    limit: Optional[Union[Limit, int]] = None
    select: Tuple[str, ...] = ()

    @property
    def limit_count(self) -> Optional[int]:
        """The row cap as an int (accepts Limit or bare int; None = no cap)."""
        if self.limit is None:
            return None
        return self.limit.count if isinstance(self.limit, Limit) else int(self.limit)


@dataclasses.dataclass(frozen=True)
class Join:
    """Two-table equi-join: rows (l, r) with left_col(l) == right_col(r).

    The engine's first multi-table plan node.  `left` / `right` are
    optional single-table sub-plans (a `Query`, a bare `Predicate`, or
    None = all rows) that filter each side BEFORE the join; their
    `select` columns become the joined result's projected columns
    (prefixed "left." / "right.").  `on` names the join key: one column
    name shared by both tables, or a `(left_column, right_column)` pair.

    `eps` widens equality to the ε-band |left_col - right_col| <= ε
    (plaintext units) — the float-key join semantics CKKS columns need;
    `eps=None` keeps the profile's native τ (exact on BFV).  As with
    filter predicates, ε resolves to a host-side decode threshold on the
    shared raw-eval launches, so mixed-ε joins share compiled programs.

    Compare cost (see `db.join` for the execution strategies):

      * nested-loop: ONE tiled batched Eval over the full padded
        N_l × N_r row-pair grid — exact, index-free, O(n_l·n_r) lanes.
      * sort-merge:  two sorted runs (reused from `SortedIndex`es, or
        built on the fly) merged by the log-depth half-cleaner network
        plus one adjacency Eval — O((n_l+n_r)·log(n_l+n_r)) compares.

    `kind` currently must be "eq" (the HADES comparison plane also
    supports ordering, so band/θ-joins are a natural follow-on).
    """
    left: Optional[Union["Query", Predicate]]
    right: Optional[Union["Query", Predicate]]
    on: Union[str, Tuple[str, str]]
    kind: str = "eq"
    eps: Optional[float] = None

    @property
    def on_columns(self) -> Tuple[str, str]:
        """Normalized (left_column, right_column) join-key pair."""
        if isinstance(self.on, str):
            return (self.on, self.on)
        lcol, rcol = self.on
        return (str(lcol), str(rcol))


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Atom:
    """One scan comparison: satisfied iff compare(column_row, value) op 0.

    `eps` is the predicate's tolerance (plaintext units) — the executor
    resolves it to this atom's decode threshold; None = profile default.
    """
    column: str
    op: str                    # ">=", "<=", "=="
    value: Ciphertext
    eps: Optional[float] = None


@dataclasses.dataclass
class CompiledPlan:
    """Lowered plan: deduped comparison leaves + boolean tree over them.

    tree grammar: ("leaf", i) | ("and", [t..]) | ("or", [t..]) | ("not", t)
    leaves[i] is a Range or Eq node.  `None` tree = select-all.
    """
    query: Query
    leaves: list
    tree: Optional[tuple]

    @property
    def num_leaves(self) -> int:
        """Deduped comparison-leaf count (the filter stage's lane budget:
        each leaf is 1 Eq or 2 Range atoms in the fused scan)."""
        return len(self.leaves)

    def scan_atoms(self, leaf_idx: int) -> Tuple[Atom, ...]:
        """The linear-scan comparisons leaf `leaf_idx` lowers to."""
        leaf = self.leaves[leaf_idx]
        if isinstance(leaf, Range):
            return (Atom(leaf.column, ">=", leaf.lo, leaf.eps),
                    Atom(leaf.column, "<=", leaf.hi, leaf.eps))
        return (Atom(leaf.column, "==", leaf.value, leaf.eps),)


def _leaf_key(leaf: Predicate) -> tuple:
    """Structural identity for dedup: same column + same trapdoor arrays
    + same tolerance (different ε = different predicate)."""
    if isinstance(leaf, Range):
        return ("range", leaf.column, id(leaf.lo.c0), id(leaf.hi.c0),
                leaf.eps)
    return ("eq", leaf.column, id(leaf.value.c0), leaf.eps)


def compile_plan(query: Union[Query, Predicate]) -> CompiledPlan:
    """Lower a Query (or bare predicate) to a CompiledPlan.

    Duplicate leaves (same column, same trapdoor ciphertexts) collapse to
    one comparison — e.g. Or(And(Range(a), Eq(b)), And(Range(a), Eq(c)))
    evaluates Range(a) once.
    """
    if isinstance(query, Predicate):
        query = Query(where=query)
    leaves: list = []
    seen: dict = {}

    def walk(p: Predicate) -> tuple:
        if isinstance(p, (Range, Eq)):
            key = _leaf_key(p)
            if key not in seen:
                seen[key] = len(leaves)
                leaves.append(p)
            return ("leaf", seen[key])
        if isinstance(p, And):
            return ("and", [walk(c) for c in p.children])
        if isinstance(p, Or):
            return ("or", [walk(c) for c in p.children])
        if isinstance(p, Not):
            return ("not", walk(p.child))
        raise TypeError(f"unknown predicate node: {p!r}")

    tree = walk(query.where) if query.where is not None else None
    return CompiledPlan(query=query, leaves=leaves, tree=tree)


@dataclasses.dataclass
class CompiledJoin:
    """Lowered `Join`: per-side compiled filter plans + the key pair.

    `left_plan` / `right_plan` are `CompiledPlan`s (None = select-all
    side); their leaves resolve through the same index-or-fused-scan
    machinery as single-table plans — which is exactly how the batched
    QueryServer folds a join's side filters into its shared launches.
    """
    join: Join
    left_plan: Optional[CompiledPlan]
    right_plan: Optional[CompiledPlan]

    @property
    def on_columns(self) -> Tuple[str, str]:
        """Normalized (left_column, right_column) join-key pair."""
        return self.join.on_columns


def _side_plan(side) -> Optional[CompiledPlan]:
    """Compile one side of a Join (None / Predicate / Query)."""
    if side is None:
        return None
    if isinstance(side, (Query, Predicate)):
        return compile_plan(side)
    raise TypeError(f"join side must be Query/Predicate/None, got {side!r}")


def compile_join(join: Join) -> CompiledJoin:
    """Lower a `Join` to a CompiledJoin (validates `kind`)."""
    if not isinstance(join, Join):
        raise TypeError(f"cannot compile {join!r} as a join")
    if join.kind != "eq":
        raise ValueError(
            f"unsupported join kind {join.kind!r} (only 'eq' for now)")
    lcol, rcol = join.on_columns          # validates the `on` shape
    assert lcol and rcol
    return CompiledJoin(join=join, left_plan=_side_plan(join.left),
                        right_plan=_side_plan(join.right))
