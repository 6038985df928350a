"""Database-perspective demo: encrypted column -> range query, sort, top-k,
then the same workload through the `repro_torch.db` query engine over
hg38.

The port of `examples/encrypted_range_query.py`, parts 1-5 with the
reference's flags plus `--device`.  The server never sees plaintext
values, only HADES comparison outcomes; every answer is checked against
the plaintext (a wrong one raises).

    PYTHONPATH=src python -m repro_torch.examples.encrypted_range_query
    PYTHONPATH=src python -m repro_torch.examples.encrypted_range_query \\
        --device cpu --rows 2048 --index-rows 512

Part 1 drives the raw core/compare.py primitives on a 64-row bitcoin
slice.  Part 2 builds a `Table` over hg38, runs a fused And(Range, Eq) +
TopK plan (every filter comparison in ONE batched Eval) and contrasts a
linear-scan range query with the same query through a HADES sorted
index.  Part 3 runs the engine over FLOAT columns under a CKKS profile:
ε-band equality, an ε-aware indexed lookup and a float top-k.  Part 4
splits the table into logical shards on the one device: the same plan
with a cross-shard top-k merge, each shard scanning 1/S of the rows.
Part 5 joins two encrypted tables on an encrypted key column: nested
loops against the index-reusing sort-merge, identical pairs.
"""
import argparse
import time

import numpy as np

from repro_torch import db
from repro_torch.core import compare as C
from repro_torch.core import encrypt as E
from repro_torch.core.keys import keygen
from repro_torch.core.params import make_params
from repro_torch.core.ring import resolve_device
from repro_torch.data import load_dataset
from repro_torch.examples import check


def _n(x) -> np.ndarray:
    return x.cpu().numpy()


def part1_primitives(ks, params) -> dict:
    """The raw comparator ops on a small bitcoin slice."""
    col_plain = load_dataset("bitcoin", scheme="bfv", t=params.t)[:64]
    # clamp into the comparable range of the small test profile
    col_plain = (col_plain % (params.max_operand // 2)).astype(np.int64)
    column = E.encrypt(ks, col_plain, 1)
    print(f"encrypted column: {col_plain.shape[0]} rows, "
          f"ct bytes/row = {2 * params.num_towers * params.n * 8}")

    lo_v, hi_v = (int(np.percentile(col_plain, 25)),
                  int(np.percentile(col_plain, 75)))
    ct_lo, ct_hi = E.encrypt(ks, lo_v, 2), E.encrypt(ks, hi_v, 3)

    t0 = time.time()
    mask = _n(C.range_query(ks, column, ct_lo, ct_hi))
    want = (col_plain >= lo_v) & (col_plain <= hi_v)
    print(f"range [{lo_v}, {hi_v}]: {int(mask.sum())} rows matched "
          f"({time.time()-t0:.2f}s); exact: {int(want.sum())}")

    t0 = time.time()
    _, perm = C.encrypted_sort(ks, column)
    ok = bool((col_plain[_n(perm)] == np.sort(col_plain)).all())
    print(f"encrypted bitonic sort: correct={ok} ({time.time()-t0:.2f}s)")

    _, idx = C.encrypted_topk(ks, column, 5)
    top = sorted(col_plain[_n(idx)].tolist())
    print("top-5 (via encrypted compare):", top,
          " exact:", sorted(np.sort(col_plain)[-5:].tolist()))
    return {"range": check(np.array_equal(mask, want), "part 1 range"),
            "sort": check(ok, "part 1 sort"),
            "topk": check(top == sorted(np.sort(col_plain)[-5:].tolist()),
                          "part 1 top-5")}


def part2_db_engine(ks, params, rows: int, index_rows: int) -> dict:
    """The engine over the hg38 genomic-coordinate dataset."""
    vals = load_dataset("hg38", scheme="bfv", t=params.t).astype(np.int64)
    if rows:
        vals = vals[:rows]
    rng = np.random.default_rng(0)
    chrom = rng.integers(1, 23, len(vals))         # second encrypted column

    print(f"\n--- repro_torch.db on hg38 ({len(vals)} rows) ---")
    t0 = time.time()
    table = db.Table.from_arrays(ks, "hg38", {"pos": vals, "chrom": chrom},
                                 10)
    print(f"table: {table} ({table.ciphertext_bytes() / 1e6:.0f} MB ct, "
          f"encrypted in {time.time()-t0:.1f}s)")

    def enc(v, s):
        return E.encrypt(ks, int(v), s)

    # fused plan: And(Range(pos), Eq(chrom)) + TopK — one Eval for the
    # whole filter stage, regardless of how many predicates it holds
    lo, hi = int(np.percentile(vals, 40)), int(np.percentile(vals, 60))
    query = db.Query(
        where=db.And(db.Range("pos", enc(lo, 11), enc(hi, 12)),
                     db.Eq("chrom", enc(7, 13))),
        top_k=db.TopK("pos", 5))
    t0 = time.time()
    res = db.execute(ks, table, query)
    want = (vals >= lo) & (vals <= hi) & (chrom == 7)
    want_top = sorted(vals[want].tolist(), reverse=True)[:5]
    top_ok = vals[res.row_ids].tolist() == want_top
    print(f"And(Range, Eq) + TopK: {int(want.sum())} matched, "
          f"top-5 exact={top_ok} ({time.time()-t0:.1f}s, "
          f"{res.stats.eval_calls} fused Eval, "
          f"{res.stats.filter_compares} compares)")

    # index: build once on a prefix, then range scans in O(log n)
    # compares instead of a linear scan
    n_idx = min(index_rows or len(vals), len(vals))
    sub = db.Table.from_arrays(ks, "hg38_idx", {"pos": vals[:n_idx]}, 14)
    t0 = time.time()
    index = db.SortedIndex.build(ks, sub, "pos")
    sorted_ok = bool((vals[:n_idx][index.perm]
                      == np.sort(vals[:n_idx])).all())
    print(f"sorted index over {n_idx} rows: built in {time.time()-t0:.1f}s "
          f"({index.build_compares} build compares, sorted_ok={sorted_ok})")

    q = db.Range("pos", enc(lo, 15), enc(hi, 16))
    db.execute(ks, sub, q)                                  # warm-up
    db.execute(ks, sub, q, indexes={"pos": index})
    t0 = time.time()
    lin = db.execute(ks, sub, q)
    t_lin = time.time() - t0
    t0 = time.time()
    ind = db.execute(ks, sub, q, indexes={"pos": index})
    t_ind = time.time() - t0
    sub_want = (vals[:n_idx] >= lo) & (vals[:n_idx] <= hi)
    match = bool(np.array_equal(lin.mask, ind.mask))
    print(f"range query: linear {t_lin:.2f}s "
          f"({lin.stats.filter_compares} compares) vs indexed {t_ind:.2f}s "
          f"({ind.stats.filter_compares} compares) — "
          f"speedup {t_lin / t_ind:.1f}x, match={match}")
    return {"fused_mask": check(np.array_equal(res.mask, want),
                                "part 2 And(Range, Eq)"),
            "fused_topk": check(top_ok, "part 2 top-5"),
            "sorted_ok": check(sorted_ok, "part 2 index order"),
            "indexed_range": check(
                match and np.array_equal(lin.mask, sub_want),
                "part 2 indexed range")}


def part3_ckks_floats(rows: int, dev) -> dict:
    """Float columns through the ckks profile: ε-band Eq + float top-k."""
    from repro_torch.core.ckks import equality_tolerance

    params = make_params("test-ckks", mode="gadget")
    print(f"\n--- ckks float columns ({rows} rows, native tolerance "
          f"{equality_tolerance(params):.4f}) ---")
    t0 = time.time()
    ks = keygen(params, 3, device=dev)
    print(f"ckks keygen: {time.time()-t0:.1f}s")

    raw = load_dataset("bitcoin", scheme="ckks")[:rows]
    vals = np.round(raw / raw.max() * 400) * 0.25       # [0, 100] grid floats
    rng = np.random.default_rng(1)
    score = np.round(rng.uniform(0, 10, rows) * 4) * 0.25
    table = db.Table.from_arrays(ks, "btc_float",
                                 {"vol": vals, "score": score}, 4)

    def enc(v, s):
        return E.encrypt(ks, float(v), s)

    # ε-band equality: every day whose score is within 0.3 of today's
    target, eps = float(score[-1]), 0.3
    res = db.execute(ks, table, db.Eq("score", enc(target, 5), eps=eps))
    want = np.abs(score - target) <= eps
    eq_ok = bool(np.array_equal(res.mask, want))
    print(f"Eq(score, {target}, eps={eps}): {len(res)} rows "
          f"(plaintext: {int(want.sum())}, exact={eq_ok})")

    # float range + top-k, linear vs ε-aware indexed binary search
    lo, hi = (float(np.percentile(vals, 40)) - 0.125,
              float(np.percentile(vals, 60)) + 0.125)
    q = db.Query(where=db.Range("vol", enc(lo, 6), enc(hi, 7)),
                 top_k=db.TopK("vol", 5), select=("vol",))
    idx = db.SortedIndex.build(ks, table, "vol")
    lin = db.execute(ks, table, q)
    ind = db.execute(ks, table, q, indexes={"vol": idx})
    wmask = (vals >= lo) & (vals <= hi)
    wtop = sorted(vals[wmask].tolist(), reverse=True)[:5]
    same = bool(np.array_equal(lin.mask, ind.mask))
    top_ok = vals[ind.row_ids].tolist() == wtop
    print(f"Range[{lo:.2f}, {hi:.2f}] + TopK(5): "
          f"linear==indexed=={same}, top-5 exact={top_ok} "
          f"({ind.stats.index_compares} probe compares vs "
          f"{lin.stats.scan_compares} scan)")
    dec = _n(E.decrypt(ks, ind.columns["vol"]))
    err = float(np.abs(dec - np.asarray(wtop)).max())
    print(f"projected ciphertexts decrypt within {err:.2e} of plaintext")
    return {"eps_eq": check(eq_ok, "part 3 ε-band Eq"),
            "range": check(same and np.array_equal(lin.mask, wmask),
                           "part 3 float range"),
            "topk": check(top_ok, "part 3 float top-5"),
            "decrypt": check(err <= equality_tolerance(params),
                             "part 3 projected decrypt")}


def part4_sharded(ks, params, rows: int, shards: int, topk: int) -> dict:
    """The same workload on a table split into logical shards."""
    vals = load_dataset("hg38", scheme="bfv", t=params.t).astype(np.int64)
    if rows:
        vals = vals[:rows]
    spec = db.ShardSpec.create(shards)
    print(f"\n--- sharded table: {len(vals)} rows over {spec} "
          f"(logical shards on one device) ---")

    t0 = time.time()
    st = db.ShardedTable.from_arrays(ks, "hg38", {"pos": vals}, 20,
                                     spec=spec)
    print(f"sharded ingest: {st.num_shards} x {st.n_padded_per_shard}-row "
          f"blocks, uneven tails masked per shard ({time.time()-t0:.1f}s)")

    def enc(v, s):
        return E.encrypt(ks, int(v), s)

    lo, hi = int(np.percentile(vals, 35)), int(np.percentile(vals, 65))
    query = db.Query(where=db.Range("pos", enc(lo, 21), enc(hi, 22)),
                     top_k=db.TopK("pos", topk))
    db.execute(ks, st, query)                               # warm-up
    t0 = time.time()
    res = db.execute(ks, st, query)                         # auto-dispatch
    wall = time.time() - t0
    want = (vals >= lo) & (vals <= hi)
    want_top = sorted(vals[want].tolist(), reverse=True)[:topk]
    top_ok = vals[res.row_ids].tolist() == want_top
    s = res.stats
    print(f"Range + TopK({topk}): {int(want.sum())} matched, "
          f"exact={top_ok} ({wall:.1f}s)")
    print(f"  per-shard scan: {s.per_shard_scan_compares} compares "
          f"(total {s.scan_compares} = {st.num_shards} shards x 1/S slices)")
    print(f"  top-k: {s.per_shard_order_compares} per-shard network + "
          f"{s.merge_compares} cross-shard merge compares "
          f"(merge is O(k*S), independent of n)")

    # fan-out index: every shard's index probed in one lane-batched launch
    idx = db.ShardedIndex.build(ks, st, "pos")
    res_i = db.execute(ks, st, db.Range("pos", enc(lo, 23), enc(hi, 24)),
                       indexes={"pos": idx})
    match = bool(np.array_equal(res_i.mask, want))
    print(f"fan-out indexed range: match={match}, "
          f"{res_i.stats.index_compares} probe compares across "
          f"{st.num_shards} shard indexes, 0 scans")
    return {"topk": check(top_ok, "part 4 sharded top-k"),
            "indexed_range": check(match, "part 4 fan-out range")}


def part5_join(ks, params, rows: int) -> dict:
    """Two encrypted tables, one decrypted result: an equi-join."""
    vals = load_dataset("hg38", scheme="bfv", t=params.t).astype(np.int64)
    vals = vals[:rows]
    rng = np.random.default_rng(2)
    chrom = rng.integers(1, 23, len(vals))          # join key, left side
    positions = db.Table.from_arrays(
        ks, "positions", {"chrom": chrom, "pos": vals}, 30)
    # right side: one annotation row per chromosome
    ann_chrom = np.arange(1, 23)
    ann_score = rng.integers(0, 100, len(ann_chrom))
    annotations = db.Table.from_arrays(
        ks, "annotations", {"chrom": ann_chrom, "score": ann_score}, 31)

    print(f"\n--- encrypted join: {positions.n_rows} positions x "
          f"{annotations.n_rows} annotations on 'chrom' ---")
    join = db.Join(db.Query(select=("pos",)), db.Query(select=("score",)),
                   on="chrom")
    t0 = time.time()
    nested = db.execute_join(ks, positions, annotations, join,
                             strategy="nested")
    t_nested = time.time() - t0
    want = np.argwhere(chrom[:, None] == ann_chrom[None, :])
    nested_ok = bool(np.array_equal(nested.pairs, want))
    print(f"nested-loop: {len(nested)} pairs (exact={nested_ok}, "
          f"{nested.stats.join_compares} pair compares in "
          f"{nested.stats.eval_calls} tiled launches, {t_nested:.1f}s)")

    li = {"chrom": db.SortedIndex.build(ks, positions, "chrom")}
    ri = {"chrom": db.SortedIndex.build(ks, annotations, "chrom")}
    t0 = time.time()
    merged = db.execute_join(ks, positions, annotations, join,
                             left_indexes=li, right_indexes=ri)
    t_sm = time.time() - t0
    same = bool(np.array_equal(merged.pairs, nested.pairs))
    print(f"sort-merge:  {len(merged)} pairs (identical={same}, "
          f"{merged.stats.join_compares} compares = "
          f"{nested.stats.join_compares // max(1, merged.stats.join_compares)}"
          f"x fewer, {t_sm:.1f}s)")

    # ONLY the projected result ever decrypts (client-side, needs sk)
    pos_dec = _n(E.decrypt(ks, merged.columns["left.pos"]))
    score_dec = _n(E.decrypt(ks, merged.columns["right.score"]))
    ok = (np.array_equal(pos_dec, vals[merged.pairs[:, 0]])
          and np.array_equal(score_dec, ann_score[merged.pairs[:, 1]]))
    print(f"decrypted join result: {len(pos_dec)} (pos, score) rows, "
          f"exact={ok}; first 3: "
          f"{list(zip(pos_dec[:3].tolist(), score_dec[:3].tolist()))}")
    return {"nested": check(nested_ok, "part 5 nested-loop pairs"),
            "sort_merge": check(same, "part 5 sort-merge pairs"),
            "decrypt": check(bool(ok), "part 5 decrypted columns")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--rows", type=int, default=0,
                    help="hg38 rows for the db demo (0 = all 34,423)")
    ap.add_argument("--index-rows", type=int, default=4096,
                    help="rows to index (0 = all; build is O(n log^2 n))")
    ap.add_argument("--no-ckks", action="store_true",
                    help="skip the float-column (ckks) part")
    ap.add_argument("--ckks-rows", type=int, default=256,
                    help="rows for the float-column part")
    ap.add_argument("--no-shard", action="store_true",
                    help="skip the sharded-table part")
    ap.add_argument("--shards", type=int, default=4,
                    help="logical shard count for part 4")
    ap.add_argument("--shard-rows", type=int, default=8192,
                    help="hg38 rows for the sharded part (0 = all)")
    ap.add_argument("--join-rows", type=int, default=512,
                    help="hg38 rows for the join part (0 = skip)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = make_params("test-bfv", mode="gadget")
    ks = keygen(params, 0, device=dev)
    out = {"part1": part1_primitives(ks, params),
           "part2": part2_db_engine(ks, params, args.rows, args.index_rows)}
    if not args.no_ckks:
        out["part3"] = part3_ckks_floats(args.ckks_rows, dev)
    if not args.no_shard:
        out["part4"] = part4_sharded(ks, params, args.shard_rows,
                                     args.shards, 5)
    if args.join_rows:
        out["part5"] = part5_join(ks, params, args.join_rows)
    return out


if __name__ == "__main__":
    main()
