"""CPU tests of the benchmark's harness, at small sizes (no card).

Each cell runs here at test-bfv / test-ckks on 200 rows, with a few
clients and a window of half a second, through the same set-up, clients,
drain and judgement as on the card (the kernels' plain versions run in
place of the CUDA ones).  The data are cut to a narrow domain so that
200 rows fill it as densely as the full column fills its own, which the
control needs to show."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from hbench import cli, reference  # noqa: E402
from hbench.spec import Bench  # noqa: E402

SMALL_CONFIG = {
    "bfv": {"profile": "test-bfv", "rows": 200, "modulus": 512,
            "domain": [0, 511]},
    "ckks": {"profile": "test-ckks", "rows": 200, "span": 50,
             "domain": [0, 50]},
}
SMALL_TRAFFIC = {"readers": 4, "batch": 4, "pool": 48, "warm_reads": 8}
SMALL_WRITES = {"insert_rate": 8, "insert_rows": 4, "compact_threshold": 16,
                "warm_inserts": 4}
SEED = 2**31 + 77
CELLS = ("hg38-bfv.scan", "hg38-ckks.scan", "hg38-bfv.ingest")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def small(bench: Bench) -> Bench:
    """`bench` with every configuration and traffic mix cut to test size."""
    config, traffic = bench.config, bench.traffic

    def cut_config(name):
        c = config(name)
        c.update(SMALL_CONFIG[c["scheme"]])
        return c

    def cut_traffic(name):
        t = traffic(name)
        t.update(SMALL_TRAFFIC)
        if t.get("insert_rate"):
            t.update(SMALL_WRITES)
        return t
    bench.config, bench.traffic = cut_config, cut_traffic
    return bench


def run(bench, workload, *, trace=False, seconds=0.5):
    cell, win, back = cli.measure(bench, workload, SEED, seconds, trace,
                                  torch.device("cpu"), time.perf_counter())
    return cell, win, back, cli.judge_run(cell, win, back)


def test_entries_resolve():
    bench = Bench(ROOT)
    doc = bench.doc
    names = {w["name"] for w in doc["workloads"]}
    for c in doc["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["guarantees"]) == {"answers", "writes"}
    for w in doc["workloads"]:
        bench.config(w["config"])
        t = bench.traffic(w["traffic"])
        assert {"readers", "batch", "pool", "reads", "warm_reads"} <= set(t)
        e2e = [m["name"] for m in bench.metrics(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics(w["name"], True)
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert callable(bench.reader(m["name"]))
        assert set(m.get("workloads", names)) <= names
    e2e = {e["name"]: e for e in doc["end_to_end"]}
    for m in doc["per_layer"]:
        # every cell that reads the metric reports what it moves
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", names)) <= set(
            moved.get("workloads", names))


def test_new_traffic_file_runs_without_an_edit(tmp_path):
    shutil.copytree(HERE, tmp_path / "hades_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "hg38-bfv.points", "config": "hg38-bfv",
                             "traffic": "bfv_points", "chips": 1,
                             "why": "exact Eq reads only"})
    # a split quantity is read by its quantity's file: no new reader
    doc["end_to_end"].append({"name": "qps.hg38-bfv.points",
                              "unit": "queries/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["hg38-bfv.points"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (tmp_path / "hades_bench" / "traffic" / "bfv_points.json").write_text(
        json.dumps({"readers": 4, "batch": 4, "pool": 16, "warm_reads": 4,
                    "reads": [{"weight": 1, "where": {"eq": {}}}]}))
    bench = small(Bench(tmp_path))
    _, win, _, checks = run(bench, "hg38-bfv.points")
    assert reference.is_correct(checks) and win.ok_reads()
    assert set(cli.read_metrics(bench, "hg38-bfv.points", win, False)) == {
        "qps.hg38-bfv.points", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_port_and_control_fails(workload):
    cell, win, back, checks = run(small(Bench(ROOT)), workload)
    assert checks == {k: [0, 0] for k in checks}
    assert len(win.reads) >= 8
    if win.writes:
        assert len(win.writes) >= 2 and cell.server.compaction_log
    reads = win.reads + [back]
    ref = reference.Reference(cell.column.values, cell.insert_rows)
    control = reference.judge(reads, win.writes, ref,
                              answers=reference.control_answers(
                                  reads, cell.column.values,
                                  cell.insert_rows, cell.column.step))
    assert control["wrong_reads"][0] > 0


def test_inserts_keep_to_the_schedule():
    """Inserts arrive at the traffic's rate whatever the program's speed:
    every one due by the close is admitted, none after it, and each is
    timed from its due time."""
    cell, win, _, checks = run(small(Bench(ROOT)), "hg38-bfv.ingest")
    rate = SMALL_WRITES["insert_rate"]
    due = [w.submit_t - win.t0 for w in win.writes]
    assert reference.is_correct(checks) and due
    assert np.allclose(due, np.arange(len(due)) / rate)
    assert len(due) == int(win.seconds * rate) + 1
    assert all(w.done_t >= w.submit_t for w in win.writes)
    assert cell.table.n_total == 200 + 4 * (4 + len(due))


def test_window_refuses_inserts_past_the_slots():
    bench = small(Bench(ROOT))
    traffic = bench.traffic

    def fast(name):
        t = traffic(name)
        t["insert_rate"] = 200      # 0.75 s x 200 x 4 rows: past 256 slots
        return t
    bench.traffic = fast
    with pytest.raises(ValueError, match="slots"):
        run(bench, "hg38-bfv.ingest")


def test_result_line_keys():
    bench = small(Bench(ROOT))
    _, win, _, checks = run(bench, "hg38-bfv.ingest", trace=True)
    metrics = cli.read_metrics(bench, "hg38-bfv.ingest", win, True)
    assert {"loop.batch_fill.hg38-bfv.ingest",
            "server.batch_ms.hg38-bfv.ingest", "loop.read_qps.hg38-bfv.ingest",
            "index.search_ms", "write.compact_ms"} <= set(metrics)
    device = {"platform": "gpu", "kind": "card", "count": 1,
              "memory_peak_bytes": 1}
    plain = cli.result_line(checks, 3, 0, metrics, device)
    traced = cli.result_line(checks, 3, 0, metrics, device,
                             cli.breakdown(win))
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert json.loads(json.dumps(traced)) == traced


def test_runner_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the runner would run")
    rc = cli.main(["--workload", "hg38-bfv.scan", "--seed", "1",
                   "--seconds", "1"], time.perf_counter())
    assert rc == 2 and capsys.readouterr().out == ""


def test_foreign_modules_compare_whole_names():
    assert cli.foreign_modules(["repro_torch", "repro_torch.db",
                                "numpy", "jaxtyping"]) == []
    assert cli.foreign_modules(["repro.core.params"]) == ["repro"]
    assert cli.foreign_modules(["jax.numpy", "jaxlib", "flax.linen",
                                "benchmarks.db_engine"]) == [
        "benchmarks", "flax", "jax", "jaxlib"]


def test_harness_and_port_load_nothing_foreign():
    code = ("import sys; sys.path[:0] = [{src!r}, {here!r}]; "
            "from hbench import cli, cell, devtrace, spec, traffic; "
            "import repro_torch.db.serve_loop, repro_torch.db.query_serve, "
            "repro_torch.db.index, repro_torch.core.keys; "
            "print(cli.foreign_modules(sys.modules))").format(
                src=str(ROOT / "src"), here=str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def _half_the_atoms(monkeypatch):
    """The fused scan evaluates the first half of a batch's atoms and
    hands their values to the rest."""
    from repro_torch.db import executor as X
    inner = X.fused_eval

    def half(ks, table, atoms, **kw):
        h = max(1, len(atoms) // 2)
        vals = inner(ks, table, atoms[:h], **kw)
        return vals[np.arange(len(atoms)) % h]
    monkeypatch.setattr(X, "fused_eval", half)


def _scan_answer_altered(monkeypatch):
    """One row of every scan leaf's mask flipped where it is made."""
    from repro_torch.db import executor as X
    inner = X.scan_leaf_mask

    def altered(*args):
        m = inner(*args).copy()
        m[0] = ~m[0]
        return m
    monkeypatch.setattr(X, "scan_leaf_mask", altered)


def _index_answer_altered(monkeypatch):
    """The index search returns every lower bound one position late."""
    from repro_torch.db.index import SortedIndex
    inner = SortedIndex.search

    def altered(self, ks, values, strict, taus=None):
        pos = inner(self, ks, values, strict, taus)
        return np.where(np.asarray(strict), pos,
                        np.minimum(pos + 1, self.n_rows))
    monkeypatch.setattr(SortedIndex, "search", altered)


def _insert_leaves_state(monkeypatch):
    """An insert acknowledges ids but leaves the table as it was."""
    from repro_torch.db.table import Table

    def unchanged(self, ks, data, seed=0, *, samples=None):
        n = len(next(iter(data.values())))
        return self.n_total + np.arange(n, dtype=np.int64)
    monkeypatch.setattr(Table, "insert", unchanged)


@pytest.mark.parametrize("fault,workload", [
    (_half_the_atoms, "hg38-bfv.scan"),
    (_scan_answer_altered, "hg38-ckks.scan"),
    (_index_answer_altered, "hg38-bfv.ingest"),
    (_insert_leaves_state, "hg38-bfv.ingest"),
])
def test_faults_make_correct_false(fault, workload, monkeypatch):
    fault(monkeypatch)
    _, _, _, checks = run(small(Bench(ROOT)), workload)
    assert not reference.is_correct(checks)
