"""The port's HADES examples and trace smoke (`repro_torch.examples`,
`repro_torch.tools.trace_smoke`), each run at small rows with `--device
cpu`.  Every example checks its answers against the plaintext and raises
on a wrong one; each test also reads the checks it returns.  Without a
card each entry point's default device (CUDA) raises.
"""
import pytest
import torch

from repro_torch import obs
from repro_torch.examples import check
from repro_torch.examples import encrypted_range_query as ERQ
from repro_torch.examples import part6_observability as P6
from repro_torch.examples import quickstart as QS
from repro_torch.examples import secure_topk_serving as STS
from repro_torch.tools import trace_smoke as TS

from torch_fixtures import (  # noqa: F401  (fixtures, used by name)
    _clear_reference_spans, _one_torch_thread, _time_limit,
    _unoptimized_reference_compiles)

CPU = ["--device", "cpu"]


def _all_true(tree):
    if isinstance(tree, dict):
        return all(_all_true(v) for v in tree.values())
    return tree is True


def test_quickstart():
    out = QS.main(CPU)
    assert out["roundtrip"] and out["compare"] and out["paper_compare"]
    assert set(out["fae_flips"]) <= {0, 1}


def test_encrypted_range_query_small_rows():
    """Parts 1-5 at small sizes; every part's checks hold."""
    out = ERQ.main(CPU + ["--rows", "256", "--index-rows", "128",
                          "--ckks-rows", "64", "--shard-rows", "256",
                          "--join-rows", "64"])
    assert set(out) == {f"part{i}" for i in range(1, 6)}
    assert _all_true(out), out


def test_part6_observability(tmp_path):
    out = P6.main(CPU + ["--rows", "128",
                         "--trace-out", str(tmp_path / "t.json")])
    assert _all_true(out), out
    assert (tmp_path / "t.json").exists()


def test_secure_topk_serving():
    out = STS.main(CPU)
    assert out["topk_ok"] is True and len(out["picked"]) == 4


def test_trace_smoke_passes_and_reports_failures(tmp_path, monkeypatch):
    """The smoke passes on the port; with the trace validator reporting
    an error it returns 1 and names it."""
    out = str(tmp_path / "trace.json")
    assert TS.main(CPU + ["--out", out]) == 0
    res = TS.run(CPU + ["--out", out])
    assert res["errors"] == [] and res["events"] > 0
    monkeypatch.setattr(obs, "validate_chrome_trace",
                        lambda doc: ["planted error"])
    res = TS.run(CPU + ["--out", out])
    assert res["errors"] == ["planted error"]
    assert TS.main(CPU + ["--out", out]) == 1


def test_check_raises_on_a_wrong_answer():
    assert check(True, "fine")
    with pytest.raises(RuntimeError, match="wrong answer: x"):
        check(False, "x")


@pytest.mark.parametrize("entry", [QS.main, ERQ.main, P6.main, STS.main,
                                   TS.main],
                         ids=["quickstart", "range_query", "part6",
                              "secure_topk", "trace_smoke"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry([])
