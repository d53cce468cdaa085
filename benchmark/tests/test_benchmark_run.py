"""Whole runs of tiny cells on the CPU: the result line, the isolation from
JAX, and `correct` coming out false for the control and for each fault the
served path can have."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import faults, run
from benchmark.tests.tiny import make_root

REPO = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(root, cell, seed=5, trace=0, judge_fn=None):
    lines = []
    rc = run.run(["--workload", cell, "--seed", str(seed), "--seconds", "3",
                  "--trace", str(trace)], root=root, device="cpu", judge_fn=judge_fn,
                 emit=lines.append)
    assert rc == 0
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny_moe.decode", "tiny_dense.rag", "tiny_moe.sessions"])
def test_result_line_holds_the_contract_keys(root, cell):
    out = _run(root, cell, seed=2 ** 31 + 17)
    assert set(out) == KEYS | {"checks"} and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(out["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    gap = [k for k in out["checks"] if k.endswith("_logit_gap")]
    assert len(gap) == 1 and set(out["checks"][gap[0]]) == {"value", "limit"}


def test_traced_line_holds_the_per_layer_metrics(root):
    out = _run(root, "tiny_moe.sessions", trace=1)
    assert list(out)[-1] == "checks" and "breakdown" in out
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert {"serving.prefill_share", "serving.prefix_reuse_share",
            "model.decode_step_ms", "model.mfu"} <= set(out["metrics"])
    assert out["metrics"]["serving.prefix_reuse_share"]["value"] > 0


def test_no_jax_in_a_run_and_no_port_in_the_reference(tmp_path):
    root = make_root(tmp_path)
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from benchmark import run
rc = run.run(["--workload", "tiny_moe.decode", "--seed", "3", "--seconds", "1"],
             root={str(root)!r}, device="cpu", emit=lambda line: None)
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    top = json.loads(out.stdout.split("TOP", 1)[1].strip().replace("'", '"'))
    assert "deepgemm_ascend_tpu_torch" in top
    assert not {"jax", "jaxlib", "flax", "deepgemm_ascend_tpu"} & set(top)
    code = f"""
import sys, json
sys.path.insert(0, {str(REPO)!r})
from benchmark.reference.model import Reference
from benchmark import check
hf = json.load(open({str(root / "benchmark/configs/tiny_moe.json")!r}))
Reference(hf, 1, "cpu").logits([[1, 2, 3, 4]], [[3]])
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.split("TOP", 1)[1].strip().replace("'", '"')))
    assert not {"jax", "jaxlib", "flax", "deepgemm_ascend_tpu",
                "deepgemm_ascend_tpu_torch"} & top


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepgemm_ascend_tpu_torch_x", sys)
    assert "deepgemm_ascend_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def test_a_run_refuses_without_a_card(root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.run(["--workload", "tiny_moe.decode", "--seed", "1", "--seconds", "1"],
                 root=root)
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["tiny_moe.decode", "tiny_dense.rag"])
def test_the_control_fails_the_limit(root, cell):
    """The reference in int4, in the program's place: at every served
    position the token it puts first, judged by the stated reference."""
    assert _run(root, cell, seed=31, judge_fn=faults.control_judge)["correct"] is False


@pytest.mark.parametrize("cell", ["tiny_moe.decode", "tiny_dense.rag"])
@pytest.mark.parametrize("fault", sorted(faults.PLANTS))
def test_a_broken_served_path_is_not_correct(root, fault, cell):
    undo = faults.PLANTS[fault]()
    try:
        assert _run(root, cell, seed=41)["correct"] is False
    finally:
        undo()
