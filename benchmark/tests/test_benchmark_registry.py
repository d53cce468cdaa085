"""BENCHMARK.json against the contract, and the harness finding every part
by name, a dummy one added from a temporary directory included."""

import json
import re
from pathlib import Path

import pytest

from benchmark import registry, run
from benchmark.tests.tiny import make_root

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_parts(cell):
    c = registry.load(ROOT, cell)
    assert c.kind().Source
    assert c.config["name"] == c.entry["config"]
    assert {"max_slots", "limits"} <= set(c.settings)
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for m in c.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_name_their_source_and_changes(conf):
    f = json.loads((ROOT / conf["file"]).read_text())
    assert f["source"] == conf["source"] and f["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert key in f.get("published", {}), key


def test_a_new_config_mix_kind_and_metric_need_only_new_files(tmp_path):
    root = make_root(tmp_path)
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "tiny_dense.json").read_text())
    conf.update(name="tiny_other", num_hidden_layers=1)
    (b / "configs" / "tiny_other.json").write_text(json.dumps(conf))
    (b / "traffic" / "steady.json").write_text(json.dumps(
        {"kind": "steady", "prompt": 20, "output": 6, "clients": 2}))
    (b / "kinds" / "steady.py").write_text('''
from benchmark.kinds.closed_loop import Source as _Closed
from benchmark.kinds.common import Req

class Source(_Closed):
    def __init__(self, mix, *, seed, vocab, slots, max_seq_len):
        self.mix, self.clients, self.rid = mix, mix["clients"], 0
        self.admit_batch = 2
    def _new(self, client, due, max_new=None):
        self.rid += 1
        return Req(self.rid - 1, client, [1 + (self.rid % 7)] * self.mix["prompt"],
                   self.mix["output"], due=due)
    def setup_requests(self):
        return [self._new(c, None) for c in range(self.clients)]
    def prompt_lengths(self):
        return [self.mix["prompt"]]
''')
    (b / "metrics" / "dummy.tokens.py").write_text(
        "def read(ctx):\n    return float(len(ctx.decode_positions))\n")
    (b / "cells" / "tiny_other.steady.json").write_text(json.dumps(
        {"max_slots": 2, "limits": {"worst_request_mean_logit_gap": 0.03,
                                     "served_compared_min": 16}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_other", "source": "test", "reduced": [],
                             "file": "benchmark/configs/tiny_other.json", "why": "test"})
    bench["workloads"].append({"name": "tiny_other.steady", "config": "tiny_other",
                               "traffic": "steady", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        m["workloads"].append("tiny_other.steady")
    bench["per_layer"] = [{"name": "dummy.tokens", "unit": "tokens", "better": "higher",
                           "source": "program_counter", "layer": "serving",
                           "moves": "output_tok_s"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.load(root, "tiny_other.steady")
    assert cell.config["num_hidden_layers"] == 1 and cell.traffic["kind"] == "steady"
    lines = []
    rc = run.run(["--workload", "tiny_other.steady", "--seed", "9", "--seconds", "1",
                  "--trace", "1"], root=root, device="cpu", emit=lines.append)
    assert rc == 0
    out = json.loads(lines[-1])
    assert out["metrics"]["dummy.tokens"]["value"] > 0
