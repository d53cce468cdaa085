"""A benchmark root at test size: the real kinds and metric readers, and
tiny configurations, mixes and cells, under a temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"

CELLS = {
    "tiny_moe.decode": ("tiny_moe", "tiny_decode", {"max_slots": 4}),
    "tiny_dense.rag": ("tiny_dense", "tiny_rag", {"max_slots": 4}),
    "tiny_moe.sessions": ("tiny_moe", "tiny_sessions",
                          {"max_slots": 4, "prefix_cache_slots": 4}),
}
# Set from CPU readings of these cells (3 s windows), seeds 11-13 and
# 2**31 + 17: the worst request's mean gap of sound runs 0.0010-0.0035, of
# the int4 control 0.178-0.268; the samples compared 641-1056 served tokens.
LIMITS = {"worst_request_mean_logit_gap": 0.03, "served_compared_min": 16}
# Readers that no cell of BENCHMARK.json reports yet, each given to the
# tiny cells that have something for it to read.
EXTRA_PER_LAYER = [
    {"name": "serving.prefix_reuse_share", "unit": "%", "better": "higher",
     "source": "program_counter", "layer": "serving", "moves": "output_tok_s"},
    {"name": "kernels.expert_gemm_roofline", "unit": "%", "better": "higher",
     "source": "device_trace", "layer": "kernels", "moves": "output_tok_s"},
]


def make_root(tmp: Path, limits=None) -> Path:
    """A root holding BENCHMARK.json for the tiny cells (the real one's
    metrics, each reported where the cell has its end-to-end metric)."""
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    for sub in ("kinds", "metrics"):
        shutil.copytree(BENCH / sub, b / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (b / "configs").mkdir()
    (b / "traffic").mkdir()
    (b / "cells").mkdir()
    configs = {}
    for name, (conf, mix, settings) in CELLS.items():
        shutil.copy(DATA / f"{conf}.json", b / "configs" / f"{conf}.json")
        shutil.copy(DATA / f"{mix}.json", b / "traffic" / f"{mix}.json")
        (b / "cells" / f"{name}.json").write_text(json.dumps(
            {**settings, "limits": dict(limits or LIMITS)}))
        configs[conf] = {"name": conf, "source": "test", "file": f"benchmark/configs/{conf}.json",
                         "reduced": [], "why": "test"}
    workloads = [{"name": n, "config": c, "traffic": m, "chips": 1, "why": "test"}
                 for n, (c, m, _) in CELLS.items()]
    e2e = [dict(m, workloads=list(CELLS)) for m in real["end_to_end"]]
    per_layer = [dict(m, workloads=list(CELLS))
                 for m in real["per_layer"] + EXTRA_PER_LAYER]
    bench = dict(real, configs=list(configs.values()), workloads=workloads,
                 end_to_end=e2e, per_layer=per_layer)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
