"""The idle time put under the program's spans (``benchmark/spans.py``) on
a synthetic chrome trace and on a profiled step of the port at TINY size;
the readers of the engine's new counters, alone and in a traced tiny
cell."""

import json
import types

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import registry, run, spans, trace
from benchmark.tests.tiny import make_root


def _x(name, ts, dur, cat, **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if args:
        e["args"] = args
    return e


BASE = [
    _x(trace.STRETCH, 0.0, 100.0, "user_annotation"),
    _x("bench.step.admit", 0.0, 70.0, "user_annotation"),
    _x("ring_kernel", 10.0, 10.0, "kernel", grid=[4, 1, 1]),
    _x("ring_kernel", 30.0, 20.0, "kernel", grid=[4, 1, 1]),
    _x("live_kernel", 45.0, 15.0, "kernel", grid=[8, 1, 1]),
    _x("Memcpy DtoH", 80.0, 5.0, "gpu_memcpy"),
    _x("aten::mm", 21.0, 3.0, "cpu_op"),
]
PROGRAM = [
    _x("engine.step", 5.0, 60.0, "user_annotation"),
    _x("engine.prefill", 8.0, 32.0, "user_annotation"),
    _x("model.ffn", 22.0, 6.0, "user_annotation"),
    _x("engine.decode", 40.0, 24.0, "user_annotation"),
    _x("engine.readback", 50.0, 14.0, "user_annotation"),
]


def test_summarize_is_unmoved_by_the_program_spans():
    plain, spanned = trace.summarize(BASE), trace.summarize(BASE + PROGRAM)
    assert plain == spanned
    assert spanned["window_s"] == pytest.approx(100e-6)
    assert spanned["busy_s"] == pytest.approx(45e-6)
    assert spanned["device_ops"] == [["ring_kernel", pytest.approx(30e-6)],
                                     ["live_kernel", pytest.approx(15e-6)]]
    # a gap no program span covers keeps its label
    labels = dict((round(s * 1e6), n) for n, s in spans.labelled_gaps(BASE + PROGRAM))
    assert labels[15] == "between steps: python"
    assert dict((round(s * 1e6), n) for n, s in spanned["idle_gaps"])[15] == labels[15]


def test_idle_by_span_sums_to_the_idle_time_under_the_innermost_path():
    by = spans.idle_by_span(BASE + PROGRAM)
    want = {spans.NO_SPAN: 35, "engine.step": 4, "engine.step>engine.prefill": 6,
            "engine.step>engine.prefill>model.ffn": 6,
            "engine.step>engine.decode>engine.readback": 4}
    assert {k: round(v * 1e6, 6) for k, v in by.items()} == want
    st = trace.summarize(BASE + PROGRAM)
    assert sum(by.values()) == pytest.approx(st["window_s"] - st["busy_s"])
    assert spans.prefill_idle_share(by, st["window_s"]) == pytest.approx(12.0)
    assert spans.idle_by_span(BASE) == {spans.NO_SPAN: pytest.approx(55e-6)}


def test_gap_labels_name_the_innermost_program_span():
    # the gaps by size: [60, 80], [85, 100], [0, 10], [20, 30], each
    # labelled at its middle (25 lies in model.ffn, past aten::mm)
    assert [n for n, _ in spans.labelled_gaps(BASE + PROGRAM)] == [
        "bench.step.admit: python", "between steps: python",
        "bench.step.admit > engine.step: python",
        "bench.step.admit > model.ffn: python"]


def test_spans_closed_out_of_order_and_clipped_to_the_stretch():
    evs = [_x(trace.STRETCH, 10.0, 20.0, "user_annotation"),
           _x("engine.step", 0.0, 25.0, "user_annotation"),
           _x("engine.emit", 20.0, 15.0, "user_annotation")]
    by = {k: round(v * 1e6, 6) for k, v in spans.idle_by_span(evs).items()}
    assert by == {"engine.step": 10, "engine.step>engine.emit": 10}


def test_a_profiled_engine_step_is_put_under_its_spans(tmp_path):
    from deepgemm_ascend_tpu_torch import models
    from deepgemm_ascend_tpu_torch.serving import Engine
    params = models.init_params(0, models.TINY, device="cpu")
    eng = Engine(params, models.TINY, max_slots=2, max_seq_len=64, decode_chunk=2,
                 device="cpu")
    eng.scheduler.submit(list(range(1, 6)), 3)
    eng.scheduler.submit(list(range(1, 21)), 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.STRETCH):
            eng.step()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    by = spans.idle_by_span(events)
    st = trace.summarize(events)
    assert sum(by.values()) == pytest.approx(st["window_s"] - st["busy_s"], rel=1e-6)
    for p in ("engine.step>engine.admit", "engine.step>engine.prefill>model.attention",
              "engine.step>engine.prefill>model.ffn", "engine.step>engine.decode>model.ffn",
              "engine.step>engine.emit"):
        assert p in by, sorted(by)
    assert 0 < spans.prefill_idle_share(by, st["window_s"]) < 100


def _ctx(**counters):
    return types.SimpleNamespace(counters={f"stats.{k}": float(v) for k, v in counters.items()})


@pytest.mark.parametrize("name,counters,want", [
    ("serving.prefill_padding_share", dict(prefill_tokens_run=48, prefill_tokens_padding=23),
     100 * 23 / 48),
    ("serving.queue_wait_ms", dict(admitted=4, queue_wait_s=0.01), 2.5),
    ("serving.first_token_wait_ms", dict(admitted=4, first_token_wait_s=1.0), 250.0),
])
def test_readers_of_the_engine_counters(name, counters, want):
    from pathlib import Path
    cell = registry.Cell(name, {}, {}, {}, {}, [], [], Path(spans.__file__).parents[1])
    read = cell.reader(name)
    assert read(_ctx(**counters)) == pytest.approx(want)
    # a program without these counters: nothing to read, no error
    assert read(_ctx(prefill_tokens=10, decode_steps=3)) is None


def test_setup_program_s_sums_its_parts():
    c = {"metrics.setup.load_params_s": 1.5, "metrics.setup.kernel_libraries_s": 0.5,
         "stats.prefill_time_s": 2.0, "stats.decode_time_s": 3.0,
         "stats.graph_capture_s": 0.25, "stats.decode_steps": 99.0}
    # the libraries load inside the first prefill: not counted twice
    assert spans.setup_program_s(c) == pytest.approx(6.75)
    assert spans.setup_program_s({}) == 0.0


def test_a_traced_tiny_cell_reports_the_engine_counters(tmp_path):
    lines = []
    rc = run.run(["--workload", "tiny_moe.decode", "--seed", str(2 ** 31 + 5),
                  "--seconds", "2", "--trace", "1"], root=make_root(tmp_path),
                 device="cpu", emit=lines.append)
    assert rc == 0
    got = json.loads(lines[-1])["metrics"]
    assert 0 < got["serving.prefill_padding_share"]["value"] < 100
    assert got["serving.first_token_wait_ms"]["value"] > 0
