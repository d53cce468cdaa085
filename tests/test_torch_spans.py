"""The port's spans, request clocks and serving counters, on the CPU at TINY
size: the spans a profiled ``Engine.step`` records and how they nest, that
no span enters ``record_function`` with no profiler running, the prefill
padding counters, the request clocks, the set-up counters, the same
tokens with and without a profiler on the chunked, prefix and speculative
paths, and that a profile's kernel rows leave the spans out."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.bench.prefill_profile import kernel_rows
from deepgemm_ascend_tpu_torch.models import TINY
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.serving import Engine
from deepgemm_ascend_tpu_torch.utils import logging as dlog
from deepgemm_ascend_tpu_torch.utils.logging import metrics


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return tmodels.init_params(0, TINY, device="cpu")


def _prompt(n, mul=3, add=1):
    return [(i * mul + add) % TINY.vocab_size for i in range(n)]


def _engine(params, **kw):
    kw = {"max_slots": 2, "max_seq_len": 64, "device": "cpu", **kw}
    return Engine(params, TINY, **kw)


def _spans(prof):
    """(name, start, end) of every program span in a profile."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.split(".", 1)[0] in ("engine", "model")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_profiled_step_records_the_engine_and_model_spans(params):
    eng = _engine(params, decode_chunk=2)
    eng.scheduler.submit(_prompt(5), 4)
    eng.scheduler.submit(_prompt(20), 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "engine.step"]
    assert len(steps) == 1
    names = {s[0] for s in spans}
    assert {"engine.admit", "engine.prefill", "engine.decode", "engine.emit",
            "engine.readback", "model.attention", "model.ffn"} <= names
    assert all(_inside(s, steps[0]) for s in spans)
    prefills = [s for s in spans if s[0] == "engine.prefill"]
    assert len(prefills) == 2                     # buckets 16 and 32
    decode = [s for s in spans if s[0] == "engine.decode"]
    assert len(decode) == 1
    model = [s for s in spans if s[0].startswith("model.")]
    # 2 layers × (attention, ffn) in each prefill forward and decode step
    assert len(model) == 2 * TINY.num_layers * (2 + 2)
    assert all(any(_inside(m, p) for p in prefills + decode) for m in model)
    reads = [s for s in spans if s[0] == "engine.readback"]
    assert all(any(_inside(r, p) for p in prefills + decode) for r in reads)


def test_no_profiler_no_record_function(params, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert dlog.span("engine.step") is dlog.span("model.ffn")
    eng = _engine(params, decode_chunk=2, prefix_cache_slots=2)
    out = eng.generate([_prompt(5), _prompt(20), _prompt(40)], 5)
    assert [len(o) for o in out] == [5, 5, 5]
    spec = _engine(params, speculative_k=3)
    assert [len(o) for o in spec.generate([_prompt(6), _prompt(9)], 6)] == [6, 6]


def test_prefill_padding_counts_buckets_and_rows(params):
    eng = _engine(params)
    eng.scheduler.submit(_prompt(5), 2)
    eng.scheduler.submit(_prompt(20), 2)
    eng.step()
    # buckets 16 and 32, one row each: 48 run, 5 + 20 real
    assert eng.stats["prefill_tokens_run"] == 48
    assert eng.stats["prefill_tokens_padding"] == 23
    eng = _engine(params, max_slots=4)
    for n in (3, 5, 9):
        eng.scheduler.submit(_prompt(n), 2)
    eng.step()
    # one bucket of 16, rows padded 3 → 4: the padded row counts whole
    assert eng.stats["prefill_tokens_run"] == 64
    assert eng.stats["prefill_tokens_padding"] == 64 - 17


def test_prefill_padding_counts_the_suffix_past_a_prefix_hit(params):
    eng = _engine(params, max_slots=1, prefix_cache_slots=2)
    base = _prompt(40)
    eng.generate([base], 2)
    run0, pad0 = eng.stats["prefill_tokens_run"], eng.stats["prefill_tokens_padding"]
    eng.generate([base + [7, 8]], 2)               # hit 32, suffix 10
    assert eng.stats["prefill_tokens_run"] - run0 == 16
    assert eng.stats["prefill_tokens_padding"] - pad0 == 6


def test_request_clocks_and_their_sums(params):
    eng = _engine(params, decode_chunk=2)
    prompts = [_prompt(5), _prompt(20, 5, 2), _prompt(9, 7), _prompt(33)]
    ids = [eng.scheduler.submit(p, 3) for p in prompts]
    while eng.scheduler.has_work:
        eng.step()
    reqs = [eng.scheduler.pop_result(i) for i in ids]
    for r in reqs:
        assert r.submit_t <= r.admit_t <= r.first_token_t
    assert eng.stats["admitted"] == len(prompts)
    assert eng.stats["queue_wait_s"] == pytest.approx(
        sum(r.admit_t - r.submit_t for r in reqs), rel=1e-9, abs=1e-12)
    assert eng.stats["first_token_wait_s"] == pytest.approx(
        sum(r.first_token_t - r.admit_t for r in reqs), rel=1e-9, abs=1e-12)
    # two slots: the last two waited for the first two to finish
    assert min(r.admit_t for r in reqs[2:]) > max(r.first_token_t for r in reqs[:2])


@pytest.mark.parametrize("kw", [{"decode_chunk": 4}, {"prefix_cache_slots": 2},
                                {"speculative_k": 3}],
                         ids=["chunked", "prefix", "speculative"])
def test_profiled_paths_serve_the_same_tokens(params, kw):
    prompts = [_prompt(40), _prompt(40)[:34] + [5, 6], _prompt(7, 11)]
    want = _engine(params, **kw).generate(prompts, 6)
    eng = _engine(params, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = eng.generate(prompts, 6)
    assert got == want
    names = {s[0] for s in _spans(prof)}
    assert {"engine.step", "engine.prefill", "engine.decode", "engine.emit"} <= names
    if "prefix_cache_slots" in kw:
        assert "engine.prefix_insert" in names


def test_removed_counters_are_gone(params):
    metrics.reset()
    _engine(params, decode_chunk=2).generate([_prompt(5), _prompt(20)], 4)
    snap = metrics.snapshot()
    assert snap["engine.prefill_dispatches"] == 2
    assert not {"engine.tokens_out", "engine.prefills", "engine.active_slots",
                "uptime_s"} & set(snap)


def test_load_params_counts_its_seconds(params):
    from deepgemm_ascend_tpu_torch.models.loader import load_params
    cfg = TINY
    gen = torch.Generator().manual_seed(0)
    state = {}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        h, q, kv = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        shapes = {"self_attn.q_proj.weight": (q, h), "self_attn.k_proj.weight": (kv, h),
                  "self_attn.v_proj.weight": (kv, h), "self_attn.o_proj.weight": (h, q),
                  "input_layernorm.weight": (h,), "post_attention_layernorm.weight": (h,)}
        if i < cfg.first_dense_layers:
            d = cfg.dense_intermediate
            shapes.update({"mlp.gate_proj.weight": (d, h), "mlp.up_proj.weight": (d, h),
                           "mlp.down_proj.weight": (h, d)})
        else:
            m = cfg.moe_intermediate
            shapes["mlp.gate.weight"] = (cfg.num_experts, h)
            for j in range(cfg.num_experts):
                e = f"mlp.experts.{j}."
                shapes.update({e + "gate_proj.weight": (m, h), e + "up_proj.weight": (m, h),
                               e + "down_proj.weight": (h, m)})
            s = "mlp.shared_experts."
            shapes.update({s + "gate_proj.weight": (m, h), s + "up_proj.weight": (m, h),
                           s + "down_proj.weight": (h, m)})
        state.update({p + k: torch.randn(v, generator=gen) * 0.02
                      for k, v in shapes.items()})
    state.update({"model.embed_tokens.weight": torch.randn(cfg.vocab_size, cfg.hidden_size),
                  "model.norm.weight": torch.ones(cfg.hidden_size),
                  "lm_head.weight": torch.randn(cfg.vocab_size, cfg.hidden_size)})
    metrics.reset()
    load_params(state, cfg, device="cpu")
    assert metrics.snapshot()["setup.load_params_s"] > 0


def test_kernel_libraries_count_their_seconds(monkeypatch):
    libs = _kernels._Libraries()
    monkeypatch.setattr(libs, "_build_all", lambda out: {"k": lambda: 0})
    metrics.reset()
    assert libs.get() == libs.get()
    snap = metrics.snapshot()
    assert snap["setup.kernel_libraries_s"] >= 0 and "setup.kernel_libraries_s" in snap
    libs.get()                                    # loaded: no time added
    assert metrics.snapshot()["setup.kernel_libraries_s"] == snap["setup.kernel_libraries_s"]


def test_kernel_rows_leave_a_profiled_span_out(params):
    eng = _engine(params, decode_chunk=2)
    eng.scheduler.submit(_prompt(5), 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    avgs = {e.key: e for e in prof.key_averages()}
    assert avgs["model.ffn"].is_user_annotation
    assert not avgs["aten::mm"].is_user_annotation
    assert kernel_rows(prof) == []                # no device on the CPU


def test_kernel_rows_take_kernels_and_not_span_ranges():
    from torch.autograd import DeviceType

    def row(key, ms, count, device=DeviceType.CUDA, span=False):
        return types.SimpleNamespace(key=key, self_device_time_total=ms * 1e3, count=count,
                                     device_type=device, is_user_annotation=span)

    # A span's device row, under a CUDA-activity profiler, covers the
    # kernels launched inside it.
    prof = types.SimpleNamespace(key_averages=lambda: [
        row("model.ffn", 3.0, 2, span=True), row("ring_kernel", 2.0, 4),
        row("aten::mm", 0.0, 4), row("live_kernel", 0.5, 2),
        row("aten::add", 1.0, 1, device=DeviceType.CPU)])
    assert kernel_rows(prof) == [("ring_kernel", 2.0, 4), ("live_kernel", 0.5, 2)]
