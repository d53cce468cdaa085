"""benchmark/work.py against counts made by hand from the published shapes."""

import json
from pathlib import Path

import pytest

from benchmark import work
from benchmark.weights import Shapes

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
DATA = Path(__file__).resolve().parent / "data"


def _shapes(name):
    """A configuration of BENCHMARK.json's, else the tests' copy of a
    published one (DeepSeekMoE-16B, whose cells are left out)."""
    path = CONFIGS / f"{name}.json"
    return Shapes(json.loads((path if path.is_file() else DATA / f"{name}.json").read_text()))


def test_dsmoe16b_operations_per_token():
    s = _shapes("dsmoe16b")
    attn = 4 * 2048 * 2048                              # q, k, v, o: 16 heads of 128
    dense = 3 * 2048 * 10944                            # layer 0
    moe = 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816 + 2048 * 64   # top-6, shared, router
    params = 28 * attn + dense + 27 * moe + 2048 * 102400
    assert work.linear_ops_per_token(s) == 2 * params
    # attention of one token over 1000 keys: scores and values, 28 layers
    assert work.attention_ops(s, 1000) == 4 * 28 * 16 * 128 * 1000


def test_mistral7b_operations_per_token():
    s = _shapes("mistral7b")
    attn = 4096 * 4096 * 2 + 2 * 4096 * 1024           # q, o and the 8-head k, v
    params = 32 * (attn + 3 * 4096 * 14336) + 4096 * 32768
    assert work.linear_ops_per_token(s) == 2 * params
    assert abs(params + 32768 * 4096 - 7.25e9) < 0.01e9  # 7.25 B with the embedding


def test_prefill_span_counts_each_position_once():
    s = _shapes("mistral7b")
    per, head = work.linear_ops_per_token(s), 2 * 4096 * 32768
    got = work.model_ops(s, [(16, 20)], [])
    attn = sum(work.attention_ops(s, p + 1) for p in range(16, 20))
    assert got == pytest.approx(4 * (per - head) + head + attn, rel=1e-12)
    assert work.model_ops(s, [], [5, 9]) == pytest.approx(
        2 * per + work.attention_ops(s, 6) + work.attention_ops(s, 10), rel=1e-12)


def test_expert_gemm_bound_by_hand():
    s = _shapes("dsmoe16b")
    # 64 decode tokens: 384 rows reach all 64 experts; weights dominate.
    w1 = 64 * (2816 * 2048 + 22 * 16 * 4)
    w2 = 64 * (2048 * 1408 + 16 * 11 * 4)
    a1 = 384 * (2048 + 16 * 4) + 384 * 2816 * 2
    a2 = 384 * (1408 + 11 * 4) + 384 * 2048 * 2
    t = 27 * ((w1 + a1) + (w2 + a2)) / 3.35e12
    assert work.expert_gemm_bound_s(s, 64) == pytest.approx(t, rel=1e-12)
    # one token reaches its 6 experts only
    assert work.expert_gemm_bound_s(s, 1) < work.expert_gemm_bound_s(s, 64) / 8


def test_dense_gemm_bound_by_hand():
    s = _shapes("mistral7b")
    t = 0.0
    for n, k in [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096),
                 (28672, 4096), (4096, 14336)]:
        nbytes = n * k + (n // 128) * (k // 128) * 4 + 128 * (k + k // 128 * 4) + 128 * n * 2
        t += max(nbytes / 3.35e12, 2 * 128 * n * k / 1979e12)
    assert work.dense_gemm_bound_s(s, 128) == pytest.approx(32 * t, rel=1e-12)


def test_peaks_are_the_data_sheets():
    assert (work.HBM_BYTES_PER_S, work.FP8_OPS_PER_S, work.BF16_OPS_PER_S) == (
        3.35e12, 1979e12, 989e12)
    assert work.bound_s(3.35e12, 1.0, 1e12) == (1.0, "bytes")
