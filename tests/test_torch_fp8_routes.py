"""The CPU-side pieces of K1's and K3's routes: which route the stored
operands take, the ring's tile and group splits, and that a CPU tensor
still runs only the plain version, held against the JAX op.

``route`` (K1: ``ops.fp8_gemm.route``, K3: ``ops.grouped_gemm.route``) is
decided on the stored operands — on CPU tensors as on the card, though the
CPU runs the plain version whatever it says. ``ring_plan`` is a pure
function of the shape and the card's SM count: the expected plans below
are those of an H100 SXM (132 SMs) at V2_LITE's projection shapes.
Tolerances against JAX (its Pallas kernel in interpret mode) as in
``test_torch_fp8_gemm.py``: f32 outputs within the outlier gate, bf16 ones
within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu.ops import fp8_gemm as jf
from deepgemm_ascend_tpu.ops import grouped_gemm as jg
from deepgemm_ascend_tpu.ops import quant as jq
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.models import moe as tm
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as tf
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as tg
from deepgemm_ascend_tpu_torch.tiling import analytic
from torch_bridge import (bf16_within_one_ulp, f32_close, to_numpy, to_torch,
                          tree_of)

LITE_GEMMS = [(2048, 2048), (512, 2048), (22016, 2048), (2048, 11008),
              (2816, 2048), (2048, 1408)]


def _fp8(shape, offset=0):
    """e4m3 bytes of ``shape``, ``offset`` bytes into their storage."""
    n = int(np.prod(shape))
    g = torch.Generator().manual_seed(n)
    raw = torch.randint(0, 120, (n + offset,), generator=g,
                        dtype=torch.uint8)
    return raw[offset:].view(torch.float8_e4m3fn).view(*shape)


# ---- route


@pytest.mark.parametrize("case,want", [
    ("t aligned", "ring"),
    ("n", "tile"),
    ("t a off 16 bytes", "tile"),
    ("t b off 16 bytes", "tile"),
    ("t a off 8 bytes", "tile"),
    ("t a off 32 bytes", "ring"),
])
def test_fp8_route(case, want):
    """The ring takes B stored K-major ('t') with 16-byte-aligned pointers;
    B stored (k, n) and an operand off 16 bytes stay on the tile route."""
    m, n, k = 16, 256, 512
    offset = {"t a off 16 bytes": 1, "t a off 8 bytes": 8,
              "t a off 32 bytes": 32}.get(case, 0)
    a = _fp8((m, k), offset)
    b = _fp8((k, n) if case == "n" else (n, k),
             1 if case == "t b off 16 bytes" else 0)
    assert tf.route(a, b, "n" if case == "n" else "t") == want


@pytest.mark.parametrize("case,want", [
    ("t aligned", "ring"),
    ("n", "tile"),
    ("t a off 16 bytes", "tile"),
    ("t b off 16 bytes", "tile"),
])
def test_grouped_route(case, want):
    e, m_max, n, k = 4, 96, 256, 384
    a = _fp8((e, m_max, k), 1 if case == "t a off 16 bytes" else 0)
    b = _fp8((e, k, n) if case == "n" else (e, n, k),
             4 if case == "t b off 16 bytes" else 0)
    assert tg.route(a, b, "n" if case == "n" else "t") == want


@pytest.mark.parametrize("module", [tf, tg])
def test_route_rejects_an_unknown_layout(module):
    a, b = _fp8((16, 128)), _fp8((128, 128))
    with pytest.raises(ValueError, match="b_layout"):
        module.route(a, b, "x")


# ---- the ring's tiles and splits


# V2_LITE's projections at decode (16 slots), at the scripts' batch (64)
# and at prefill (2048): (tile index, splits) on 132 SMs.
EXPECTED_PLANS = {
    16: [(0, 4), (0, 8), (0, 1), (0, 8), (0, 3), (0, 4)],
    64: [(1, 4), (1, 8), (1, 1), (1, 8), (1, 3), (1, 4)],
    2048: [(1, 1)] * 6,
}


@pytest.mark.parametrize("m", sorted(EXPECTED_PLANS))
@pytest.mark.parametrize("i", range(len(LITE_GEMMS)))
def test_ring_plan_at_model_shapes(m, i):
    """The plan at each projection shape, and what it must hold: split
    only where the tiles fill less than half the card, never beyond a
    cluster, fill at most the card unless a split would run more than
    MAX_SPLIT_GROUPS groups, and leave every split at least two groups
    (none empty)."""
    n, k = LITE_GEMMS[i]
    tile, splits = tf.ring_plan(m, n, k, sms=132)
    assert (tile, splits) == EXPECTED_PLANS[m][i]
    bm, bn = tf.RING_TILES[tile]
    tiles = -(-m // bm) * (n // bn)
    groups = k // 128
    assert 1 <= splits <= tf.MAX_SPLITS
    if splits > 1:
        per = -(-groups // splits)
        assert 2 * tiles <= 132
        assert tiles * splits <= 132 or per >= tf.MAX_SPLIT_GROUPS - 1
        assert per >= tf.MIN_SPLIT_GROUPS and (splits - 1) * per < groups


@pytest.mark.parametrize("m,want", [(1, 0), (16, 0), (17, 1), (64, 1),
                                    (100, 1), (2048, 1), (4096, 1)])
def test_ring_tile_by_m(m, want):
    """16 rows up to m = 16, 64 rows beyond."""
    assert tf.ring_tile(m) == want


def test_ring_splits_follow_the_card():
    """The same shape splits less on a card with fewer SMs, not at all
    where its tiles already fill half of them, and a deep K more than one
    CTA an SM would give."""
    assert tf.ring_splits(16, 2048, 2048, 0, sms=132) == 4
    assert tf.ring_splits(16, 2048, 2048, 0, sms=64) == 2
    assert tf.ring_splits(16, 2048, 2048, 0, sms=60) == 1
    assert tf.ring_splits(16, 512, 2048, 0, sms=40) == 5
    assert tf.ring_splits(16, 512, 256, 0, sms=132) == 1   # two groups
    assert tf.ring_splits(16, 2048, 11008, 0, sms=132) == 8
    assert tf.ring_splits(16, 2048, 11008, 0, sms=64) == 8


@pytest.mark.parametrize("m_max,expected_m,want", [
    (16, None, 0), (17, None, 1), (96, None, 1), (128, None, 1),
    (96, 3, 0), (192, 6, 0), (384, 12, 0), (384, 16, 0), (384, 17, 1),
    (768, 24, 1), (12288, 384, 1), (16, 400, 0), (96, 200, 1)])
def test_grouped_ring_tile_by_rows(m_max, expected_m, want):
    """16-row tiles where an expert is expected to hold at most SMALL_ROWS
    rows: the hint where there is one (never above M_max), else M_max —
    the MoE layer's hints at 16, 32 and 64 tokens (top-6 over 32 experts)
    alike; 128 tokens, and the probe's 128 rows, all valid, on 64-row
    tiles."""
    assert analytic.masked_ring_tile(m_max, expected_m) == want


@pytest.mark.parametrize("plan,want", [
    (("tile", 0, 1), "tile"), (("ring", 0, 1), "ring 16x64"),
    (("ring", 1, 1), "ring 64x64"), (("ring", 0, 4), "ring 16x64/4")])
def test_plan_labels(plan, want):
    assert tf.plan_label(*plan) == want


def test_counter_counts_plans_and_resets():
    c = _kernels.Counter("x")
    for label in ("ring 16x64", "tile", "ring 16x64"):
        c.count_plan(label)
    assert c.plans == {"ring 16x64": 2, "tile": 1}
    c.reset()
    assert c.plans == {}


def test_moe_layer_hints_the_mean_rows_an_expert(monkeypatch):
    """The fp8 MoE layer passes K3 ceil(T·top_k / E) as ``expected_m``
    (the whole layer's experts, on a shard too); the result is unchanged."""
    cfg = jmodels.TINY
    tp = tmodels.params_from_numpy(
        tree_of(jmodels.init_params(jax.random.PRNGKey(0), cfg)), cfg,
        device="cpu")
    ffn = tp.layers[1].ffn
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(40, cfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    want = tm.moe_block(ffn, x, cfg)
    seen = []
    real = tg.m_grouped_gemm_masked

    def spy(*args, **kw):
        seen.append(kw.get("expected_m"))
        return real(*args, **kw)

    monkeypatch.setattr(tg, "m_grouped_gemm_masked", spy)
    got = tm.moe_block(ffn, x, cfg)
    assert seen == [-(-40 * cfg.top_k // cfg.num_experts)] * 2
    assert torch.equal(got, want)


# ---- CPU tensors: the plain version only, against JAX


def _jax_operands(m, n, k, b_t, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_t(df=4, size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(n, k) if b_t else (k, n)) / k ** 0.5).astype(
        np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    return a_q, a_s, b_q, b_s


@pytest.mark.parametrize("b_layout", ["t", "n"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_fp8_gemm_on_the_cpu_runs_the_plain_version(b_layout, out):
    """Whichever route the operands would take on the card, a CPU tensor
    runs K1's plain version once and launches nothing; it agrees with the
    JAX op (split shape: m = 16, n = 256 would split on the card)."""
    jd, td = ((jnp.float32, torch.float32) if out == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    m, n, k = 16, 256, 512
    a_q, a_s, b_q, b_s = _jax_operands(m, n, k, b_layout == "t", seed=3)
    ta, tb = to_torch(a_q), to_torch(b_q)
    assert tf.route(ta, tb, b_layout) == ("ring" if b_layout == "t"
                                          else "tile")
    assert tf.ring_plan(m, n, k)[1] > 1
    c = _kernels.COUNTERS["fp8_gemm"]
    plain, launches = c.plain_calls, c.launches
    got = to_numpy(tf.fp8_gemm(ta, to_torch(a_s), tb, to_torch(b_s),
                               out_dtype=td, b_layout=b_layout))
    assert (c.plain_calls - plain, c.launches - launches) == (1, 0)
    want = np.asarray(jf.fp8_gemm(a_q, a_s, b_q, b_s, out_dtype=jd,
                                  b_layout=b_layout), np.float32)
    if out == "f32":
        res = f32_close(got, want)
        assert res.ok, res
    else:
        assert bf16_within_one_ulp(got, want)


@pytest.mark.parametrize("b_layout", ["t", "n"])
def test_grouped_masked_on_the_cpu_runs_the_plain_version(b_layout):
    """K3 on CPU tensors: the plain version once, no launch, the JAX op's
    valid rows, and zeros from masked_m[e] on."""
    e, m_max, n, k = 4, 32, 256, 256
    b_t = b_layout == "t"
    rng = np.random.default_rng(4)
    a = rng.normal(size=(e, m_max, k)).astype(np.float32)
    w = (rng.normal(size=(e, n, k) if b_t else (e, k, n)) / k ** 0.5).astype(
        np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    masked = np.array([0, 1, 16, 32], np.int32)
    c = _kernels.COUNTERS["grouped_gemm"]
    plain, launches = c.plain_calls, c.launches
    got = to_numpy(tg.m_grouped_gemm_masked(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
        torch.from_numpy(masked), out_dtype=torch.float32,
        b_layout=b_layout))
    assert (c.plain_calls - plain, c.launches - launches) == (1, 0)
    want = np.asarray(jg.m_grouped_gemm_masked(
        a_q, a_s, b_q, b_s, jnp.asarray(masked), out_dtype=jnp.float32,
        b_layout=b_layout))
    for ei, rows in enumerate(masked):
        res = f32_close(got[ei, :rows], want[ei, :rows])
        assert res.ok, (ei, res)
        assert not got[ei, rows:].any()
