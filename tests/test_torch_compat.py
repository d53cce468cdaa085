"""Port compat (``run_mmad_*`` and the DeepGEMM aliases) and the FP8 pad
helpers vs the JAX package's, on the same inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the
port gets CPU tensors (or numpy arrays with a CPU output buffer) and runs
the kernels' plain versions. Tolerances: dense f32 outputs within 1e-5 of
Σ|a·b| (two f32 sums of the same exact products in another order,
test_torch_gemm.py); bf16 outputs of the FP8 ops within one bf16 ulp, as
the K1/K3 parity tests hold them; the pad helpers byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import compat as jcompat
from deepgemm_ascend_tpu.compat import deep_gemm as jdg
from deepgemm_ascend_tpu.models import moe as jmoe
from deepgemm_ascend_tpu.ops import fp8_gemm as jf
from deepgemm_ascend_tpu.ops import quant as jq
from deepgemm_ascend_tpu.tiling import padding as jpad
from deepgemm_ascend_tpu.utils import golden
from deepgemm_ascend_tpu_torch import compat as tcompat
from deepgemm_ascend_tpu_torch.compat import deep_gemm as tdg
from deepgemm_ascend_tpu_torch.models import moe as tmoe
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as tf
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as tg
from deepgemm_ascend_tpu_torch.ops import quant as tq
from deepgemm_ascend_tpu_torch.tiling import padding as tpad
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import (bf16_within_one_ulp, fp8_bytes, jax_to_numpy,
                          to_numpy, to_torch)

GEMM_REL_TOL = 1e-5


def assert_gemm_close(got, want, a, b):
    got = to_numpy(got).astype(np.float64)
    want = np.asarray(want, np.float64)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a) @ np.abs(b)
    np.testing.assert_array_less(np.abs(got - want),
                                 GEMM_REL_TOL * scale + 1e-30)


# ---------------------------------------------------------------- run_mmad_*

@pytest.fixture
def problem():
    rng = np.random.default_rng(0)          # tests/conftest.py's rng
    a = rng.normal(size=(64, 96)).astype(np.float32)
    b = rng.normal(size=(96, 128)).astype(np.float32)
    return a, b


def test_run_mmad_rtc_bf16_matches_jax(problem):
    a, b = problem
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(jcompat.run_mmad_rtc(ja, jb))
    got = tcompat.run_mmad_rtc(to_torch(ja), to_torch(jb))
    assert got.dtype == torch.float32
    assert_gemm_close(got, want, np.asarray(ja, np.float32),
                      np.asarray(jb, np.float32))


def test_run_mmad_custom_batched_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 32, 48)).astype(np.float32)
    b = rng.normal(size=(2, 48, 64)).astype(np.float32)
    want = np.asarray(jcompat.run_mmad_custom(jnp.asarray(a), jnp.asarray(b)))
    got = tcompat.run_mmad_custom(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, 32, 64)
    for i in range(2):
        assert_gemm_close(got[i], want[i], a[i], b[i])


@pytest.mark.parametrize("z_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["custom", "rtc", "bench"])
def test_run_mmad_writes_z_in_place(problem, z_dtype, entry):
    """A torch z gets the result in place and is returned (the JAX package
    stages a bf16 z through f32; here copy_ casts)."""
    a, b = problem
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jz = torch.zeros((64, 128), dtype=z_dtype)
    tz = torch.zeros((64, 128), dtype=z_dtype)
    args = {"custom": (), "rtc": (), "bench": ([1, 1, 4, 8, 6, 2],)}[entry]
    jfn = getattr(jcompat, f"run_mmad_{entry}")
    tfn = getattr(tcompat, f"run_mmad_{entry}")
    assert jfn(ta, tb, jz, *args) is jz
    assert tfn(ta, tb, tz, *args) is tz
    if z_dtype == torch.float32:
        assert_gemm_close(tz, jz.numpy(), a, b)
    else:
        assert bf16_within_one_ulp(to_numpy(tz), to_numpy(jz))


@pytest.mark.parametrize("params", ["numpy", "torch", "short", "none"])
def test_run_mmad_bench_params_match_jax(problem, params):
    """params[0:6] as numpy, torch, a short list (padded with ones) or
    None (run_mmad_rtc)."""
    a, b = problem
    p = {"numpy": np.asarray([1, 1, 4, 8, 6, 2], np.int64),
         "torch": torch.tensor([1, 1, 4, 8, 6, 2]),
         "short": [2, 2, 3], "none": None}[params]
    want = np.asarray(jcompat.run_mmad_bench(jnp.asarray(a), jnp.asarray(b),
                                             params=p))
    k10 = _kernels.COUNTERS["gemm"].plain_calls
    got = tcompat.run_mmad_bench(torch.from_numpy(a), torch.from_numpy(b),
                                 params=p)
    assert _kernels.COUNTERS["gemm"].plain_calls == k10 + 1
    assert_gemm_close(got, want, a, b)


def test_run_mmad_numpy_inputs_follow_z(problem):
    """numpy operands go to z's device (here the CPU); with no tensor among
    the arguments they go to cuda (test_torch_no_jax.py)."""
    a, b = problem
    z = torch.zeros((64, 128))
    got = tcompat.run_mmad_rtc(a, b, z)
    assert got is z
    assert_gemm_close(z, a @ b, a, b)
    bf = jnp.asarray(b, jnp.bfloat16)
    got = tcompat.run_mmad_rtc(torch.from_numpy(a).to(torch.bfloat16),
                               np.asarray(bf))              # ml_dtypes bf16
    assert_gemm_close(got, np.asarray(jcompat.run_mmad_rtc(
        jnp.asarray(a, jnp.bfloat16), bf)),
        np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32),
        np.asarray(bf, np.float32))


@pytest.mark.parametrize("entry", ["custom", "rtc", "bench"])
def test_output_buffer_shape_mismatch_raises_before_launch(problem, entry):
    a, b = problem
    with pytest.raises(ValueError):
        getattr(jcompat, f"run_mmad_{entry}")(
            jnp.asarray(a), jnp.asarray(b), jnp.zeros((64, 64), jnp.float32))
    k10 = _kernels.COUNTERS["gemm"].plain_calls
    with pytest.raises(ValueError, match="output buffer shape"):
        getattr(tcompat, f"run_mmad_{entry}")(
            torch.from_numpy(a), torch.from_numpy(b), torch.zeros(64, 64))
    assert _kernels.COUNTERS["gemm"].plain_calls == k10


# ---------------------------------------------------------------- DeepGEMM

def _dense(m, n, k, seed=0):
    """DeepGEMM's NT operands, quantized by JAX: (a_q, a_s), (bt_q, bt_s)."""
    a = golden.gen_heavy_tail((m, k), seed=seed)
    b = golden.gen_heavy_tail((n, k), seed=seed + 1)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    bt_q, bt_s = jq.quantize_fp8_weight(jnp.asarray(b))
    return (a_q, a_s), (bt_q, bt_s)


def _t(pair):
    return tuple(to_torch(x) for x in pair)


@pytest.mark.parametrize("m,n,k", [(64, 256, 512), (33, 200, 300),
                                   (16, 128, 10944 // 8)])
def test_gemm_fp8_fp8_bf16_nt_matches_jax(m, n, k):
    """Aligned, and ragged n and k (auto_pad), as V2_LITE_FULL's dense w2
    (k = 10944) is ragged."""
    lhs, rhs = _dense(m, n, k, seed=3)
    want = np.asarray(jdg.gemm_fp8_fp8_bf16_nt(lhs, rhs), np.float32)
    got = tdg.gemm_fp8_fp8_bf16_nt(_t(lhs), _t(rhs))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert bf16_within_one_ulp(to_numpy(got), want)


def test_gemm_nt_out_in_place_and_numpy_inputs():
    """A torch out is written in place (f32 here: the bf16 result is cast
    by copy_); numpy fp8 inputs (ml_dtypes) go to out's device bit for
    bit."""
    lhs, rhs = _dense(32, 128, 256, seed=5)
    out = torch.zeros((32, 128), dtype=torch.float32)
    jout = torch.zeros((32, 128), dtype=torch.float32)
    assert jdg.gemm_fp8_fp8_bf16_nt(lhs, rhs, jout) is jout
    np_lhs = tuple(np.asarray(x) for x in lhs)
    np_rhs = tuple(np.asarray(x) for x in rhs)
    assert tdg.gemm_fp8_fp8_bf16_nt(np_lhs, np_rhs, out) is out
    assert float(out.abs().sum()) > 0.0
    assert bf16_within_one_ulp(out.numpy(), jout.numpy())
    assert torch.equal(out, tdg.gemm_fp8_fp8_bf16_nt(_t(lhs), _t(rhs)).float())
    with pytest.raises(ValueError, match="output buffer shape"):
        tdg.gemm_fp8_fp8_bf16_nt(_t(lhs), _t(rhs), torch.zeros(32, 64))


@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("m,n,k", [(40, 200, 300), (16, 128, 200)])
def test_fp8_gemm_auto_pad_matches_jax(b_layout, m, n, k):
    rng = np.random.default_rng(4)
    a = rng.standard_t(df=4, size=(m, k)).astype(np.float32)
    w = rng.normal(size=(n, k) if b_layout == "t" else (k, n)).astype(
        np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    want = np.asarray(jf.fp8_gemm(a_q, a_s, b_q, b_s, auto_pad=True,
                                  b_layout=b_layout), np.float32)
    got = tf.fp8_gemm(to_torch(a_q), to_torch(a_s), to_torch(b_q),
                      to_torch(b_s), auto_pad=True, b_layout=b_layout)
    assert got.shape == (m, n)
    assert bf16_within_one_ulp(to_numpy(got), want)


def test_auto_pad_refuses_expanded_scales_as_jax():
    lhs, rhs = _dense(16, 128, 256)
    b_q = jnp.swapaxes(rhs[0], 0, 1)
    panel = jf.expand_weight_scales(jnp.swapaxes(rhs[1], 0, 1), 128)
    with pytest.raises(ValueError, match="auto_pad"):
        jf.fp8_gemm(*lhs, b_q, panel, auto_pad=True, b_scales_expanded=True)
    with pytest.raises(ValueError, match="auto_pad"):
        tf.fp8_gemm(*_t(lhs), to_torch(b_q), to_torch(panel), auto_pad=True,
                    b_scales_expanded=True)


def _grouped(e, m, n, k, seed):
    a = golden.gen_heavy_tail((m, k), seed=seed)
    b = golden.gen_heavy_tail((e, n, k), seed=seed + 1)
    return jq.quantize_fp8_act(jnp.asarray(a)), \
        jq.quantize_fp8_weight(jnp.asarray(b))


def test_grouped_contiguous_m_indices_conversion_matches_jax():
    """Expert 0: 1 tile, expert 1: 1 tile, padding: 1 tile (exactly zero)."""
    bm = tdg.get_m_alignment_for_contiguous_layout()
    assert bm == jdg.get_m_alignment_for_contiguous_layout() == 128
    lhs, rhs = _grouped(2, 3 * bm, 128, 256, seed=7)
    m_indices = np.repeat(np.asarray([0, 1, -1], np.int32), bm)
    want = np.asarray(jdg.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(
        lhs, rhs, None, jnp.asarray(m_indices)), np.float32)
    k8 = _kernels.COUNTERS["grouped_gemm_contiguous"].plain_calls
    got = tdg.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(
        _t(lhs), _t(rhs), None, torch.from_numpy(m_indices))
    assert _kernels.COUNTERS["grouped_gemm_contiguous"].plain_calls == k8 + 1
    got = to_numpy(got)
    assert bf16_within_one_ulp(got, want)
    assert np.all(got[2 * bm:] == 0.0) and np.any(got[:bm] != 0.0)
    native = tg.m_grouped_gemm_contiguous(
        *_t(lhs), *_t(rhs), torch.tensor([0, 1, -1]), b_layout="t")
    np.testing.assert_array_equal(got, to_numpy(native))


@pytest.mark.parametrize("case", ["misaligned", "ragged_total"])
def test_grouped_contiguous_rejects_bad_m_indices_as_jax(case):
    bm = 128
    if case == "misaligned":
        bad = np.concatenate([np.full(bm // 2, 0), np.full(bm + bm // 2, 1)])
        match = "single group id"
    else:
        bad = np.zeros(bm + 8)
        match = "multiple of"
    bad = bad.astype(np.int32)
    rows = bad.size
    a_q = np.zeros((rows, 256), np.uint8)
    a_s = np.ones((rows, 2), np.float32)
    b_q = np.zeros((2, 128, 256), np.uint8)
    b_s = np.ones((2, 1, 2), np.float32)
    as_fp8 = lambda x: jnp.asarray(x).view(jnp.float8_e4m3fn)
    with pytest.raises(ValueError, match=match):
        jdg.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(
            (as_fp8(a_q), jnp.asarray(a_s)), (as_fp8(b_q), jnp.asarray(b_s)),
            None, jnp.asarray(bad))
    fp8 = lambda x: torch.from_numpy(x).view(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match=match):
        tdg.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(
            (fp8(a_q), torch.from_numpy(a_s)), (fp8(b_q), torch.from_numpy(b_s)),
            None, torch.from_numpy(bad))


def test_grouped_masked_alias_matches_jax():
    """expected_m picks the tile and changes no result; valid rows
    compared."""
    e, m_max, k, n = 2, 32, 256, 128
    masked = np.asarray([20, 7], np.int32)
    a = golden.gen_heavy_tail((e, m_max, k), seed=10)
    b = golden.gen_heavy_tail((e, n, k), seed=9)
    lhs = jq.quantize_fp8_act(jnp.asarray(a))
    rhs = jq.quantize_fp8_weight(jnp.asarray(b))
    want = np.asarray(jdg.m_grouped_gemm_fp8_fp8_bf16_nt_masked(
        lhs, rhs, None, jnp.asarray(masked), expected_m=16), np.float32)
    out = torch.zeros((e, m_max, n), dtype=torch.bfloat16)
    got = tdg.m_grouped_gemm_fp8_fp8_bf16_nt_masked(
        _t(lhs), _t(rhs), out, torch.from_numpy(masked), expected_m=16)
    assert got is out
    for g, rows in enumerate(masked):
        assert bf16_within_one_ulp(to_numpy(got[g, :rows]), want[g, :rows])


def test_tma_alignment_helper_is_identity_and_ceil_div():
    x = torch.ones(4, 4)
    assert tdg.get_col_major_tma_aligned_tensor(x) is x
    assert tdg.ceil_div(7, 3) == jdg.ceil_div(7, 3) == 3
    assert sorted(tdg.__all__) == sorted(jdg.__all__)


# ---------------------------------------------------------------- padding

@pytest.mark.parametrize("nt", [False, True])
@pytest.mark.parametrize("m,n,k", [(8, 200, 300), (4, 128, 256),
                                   (3, 130, 128)])
def test_fp8_pad_helpers_byte_equal_to_jax(nt, m, n, k):
    rng = np.random.default_rng(m + n + k)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(
        rng.normal(size=(m, k)).astype(np.float32)))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(
        rng.normal(size=(n, k) if nt else (k, n)).astype(np.float32)))
    jfn = jpad.pad_fp8_operands_nt if nt else jpad.pad_fp8_operands
    tfn = tpad.pad_fp8_operands_nt if nt else tpad.pad_fp8_operands
    want = jfn(a_q, a_s, b_q, b_s)
    got = tfn(to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s))
    assert got[4] == want[4] == n
    for g, w in zip(got[:4], want[:4]):
        assert tuple(g.shape) == tuple(w.shape)
        gb = fp8_bytes(g) if g.dtype == torch.float8_e4m3fn else g.numpy()
        np.testing.assert_array_equal(gb, jax_to_numpy(w))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_pad_k_operands_byte_equal_to_jax(dtype, lead):
    rng = np.random.default_rng(1)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    a = jnp.asarray(rng.normal(size=(*lead, 5, 70)), jd)
    b = jnp.asarray(rng.normal(size=(*lead, 70, 3)), jd)
    wa, wb = jpad.pad_k_operands(a, b, 64) if not lead else (
        jnp.pad(a, [(0, 0), (0, 0), (0, 58)]),
        jnp.pad(b, [(0, 0), (0, 58), (0, 0)]))
    ga, gb = tpad.pad_k_operands(to_torch(a), to_torch(b), 64)
    for g, w in ((ga, wa), (gb, wb)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(jax_to_numpy(np.asarray(w)),
                                      g.view(torch.int16).numpy().view(
                                          np.uint16) if dtype == "bf16"
                                      else g.numpy())
    assert tpad.pad_k_operands(to_torch(a), to_torch(b), 70)[0].shape[-1] == 70


# ---------------------------------------------------------------- the slice

def _prefill(dg, quantize, swiglu, rows, w1, w2, m_indices):
    """One MoE layer's routed experts as a DeepGEMM caller runs them: the
    contiguous grouped GEMM for w1, SwiGLU, re-quantization, the same call
    for w2. Returns (h, (h_q, h_s), y)."""
    h = dg.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(quantize(rows), w1, None,
                                                     m_indices)
    hq = quantize(swiglu(h))
    return h, hq, dg.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(hq, w2, None,
                                                               m_indices)


def test_deepgemm_moe_prefill_matches_jax():
    """TINY's MoE widths (hidden 256, 8 experts, top-2, intermediate 256),
    48 tokens routed by seeded scores, laid out 128-aligned with a padding
    tile at the end; the same calls through JAX's compat and the port's.
    The first GEMM within one bf16 ulp; the second within one ulp when it
    is fed JAX's re-quantized h, and end to end within 1e-2 rel-L2 (an h
    one bf16 ulp apart re-quantizes to a neighbouring e4m3 value, 1/8
    relative, in rare elements)."""
    t, hidden, e, top_k, inter = 48, 256, 8, 2, 256
    rng = np.random.default_rng(11)
    x = rng.normal(size=(t, hidden)).astype(np.float32)
    topk = np.argsort(-rng.random((t, e)), axis=1)[:, :top_k]
    w1 = (rng.normal(size=(e, 2 * inter, hidden)) / 16).astype(np.float32)
    w2 = (rng.normal(size=(e, hidden, inter)) / 16).astype(np.float32)
    counts = np.bincount(topk.reshape(-1), minlength=e)
    m_total, gids, row_map = tg.make_contiguous_layout(counts.tolist(), 128)
    from deepgemm_ascend_tpu.ops import grouped_gemm as jg
    jm, jgids, jrow = jg.make_contiguous_layout(counts.tolist(), 128)
    assert m_total == jm and np.array_equal(gids, jgids) and \
        np.array_equal(row_map, jrow)
    # Assignments sorted by expert, token-major within one: source row r of
    # the layout is the r-th of them.
    order = np.argsort(topk.reshape(-1), kind="stable")
    rows = np.zeros((m_total + 128, hidden), np.float32)
    valid = row_map >= 0
    rows[:m_total][valid] = x[order[row_map[valid]] // top_k]
    m_indices = np.concatenate([np.repeat(gids, 128),
                                np.full(128, -1)]).astype(np.int32)

    jw1, jw2 = (jq.quantize_fp8_weight(jnp.asarray(w)) for w in (w1, w2))
    jh, jhq, jy = _prefill(jdg, jq.quantize_fp8_act, jmoe._swiglu,
                           jnp.asarray(rows, jnp.bfloat16), jw1, jw2,
                           jnp.asarray(m_indices))
    tw1, tw2 = (tq.quantize_fp8_weight(torch.from_numpy(w)) for w in (w1, w2))
    th, _, ty = _prefill(tdg, tq.quantize_fp8_act, tmoe._swiglu,
                         to_torch(jnp.asarray(rows, jnp.bfloat16)), tw1, tw2,
                         torch.from_numpy(m_indices))
    for tw, jw in zip(tw1 + tw2, jw1 + jw2):      # the quantizers agree
        np.testing.assert_array_equal(
            fp8_bytes(tw) if tw.dtype == torch.float8_e4m3fn else tw.numpy(),
            jax_to_numpy(jw))
    assert bf16_within_one_ulp(to_numpy(th), np.asarray(jh, np.float32))
    ty_from_jh = tdg.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(
        _t(jhq), tw2, None, torch.from_numpy(m_indices))
    jy = np.asarray(jy, np.float32)
    assert bf16_within_one_ulp(to_numpy(ty_from_jh), jy)
    ty = to_numpy(ty)
    assert np.all(ty[m_total:] == 0.0)            # the padding tile
    assert verify.relative_l2_error(ty, jy) < 1e-2
