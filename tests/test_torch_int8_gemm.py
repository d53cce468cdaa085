"""Port W8A8 int8 GEMMs (K7, K9, K6: the CPU paths) vs the JAX package's.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions. Both form one exact integer K-sum and the
same f32 epilogue ``(acc·a_s)·b_s``, rounded once to the output type, so
the results must be equal bit for bit on every valid row (rows at or past
``masked_m[e]`` are unspecified on the masked path and compared only for
the port's zeros). The exact-mode goldens are f32 matmuls of dequantized
operands, summed in another order in each package: rel-L2 < 1e-6.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu.config import GemmConfig as JConfig
from deepgemm_ascend_tpu.config import KernelType as JKernelType
from deepgemm_ascend_tpu.ops import fp8_gemm as jf
from deepgemm_ascend_tpu.ops import grouped_gemm as jg
from deepgemm_ascend_tpu.ops import int8_gemm as ji
from deepgemm_ascend_tpu.ops import quant as jq
from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as tf
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as tg
from deepgemm_ascend_tpu_torch.ops import int8_gemm as ti
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import to_numpy, to_torch

OUT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "f32": (jnp.float32, torch.float32)}


def _acts(shape, seed):
    """Heavy-tailed activations quantized per token (last axis)."""
    x = np.random.default_rng(seed).standard_t(df=4, size=shape)
    return jq.quantize_int8(jnp.asarray(x, jnp.float32), axis=-1)


def _weights(shape, seed):
    """(…, k, n) weights quantized per output channel (over k)."""
    w = np.random.default_rng(seed).normal(size=shape) / shape[-2] ** 0.5
    return jq.quantize_int8(jnp.asarray(w, jnp.float32), axis=-2)


def _b_port(b_q, b_layout):
    """The JAX (…, k, n) weight bytes in the port's layout."""
    b = np.array(b_q)
    if b_layout == "t":
        b = np.ascontiguousarray(np.swapaxes(b, -1, -2))
    return torch.from_numpy(b)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("mnk", [(64, 128, 256), (33, 70, 200)])
@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_int8_gemm_matches_jax_bit_for_bit(mnk, b_layout, out):
    """Aligned, and ragged m, n and k (a K tail inside one 128 block)."""
    m, n, k = mnk
    jd, td = OUT[out]
    a_q, a_s = _acts((m, k), 0)
    b_q, b_s = _weights((k, n), 1)
    want = ji.int8_gemm(a_q, a_s, b_q, b_s, out_dtype=jd)
    got = ti.int8_gemm(to_torch(a_q), to_torch(a_s), _b_port(b_q, b_layout),
                       to_torch(b_s), out_dtype=td, b_layout=b_layout)
    assert got.dtype == td and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(to_numpy(got), _bits(want))


@pytest.mark.parametrize("b_layout", ["n", "t"])
def test_int8_gemm_with_config_multi_step_k_matches_jax(b_layout):
    """K = 320 over 128-deep JAX blocks: two full steps and a 64-deep tail."""
    a_q, a_s = _acts((32, 320), 2)
    b_q, b_s = _weights((320, 128), 3)
    want = ji.int8_gemm_with_config(a_q, a_s, b_q, b_s,
                                    config=JConfig(32, 128, 128),
                                    out_dtype=jnp.float32)
    got = ti.int8_gemm_with_config(
        to_torch(a_q), to_torch(a_s), _b_port(b_q, b_layout), to_torch(b_s),
        config=GemmConfig(32, 128, 128), out_dtype=torch.float32,
        b_layout=b_layout)
    np.testing.assert_array_equal(to_numpy(got), _bits(want))


def _layout(counts, block_m, pad_tiles=0):
    """make_contiguous_layout of the JAX package, plus ``pad_tiles``
    padding tiles (id -1) appended."""
    m, gids, row_map = jg.make_contiguous_layout(counts, block_m)
    gids = np.concatenate([gids, np.full(pad_tiles, -1, np.int32)])
    return m + pad_tiles * block_m, gids


@pytest.mark.parametrize("case", [([5, 0, 70, 33], 32, 0),
                                  ([40, 7, 0], 64, 2)])
@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_contiguous_matches_jax_bit_for_bit(case, b_layout, out):
    """Uneven expert spans, an empty expert, padding tiles (-1), ragged n
    and k."""
    counts, block_m, pad = case
    jd, td = OUT[out]
    m, gids = _layout(counts, block_m, pad)
    e, n, k = len(counts), 96, 200
    a_q, a_s = _acts((m, k), 4)
    b_q, b_s = _weights((e, k, n), 5)
    want = ji.m_grouped_int8_gemm_contiguous(a_q, a_s, b_q, b_s,
                                             jnp.asarray(gids), out_dtype=jd)
    got = ti.m_grouped_int8_gemm_contiguous(
        to_torch(a_q), to_torch(a_s), _b_port(b_q, b_layout), to_torch(b_s),
        gids, out_dtype=td, b_layout=b_layout)
    np.testing.assert_array_equal(to_numpy(got), _bits(want))
    if pad:
        assert not to_numpy(got)[-pad * block_m:].any()


@pytest.mark.parametrize("masked", [[0, 3, 40, 64], [64, 64, 1, 17]])
@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_masked_matches_jax_on_valid_rows(masked, b_layout, out):
    jd, td = OUT[out]
    e, m_max, n, k = 4, 64, 192, 200
    a_q, a_s = _acts((e, m_max, k), 6)
    b_q, b_s = _weights((e, k, n), 7)
    mm = np.asarray(masked, np.int32)
    want = _bits(ji.m_grouped_int8_gemm_masked(a_q, a_s, b_q, b_s,
                                               jnp.asarray(mm), out_dtype=jd))
    _kernels.reset_counters()
    got = to_numpy(ti.m_grouped_int8_gemm_masked(
        to_torch(a_q), to_torch(a_s), _b_port(b_q, b_layout), to_torch(b_s),
        torch.from_numpy(mm), out_dtype=td, b_layout=b_layout))
    for ei, rows in enumerate(masked):
        np.testing.assert_array_equal(got[ei, :rows], want[ei, :rows])
        assert not got[ei, rows:].any()          # plain: invalid rows zero
    c = _kernels.COUNTERS["int8_grouped_masked"]
    assert (c.launches, c.plain_calls) == (0, 1)


def _exact_inputs(op):
    e, n, k = 3, 128, 160
    if op == "dense":
        return _acts((24, k), 8), _weights((k, n), 9), None
    if op == "contiguous":
        m, gids = _layout([9, 0, 20], 16, pad_tiles=1)
        return _acts((m, k), 10), _weights((e, k, n), 11), gids
    return (_acts((e, 32, k), 12), _weights((e, k, n), 13),
            np.asarray([32, 7, 0], np.int32))


def _call(mod, op, a, b, extra, *, b_layout=None, **kw):
    if b_layout is not None:
        kw["b_layout"] = b_layout
    if op == "dense":
        return mod.int8_gemm(*a, *b, **kw)
    fn = (mod.m_grouped_int8_gemm_contiguous if op == "contiguous"
          else mod.m_grouped_int8_gemm_masked)
    return fn(*a, *b, extra, **kw)


@pytest.mark.parametrize("op", ["dense", "contiguous", "masked"])
def test_exact_mode_matches_jax(op):
    (a_q, a_s), (b_q, b_s), extra = _exact_inputs(op)
    with jf.exact_mode():
        want = np.asarray(_call(ji, op, (a_q, a_s), (b_q, b_s),
                                None if extra is None else jnp.asarray(extra),
                                out_dtype=jnp.float32))
    t_extra = None if extra is None else torch.from_numpy(extra)
    with tf.exact_mode():
        got = to_numpy(_call(ti, op, (to_torch(a_q), to_torch(a_s)),
                             (_b_port(b_q, "t"), to_torch(b_s)), t_extra,
                             b_layout="t", out_dtype=torch.float32))
    assert verify.relative_l2_error(got, want) < 1e-6


@pytest.mark.parametrize("case", [([3, 0, 130, 5], 64), ([1] * 5, 32),
                                  ([0, 0], 128)])
def test_make_contiguous_layout_matches_jax(case):
    counts, block_m = case
    want = jg.make_contiguous_layout(counts, block_m)
    got = tg.make_contiguous_layout(counts, block_m)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _bad_inputs(case):
    """(JAX call, port call) pairs that each package must refuse."""
    a_q, a_s = _acts((32, 128), 14)
    b_q, b_s = _weights((128, 64), 15)
    ga_q, ga_s = _acts((2, 16, 128), 16)
    gb_q, gb_s = _weights((2, 128, 64), 17)
    ca_q, ca_s = _acts((64, 128), 18)
    gids = np.asarray([0, 1], np.int32)
    t = to_torch
    tb, tgb = _b_port(b_q, "n"), _b_port(gb_q, "n")
    mm = np.asarray([3, 16], np.int32)
    cases = {
        "dense_inner": (lambda: ji.int8_gemm(a_q, a_s, b_q[:64], b_s),
                        lambda: ti.int8_gemm(t(a_q), t(a_s), tb[:64],
                                             t(b_s))),
        "dense_dtype": (lambda: ji.int8_gemm(a_q.astype(jnp.bfloat16), a_s,
                                             b_q, b_s),
                        lambda: ti.int8_gemm(t(a_q).to(torch.bfloat16),
                                             t(a_s), tb, t(b_s))),
        "dense_a_scales": (lambda: ji.int8_gemm(a_q, a_s[:, 0], b_q, b_s),
                           lambda: ti.int8_gemm(t(a_q), t(a_s)[:, 0], tb,
                                                t(b_s))),
        "dense_b_scales": (lambda: ji.int8_gemm(a_q, a_s, b_q, b_s.T),
                           lambda: ti.int8_gemm(t(a_q), t(a_s), tb,
                                                t(b_s).t())),
        "contig_inner": (lambda: ji.m_grouped_int8_gemm_contiguous(
            ca_q[:, :64], ca_s, gb_q, gb_s, gids),
            lambda: ti.m_grouped_int8_gemm_contiguous(
                t(ca_q)[:, :64], t(ca_s), tgb, t(gb_s), gids)),
        "contig_a_scales": (lambda: ji.m_grouped_int8_gemm_contiguous(
            ca_q, ca_s[:32], gb_q, gb_s, gids),
            lambda: ti.m_grouped_int8_gemm_contiguous(
                t(ca_q), t(ca_s)[:32], tgb, t(gb_s), gids)),
        "contig_b_scales": (lambda: ji.m_grouped_int8_gemm_contiguous(
            ca_q, ca_s, gb_q, gb_s[:1], gids),
            lambda: ti.m_grouped_int8_gemm_contiguous(
                t(ca_q), t(ca_s), tgb, t(gb_s)[:1], gids)),
        "contig_block_m": (lambda: ji.m_grouped_int8_gemm_contiguous(
            ca_q, ca_s, gb_q, gb_s, gids, config=JConfig(48, 128, 128)),
            lambda: ti.m_grouped_int8_gemm_contiguous(
                t(ca_q), t(ca_s), tgb, t(gb_s), gids,
                config=GemmConfig(48, 128, 128))),
        "contig_tile_ids": (lambda: ji.m_grouped_int8_gemm_contiguous(
            ca_q, ca_s, gb_q, gb_s, gids, config=JConfig(16, 128, 128)),
            lambda: ti.m_grouped_int8_gemm_contiguous(
                t(ca_q), t(ca_s), tgb, t(gb_s), gids,
                config=GemmConfig(16, 128, 128))),
        "contig_xla": (lambda: ji.m_grouped_int8_gemm_contiguous(
            ca_q, ca_s, gb_q, gb_s, gids,
            config=JConfig(32, 128, 128, kernel_type=JKernelType.XLA)),
            lambda: ti.m_grouped_int8_gemm_contiguous(
                t(ca_q), t(ca_s), tgb, t(gb_s), gids,
                config=GemmConfig(32, 128, 128,
                                  kernel_type=KernelType.XLA))),
        "masked_shapes": (lambda: ji.m_grouped_int8_gemm_masked(
            ga_q, ga_s, gb_q[:1], gb_s[:1], jnp.asarray(mm)),
            lambda: ti.m_grouped_int8_gemm_masked(
                t(ga_q), t(ga_s), tgb[:1], t(gb_s)[:1],
                torch.from_numpy(mm))),
        "masked_a_scales": (lambda: ji.m_grouped_int8_gemm_masked(
            ga_q, ga_s[:, :8], gb_q, gb_s, jnp.asarray(mm)),
            lambda: ti.m_grouped_int8_gemm_masked(
                t(ga_q), t(ga_s)[:, :8], tgb, t(gb_s),
                torch.from_numpy(mm))),
        "masked_b_scales": (lambda: ji.m_grouped_int8_gemm_masked(
            ga_q, ga_s, gb_q, gb_s[:, :, :32], jnp.asarray(mm)),
            lambda: ti.m_grouped_int8_gemm_masked(
                t(ga_q), t(ga_s), tgb, t(gb_s)[:, :, :32],
                torch.from_numpy(mm))),
    }
    return cases[case]


@pytest.mark.parametrize("case", [
    "dense_inner", "dense_dtype", "dense_a_scales", "dense_b_scales",
    "contig_inner", "contig_a_scales", "contig_b_scales", "contig_block_m",
    "contig_tile_ids", "contig_xla", "masked_shapes", "masked_a_scales",
    "masked_b_scales"])
def test_bad_inputs_raise_value_error_in_both(case):
    jax_call, port_call = _bad_inputs(case)
    with pytest.raises(ValueError):
        jax_call()
    with pytest.raises(ValueError):
        port_call()


def test_contiguous_refuses_a_tile_count_that_does_not_divide_m():
    """The JAX exact path assumes M_total % len(tile_group_ids) == 0
    (int8_gemm.py:328-331); the port says so in every mode."""
    a_q, a_s = (to_torch(x) for x in _acts((100, 128), 19))
    b_q, b_s = (to_torch(x) for x in _weights((2, 128, 64), 20))
    for mode in (tf.exact_mode, contextlib.nullcontext):
        with mode():
            with pytest.raises(ValueError, match="divides M_total"):
                ti.m_grouped_int8_gemm_contiguous(
                    a_q, a_s, b_q, b_s, np.asarray([0, 1, 1], np.int32))
    with pytest.raises(ValueError, match=r"\[-1, 2\)"):
        ti.m_grouped_int8_gemm_contiguous(a_q[:96], a_s[:96], b_q, b_s,
                                          np.asarray([0, 2, 1], np.int32))


@pytest.mark.parametrize("op", ["dense", "masked"])
def test_xla_kernel_type_arrives_with_the_tiling_slice(op):
    """KernelType.XLA (JAX's product outside Pallas, plain torch ops in the
    port) equals JAX's XLA realization bit for bit: the integer sum is
    exact and the f32 epilogue the same (rows past masked_m are zero in
    both)."""
    (a_q, a_s), (b_q, b_s), extra = _exact_inputs(op)
    cfg = GemmConfig(32, 128, 128, kernel_type=KernelType.XLA)
    jcfg = JConfig(32, 128, 128, kernel_type=JKernelType.XLA)
    args = ((to_torch(a_q), to_torch(a_s)), (_b_port(b_q, "n"), to_torch(b_s)),
            None if extra is None else torch.from_numpy(extra))
    before = (ti.K7.plain_calls, ti.K6.plain_calls)
    if op == "dense":
        got = ti.int8_gemm_with_config(*args[0], *args[1], config=cfg)
        want = ji.int8_gemm_with_config(a_q, a_s, b_q, b_s, config=jcfg)
    else:
        got = _call(ti, op, *args, config=cfg)
        want = _call(ji, op, (a_q, a_s), (b_q, b_s), jnp.asarray(extra),
                     config=jcfg)
    assert (ti.K7.plain_calls, ti.K6.plain_calls) == before   # no kernel
    assert np.array_equal(_bits(to_numpy(got)), _bits(want))


@pytest.mark.parametrize("kw", [{"expected_m": 3}, {"expected_m": 40},
                                {"config": (16, 64)}, {"config": (128, 256)},
                                {"contiguous": (128, 256)},
                                {"contiguous": (128, 64)}])
def test_grouped_hint_and_caller_tile_change_no_result(kw):
    """``expected_m`` and a caller's config naming a compiled K6 or K9 tile
    (a contiguous config names the layout's block_m and the tile's
    columns) change no bit of the result: JAX's output with no hint and no
    config."""
    from deepgemm_ascend_tpu_torch.config import GemmConfig
    if "contiguous" in kw:
        m, gids = _layout([40, 0, 100], 128, pad_tiles=1)
        a_q, a_s = _acts((m, 256), 14)
        b_q, b_s = _weights((3, 256, 192), 15)
        want = _bits(ji.m_grouped_int8_gemm_contiguous(
            a_q, a_s, b_q, b_s, jnp.asarray(gids), out_dtype=jnp.float32))
        got = ti.m_grouped_int8_gemm_contiguous(
            to_torch(a_q), to_torch(a_s), _b_port(b_q, "t"), to_torch(b_s),
            gids, out_dtype=torch.float32, b_layout="t",
            config=GemmConfig(*kw["contiguous"], 128))
        np.testing.assert_array_equal(to_numpy(got), want)
        return
    masked = [0, 3, 40, 64]
    a_q, a_s = _acts((4, 64, 256), 16)
    b_q, b_s = _weights((4, 256, 192), 17)
    mm = np.asarray(masked, np.int32)
    want = _bits(ji.m_grouped_int8_gemm_masked(a_q, a_s, b_q, b_s,
                                               jnp.asarray(mm),
                                               out_dtype=jnp.float32))
    if "config" in kw:
        kw = {"config": GemmConfig(*kw["config"], 128)}
    got = to_numpy(ti.m_grouped_int8_gemm_masked(
        to_torch(a_q), to_torch(a_s), _b_port(b_q, "t"), to_torch(b_s),
        torch.from_numpy(mm), out_dtype=torch.float32, b_layout="t", **kw))
    for ei, rows in enumerate(masked):
        np.testing.assert_array_equal(got[ei, :rows], want[ei, :rows])


# (op, b_layout, block_m, block_n) of caller configs no kernel of the
# route compiles: JAX's default GemmConfig() (256 x 256), K6's ring at 64
# columns past its 16 rows, its int8_tile route ('n') at 16 x 64, and K9's
# wgmma route at 128-row m-tiles with 128 columns and its int8_tile route
# with 256.
UNCOMPILED = [("masked", "t", 256, 256), ("masked", "t", 64, 128),
              ("masked", "n", 16, 64), ("contiguous", "t", 128, 128),
              ("contiguous", "n", 128, 256)]


@pytest.mark.parametrize("kind,b_layout,block_m,block_n", UNCOMPILED)
def test_an_uncompiled_caller_tile_raises_on_the_cpu(kind, b_layout, block_m,
                                                     block_n):
    """A caller's config naming a tile outside the route's compiled set
    raises ValueError naming the compiled tiles on a CPU tensor as on the
    card, before the plain version runs."""
    cfg = GemmConfig(block_m, block_n, 128)
    b_q, b_s = _weights((2, 256, 192), 18)
    if kind == "masked":
        a_q, a_s = _acts((2, 32, 256), 19)
        call = lambda: ti.m_grouped_int8_gemm_masked(
            to_torch(a_q), to_torch(a_s), _b_port(b_q, b_layout),
            to_torch(b_s), torch.tensor([5, 32], dtype=torch.int32),
            config=cfg, b_layout=b_layout)
        counter = ti.K6
    else:
        m, gids = _layout([40, 100], 128)
        a_q, a_s = _acts((m, 256), 20)
        call = lambda: ti.m_grouped_int8_gemm_contiguous(
            to_torch(a_q), to_torch(a_s), _b_port(b_q, b_layout),
            to_torch(b_s), gids, config=cfg, b_layout=b_layout)
        counter = ti.K9
    before = counter.plain_calls
    with pytest.raises(ValueError, match="compiled"):
        call()
    assert counter.plain_calls == before
