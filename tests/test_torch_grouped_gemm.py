"""Port m_grouped_gemm_masked and m_grouped_gemm_contiguous (K3 and K8's
CPU paths) vs the JAX package's.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the
port runs the kernels' plain versions. Rows at or past masked_m[e] are
unspecified in both (``grouped_gemm.py:433-436``), so only valid rows are
compared; the contiguous GEMM's padding tiles (-1) are exactly zero in
both. Tolerances as in test_torch_fp8_gemm.py: the outlier gate for f32
outputs, one bf16 ulp for bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu.ops import fp8_gemm as jf
from deepgemm_ascend_tpu.ops import grouped_gemm as jg
from deepgemm_ascend_tpu.ops import quant as jq
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as tf
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as tg
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import bf16_within_one_ulp, f32_close, to_numpy, to_torch


def _operands(e, m_max, n, k, b_t, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_t(df=4, size=(e, m_max, k)).astype(np.float32)
    w = (rng.normal(size=(e, n, k) if b_t else (e, k, n)) / k ** 0.5).astype(
        np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    return a_q, a_s, b_q, b_s


@pytest.mark.parametrize("masked", [[0, 3, 40, 64], [64, 64, 1, 17]])
@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_masked_matches_jax_on_valid_rows(masked, b_layout, out):
    jd, td = ((jnp.float32, torch.float32) if out == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    a_q, a_s, b_q, b_s = _operands(4, 64, 256, 256, b_layout == "t")
    mm = np.asarray(masked, np.int32)
    want = np.asarray(jg.m_grouped_gemm_masked(
        a_q, a_s, b_q, b_s, jnp.asarray(mm), out_dtype=jd,
        b_layout=b_layout), np.float32)
    got = to_numpy(tg.m_grouped_gemm_masked(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
        torch.from_numpy(mm), out_dtype=td, b_layout=b_layout))
    for e, rows in enumerate(masked):
        assert not got[e, rows:].any()          # plain: invalid rows zero
        if not rows:
            continue
        if out == "f32":
            res = f32_close(got[e, :rows], want[e, :rows])
            assert res.ok, (e, res)
        else:
            assert bf16_within_one_ulp(got[e, :rows], want[e, :rows])


def test_masked_expanded_scales_match_compact():
    a_q, a_s, b_q, b_s = (to_torch(x) for x in
                          _operands(3, 32, 256, 128, False, seed=1))
    mm = torch.tensor([32, 5, 0], dtype=torch.int32)
    panel = tf.expand_weight_scales(b_s, 256)
    got = tg.m_grouped_gemm_masked(a_q, a_s, b_q, panel, mm,
                                   b_scales_expanded=True,
                                   out_dtype=torch.float32)
    ref = tg.m_grouped_gemm_masked(a_q, a_s, b_q, b_s, mm,
                                   out_dtype=torch.float32)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("b_layout", ["n", "t"])
def test_masked_exact_mode_matches_jax(b_layout):
    a_q, a_s, b_q, b_s = _operands(3, 32, 128, 256, b_layout == "t", seed=2)
    mm = np.asarray([32, 7, 0], np.int32)
    with jf.exact_mode():
        want = np.asarray(jg.m_grouped_gemm_masked(
            a_q, a_s, b_q, b_s, jnp.asarray(mm), out_dtype=jnp.float32,
            b_layout=b_layout))
    with tf.exact_mode():
        got = to_numpy(tg.m_grouped_gemm_masked(
            to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
            torch.from_numpy(mm), out_dtype=torch.float32,
            b_layout=b_layout))
    assert verify.relative_l2_error(got, want) < 1e-6


def test_masked_bad_shapes_raise():
    a_q, a_s, b_q, b_s = (to_torch(x) for x in
                          _operands(2, 16, 128, 128, False, seed=3))
    mm = torch.tensor([1, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        tg.m_grouped_gemm_masked(a_q, a_s, b_q[:1], b_s[:1], mm)
    with pytest.raises(ValueError):
        tg.m_grouped_gemm_masked(a_q, a_s, b_q, b_s, mm, b_layout="t",
                                 b_scales_expanded=True)


def _contiguous(block_m, b_t, seed, e=3, n=256, k=384):
    """Operands laid out for experts of 70, 0 and 130 rows, plus a padding
    tile (-1) at the end."""
    _, gids, _ = tg.make_contiguous_layout([70, 0, 130], block_m)
    gids = np.append(gids, -1).astype(np.int32)
    rng = np.random.default_rng(seed)
    m = gids.size * block_m
    a = rng.standard_t(df=4, size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(e, n, k) if b_t else (e, k, n)) / k ** 0.5).astype(
        np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    return a_q, a_s, b_q, b_s, gids


@pytest.mark.parametrize("block_m", [128, 96])
@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_contiguous_matches_jax(block_m, b_layout, out):
    jd, td = ((jnp.float32, torch.float32) if out == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    a_q, a_s, b_q, b_s, gids = _contiguous(block_m, b_layout == "t", seed=4)
    want = np.asarray(jg.m_grouped_gemm_contiguous(
        a_q, a_s, b_q, b_s, jnp.asarray(gids), out_dtype=jd,
        b_layout=b_layout), np.float32)
    k8 = tg.K8.plain_calls
    got = to_numpy(tg.m_grouped_gemm_contiguous(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
        torch.from_numpy(gids), out_dtype=td, b_layout=b_layout))
    assert tg.K8.plain_calls == k8 + 1
    assert not got[-block_m:].any() and not want[-block_m:].any()
    if out == "f32":
        res = f32_close(got, want)
        assert res.ok, res
    else:
        assert bf16_within_one_ulp(got, want)


@pytest.mark.parametrize("source", ["expanded", "config"])
def test_contiguous_expanded_scales_and_config_block_m(source):
    """b_scales_expanded (the (E, K/128, N) panel) and a config whose
    block_m fixes the m-tile give what JAX gives (the config's block_n
    names a compiled tile of the route, 'n': the tile route's 64 × 64)."""
    a_q, a_s, b_q, b_s, gids = _contiguous(128, False, seed=5)
    kw_j, kw_t, bs_j = {}, {}, b_s
    if source == "expanded":
        bs_j = jnp.repeat(b_s, 128, axis=2)
        kw_j = kw_t = {"b_scales_expanded": True}
    else:
        from deepgemm_ascend_tpu.config import GemmConfig as JConfig
        from deepgemm_ascend_tpu_torch.config import GemmConfig
        kw_j = {"config": JConfig(block_m=128, block_n=128, block_k=128)}
        kw_t = {"config": GemmConfig(block_m=128, block_n=64)}
    want = np.asarray(jg.m_grouped_gemm_contiguous(
        a_q, a_s, b_q, bs_j, jnp.asarray(gids), out_dtype=jnp.float32,
        **kw_j))
    got = to_numpy(tg.m_grouped_gemm_contiguous(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(bs_j),
        torch.from_numpy(gids), out_dtype=torch.float32, **kw_t))
    res = f32_close(got, want)
    assert res.ok, res


@pytest.mark.parametrize("b_layout", ["n", "t"])
def test_contiguous_exact_mode_matches_jax(b_layout):
    a_q, a_s, b_q, b_s, gids = _contiguous(128, b_layout == "t", seed=6)
    with jf.exact_mode():
        want = np.asarray(jg.m_grouped_gemm_contiguous(
            a_q, a_s, b_q, b_s, jnp.asarray(gids), out_dtype=jnp.float32,
            b_layout=b_layout))
    with tf.exact_mode():
        got = to_numpy(tg.m_grouped_gemm_contiguous(
            to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
            torch.from_numpy(gids), out_dtype=torch.float32,
            b_layout=b_layout))
    assert verify.relative_l2_error(got, want) < 1e-6
    assert not got[-128:].any()


CONTIGUOUS_ERRORS = ["b_layout", "t_expanded", "ragged_k", "block_m",
                     "tile_ids", "xla"]


@pytest.mark.parametrize("case", CONTIGUOUS_ERRORS)
def test_contiguous_raises_as_jax(case):
    from deepgemm_ascend_tpu.config import GemmConfig as JConfig
    from deepgemm_ascend_tpu.config import KernelType as JKernelType
    from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType
    a_q, a_s, b_q, b_s, gids = _contiguous(128, False, seed=7, e=2, n=128,
                                           k=256)
    args = [a_q, a_s, b_q, b_s, gids]
    kw_j, kw_t = {}, {}
    if case == "b_layout":
        kw_j = kw_t = {"b_layout": "x"}
    elif case == "t_expanded":
        kw_j = kw_t = {"b_layout": "t", "b_scales_expanded": True}
    elif case == "ragged_k":
        args[0], args[1] = a_q[:, :200], a_s
    elif case == "block_m":
        kw_j = {"config": JConfig(block_m=120, block_n=128, block_k=128)}
        kw_t = {"config": GemmConfig(block_m=120)}
    elif case == "tile_ids":
        args[4] = gids[:-1]
    else:
        kw_j = {"config": JConfig(kernel_type=JKernelType.XLA)}
        kw_t = {"config": GemmConfig(kernel_type=KernelType.XLA)}
    with pytest.raises(ValueError):
        jg.m_grouped_gemm_contiguous(*args[:4], jnp.asarray(args[4]), **kw_j)
    with pytest.raises(ValueError):
        tg.m_grouped_gemm_contiguous(*(to_torch(x) for x in args[:4]),
                                     torch.from_numpy(args[4]), **kw_t)


@pytest.mark.parametrize("kw", [{"expected_m": 3}, {"expected_m": 200},
                                {"config": "ring 16x64"},
                                {"config": "ring 64x64"}])
def test_masked_hint_and_caller_tile_change_no_result(kw):
    """``expected_m`` and a caller's config naming a compiled K3 tile pick
    the kernel's tile and change no result: JAX's output (no hint, no
    config) on the valid rows, within the file's fp8 tolerance."""
    from deepgemm_ascend_tpu_torch.config import GemmConfig
    masked = [0, 3, 40, 64]
    a_q, a_s, b_q, b_s = _operands(4, 64, 256, 256, True, seed=11)
    mm = np.asarray(masked, np.int32)
    want = np.asarray(jg.m_grouped_gemm_masked(
        a_q, a_s, b_q, b_s, jnp.asarray(mm), out_dtype=jnp.float32,
        b_layout="t"))
    if "config" in kw:
        tile = tuple(int(x) for x in kw["config"].split()[1].split("x"))
        kw = {"config": GemmConfig(*tile, 128)}
    got = to_numpy(tg.m_grouped_gemm_masked(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
        torch.from_numpy(mm), out_dtype=torch.float32, b_layout="t", **kw))
    for e, rows in enumerate(masked):
        if rows:
            res = f32_close(got[e, :rows], want[e, :rows])
            assert res.ok, (e, res)


# (op, b_layout, block_m, block_n) of caller configs no kernel of the
# route compiles: JAX's default GemmConfig() (256 x 256), a 128-row ring
# tile, and K8's tile route ('n') and wgmma16 route ('t') at 128-row
# m-tiles with 256 and 64 columns.
UNCOMPILED = [("masked", "t", 256, 256), ("masked", "t", 128, 64),
              ("masked", "n", 16, 64), ("contiguous", "n", 128, 128),
              ("contiguous", "t", 128, 256), ("contiguous", "t", 128, 64)]


@pytest.mark.parametrize("kind,b_layout,block_m,block_n", UNCOMPILED)
def test_an_uncompiled_caller_tile_raises_on_the_cpu(kind, b_layout, block_m,
                                                     block_n):
    """A caller's config naming a tile outside the route's compiled set
    raises ValueError naming the compiled tiles on a CPU tensor as on the
    card, before the plain version runs."""
    from deepgemm_ascend_tpu_torch.config import GemmConfig
    b_t = b_layout == "t"
    cfg = GemmConfig(block_m, block_n, 128)
    if kind == "masked":
        ops = [to_torch(x) for x in _operands(2, 32, 256, 256, b_t, seed=12)]
        call = lambda: tg.m_grouped_gemm_masked(
            *ops, torch.tensor([5, 32], dtype=torch.int32), config=cfg,
            b_layout=b_layout)
        counter = tg.COUNTER
    else:
        *ops, gids = _contiguous(128, b_t, seed=13)
        call = lambda: tg.m_grouped_gemm_contiguous(
            *(to_torch(x) for x in ops), torch.from_numpy(gids), config=cfg,
            b_layout=b_layout)
        counter = tg.K8
    before = counter.plain_calls
    with pytest.raises(ValueError, match="compiled"):
        call()
    assert counter.plain_calls == before
