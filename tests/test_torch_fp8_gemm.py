"""Port fp8_gemm (K1's CPU path) vs the JAX package's fp8_gemm.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as its
own tests do; the port runs the kernel's plain version. Both get the same
e4m3 bytes and scales (quantized once by JAX, carried over bit for bit).
Tolerances: f32 outputs pass the outlier gate (rtol 2e-4, atol 1e-5 of the
largest |ref|, ratio ≤ 1e-4) — both sum the same exact products in
another order; bf16 outputs may differ by one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu.config import GemmConfig as JGemmConfig
from deepgemm_ascend_tpu.config import KernelType as JKernelType
from deepgemm_ascend_tpu.ops import fp8_gemm as jf
from deepgemm_ascend_tpu.ops import quant as jq
from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as tf
from deepgemm_ascend_tpu_torch.ops import reference
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import bf16_within_one_ulp, f32_close, to_numpy, to_torch


def _operands(m, n, k, b_t, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_t(df=4, size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(n, k) if b_t else (k, n)) / k ** 0.5).astype(
        np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    return a_q, a_s, b_q, b_s


SHAPES = [(16, 256, 256), (100, 384, 512), (64, 128, 1024)]


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_fp8_gemm_matches_jax(m, n, k, b_layout, out):
    jd, td = ((jnp.float32, torch.float32) if out == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    a_q, a_s, b_q, b_s = _operands(m, n, k, b_layout == "t")
    want = np.asarray(jf.fp8_gemm(a_q, a_s, b_q, b_s, out_dtype=jd,
                                  b_layout=b_layout), np.float32)
    got = to_numpy(tf.fp8_gemm(to_torch(a_q), to_torch(a_s), to_torch(b_q),
                               to_torch(b_s), out_dtype=td,
                               b_layout=b_layout))
    if out == "f32":
        res = f32_close(got, want)
        assert res.ok, res
    else:
        assert bf16_within_one_ulp(got, want)


def test_fp8_gemm_matches_numpy_golden():
    a_q, a_s, b_q, b_s = _operands(96, 256, 384, False, seed=1)
    got = to_numpy(tf.fp8_gemm(to_torch(a_q), to_torch(a_s), to_torch(b_q),
                               to_torch(b_s), out_dtype=torch.float32))
    ref = reference.fp8_gemm_reference(
        to_numpy(to_torch(a_q)), np.asarray(a_s), to_numpy(to_torch(b_q)),
        np.asarray(b_s))
    assert verify.relative_l2_error(got, ref) < 1e-6


def test_fp8_gemm_with_config_expanded_panel_matches_jax():
    a_q, a_s, b_q, b_s = _operands(32, 256, 256, False, seed=2)
    panel = jf.expand_weight_scales(b_s, 256)
    want = np.asarray(jf.fp8_gemm_with_config(
        a_q, a_s, b_q, panel, config=JGemmConfig(128, 128, 128),
        out_dtype=jnp.float32))
    tpanel = tf.expand_weight_scales(to_torch(b_s), 256)
    assert np.array_equal(tpanel.numpy(), np.asarray(panel))
    got = to_numpy(tf.fp8_gemm_with_config(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), tpanel,
        config=GemmConfig(128, 128, 128), out_dtype=torch.float32))
    res = f32_close(got, want)
    assert res.ok, res
    got2 = to_numpy(tf.fp8_gemm(to_torch(a_q), to_torch(a_s), to_torch(b_q),
                                tpanel, b_scales_expanded=True,
                                out_dtype=torch.float32))
    assert np.array_equal(got, got2)


@pytest.mark.parametrize("b_layout", ["n", "t"])
def test_exact_mode_matches_jax(b_layout):
    a_q, a_s, b_q, b_s = _operands(48, 256, 384, b_layout == "t", seed=3)
    with jf.exact_mode():
        want = np.asarray(jf.fp8_gemm(a_q, a_s, b_q, b_s,
                                      out_dtype=jnp.float32,
                                      b_layout=b_layout))
    with tf.exact_mode():
        assert tf.exact_enabled()
        got = to_numpy(tf.fp8_gemm(to_torch(a_q), to_torch(a_s),
                                   to_torch(b_q), to_torch(b_s),
                                   out_dtype=torch.float32,
                                   b_layout=b_layout))
    assert not tf.exact_enabled()
    assert verify.relative_l2_error(got, want) < 1e-6


def test_cpu_tensors_take_the_plain_version():
    a_q, a_s, b_q, b_s = _operands(16, 128, 128, True, seed=4)
    c = _kernels.COUNTERS["fp8_gemm"]
    before = (c.launches, c.plain_calls)
    tf.fp8_gemm(to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
                b_layout="t")
    assert (c.launches, c.plain_calls) == (before[0], before[1] + 1)


def test_ragged_k_raises_like_jax():
    """V2_LITE_FULL's dense w2 (k = 10944 = 85.5·128) fails the same way in
    both packages."""
    k = 10944
    a = jnp.zeros((16, k), jnp.float32)
    w = jnp.zeros((k, 256), jnp.float32)
    a_q, a_s = jq.quantize_fp8_act(a)
    b_q, b_s = jq.quantize_fp8_weight(w)
    with pytest.raises(ValueError) as je:
        jf.fp8_gemm(a_q, a_s, b_q, b_s)
    with pytest.raises(ValueError) as te:
        tf.fp8_gemm(to_torch(a_q), to_torch(a_s), to_torch(b_q),
                    to_torch(b_s))
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("bad", ["n_ragged", "layout", "t_expanded",
                                 "scales", "xla"])
def test_bad_arguments_raise(bad):
    a_q, a_s, b_q, b_s = (to_torch(x) for x in _operands(16, 256, 256, False))
    with pytest.raises((ValueError, NotImplementedError)):
        if bad == "n_ragged":
            tf.fp8_gemm(a_q, a_s, b_q[:, :200], b_s)
        elif bad == "layout":
            tf.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="x")
        elif bad == "t_expanded":
            tf.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t",
                        b_scales_expanded=True)
        elif bad == "scales":
            tf.fp8_gemm(a_q, a_s[:, :1], b_q, b_s)
        else:   # the XLA family computes accum-mode math only
            tf.fp8_gemm(a_q, a_s, b_q, b_s,
                        config=GemmConfig(kernel_type=KernelType.XLA),
                        scale_mode="folded", allow_relaxed=True)


MXU = {"none": (None, None), "f16": (jnp.float16, torch.float16),
       "bf16": (jnp.bfloat16, torch.bfloat16),
       "f32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("mxu", list(MXU))
@pytest.mark.parametrize("entry,b_layout", [("fp8_gemm", "n"),
                                            ("fp8_gemm", "t"),
                                            ("with_config", "t")])
def test_mxu_dtype_matches_jax(mxu, entry, b_layout):
    """``mxu_dtype`` at None, f16, bf16 and f32: each holds e4m3 exactly,
    so JAX's cast of each group's operands changes no value; the port
    stays within the fp8 tolerance of JAX's Pallas kernel in interpret
    mode with the same type, and equals its own None output."""
    jt, tt = MXU[mxu]
    b_t = b_layout == "t"
    a_q, a_s, b_q, b_s = _operands(32, 256, 384, b_t, seed=9)
    targs = [to_torch(x) for x in (a_q, a_s, b_q, b_s)]
    if entry == "fp8_gemm":
        want = jf.fp8_gemm(a_q, a_s, b_q, b_s, out_dtype=jnp.float32,
                           b_layout=b_layout, mxu_dtype=jt)
        got = tf.fp8_gemm(*targs, out_dtype=torch.float32, b_layout=b_layout,
                          mxu_dtype=tt)
        base = tf.fp8_gemm(*targs, out_dtype=torch.float32,
                           b_layout=b_layout)
    else:
        panel = jf.expand_weight_scales(jnp.swapaxes(b_s, 0, 1), 256)
        want = jf.fp8_gemm_with_config(
            a_q, a_s, b_q, panel, config=JGemmConfig(128, 128, 128),
            out_dtype=jnp.float32, b_layout=b_layout, mxu_dtype=jt)
        tpanel = tf.expand_weight_scales(targs[3].t(), 256)
        got = tf.fp8_gemm_with_config(
            *targs[:3], tpanel, config=GemmConfig(64, 64, 128),
            out_dtype=torch.float32, b_layout=b_layout, mxu_dtype=tt)
        base = tf.fp8_gemm_with_config(
            *targs[:3], tpanel, config=GemmConfig(64, 64, 128),
            out_dtype=torch.float32, b_layout=b_layout)
    res = f32_close(to_numpy(got), np.asarray(want))
    assert res.ok, res
    assert torch.equal(got, base)


@pytest.mark.parametrize("case", ["xla_fp8_gemm", "xla_with_config",
                                  "int8", "float64"])
def test_mxu_dtype_refusals(case):
    """``KernelType.XLA`` with an mxu_dtype raises in both packages (JAX's
    message, with the type passed); a type that does not hold e4m3 exactly
    raises in the port before any work."""
    a_q, a_s, b_q, b_s = _operands(16, 128, 128, False, seed=10)
    targs = [to_torch(x) for x in (a_q, a_s, b_q, b_s)]
    xla = GemmConfig(kernel_type=KernelType.XLA)
    if case.startswith("xla"):
        panel = jf.expand_weight_scales(b_s, 128)
        with pytest.raises(ValueError) as je:
            if case == "xla_fp8_gemm":
                jf.fp8_gemm(a_q, a_s, b_q, b_s, mxu_dtype=jnp.bfloat16,
                            config=JGemmConfig(kernel_type=JKernelType.XLA))
            else:
                jf.fp8_gemm_with_config(
                    a_q, a_s, b_q, panel, mxu_dtype=jnp.bfloat16,
                    config=JGemmConfig(kernel_type=JKernelType.XLA))
        with pytest.raises(ValueError) as te:
            if case == "xla_fp8_gemm":
                tf.fp8_gemm(*targs, mxu_dtype=torch.bfloat16, config=xla)
            else:
                tf.fp8_gemm_with_config(
                    *targs[:3], tf.expand_weight_scales(targs[3], 128),
                    mxu_dtype=torch.bfloat16, config=xla)
        assert str(je.value).split("(got")[0] == \
            str(te.value).split("(got")[0]
        assert "'accum'/torch.bfloat16" in str(te.value)
        return
    bad = torch.int8 if case == "int8" else torch.float64
    for call in (lambda: tf.fp8_gemm(*targs, mxu_dtype=bad),
                 lambda: tf.fp8_gemm_with_config(
                     *targs[:3], tf.expand_weight_scales(targs[3], 128),
                     config=GemmConfig(64, 64, 128), mxu_dtype=bad)):
        with pytest.raises(ValueError, match="mxu_dtype"):
            call()


def test_auto_pad_passes_mxu_dtype_on():
    """``auto_pad`` hands mxu_dtype to the padded call, as JAX does: there
    ``KernelType.XLA`` refuses it with JAX's message, and with no config
    the output matches JAX's padded call."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(16, 200)).astype(np.float32)
    w = (rng.normal(size=(200, 200)) / 15).astype(np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    targs = [to_torch(x) for x in (a_q, a_s, b_q, b_s)]
    with pytest.raises(ValueError) as je:
        jf.fp8_gemm(a_q, a_s, b_q, b_s, auto_pad=True, mxu_dtype=jnp.float16,
                    config=JGemmConfig(kernel_type=JKernelType.XLA))
    with pytest.raises(ValueError) as te:
        tf.fp8_gemm(*targs, auto_pad=True, mxu_dtype=torch.float16,
                    config=GemmConfig(kernel_type=KernelType.XLA))
    assert str(je.value).split("(got")[0] == str(te.value).split("(got")[0]
    assert "'accum'/torch.float16" in str(te.value)
    want = jf.fp8_gemm(a_q, a_s, b_q, b_s, out_dtype=jnp.float32,
                       auto_pad=True, mxu_dtype=jnp.float16)
    got = tf.fp8_gemm(*targs, out_dtype=torch.float32, auto_pad=True,
                      mxu_dtype=torch.float16)
    assert got.shape == (16, 200)
    res = f32_close(to_numpy(got), np.asarray(want))
    assert res.ok, res


@pytest.mark.parametrize("entry", ["fp8_gemm", "with_config"])
@pytest.mark.parametrize("tile,n", [((256, 256), 256), ((128, 256), 384),
                                    ((16, 64), 256)])
def test_an_uncompiled_folded_tile_raises_on_the_cpu(entry, tile, n):
    """K12 with a caller's tile outside its compiled set (JAX's default
    GemmConfig(), K1's ring tile) or one that cannot run the output
    (128 × 256 where 256 does not divide n) raises ValueError on a CPU
    tensor as on the card, before the plain version runs."""
    a_q, a_s, b_q, b_s = (to_torch(x) for x in _operands(32, n, 256, True,
                                                          seed=12))
    cfg = GemmConfig(*tile, 128)
    before = tf.FOLDED_COUNTER.plain_calls
    with pytest.raises(ValueError, match="folded|compiled"):
        if entry == "fp8_gemm":
            tf.fp8_gemm(a_q, a_s, b_q, b_s, config=cfg, b_layout="t",
                        scale_mode="folded", allow_relaxed=True)
        else:
            tf.fp8_gemm_with_config(
                a_q, a_s, b_q, tf.expand_weight_scales(b_s.t(), n),
                config=cfg, b_layout="t", scale_mode="folded",
                allow_relaxed=True)
    assert tf.FOLDED_COUNTER.plain_calls == before
