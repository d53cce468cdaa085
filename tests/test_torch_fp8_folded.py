"""Port fp8_gemm with ``scale_mode="folded"`` (K12's CPU path) vs the JAX
package's.

The JAX side runs its folded Pallas kernel in interpret mode on the CPU;
the port runs K12's plain version. Both fold the scales into the operands
in f32 and round them to bf16 the same way, so they differ only in the
order of the f32 sums: f32 outputs within 1e-5 of Σ|a_sc·b_sc| (the sum of
the magnitudes of the bf16 products), bf16 outputs within one bf16 ulp.
Against the accum mode (K1), JAX's own contract: rel-L2 < 5e-3.
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
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import bf16_within_one_ulp, to_numpy, to_torch

FOLDED = dict(scale_mode="folded", allow_relaxed=True)


def _operands(m, n, k, b_t, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_t(df=4, size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(n, k) if b_t else (k, n)) / k ** 0.5).astype(
        np.float32)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(a))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(w))
    return a_q, a_s, b_q, b_s


def _folded_magnitudes(a_q, a_s, b_q, b_s, b_t):
    """Σ|a_sc·b_sc| per output, from the bf16-folded operands."""
    bs = to_torch(b_s).t() if b_t else to_torch(b_s)
    a, b = tf.fold_operands(to_torch(a_q), to_torch(a_s), to_torch(b_q), bs,
                            b_t=b_t)
    return (a.float().abs() @ b.float().abs()).numpy()


def _torch_args(a_q, a_s, b_q, b_s):
    return to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s)


@pytest.mark.parametrize("m,n,k", [(16, 256, 256), (100, 384, 512),
                                   (64, 128, 1024)])
@pytest.mark.parametrize("b_layout", ["n", "t"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_folded_matches_jax(m, n, k, b_layout, out):
    jd, td = ((jnp.float32, torch.float32) if out == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    b_t = b_layout == "t"
    ops = _operands(m, n, k, b_t, seed=m + n)
    want = np.asarray(jf.fp8_gemm(*ops, out_dtype=jd, b_layout=b_layout,
                                  **FOLDED), np.float32)
    got = to_numpy(tf.fp8_gemm(*_torch_args(*ops), out_dtype=td,
                               b_layout=b_layout, **FOLDED))
    if out == "f32":
        tol = 1e-5 * _folded_magnitudes(*ops, b_t)
        assert np.all(np.abs(got - want) <= tol)
    else:
        assert bf16_within_one_ulp(got, want)
    accum = to_numpy(tf.fp8_gemm(*_torch_args(*ops), out_dtype=torch.float32,
                                 b_layout=b_layout))
    assert verify.relative_l2_error(got, accum) < 5e-3


def test_folded_expanded_panel_matches_jax():
    """fp8_gemm_with_config with the lane-expanded (k/128, n) panel, and
    fp8_gemm with b_scales_expanded=True."""
    ops = _operands(32, 256, 384, False, seed=2)
    a_q, a_s, b_q, b_s = ops
    panel = jf.expand_weight_scales(b_s, 256)
    want = np.asarray(jf.fp8_gemm_with_config(
        a_q, a_s, b_q, panel, config=JGemmConfig(128, 128, 128),
        out_dtype=jnp.float32, **FOLDED))
    tpanel = tf.expand_weight_scales(to_torch(b_s), 256)
    got = to_numpy(tf.fp8_gemm_with_config(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), tpanel,
        config=GemmConfig(128, 128, 128), out_dtype=torch.float32, **FOLDED))
    assert np.all(np.abs(got - want)
                  <= 1e-5 * _folded_magnitudes(*ops, False))
    got2 = to_numpy(tf.fp8_gemm(to_torch(a_q), to_torch(a_s), to_torch(b_q),
                                tpanel, b_scales_expanded=True,
                                out_dtype=torch.float32, **FOLDED))
    assert np.array_equal(got, got2)


def test_folded_auto_pad_matches_jax():
    """A ragged n/k lifted by auto_pad keeps the folded mode."""
    ops = _operands(16, 200, 320, True, seed=5)
    want = np.asarray(jf.fp8_gemm(*ops, out_dtype=jnp.float32, b_layout="t",
                                  auto_pad=True, **FOLDED))
    got = to_numpy(tf.fp8_gemm(*_torch_args(*ops), out_dtype=torch.float32,
                               b_layout="t", auto_pad=True, **FOLDED))
    assert got.shape == want.shape == (16, 200)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["fp8_gemm", "with_config"])
def test_relaxed_gate_message_matches_jax(entry):
    ops = _operands(16, 128, 128, False, seed=3)
    with pytest.raises(ValueError) as je:
        if entry == "fp8_gemm":
            jf.fp8_gemm(*ops, scale_mode="folded")
        else:
            jf.fp8_gemm_with_config(*ops[:3], jf.expand_weight_scales(
                ops[3], 128), config=JGemmConfig(), scale_mode="folded")
    targs = _torch_args(*ops)
    with pytest.raises(ValueError) as te:
        if entry == "fp8_gemm":
            tf.fp8_gemm(*targs, scale_mode="folded")
        else:
            tf.fp8_gemm_with_config(*targs[:3], tf.expand_weight_scales(
                targs[3], 128), config=GemmConfig(), scale_mode="folded")
    assert str(je.value) == str(te.value)
    assert "allow_relaxed=True" in str(te.value)


@pytest.mark.parametrize("b_layout", ["n", "t"])
def test_exact_mode_wins_over_folded(b_layout):
    """Under exact_mode both packages compute the exact golden in either
    mode; the relaxed gate still runs first."""
    b_t = b_layout == "t"
    ops = _operands(48, 256, 384, b_t, seed=4)
    with jf.exact_mode():
        want = np.asarray(jf.fp8_gemm(*ops, out_dtype=jnp.float32,
                                      b_layout=b_layout, **FOLDED))
    targs = _torch_args(*ops)
    with tf.exact_mode():
        got = to_numpy(tf.fp8_gemm(*targs, out_dtype=torch.float32,
                                   b_layout=b_layout, **FOLDED))
        exact = to_numpy(tf.fp8_gemm(*targs, out_dtype=torch.float32,
                                     b_layout=b_layout))
        with pytest.raises(ValueError, match="allow_relaxed"):
            tf.fp8_gemm(*targs, b_layout=b_layout, scale_mode="folded")
    assert np.array_equal(got, exact)
    assert verify.relative_l2_error(got, want) < 1e-6


def test_xla_config_rejects_folded_like_jax():
    """KernelType.XLA + folded: JAX's ValueError, before the port's
    NotImplementedError for XLA itself."""
    ops = _operands(16, 128, 128, False, seed=6)
    with pytest.raises(ValueError) as je:
        jf.fp8_gemm(*ops, config=JGemmConfig(kernel_type=JKernelType.XLA),
                    **FOLDED)
    targs = _torch_args(*ops)
    xla = GemmConfig(kernel_type=KernelType.XLA)
    with pytest.raises(ValueError) as te:
        tf.fp8_gemm(*targs, config=xla, **FOLDED)
    assert str(je.value) == str(te.value)
    with pytest.raises(ValueError) as te2:
        tf.fp8_gemm_with_config(*targs[:3], tf.expand_weight_scales(
            targs[3], 128), config=xla, **FOLDED)
    assert str(te2.value) == str(je.value)
    with pytest.raises(NotImplementedError):
        tf.fp8_gemm(*targs, config=xla)


def test_unknown_scale_mode_raises():
    targs = _torch_args(*_operands(16, 128, 128, False, seed=7))
    with pytest.raises(ValueError, match="scale_mode must be one of"):
        tf.fp8_gemm(*targs, scale_mode="fold", allow_relaxed=True)


def test_folded_cpu_path_counts_its_own_plain_calls():
    targs = _torch_args(*_operands(16, 128, 128, True, seed=8))
    folded, accum = (_kernels.COUNTERS[n] for n in ("fp8_gemm_folded",
                                                     "fp8_gemm"))
    before = (folded.launches, folded.plain_calls, accum.plain_calls)
    tf.fp8_gemm(*targs, b_layout="t", **FOLDED)
    assert (folded.launches, folded.plain_calls, accum.plain_calls) == (
        before[0], before[1] + 1, before[2])
