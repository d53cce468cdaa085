"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device;
the check happens in a fixture, never at import time. On the machine with
the card, run them without the JAX conftest (that machine has no JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Tolerances: fp8 f32 outputs pass the outlier gate (rtol 2e-4, atol 1e-5
of the largest |ref|, ratio ≤ 1e-4): the kernel and the plain version sum
the same exact products in another order. fp8 bf16 outputs may differ by
one bf16 ulp (the f32 sums round to neighbouring bf16 values). The int8
kernels sum exactly in integers and round once, as the plain version does:
their valid rows must be equal bit for bit. Attention outputs agree
to 2e-3 absolute: the kernels' online softmax rounds p·v_s to bf16 against
a running max where the plain version uses the final one. Cache writes are
exact.
"""

import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu_torch.ops import _kernels, quant
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as fp8mod
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as ggmod
from deepgemm_ascend_tpu_torch.ops import int8_gemm as i8mod
from deepgemm_ascend_tpu_torch.ops.flash_decode import (
    flash_decode_gqa_inplace, flash_decode_inplace_plain)
from deepgemm_ascend_tpu_torch.ops.flash_prefill import (
    flash_prefill_gqa, flash_prefill_plain)
from torch_bridge import bf16_within_one_ulp, f32_close, to_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    return torch.device("cuda")


def _gen(seed, dev):
    return torch.Generator(device=dev).manual_seed(seed)


def assert_f32_close(got, ref):
    res = f32_close(to_numpy(got), to_numpy(ref))
    assert res.ok, res


def assert_bf16_close(got, ref):
    assert bf16_within_one_ulp(to_numpy(got), to_numpy(ref))


def _operands(m, n, k, b_t, dev, seed=0):
    g = _gen(seed, dev)
    a = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn((n, k) if b_t else (k, n), generator=g, device=dev) / k ** 0.5
    a_q, a_s = quant.quantize_fp8_act(a)
    b_q, b_s = quant.quantize_fp8_weight(w)
    return a_q, a_s, b_q, b_s


@pytest.mark.parametrize("m", [16, 100, 256])
@pytest.mark.parametrize("b_layout", ["t", "n"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_fp8_gemm_kernel_matches_plain(dev, m, b_layout, out_dtype):
    b_t = b_layout == "t"
    a_q, a_s, b_q, b_s = _operands(m, 256, 512, b_t, dev)
    got = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                          out_dtype=out_dtype)
    ref = fp8mod.fp8_gemm_plain(a_q, a_s, b_q, b_s.t() if b_t else b_s,
                                b_t=b_t, out_dtype=out_dtype)
    torch.cuda.synchronize()
    (assert_bf16_close if out_dtype == torch.bfloat16 else assert_f32_close)(
        got, ref)


def test_fp8_gemm_expanded_panel_matches_compact(dev):
    a_q, a_s, b_q, b_s = _operands(64, 256, 256, False, dev)
    panel = fp8mod.expand_weight_scales(b_s, 256)
    got = fp8mod.fp8_gemm(a_q, a_s, b_q, panel, b_scales_expanded=True,
                          out_dtype=torch.float32)
    ref = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("b_layout", ["t", "n"])
def test_grouped_masked_kernel_matches_plain(dev, b_layout):
    b_t = b_layout == "t"
    e, m_max, n, k = 4, 96, 256, 256
    g = _gen(1, dev)
    a = torch.randn(e, m_max, k, generator=g, device=dev)
    w = torch.randn((e, n, k) if b_t else (e, k, n), generator=g,
                    device=dev) / k ** 0.5
    a_q, a_s = quant.quantize_fp8_act(a)
    b_q, b_s = quant.quantize_fp8_weight(w)
    masked_m = torch.tensor([0, 5, 64, 96], dtype=torch.int32, device=dev)
    got = ggmod.m_grouped_gemm_masked(a_q, a_s, b_q, b_s, masked_m,
                                      b_layout=b_layout,
                                      out_dtype=torch.float32)
    ref = ggmod.grouped_gemm_masked_plain(
        a_q, a_s, b_q, b_s.transpose(1, 2) if b_t else b_s, masked_m,
        b_t=b_t, out_dtype=torch.float32)
    torch.cuda.synchronize()
    for ei, rows in enumerate(masked_m.tolist()):
        if rows:
            assert_f32_close(got[ei, :rows], ref[ei, :rows])
    # A tile that starts at or past masked_m is written as zeros.
    assert bool((got[0] == 0).all()) and bool((got[1, 64:] == 0).all())


def _int8_operands(a_shape, b_shape, b_t, dev, seed):
    """Per-token int8 activations and per-channel int8 weights; B given as
    (…, k, n), or (…, n, k) for b_t."""
    g = _gen(seed, dev)
    a_q, a_s = quant.quantize_int8(
        torch.randn(*a_shape, generator=g, device=dev) * 3, axis=-1)
    w = torch.randn(*b_shape, generator=g, device=dev)
    b_q, b_s = quant.quantize_int8(w, axis=-1 if b_t else -2)
    return a_q, a_s, b_q, (b_s.transpose(-1, -2) if b_t else b_s)


@pytest.mark.parametrize("mnk", [(16, 256, 512), (100, 200, 1000),
                                 (33, 384, 1008)])
@pytest.mark.parametrize("b_layout", ["t", "n"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_gemm_kernel_matches_plain_bit_for_bit(dev, mnk, b_layout,
                                                    out_dtype):
    """Decode m, ragged m/n/k (byte loads) and a K tail inside the last
    128-deep step (16-byte loads)."""
    m, n, k = mnk
    b_t = b_layout == "t"
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k) if b_t else (k, n),
                                        b_t, dev, seed=6)
    got = i8mod.int8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                          out_dtype=out_dtype)
    ref = i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s, b_t=b_t,
                                out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, ref)


@pytest.mark.parametrize("block_m", [32, 96, 128])
@pytest.mark.parametrize("b_layout", ["t", "n"])
def test_int8_contiguous_kernel_matches_plain_bit_for_bit(dev, block_m,
                                                          b_layout):
    """Layout tiles smaller than, not a multiple of, and larger than the
    kernel's 64-row tile; a padding tile (-1) comes out zero."""
    b_t = b_layout == "t"
    e, n, k = 3, 192, 320
    _, gids, _ = ggmod.make_contiguous_layout([70, 0, 130], block_m)
    gids = torch.from_numpy(np.append(gids, -1).astype(np.int32))
    m = gids.numel() * block_m
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (e, n, k) if b_t
                                        else (e, k, n), b_t, dev, seed=7)
    got = i8mod.m_grouped_int8_gemm_contiguous(
        a_q, a_s, b_q, b_s, gids, b_layout=b_layout)
    ref = i8mod.grouped_contiguous_plain(a_q, a_s, b_q, b_s, gids, b_t=b_t)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool((got[-block_m:] == 0).all())


@pytest.mark.parametrize("b_layout", ["t", "n"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_masked_kernel_matches_plain_bit_for_bit(dev, b_layout,
                                                      out_dtype):
    b_t = b_layout == "t"
    e, m_max, n, k = 4, 96, 256, 200
    a_q, a_s, b_q, b_s = _int8_operands((e, m_max, k), (e, n, k) if b_t
                                        else (e, k, n), b_t, dev, seed=8)
    masked_m = torch.tensor([0, 5, 64, 96], dtype=torch.int32, device=dev)
    got = i8mod.m_grouped_int8_gemm_masked(a_q, a_s, b_q, b_s, masked_m,
                                           b_layout=b_layout,
                                           out_dtype=out_dtype)
    ref = i8mod.grouped_masked_plain(a_q, a_s, b_q, b_s, masked_m, b_t=b_t,
                                     out_dtype=out_dtype)
    torch.cuda.synchronize()
    for ei, rows in enumerate(masked_m.tolist()):
        assert torch.equal(got[ei, :rows], ref[ei, :rows])
    # A 64-row tile that starts at or past masked_m is written as zeros.
    assert bool((got[0] == 0).all()) and bool((got[1, 64:] == 0).all())
    assert bool((got[2, 64:] == 0).all())


def _cache(b, kvh, s_max, hd, dev, seed):
    g = _gen(seed, dev)
    k_q = torch.randint(-127, 128, (b, kvh, s_max, hd), generator=g,
                        device=dev, dtype=torch.int8)
    v_q = torch.randint(-127, 128, (b, kvh, s_max, hd), generator=g,
                        device=dev, dtype=torch.int8)
    k_s = torch.rand(b, kvh, s_max, generator=g, device=dev) * 0.02 + 1e-3
    v_s = torch.rand(b, kvh, s_max, generator=g, device=dev) * 0.02 + 1e-3
    return k_q, k_s, v_q, v_s


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("split_keys", [128, 512])
def test_flash_decode_kernel_matches_plain(dev, g, split_keys, monkeypatch):
    """5 spans of 128 keys (lengths ending mid-span and on a span edge)
    and one span of 512 for the whole 320-key cache."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    monkeypatch.setattr(fdmod, "SPLIT_KEYS", split_keys)
    b, kvh, s_max, hd = 4, 2, 320, 128
    k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, hd, dev, 2)
    gen = _gen(3, dev)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=dev).to(torch.bfloat16)
    k_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                          dtype=torch.int8)
    v_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                          dtype=torch.int8)
    ks_new = torch.rand(b, kvh, generator=gen, device=dev) * 0.02
    vs_new = torch.rand(b, kvh, generator=gen, device=dev) * 0.02
    # 1 token, a ragged length, a full cache, and a freed slot past S.
    lens = torch.tensor([1, 256, s_max, s_max + 7], dtype=torch.int32,
                        device=dev)
    caches_k = [t.clone() for t in (k_q, k_s, v_q, v_s)]
    caches_p = [t.clone() for t in (k_q, k_s, v_q, v_s)]
    out, *new_k = flash_decode_gqa_inplace(
        q, caches_k[0], caches_k[1], caches_k[2], caches_k[3], k_new, v_new,
        ks_new, vs_new, lens)
    ref = flash_decode_inplace_plain(
        q, caches_p[0], caches_p[1], caches_p[2], caches_p[3], k_new, v_new,
        ks_new, vs_new, lens.clamp(max=s_max)).reshape(b, kvh * g, hd)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 2e-3
    for got_c, ref_c in zip(caches_k, caches_p):
        assert torch.equal(got_c, ref_c)
    assert new_k[0] is caches_k[0]


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("start", [0, 100, -8])
def test_flash_prefill_kernel_matches_plain(dev, g, start):
    b, kvh, s, s_max, hd = 2, 2, 64, 256, 128
    k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, hd, dev, 4)
    q = torch.randn(b, s, kvh * g, hd, generator=_gen(5, dev),
                    device=dev).to(torch.bfloat16)
    st = torch.tensor([start, max(start, 0) + 3], dtype=torch.int32,
                      device=dev)
    lens = st.clamp(min=0) + s
    got = flash_prefill_gqa(q, k_q, k_s, v_q, v_s, st, lens)
    qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
    ref = flash_prefill_plain(qg, k_q, k_s, v_q, v_s, st, lens)
    ref = ref.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) < 2e-3
