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
their valid rows must be equal bit for bit. The dense GEMMs (K10, K11)
sum exact products of bf16/fp16 inputs (or f32 FMAs) in f32 in another
order than the plain version's f32 matmul: each f32 output lies within
1e-5 of Σ|a·b| of it (the bound of a reordered f32 sum over K ≤ 11008 is
K·2⁻²⁴ ≈ 6.6e-4 of Σ|a·b|; random rounding errors grow as √K, ~6e-6), and
each bf16/fp16 output, rounded once from such a sum, within that plus one
ulp of its type. K8 keeps K1/K3's group arithmetic on both its routes
(route wgmma16: f16 wgmma, which the probe test shows sums a group as
mma.sync does): one bf16 ulp from its plain version, and equal bit for bit
to K3 and to its tile route on the same rows. Attention outputs agree
to 2e-3 absolute: the kernels' online softmax rounds p·v_s to bf16 against
a running max where the plain version uses the final one. Cache writes are
exact.
"""

import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType, SwizzleDir
from deepgemm_ascend_tpu_torch.ops import _kernels, quant
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as fp8mod
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as ggmod
from deepgemm_ascend_tpu_torch.ops import int8_gemm as i8mod
from deepgemm_ascend_tpu_torch.ops.flash_common import (PV_ROUNDING,
                                                        output_close,
                                                        state_close)
from deepgemm_ascend_tpu_torch.ops.flash_decode import (
    flash_decode_gqa_inplace, flash_decode_inplace_plain, merge_current_token)
from deepgemm_ascend_tpu_torch.ops.flash_prefill import (
    flash_prefill_gqa, flash_prefill_plain)
from deepgemm_ascend_tpu_torch.ops.gemm import (ROUTES, bgemm, gemm,
                                                gemm_ksplit_plain,
                                                gemm_plain, gemm_with_config,
                                                ksplit_partials_plain, route,
                                                split_ranges)
from deepgemm_ascend_tpu_torch.tiling import analytic
from deepgemm_ascend_tpu_torch.tiling import cache as cachemod
from deepgemm_ascend_tpu_torch.tiling.selector import select_config
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


# ---- K1 and K3 on the ring route (TMA ring of scale groups) and the tile
# route: one element's arithmetic, so without splits the same bits.

RING_MS = [1, 16, 33, 64, 100, 256, 2048]


@pytest.mark.parametrize("m", RING_MS)
@pytest.mark.parametrize("tile", range(len(fp8mod.RING_TILES)))
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_fp8_gemm_ring_equals_tile_bit_for_bit(dev, m, tile, out_dtype):
    """Every ring tile at every m, unsplit, against the tile route on the
    same weights stored (k, n): equal bit for bit (rows past m, and m16
    fragments past them inside a tile, are skipped)."""
    n, k = 256, 512
    a_q, a_s, b_q, b_s = _operands(m, n, k, True, dev, seed=m)
    b_kn = b_q.t().contiguous()
    assert fp8mod.route(a_q, b_q, "t") == "ring"
    assert fp8mod.route(a_q, b_kn, "n") == "tile"
    want = fp8mod.fp8_gemm(a_q, a_s, b_kn, b_s.t().contiguous(),
                           b_layout="n", out_dtype=out_dtype)
    got = fp8mod._launch(a_q, a_s, b_q, b_s.t(), fp8mod._SHIFT, True,
                         out_dtype, plan=("ring", tile, 1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 16, 64])
@pytest.mark.parametrize("nk", [(2048, 2048), (512, 2048), (22016, 2048),
                                (2048, 11008), (2816, 2048), (2048, 1408)])
def test_fp8_gemm_ring_plan_at_model_shapes(dev, m, nk):
    """The wrapper's own plan (splits where the tiles are few) at V2_LITE's
    projection shapes: within one bf16 ulp of the plain version, and
    within the f32 gate with f32 output."""
    n, k = nk
    a_q, a_s, b_q, b_s = _operands(m, n, k, True, dev, seed=n + k)
    for out_dtype, close in ((torch.bfloat16, assert_bf16_close),
                             (torch.float32, assert_f32_close)):
        got = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t",
                              out_dtype=out_dtype)
        ref = fp8mod.fp8_gemm_plain(a_q, a_s, b_q, b_s.t(), b_t=True,
                                    out_dtype=out_dtype)
        torch.cuda.synchronize()
        close(got, ref)


@pytest.mark.parametrize("splits", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("tile,m", [(0, 16), (1, 64), (1, 256)])
def test_fp8_gemm_ring_splits_within_tolerance(dev, splits, tile, m):
    """Each split count on each tile, k = 9 groups (4 splits leave the last
    one empty): the f32 sum changes order only, so the outputs stay within
    the checks of the unsplit kernel."""
    n, k = 256, 9 * 128
    a_q, a_s, b_q, b_s = _operands(m, n, k, True, dev, seed=splits)
    for out_dtype, close in ((torch.bfloat16, assert_bf16_close),
                             (torch.float32, assert_f32_close)):
        got = fp8mod._launch(a_q, a_s, b_q, b_s.t(), fp8mod._SHIFT, True,
                             out_dtype, plan=("ring", tile, splits))
        ref = fp8mod.fp8_gemm_plain(a_q, a_s, b_q, b_s.t(), b_t=True,
                                    out_dtype=out_dtype)
        torch.cuda.synchronize()
        close(got, ref)


def _masked_operands(m_max, loads, dev, seed):
    e, n, k = len(loads), 256, 384
    g = _gen(seed, dev)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(e, m_max, k, generator=g, device=dev))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=dev) / k ** 0.5)
    masked_m = torch.tensor(loads, dtype=torch.int32, device=dev)
    return a_q, a_s, b_q, b_s, masked_m


@pytest.mark.parametrize("m_max", [96, 400, 1100])
@pytest.mark.parametrize("tile", [None, 0, 1])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_masked_ring_equals_tile_bit_for_bit(dev, m_max, tile,
                                                     out_dtype):
    """K3 on every ring tile (None: the wrapper's own) against the tile
    route on the same weights stored (E, k, n), with masked_m of 0, 1, 15,
    16, 64 and every row: the valid rows equal bit for bit, and every tile
    at or past masked_m[e] zero on both routes."""
    loads = [0, 1, 15, 16, 64, m_max]
    a_q, a_s, b_q, b_s, masked_m = _masked_operands(m_max, loads, dev,
                                                    seed=m_max)
    b_kn = b_q.transpose(1, 2).contiguous()
    assert ggmod.route(a_q, b_q, "t") == "ring"
    assert ggmod.route(a_q, b_kn, "n") == "tile"
    want = ggmod.m_grouped_gemm_masked(a_q, a_s, b_kn,
                                       b_s.transpose(1, 2).contiguous(),
                                       masked_m, b_layout="n",
                                       out_dtype=out_dtype)
    plan = None if tile is None else ("ring", tile)
    got = ggmod._launch(a_q, a_s, b_q, b_s.transpose(1, 2), fp8mod._SHIFT,
                        masked_m, True, out_dtype, plan=plan)
    torch.cuda.synchronize()
    bm = fp8mod.RING_TILES[analytic.masked_ring_tile(m_max) if tile is None
                           else tile][0]
    for e, rows in enumerate(loads):
        assert torch.equal(got[e, :rows], want[e, :rows]), e
        assert bool((got[e, -(-rows // bm) * bm:] == 0).all()), e
        assert bool((want[e, -(-rows // 64) * 64:] == 0).all()), e


def test_fp8_entries_refuse_what_they_cannot_run(dev):
    """K1's and K3's C entries refuse the ring for B stored (k, n) and for
    an operand TMA cannot describe (a pointer off 16 bytes), an unknown
    route, tile or split count, and a split on the tile route; the tile
    route takes B stored (k, n). K8's wrapper refuses an offset A."""
    m, n, k = 16, 256, 512
    a_q, a_s, b_q, b_s = _operands(m, n, k, True, dev, seed=11)
    bs = b_s.t()
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    entry = _kernels.entry("fp8_gemm")
    stream = _kernels.stream_ptr(dev)
    flat = torch.zeros(m * k + 1, dtype=torch.uint8, device=dev)
    shifted = flat[1:].view(m, k).view(a_q.dtype)
    shifted.copy_(a_q)
    assert fp8mod.route(shifted, b_q, "t") == "tile"
    b_kn = b_q.t().contiguous()
    bs_kn = bs.contiguous()

    def args(a, b, strides, scales):
        return (a.data_ptr(), a_s.data_ptr(), b.data_ptr(), scales.data_ptr(),
                out.data_ptr(), m, n, k, *strides, scales.stride(0),
                scales.stride(1), fp8mod._SHIFT, 0)

    assert entry(*args(a_q, b_kn, (n, 1), bs_kn), 1, 0, 1, stream) != 0
    assert entry(*args(a_q, b_kn, (n, 1), bs_kn), 0, 0, 1, stream) == 0
    torch.cuda.synchronize()
    assert_bf16_close(out, fp8mod.fp8_gemm_plain(a_q, a_s, b_kn, bs_kn))
    # The offset A: the ring refuses it before any launch, and the wrapper
    # raises (the tile route reads A in 16-byte words too).
    assert entry(*args(shifted, b_q, (1, k), bs), 1, 0, 1, stream) != 0
    with pytest.raises(ValueError, match="16-byte"):
        fp8mod.fp8_gemm(shifted, a_s, b_q, b_s, b_layout="t")
    ok = args(a_q, b_q, (1, k), bs)
    assert entry(*ok, 1, 0, 1, stream) == 0
    for bad in ((2, 0, 1), (1, 2, 1), (1, -1, 1), (1, 0, 0), (1, 0, 9),
                (0, 0, 2)):
        assert entry(*ok, *bad, stream) != 0, bad
    torch.cuda.synchronize()
    # K3: the ring refuses B stored (E, k, n); the tile route takes it.
    a3, as3, b3, bs3, mm = _masked_operands(32, [5, 32], dev, seed=12)
    b3_kn = b3.transpose(1, 2).contiguous()
    bs3_kn = bs3.transpose(1, 2).contiguous()
    out3 = torch.empty(2, 32, n, dtype=torch.bfloat16, device=dev)
    k3 = _kernels.entry("grouped_gemm")
    kk = a3.shape[-1]
    args3 = (a3.data_ptr(), as3.data_ptr(), b3_kn.data_ptr(),
             bs3_kn.data_ptr(), mm.data_ptr(), out3.data_ptr(), 2, 32, n, kk,
             b3_kn.stride(0), n, 1, bs3_kn.stride(0), bs3_kn.stride(1),
             bs3_kn.stride(2), fp8mod._SHIFT, 0)
    assert k3(*args3, 1, 0, stream) != 0
    assert k3(*args3, 2, 0, stream) != 0
    assert k3(*args3, 0, 0, stream) == 0
    torch.cuda.synchronize()
    # K8 reads A in 16-byte words as the tile route does: an offset A
    # raises before any launch, and the aligned one still runs.
    a8, as8, b8, bs8, gids = _contiguous_operands(128, True, dev, 13)
    flat8 = torch.zeros(a8.numel() + 1, dtype=torch.uint8, device=dev)
    a8_off = flat8[1:].view(a8.shape).view(a8.dtype)
    a8_off.copy_(a8)
    with pytest.raises(ValueError, match="16-byte"):
        ggmod.m_grouped_gemm_contiguous(a8_off, as8, b8, bs8, gids,
                                        b_layout="t")
    ggmod.m_grouped_gemm_contiguous(a8, as8, b8, bs8, gids, b_layout="t")
    torch.cuda.synchronize()


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


# ---- K6 on its ring and wgmma routes


@pytest.mark.parametrize("plan", [("ring", 0), ("wgmma", 0), ("wgmma", 1)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("loads", ["none", "full", "mixed"])
def test_int8_masked_routes_match_plain_and_tile(dev, plan, out_dtype, loads):
    """Every new route and tile of K6 (B stored (E, n, k)) bit-equal to the
    plain version and to int8_tile on the valid rows, for masked_m all 0,
    all M_max, and mixed (0, 1, a tile edge + 1, most rows); every tile
    that starts at or past masked_m[e] is zeros. n = 320 ends inside a 64-
    and a 256-column tile, k = 208 inside the second 128-deep stage, and
    M_max = 272 inside a 128-row tile."""
    e, m_max, n, k = 4, 272, 320, 208
    a_q, a_s, b_q, b_s = _int8_operands((e, m_max, k), (e, n, k), True, dev,
                                        seed=11)
    rows = {"none": [0] * e, "full": [m_max] * e,
            "mixed": [0, 1, 17, 200]}[loads]
    masked_m = torch.tensor(rows, dtype=torch.int32, device=dev)
    k6 = _kernels.COUNTERS["int8_grouped_masked"]
    k6.plans.clear()
    got = i8mod._launch_masked(a_q, a_s, b_q, b_s, masked_m, True, out_dtype,
                               plan=plan)
    tile = i8mod._launch_masked(a_q, a_s, b_q, b_s, masked_m, True,
                                out_dtype, plan=("int8_tile", 0))
    ref = i8mod.grouped_masked_plain(a_q, a_s, b_q, b_s, masked_m, b_t=True,
                                     out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert k6.plans == {i8mod.masked_plan_label(*plan): 1, "int8_tile": 1}
    bm = 16 if plan[0] == "ring" else i8mod.MASKED_WGMMA_TILES[plan[1]][0]
    for ei, r in enumerate(rows):
        assert torch.equal(got[ei, :r], ref[ei, :r]), ei
        assert torch.equal(got[ei, :r], tile[ei, :r]), ei
        assert bool((got[ei, -(-r // bm) * bm:] == 0).all()), ei


def test_int8_masked_plan_follows_the_hint(dev):
    """At V2_LITE's decode shape the MoE layer's hint (3 rows an expert)
    takes the ring, a short prefill's (24 rows) the 64 x 64 wgmma tile, a
    long prefill's the 128 x 256 tile; 'n' stays on int8_tile. Each is
    bit-equal to the plain version."""
    e, m_max, n, k = 32, 96, 2816, 2048
    a_q, a_s, b_q, b_s = _int8_operands((e, m_max, k), (e, n, k), True, dev,
                                        seed=12)
    masked_m = torch.randint(0, 8, (e,), dtype=torch.int32, device=dev)
    k6 = _kernels.COUNTERS["int8_grouped_masked"]
    ref = i8mod.grouped_masked_plain(a_q, a_s, b_q, b_s, masked_m, b_t=True)
    b_kn = b_q.transpose(1, 2).contiguous()
    for kw, b, label in ((dict(b_layout="t", expected_m=3), b_q,
                          "ring 16x64"),
                         (dict(b_layout="t", expected_m=24), b_q,
                          "wgmma 64x64"),
                         (dict(b_layout="t", expected_m=384), b_q,
                          "wgmma 128x256"),
                         (dict(b_layout="n", expected_m=3), b_kn,
                          "int8_tile")):
        k6.plans.clear()
        got = i8mod.m_grouped_int8_gemm_masked(a_q, a_s, b, b_s, masked_m,
                                               **kw)
        torch.cuda.synchronize()
        assert list(k6.plans) == [label]
        for ei, r in enumerate(masked_m.tolist()):
            assert torch.equal(got[ei, :r], ref[ei, :r]), (label, ei)


def test_int8_masked_entry_refuses_what_it_cannot_run(dev):
    """Routes 1 and 2 refuse B stored (k, n) and an unknown wgmma tile;
    int8_tile takes B stored (k, n)."""
    e, m_max, n, k = 2, 32, 128, 256
    a_q, a_s, b_q, b_s = _int8_operands((e, m_max, k), (e, k, n), False, dev,
                                        seed=13)
    mm = torch.tensor([3, 32], dtype=torch.int32, device=dev)
    out = torch.empty(e, m_max, n, dtype=torch.bfloat16, device=dev)
    entry = _kernels.entry("int8_grouped_masked")
    stream = _kernels.stream_ptr(dev)
    args = (a_q.data_ptr(), a_s.contiguous().data_ptr(), b_q.data_ptr(),
            b_s.contiguous().data_ptr(), mm.data_ptr(), out.data_ptr(), e,
            m_max, n, k, n * k, n, 1, 0)
    assert entry(*args, 1, 0, stream) != 0
    assert entry(*args, 2, 0, stream) != 0
    kmajor = args[:11] + (1, k, 0)
    assert entry(*kmajor, 2, 2, stream) != 0
    assert entry(*args, 0, 0, stream) == 0
    torch.cuda.synchronize()
    want = i8mod.grouped_masked_plain(a_q, a_s, b_q, b_s, mm)
    for ei, r in enumerate(mm.tolist()):
        assert torch.equal(out[ei, :r], want[ei, :r])


# ---- K7 on the wgmma route (TMA + wgmma s8, csrc/sm90_gemm.cuh)


@pytest.mark.parametrize("n", [328, 4000])
@pytest.mark.parametrize("k", [16, 144, 2048])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_gemm_wgmma_route_matches_plain_bit_for_bit(dev, n, k,
                                                         out_dtype):
    """B stored (n, k) with k a multiple of 16 takes the wgmma route. Every
    m the two tiles meet: 1 and 16 (decode), 33, 64 and 65 (the 64-row
    tile's edge), 2048 (16 row tiles: 128 x 256 tiles at n = 4000); n not a
    multiple of 256 (an N edge inside the last tile); k one stage's first
    16 bytes, a K tail inside the second 128-deep stage, and 16 stages. The
    s32 sums are exact, so the result equals the plain version bit for
    bit."""
    for m in (1, 16, 33, 64, 65, 2048):
        a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k), True, dev,
                                            seed=m + k)
        assert i8mod.route(a_q, b_q, "t") == "wgmma"
        k7 = _kernels.COUNTERS["int8_gemm"]
        before = k7.launches
        got = i8mod.int8_gemm(a_q, a_s, b_q, b_s, b_layout="t",
                              out_dtype=out_dtype)
        ref = i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s, b_t=True,
                                    out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert k7.launches == before + 1
        assert got.dtype == out_dtype and torch.equal(got, ref), m


@pytest.mark.parametrize("m", [16, 2048])
def test_int8_gemm_n_layout_stays_on_int8_tile(dev, m):
    """B stored (k, n) cannot take wgmma (8-bit operands K-major only): the
    route is int8_tile, bit-equal to the plain version."""
    n, k = 2048, 2048
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (k, n), False, dev, seed=9)
    assert i8mod.route(a_q, b_q, "n") == "int8_tile"
    got = i8mod.int8_gemm(a_q, a_s, b_q, b_s, b_layout="n")
    ref = i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_int8_gemm_refuses_a_route_it_cannot_take(dev):
    """The C entry refuses the wgmma route for B stored (k, n) and for an
    operand TMA cannot describe (a pointer off 16 bytes); int8_tile takes
    both."""
    m, n, k = 16, 256, 512
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k), True, dev, seed=10)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    entry = _kernels.entry("int8_gemm")
    stream = _kernels.stream_ptr(dev)
    flat = torch.zeros(m * k + 1, dtype=torch.int8, device=dev)
    shifted = flat[1:].view(m, k)
    shifted.copy_(a_q)
    assert i8mod.route(shifted, b_q, "t") == "int8_tile"
    cases = {"b (k, n)": (a_q, b_q.t().contiguous(), (n, 1)),
             "a off 16 bytes": (shifted, b_q, (1, k))}
    for label, (a, b, strides) in cases.items():
        args = (a.data_ptr(), a_s.data_ptr(), b.data_ptr(), b_s.data_ptr(),
                out.data_ptr(), m, n, k, *strides, 0)
        assert entry(*args, 1, 0, stream) != 0, label
        assert entry(*args, 0, 0, stream) == 0, label
        torch.cuda.synchronize()
        b_t = label != "b (k, n)"
        want = i8mod.int8_gemm_plain(a, a_s, b, b_s, b_t=b_t)
        assert torch.equal(out, want), label


def _cache(b, kvh, s_max, hd, dev, seed):
    g = _gen(seed, dev)
    k_q = torch.randint(-127, 128, (b, kvh, s_max, hd), generator=g,
                        device=dev, dtype=torch.int8)
    v_q = torch.randint(-127, 128, (b, kvh, s_max, hd), generator=g,
                        device=dev, dtype=torch.int8)
    k_s = torch.rand(b, kvh, s_max, generator=g, device=dev) * 0.02 + 1e-3
    v_s = torch.rand(b, kvh, s_max, generator=g, device=dev) * 0.02 + 1e-3
    return k_q, k_s, v_q, v_s


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("blocks", [9, 64])
def test_flash_decode_kernel_matches_plain(dev, g, blocks):
    """K2's route "live" on a grid of one block per (batch, kv head) and
    one to spare (a quota of every live chunk), and of 64 blocks (one or
    two chunks each), over a 320-key cache (lengths ending mid-chunk and on
    a chunk edge)."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
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
    out, *new_k = fdmod._launch_inplace(
        q, caches_k[0], caches_k[1], caches_k[2], caches_k[3], k_new, v_new,
        ks_new, vs_new, lens, plan=("live", blocks))
    ref = flash_decode_inplace_plain(
        q, caches_p[0], caches_p[1], caches_p[2], caches_p[3], k_new, v_new,
        ks_new, vs_new, lens.clamp(max=s_max)).reshape(b, kvh * g, hd)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 2e-3
    for got_c, ref_c in zip(caches_k, caches_p):
        assert torch.equal(got_c, ref_c)
    assert new_k[0] is caches_k[0]


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_flash_decode_live_route_matches_plain_and_span(dev, g):
    """K2 takes route "live" on its own plan; against its plain version and
    against route "span" on the same inputs the output agrees within 2e-3
    and per element within (2⁻⁷ + 2⁻¹²)·Σ w·|v|, and the three caches are
    equal. Lengths: empty, one token, a chunk's edges, ragged, S and past S
    (a freed slot)."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    b, kvh, s_max, hd = 7, 2, 320, 128
    cache = _cache(b, kvh, s_max, hd, dev, 31)
    gen = _gen(32, dev)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=dev).to(torch.bfloat16)
    new = (torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3,
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3)
    lens = torch.tensor([0, 1, 64, 65, 200, s_max, s_max + 3],
                        dtype=torch.int32, device=dev)
    live, span, plain = ([t.clone() for t in cache] for _ in range(3))
    counter = _kernels.COUNTERS["flash_decode"]
    counter.plans.clear()
    got = flash_decode_gqa_inplace(q, *live, *new, lens)[0]
    assert list(counter.plans) == [
        f"live/{fdmod.live_blocks(b, kvh, s_max, 132)}"]
    by_span = fdmod._launch_inplace(q, *span, *new, lens,
                                    plan=("span", 128))[0]
    clamped = lens.clamp(max=s_max)
    ref = flash_decode_inplace_plain(q, *plain, *new, clamped).reshape(
        b, kvh * g, hd)
    pv = fdmod.flash_decode_plain(q, *_abs_v(plain), clamped).reshape(
        b, kvh * g, hd)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) < 2e-3
    assert output_close(got, ref, pv)
    assert float((got - by_span).abs().max()) < 2e-3
    assert not got[0].any()
    for x, y, z in zip(live, span, plain):
        assert torch.equal(x, z) and torch.equal(y, z)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_flash_decode_span_route_at_head_dim_64(dev, g):
    """At head size 64 K2 takes route "span" (route "live" is built for
    128): against its plain version the output agrees within 2e-3 and per
    element within (2⁻⁷ + 2⁻¹²)·Σ w·|v|, and the caches are equal. Lengths:
    empty, one token, a chunk's edges, ragged, S and past S."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    b, kvh, s_max, hd = 7, 2, 320, 64
    cache = _cache(b, kvh, s_max, hd, dev, 33)
    gen = _gen(34, dev)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=dev).to(torch.bfloat16)
    new = (torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3,
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3)
    lens = torch.tensor([0, 1, 128, 129, 200, s_max, s_max + 3],
                        dtype=torch.int32, device=dev)
    span, plain = ([t.clone() for t in cache] for _ in range(2))
    counter = _kernels.COUNTERS["flash_decode"]
    counter.plans.clear()
    before = (counter.launches, counter.plain_calls)
    got = flash_decode_gqa_inplace(q, *span, *new, lens)[0]
    assert (counter.launches, counter.plain_calls) == (before[0] + 1,
                                                       before[1])
    assert list(counter.plans) == [f"span/{fdmod.SPLIT_KEYS}"]
    clamped = lens.clamp(max=s_max)
    ref = flash_decode_inplace_plain(q, *plain, *new, clamped).reshape(
        b, kvh * g, hd)
    pv = fdmod.flash_decode_plain(q, *_abs_v(plain), clamped).reshape(
        b, kvh * g, hd)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) < 2e-3
    assert output_close(got, ref, pv)
    assert not got[0].any()
    for x, y in zip(span, plain):
        assert torch.equal(x, y)


def test_flash_decode_live_route_on_two_streams(dev):
    """K2 launched on two streams at once, again and again: each stream
    has its own arrival counts, so every launch merges its own blocks and
    matches its plain version, caches equal."""
    b, kvh, g, s_max, hd = 16, 4, 4, 1024, 128
    gen = _gen(41, dev)
    cases = []
    for seed in (42, 43):
        cache = _cache(b, kvh, s_max, hd, dev, seed)
        q = torch.randn(b, kvh * g, hd, generator=gen, device=dev).to(
            torch.bfloat16)
        new = (torch.randint(-127, 128, (b, kvh, hd), generator=gen,
                             device=dev, dtype=torch.int8),
               torch.randint(-127, 128, (b, kvh, hd), generator=gen,
                             device=dev, dtype=torch.int8),
               torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3,
               torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3)
        lens = torch.randint(1, s_max + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
        plain = [t.clone() for t in cache]
        ref = flash_decode_inplace_plain(q, *plain, *new, lens).reshape(
            b, kvh * g, hd)
        cases.append((cache, q, new, lens, plain, ref))
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(20):
        for s, (cache, q, new, lens, _, _), got in zip(streams, cases, outs):
            with torch.cuda.stream(s):
                got.append(flash_decode_gqa_inplace(q, *cache, *new,
                                                    lens)[0])
    torch.cuda.synchronize()
    for (cache, _, _, _, plain, ref), got in zip(cases, outs):
        for out in got:
            assert float((out - ref).abs().max()) < 2e-3
        for x, y in zip(cache, plain):
            assert torch.equal(x, y)


PREFILL_GROUPS = [1, 2, 4, 8, 16]
# The head sizes the attention kernels are built for (flash_common).
HEAD_DIMS = [128, 64]


def _check_prefill(q, cache, st, lens, dev):
    """K4 and K4-stats on the card against their plain versions: one launch
    each and no plain call; K4's output within 2e-3 and per element within
    ``output_close``, K4-stats' state within ``state_close`` (empty rows
    exactly (0, -1e30, 0)), and its acc / l K4's output within 2e-3."""
    from deepgemm_ascend_tpu_torch.ops.flash_prefill import \
        flash_prefill_stats_plain
    b, s, heads, hd = q.shape
    kvh = cache[0].shape[1]
    g = heads // kvh
    counters = [_kernels.COUNTERS[n] for n in ("flash_prefill",
                                               "flash_prefill_stats")]
    before = [(c.launches, c.plain_calls) for c in counters]
    out = flash_prefill_gqa(q, *cache, st, lens)
    acc, m, l = flash_prefill_gqa(q, *cache, st, lens, return_stats=True)
    assert [(c.launches, c.plain_calls) for c in counters] == [
        (n + 1, p) for n, p in before]
    qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
    to_rows = lambda x: x.permute(0, 3, 1, 2, *range(4, x.dim())).reshape(
        b, s, heads, *x.shape[4:])
    ref = to_rows(flash_prefill_plain(qg, *cache, st, lens))
    pv = to_rows(flash_prefill_plain(qg, *_abs_v(cache), st, lens))
    ref_state = [to_rows(x)
                 for x in flash_prefill_stats_plain(qg, *cache, st, lens)]
    pv_state = to_rows(flash_prefill_stats_plain(qg, *_abs_v(cache), st,
                                                 lens)[0])
    torch.cuda.synchronize()
    assert out.shape == (b, s, heads, hd) and m.shape == (b, s, heads)
    assert float((out - ref).abs().max()) < 2e-3
    assert output_close(out, ref, pv)
    assert state_close((acc, m, l), ref_state, pv_state)
    safe = torch.where(l > 0, l, torch.ones_like(l))[..., None]
    assert float((acc / safe - out).abs().max()) < 2e-3
    return out, (acc, m, l)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", PREFILL_GROUPS)
@pytest.mark.parametrize("start", [0, 100, -8, -300, 1000, "S"])
def test_flash_prefill_kernel_matches_plain(dev, g, start, hd):
    """K4 and K4-stats over a 256-key cache from a start before position 0
    (-8: a block straddling it; -300: every row before it), at 0, inside
    the cache, at S and past it (every valid key); head size 128 (wgmma)
    and 64 (the CUDA cores)."""
    b, kvh, s, s_max = 2, 2, 64, 256
    start = s_max if start == "S" else start
    cache = _cache(b, kvh, s_max, hd, dev, 4)
    q = torch.randn(b, s, kvh * g, hd, generator=_gen(5, dev),
                    device=dev).to(torch.bfloat16)
    st = torch.tensor([start, max(start, 0) + 3], dtype=torch.int32,
                      device=dev)
    lens = st.clamp(min=0) + s
    _check_prefill(q, cache, st, lens, dev)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", PREFILL_GROUPS)
@pytest.mark.parametrize("s", [16, 48, 1024])
def test_flash_prefill_kernel_bucket_geometry(dev, g, s, hd):
    """Serving's buckets: s = 16 and 48 (narrower than a 64-row block's
    positions at groups 1 and 2) and 1024, over caches that are not a
    multiple of 64 keys, with ragged lengths in one bucket: an empty row, a
    padding row of length 1, one a few tokens short of the bucket, a
    resumed one (start 37) and one that stops mid-bucket."""
    kvh = 2
    s_max = 200 if s < 64 else 1090
    starts = [0, 0, 0, 37, 0]
    lens = [0, 1, max(1, s - 5), 37 + s, s // 2 + 3]
    b = len(starts)
    cache = _cache(b, kvh, s_max, hd, dev, 6 + s)
    q = torch.randn(b, s, kvh * g, hd, generator=_gen(7 + g, dev),
                    device=dev).to(torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, (acc, m, l) = _check_prefill(q, cache, st, ln, dev)
    # The empty row: zeros, and the state (0, -1e30, 0).
    assert not out[0].any() and not acc[0].any()
    assert bool((m[0] == -1e30).all()) and not l[0].any()


def test_flash_prefill_refuses_an_offset_cache(dev):
    """q read in 16-byte words and the caches by TMA: a view off 16 bytes
    (``buf[1:]`` of a flat buffer) raises ValueError from K4 and K4-stats
    before any launch, and the C entry refuses an offset q itself; the
    aligned copies still run."""
    b, kvh, g, s, s_max, hd = 1, 2, 4, 32, 128, 128
    cache = list(_cache(b, kvh, s_max, hd, dev, 8))
    q = torch.randn(b, s, kvh * g, hd, generator=_gen(9, dev),
                    device=dev).to(torch.bfloat16)
    st = torch.zeros(b, dtype=torch.int32, device=dev)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    c = _kernels.COUNTERS["flash_prefill"]
    cs = _kernels.COUNTERS["flash_prefill_stats"]
    before = (c.launches, cs.launches)
    for i in (0, 2):
        flat = torch.zeros(cache[i].numel() + 1, dtype=torch.int8, device=dev)
        shifted = flat[1:].view(cache[i].shape)
        shifted.copy_(cache[i])
        bad = list(cache)
        bad[i] = shifted
        for stats in (False, True):
            with pytest.raises(ValueError, match="16-byte"):
                flash_prefill_gqa(q, *bad, st, lens, return_stats=stats)
    flat_q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    q_off = flat_q[1:].view(q.shape)
    q_off.copy_(q)
    for stats in (False, True):
        with pytest.raises(ValueError, match="16-byte"):
            flash_prefill_gqa(q_off, *cache, st, lens, return_stats=stats)
    assert (c.launches, cs.launches) == before
    out = torch.empty(b, s, kvh * g, hd, dtype=torch.float32, device=dev)
    entry = _kernels.entry("flash_prefill")
    args = [q_off.data_ptr(), cache[0].data_ptr(), cache[1].data_ptr(),
            cache[2].data_ptr(), cache[3].data_ptr(), st.data_ptr(),
            lens.data_ptr(), out.data_ptr(), b, kvh, g, s, s_max, hd,
            float(1.0 / np.sqrt(hd)), _kernels.stream_ptr(dev)]
    assert entry(*args) != 0
    args[0] = q.data_ptr()
    assert entry(*args) == 0
    torch.cuda.synchronize()
    want = flash_prefill_gqa(q, *cache, st, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


GEMM_REL_TOL = 1e-5


def assert_gemm_close(got, ref, a, b):
    """f32: within GEMM_REL_TOL of Σ|a·b| per element; a 16-bit output
    (both sides rounded once from such sums): that plus one ulp of its type
    (the module docstring)."""
    g, r = got.float(), ref.float()
    tol = GEMM_REL_TOL * torch.matmul(a.float().abs(), b.float().abs())
    if got.dtype != torch.float32:
        tol = tol + torch.finfo(got.dtype).eps * torch.maximum(g.abs(),
                                                               r.abs())
    assert bool(((g - r).abs() <= tol).all())
    assert bool(torch.isfinite(got).all())


def _cfg(a_in, b_in, layout="nn", splits=1, rt=None, **kw):
    """K10's config (K11's with ``splits`` > 1) on the tile the kernels
    pick for this grid on the route the operands take (or ``rt``)."""
    rt = rt or route(a_in, b_in, layout)
    a_t = layout[0] == "t"
    m = a_in.shape[-1] if a_t else a_in.shape[-2]
    n = b_in.shape[-2] if layout[1] == "t" else b_in.shape[-1]
    batch = int(np.prod(a_in.shape[:-2])) if a_in.dim() > 2 else 1
    bm, bn = analytic.default_tile("gemm", rt, m, n, batch, splits)
    if splits > 1:
        kw.update(kernel_type=KernelType.KSPLIT, k_split=splits)
    return GemmConfig(bm, bn, 64, **kw)


def _dense(m, n, k, dtype, layout, dev, seed=0):
    """Operands in their stored layout, and their logical (m, k) / (k, n)
    views."""
    g = _gen(seed, dev)
    a = torch.randn(m, k, generator=g, device=dev).to(dtype)
    b = torch.randn(k, n, generator=g, device=dev).to(dtype)
    a_in = a.t().contiguous() if layout[0] == "t" else a
    b_in = b.t().contiguous() if layout[1] == "t" else b
    return a_in, b_in, a, b


@pytest.mark.parametrize("mnk", [(16, 256, 1024), (33, 97, 1000),
                                 (130, 200, 72)])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_gemm_kernel_matches_plain(dev, mnk, layout, dtype):
    """Decode m, ragged m/n/k (element loads where a row pitch is not a
    multiple of 8) and a K tail inside the last 64-deep block, in every
    layout and input type."""
    m, n, k = mnk
    a_in, b_in, a, b = _dense(m, n, k, dtype, layout, dev)
    cfg = GemmConfig(block_m=64, block_n=64, block_k=64)
    got = gemm_with_config(a_in, b_in, config=cfg, layout=layout)
    ref = gemm_plain(a, b)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    assert_gemm_close(got, ref, a, b)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_kernel_rounds_once_to_out_dtype(dev, out_dtype, dtype):
    a_in, b_in, a, b = _dense(70, 136, 520, dtype, "nn", dev, seed=1)
    cfg = GemmConfig(block_m=64, block_n=64, block_k=64)
    got = gemm_with_config(a_in, b_in, config=cfg, out_dtype=out_dtype)
    ref = gemm_plain(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert_gemm_close(got, ref, a, b)


def test_gemm_kernel_swizzle_and_unaligned_pointers(dev):
    """N-major raster gives the same tiles, bit for bit, within one route;
    an operand whose data pointer is not 16-byte aligned takes the
    mma_tile route (TMA cannot describe it), and its aligned clone the
    wgmma route, which sums in another order: the two are held to the
    plain product's tolerance, not to each other's bits."""
    m, n, k = 96, 192, 256
    g = _gen(2, dev)
    flat_a = torch.randn(m * k + 1, generator=g, device=dev).to(torch.bfloat16)
    a = flat_a[1:].view(m, k)                     # 2-byte offset
    b = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
    assert a.data_ptr() % 16 and a.is_contiguous()
    assert route(a, b) == "mma_tile" and route(a.clone(), b) == "wgmma"
    base = GemmConfig(block_m=64, block_n=64, block_k=64)
    n_cfg = base.replace(swizzle=SwizzleDir.N_MAJOR)
    m_major = gemm_with_config(a, b, config=base)
    n_major = gemm_with_config(a, b, config=n_cfg)
    aligned = gemm_with_config(a.clone(), b, config=base)
    aligned_n = gemm_with_config(a.clone(), b, config=n_cfg)
    torch.cuda.synchronize()
    assert torch.equal(m_major, n_major) and torch.equal(aligned, aligned_n)
    ref = gemm_plain(a, b)
    assert_gemm_close(m_major, ref, a, b)
    assert_gemm_close(aligned, ref, a, b)


# ---- K10 on the wgmma route (TMA + wgmma, csrc/sm90_gemm.cuh)


def _wgmma_expected(m, n, k, layout):
    """The route of contiguous operands: every stored row pitch (the stored
    last dims) a multiple of 8 elements."""
    pitches = (m if layout[0] == "t" else k, k if layout[1] == "t" else n)
    return "wgmma" if all(p % 8 == 0 for p in pitches) else "mma_tile"


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gemm_wgmma_route_matches_plain(dev, dtype, layout, out_dtype):
    """Every m the two tile shapes meet: 1 and 16 (decode), 64 and 65 (the
    64-row variant's edge), 200 (a ragged 128-row tile), 2048 (16 tiles),
    in every layout, input and output type; n = 256 (one 256-wide tile) and
    k = 512. Where A is stored (k, m) with m not a multiple of 8, the route
    is mma_tile (checked), and the product is held the same way."""
    n, k = 256, 512
    for m in (1, 16, 64, 65, 200, 2048):
        a_in, b_in, a, b = _dense(m, n, k, dtype, layout, dev, seed=m)
        assert route(a_in, b_in, layout) == _wgmma_expected(m, n, k, layout)
        cfg = GemmConfig(block_m=64, block_n=64, block_k=64)
        got = gemm_with_config(a_in, b_in, config=cfg, layout=layout,
                               out_dtype=out_dtype)
        ref = gemm_plain(a, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert_gemm_close(got, ref, a, b)


@pytest.mark.parametrize("mnk", [(130, 136, 1000), (16, 136, 1000),
                                 (2048, 264, 1000)])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
def test_gemm_wgmma_route_edges(dev, mnk, layout):
    """A K tail inside the last 64-deep block (k = 1000), an N edge inside
    a tile (n = 136, 264) and an M edge (m = 130), zero-filled by TMA."""
    m, n, k = mnk
    a_in, b_in, a, b = _dense(m, n, k, torch.bfloat16, layout, dev, seed=7)
    assert route(a_in, b_in, layout) == _wgmma_expected(m, n, k, layout)
    cfg = GemmConfig(block_m=64, block_n=64, block_k=64)
    got = gemm_with_config(a_in, b_in, config=cfg, layout=layout)
    ref = gemm_plain(a, b)
    torch.cuda.synchronize()
    assert_gemm_close(got, ref, a, b)


@pytest.mark.parametrize("swizzle", [SwizzleDir.M_MAJOR, SwizzleDir.N_MAJOR])
def test_gemm_wgmma_route_batch_and_raster(dev, swizzle):
    """bgemm over a batch of 3 (the batch a grid axis, a 3-D tensor map),
    and both raster orders over 17 x 5 output tiles (bands of 16 with a
    ragged last band): the same bits either way."""
    g = _gen(8, dev)
    a = torch.randn(3, 200, 1000, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(3, 1000, 136, generator=g, device=dev).to(torch.bfloat16)
    assert route(a, b) == "wgmma"
    got = bgemm(a, b, config=_cfg(a, b, swizzle=swizzle))
    torch.cuda.synchronize()
    for i in range(3):
        assert_gemm_close(got[i], gemm_plain(a[i], b[i]), a[i], b[i])
    a2 = torch.randn(17 * 128, 512, generator=g, device=dev).to(torch.bfloat16)
    b2 = torch.randn(512, 5 * 256, generator=g, device=dev).to(torch.bfloat16)
    base = GemmConfig(block_m=64, block_n=64, block_k=64)
    got2 = gemm_with_config(a2, b2, config=base.replace(swizzle=swizzle))
    ref2 = gemm_with_config(a2, b2, config=base)
    torch.cuda.synchronize()
    assert torch.equal(got2, ref2)
    assert_gemm_close(got2, gemm_plain(a2, b2), a2, b2)


@pytest.mark.parametrize("k_split,k", [(4, 2048), (3, 1000), (4, 320)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_ksplit_kernel_matches_plain(dev, k_split, k, dtype):
    """Even splits, an uneven one with a ragged K tail, and k = 320 over 4
    splits of 2 blocks: the last split is empty and must add zeros."""
    m, n = 16, 320
    a_in, b_in, a, b = _dense(m, n, k, dtype, "nn", dev, seed=3)
    cfg = GemmConfig(block_m=64, block_n=64, block_k=64,
                     kernel_type=KernelType.KSPLIT, k_split=k_split)
    k11 = _kernels.COUNTERS["gemm_ksplit"]
    before = k11.launches
    got = gemm_with_config(a_in, b_in, config=cfg)
    ref = gemm_ksplit_plain(a, b, k_split)
    torch.cuda.synchronize()
    assert k11.launches == before + 1
    assert_gemm_close(got, ref, a, b)


def test_gemm_ksplit_kernel_writes_every_partial(dev):
    """The partials buffer comes from torch.empty: every split, an empty
    one included, must overwrite all of its (m, n) slice (route 0: n = 130
    is no multiple of 8)."""
    m, n, k, splits, per = 20, 130, 320, 4, 128
    g = _gen(4, dev)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
    parts = torch.full((splits, m, n), float("nan"), device=dev)
    rc = _kernels.entry("gemm_ksplit")(
        a.data_ptr(), b.data_ptr(), parts.data_ptr(), 1, m, n, k, splits, per,
        1, 0, 0, _kernels.stream_ptr(dev))
    _kernels.check(rc, "gemm_ksplit")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(parts).all())
    assert bool((parts[3] == 0).all())
    for s in range(3):
        sl = slice(s * per, (s + 1) * per)
        assert_gemm_close(parts[s], gemm_plain(a[:, sl], b[sl]), a[:, sl],
                          b[sl])


# ---- K11 on the wgmma route (csrc/sm90_gemm.cuh)


def test_gemm_ksplit_wgmma_route_writes_every_partial(dev):
    """As above on the wgmma route (n = 136: TMA can describe B): the
    empty last split issues no load and stores the zero tile of its
    cleared accumulators; the others equal ksplit_partials_plain's slices
    within tolerance. The route refuses f32 operands."""
    m, n, k, splits = 20, 136, 320, 4
    ranges = split_ranges(k, splits)
    assert ranges[3] == (k, k)
    g = _gen(4, dev)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
    assert route(a, b) == "wgmma"
    parts = torch.full((splits, m, n), float("nan"), device=dev)
    entry = _kernels.entry("gemm_ksplit")
    args = (parts.data_ptr(), 1, m, n, k, splits, ranges[0][1])
    stream = _kernels.stream_ptr(dev)
    _kernels.check(entry(a.data_ptr(), b.data_ptr(), *args, 1, 1, 0,
                         stream), "gemm_ksplit")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(parts).all())
    assert bool((parts[3] == 0).all())
    want = ksplit_partials_plain(a, b, splits)
    for s, (lo, hi) in enumerate(ranges[:3]):
        assert_gemm_close(parts[s], want[s], a[:, lo:hi], b[lo:hi])
    a32, b32 = a.float(), b.float()
    assert entry(a32.data_ptr(), b32.data_ptr(), *args, 0, 1, 0,
                 stream) != 0


@pytest.mark.parametrize("k_split,k", [(4, 2048), (3, 1000), (4, 320),
                                       (4, 576)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gemm_ksplit_wgmma_route_matches_plain(dev, k_split, k, dtype):
    """K11 on the Hopper main loop: even splits, an uneven one over a
    ragged K tail (k = 1000: TMA zero-fills the last block), and two with
    an empty last split (k = 320: 5 blocks in 4 splits of 2; k = 576: 9
    blocks in 4 splits of 3), at decode m = 16 and at m = 200 (ragged
    rows), f32 and 16-bit output."""
    for m, n in ((16, 2048), (200, 136)):
        a, b, _, _ = _dense(m, n, k, dtype, "nn", dev, seed=k + m)
        assert route(a, b) == "wgmma"
        cfg = _cfg(a, b, splits=k_split)
        k11 = _kernels.COUNTERS["gemm_ksplit"]
        before = k11.launches
        got = gemm_with_config(a, b, config=cfg)
        got16 = gemm_with_config(a, b, config=cfg, out_dtype=dtype)
        ref = gemm_ksplit_plain(a, b, k_split)
        ref16 = gemm_ksplit_plain(a, b, k_split, out_dtype=dtype)
        torch.cuda.synchronize()
        assert k11.launches == before + 2
        assert_gemm_close(got, ref, a, b)
        assert_gemm_close(got16, ref16, a, b)


def test_bgemm_ksplit_wgmma_route_matches_plain(dev):
    """bgemm with KSPLIT over a batch of 3 on the wgmma route: one launch,
    grid z batch x splits, each batch element's partials in its own
    slices."""
    g = _gen(11, dev)
    a = torch.randn(3, 16, 1088, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(3, 1088, 200, generator=g, device=dev).to(torch.bfloat16)
    assert route(a, b) == "wgmma"
    k11 = _kernels.COUNTERS["gemm_ksplit"]
    before = k11.launches
    got = bgemm(a, b, config=_cfg(a, b, splits=4))
    torch.cuda.synchronize()
    assert k11.launches == before + 1
    for i in range(3):
        assert_gemm_close(got[i], gemm_ksplit_plain(a[i], b[i], 4), a[i],
                          b[i])


# V2_LITE's dense projections (n, k), as chip_smoke.py's LITE_GEMMS.
DENSE_NK = [(2048, 2048), (512, 2048), (22016, 2048), (2048, 11008),
            (2816, 2048), (2048, 1408)]


@pytest.mark.parametrize("m", [1, 16, 64, 2048])
def test_gemm_ksplit_where_the_selector_splits(dev, m):
    """gemm() with no config at V2_LITE's projection shapes: wherever
    select_config picks KSPLIT on this card, K11 runs and agrees with its
    plain version; elsewhere K10 runs."""
    for n, k in DENSE_NK:
        a, b, _, _ = _dense(m, n, k, torch.bfloat16, "nn", dev, seed=n + k)
        cfg = select_config(m, n, k, torch.bfloat16, torch.float32,
                            device=dev)
        split = cfg.kernel_type == KernelType.KSPLIT
        counter = _kernels.COUNTERS["gemm_ksplit" if split else "gemm"]
        before = counter.launches
        got = gemm(a, b)
        ref = (gemm_ksplit_plain(a, b, cfg.k_split) if split
               else gemm_plain(a, b))
        torch.cuda.synchronize()
        assert counter.launches == before + 1, (n, k)
        assert_gemm_close(got, ref, a, b)


@pytest.mark.parametrize("ksplit", [False, True])
def test_bgemm_kernel_matches_plain(dev, ksplit):
    """Batch 4 in one launch (the third grid axis), ragged m/n/k."""
    g = _gen(5, dev)
    a = torch.randn(2, 2, 33, 300, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(2, 2, 300, 70, generator=g, device=dev).to(torch.bfloat16)
    cfg = _cfg(a, b, splits=2 if ksplit else 1)
    got = bgemm(a, b, config=cfg)
    ref = torch.matmul(a.float(), b.float())
    torch.cuda.synchronize()
    assert got.shape == (2, 2, 33, 70)
    for i in range(2):
        for j in range(2):
            assert_gemm_close(got[i, j], ref[i, j], a[i, j], b[i, j])


# ---- K10 and K11 on the ffma route (f32 on the CUDA cores)

# Shapes of each ffma tile: m <= 16 (16 x 128), the 64 x 64 tile (m, n
# off its edges; k = 1000 and 72 not whole 16-deep steps) and the 128 x 128
# tile (108 of them: the grid fills the card), every stored pitch a
# multiple of 4 (m too: A stored (k, m) in tn and tt).
FFMA_SHAPES = [(4, 256, 512), (16, 2048, 1000), (200, 136, 1000),
               (68, 260, 72), (1100, 1420, 516)]


def _k10_route(a_in, b_in, layout, out_dtype, rt=None, config=None):
    """K10 through its wrapper (``bgemm`` for a batch) on route ``rt``
    (None: its own) with the tile the kernels pick there (``config``'s
    raster order), and the route its counter counted for the launch."""
    k10 = _kernels.COUNTERS["gemm"]
    k10.plans.clear()
    cfg = _cfg(a_in, b_in, layout, rt=rt)
    if config is not None:
        cfg = cfg.replace(swizzle=config.swizzle)
    if a_in.dim() > 2:
        got = bgemm(a_in, b_in, config=cfg, out_dtype=out_dtype, plan=rt)
    else:
        got = gemm_with_config(a_in, b_in, config=cfg, layout=layout,
                               out_dtype=out_dtype, plan=rt)
    return got, [p.split()[0] for p in k10.plans]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("mnk", FFMA_SHAPES)
def test_gemm_ffma_route_equals_mma_tile_bit_for_bit(dev, mnk, layout,
                                                     out_dtype):
    """f32 operands that 16-byte loads can read take route ffma, which
    sums every output in the f32 mma_tile route's one order: equal bit for
    bit in every layout and output type, and within the plain product's
    tolerance."""
    m, n, k = mnk
    a_in, b_in, a, b = _dense(m, n, k, torch.float32, layout, dev, seed=m + k)
    assert route(a_in, b_in, layout) == "ffma"
    got, plans = _k10_route(a_in, b_in, layout, out_dtype)
    old, old_plans = _k10_route(a_in, b_in, layout, out_dtype, rt="mma_tile")
    ref = gemm_plain(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (plans, old_plans) == (["ffma"], ["mma_tile"])
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, old)
    assert_gemm_close(got, ref, a, b)


@pytest.mark.parametrize("swizzle", [SwizzleDir.M_MAJOR, SwizzleDir.N_MAJOR])
def test_gemm_ffma_route_batch_and_raster(dev, swizzle):
    """bgemm over a batch of 3 (grid z) on route ffma, and both rasters
    over the 128 x 128 tile's bands: bit-equal to route mma_tile."""
    g = _gen(60, dev)
    a = torch.randn(3, 200, 1000, generator=g, device=dev)
    b = torch.randn(3, 1000, 136, generator=g, device=dev)
    cfg = GemmConfig(swizzle=swizzle)
    got, plans = _k10_route(a, b, "nn", torch.float32, config=cfg)
    old, _ = _k10_route(a, b, "nn", torch.float32, rt="mma_tile", config=cfg)
    a2 = torch.randn(17 * 128, 512, generator=g, device=dev)
    b2 = torch.randn(512, 7 * 128 + 4, generator=g, device=dev)
    got2, plans2 = _k10_route(a2, b2, "nn", torch.float32, config=cfg)
    old2, _ = _k10_route(a2, b2, "nn", torch.float32, rt="mma_tile")
    torch.cuda.synchronize()
    assert plans == plans2 == ["ffma"]
    assert torch.equal(got, old) and torch.equal(got2, old2)
    for i in range(3):
        assert_gemm_close(got[i], gemm_plain(a[i], b[i]), a[i], b[i])


@pytest.mark.parametrize("k_split,k", [(4, 2048), (3, 1000), (4, 320),
                                       (4, 576), (8, 11008)])
@pytest.mark.parametrize("m,n", [(16, 2048), (200, 136)])
def test_gemm_ksplit_ffma_route_equals_mma_tile(dev, k_split, k, m, n):
    """K11 on route ffma: every f32 partial equal bit for bit to route
    mma_tile's, an empty last split (k = 320: 5 blocks in 4 splits of 2;
    k = 576: 9 in 4 of 3) all zeros, each written over a NaN-filled
    buffer; through the wrapper the summed output equal too, and within
    the plain version's tolerance."""
    a, b, _, _ = _dense(m, n, k, torch.float32, "nn", dev, seed=k + m)
    assert route(a, b) == "ffma"
    ranges = split_ranges(k, k_split)
    entry = _kernels.entry("gemm_ksplit")
    stream = _kernels.stream_ptr(dev)
    parts = {}
    for rt in ("ffma", "mma_tile"):
        parts[rt] = torch.full((k_split, m, n), float("nan"), device=dev)
        rc = entry(a.data_ptr(), b.data_ptr(), parts[rt].data_ptr(), 1, m, n,
                   k, k_split, ranges[0][1], 0, ROUTES.index(rt),
                   analytic.tile_code("gemm", rt, *analytic.default_tile(
                       "gemm", rt, m, n, splits=k_split)), stream)
        _kernels.check(rc, "gemm_ksplit")
    cfg = _cfg(a, b, splits=k_split)
    k11 = _kernels.COUNTERS["gemm_ksplit"]
    k11.plans.clear()
    got = gemm_with_config(a, b, config=cfg)
    old = gemm_with_config(a, b, config=_cfg(a, b, splits=k_split,
                                             rt="mma_tile"), plan="mma_tile")
    ref = gemm_ksplit_plain(a, b, k_split)
    torch.cuda.synchronize()
    assert {p.split()[0]: c for p, c in k11.plans.items()} == {
        "ffma": 1, "mma_tile": 1}
    assert torch.equal(parts["ffma"], parts["mma_tile"])
    for s, (lo, hi) in enumerate(ranges):
        if lo == hi:
            assert bool((parts["ffma"][s] == 0).all())
    assert torch.equal(got, old)
    assert_gemm_close(got, ref, a, b)


def test_bgemm_ksplit_ffma_route_equals_mma_tile(dev):
    """bgemm with KSPLIT over a batch of 3 on route ffma: one launch,
    grid z batch x splits, equal to route mma_tile bit for bit."""
    g = _gen(61, dev)
    a = torch.randn(3, 16, 1088, generator=g, device=dev)
    b = torch.randn(3, 1088, 200, generator=g, device=dev)
    cfg = _cfg(a, b, splits=4)
    k11 = _kernels.COUNTERS["gemm_ksplit"]
    before = k11.launches
    got = bgemm(a, b, config=cfg)
    old = bgemm(a, b, config=_cfg(a, b, splits=4, rt="mma_tile"),
                plan="mma_tile")
    torch.cuda.synchronize()
    assert k11.launches == before + 2
    assert torch.equal(got, old)
    for i in range(3):
        assert_gemm_close(got[i], gemm_ksplit_plain(a[i], b[i], 4), a[i],
                          b[i])


def test_gemm_entries_refuse_a_route_they_cannot_take(dev):
    """Route ffma takes f32 alone, 16-byte aligned bases and row pitches of
    whole 16-byte chunks; route wgmma 16-bit operands alone; no entry knows
    route 3. Each refusal is cudaErrorInvalidValue (1) and launches
    nothing; the wrapper raises, with no other route tried."""
    g = _gen(62, dev)
    a = torch.randn(64, 256, generator=g, device=dev)
    b = torch.randn(256, 128, generator=g, device=dev)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    off = torch.randn(64 * 256 + 1, generator=g, device=dev)[1:].view(64, 256)
    odd = torch.randn(256, 130, generator=g, device=dev)
    assert route(off, b) == route(a, odd) == "mma_tile"
    out = torch.zeros(64, 130, device=dev)
    k10 = _kernels.entry("gemm")
    stream = _kernels.stream_ptr(dev)

    def call(x, y, n, in_code, rt, tile=0):
        return k10(x.data_ptr(), y.data_ptr(), out.data_ptr(), 1, 64, n, 256,
                   0, 0, in_code, 0, 0, rt, tile, stream)

    assert call(a16, b16, 128, 1, 2) == 1           # ffma: 16-bit
    assert call(off, b, 128, 0, 2) == 1             # ffma: A off 16 bytes
    assert call(a, odd, 130, 0, 2) == 1             # ffma: pitch 130
    assert call(a, b, 128, 0, 1) == 1               # wgmma: f32
    assert call(a, b, 128, 0, 3) == 1               # no route 3
    assert call(a16, b16, 128, 1, 1, 3) == 1        # wgmma: no tile 3
    assert call(a, b, 128, 0, 2, 3) == 1            # ffma: no tile 3
    assert call(off, b, 128, 0, 0, 1) == 1          # mma_tile: tile 0 only
    k11 = _kernels.entry("gemm_ksplit")
    parts = torch.zeros(4, 64, 128, device=dev)
    assert k11(a16.data_ptr(), b16.data_ptr(), parts.data_ptr(), 1, 64, 128,
               256, 4, 64, 1, 2, 0, stream) == 1
    assert k11(a.data_ptr(), b.data_ptr(), parts.data_ptr(), 1, 64, 128, 256,
               4, 64, 0, 3, 0, stream) == 1
    assert k11(a16.data_ptr(), b16.data_ptr(), parts.data_ptr(), 1, 64, 128,
               256, 4, 64, 1, 1, 5, stream) == 1
    torch.cuda.synchronize()
    assert not out.any() and not parts.any()
    with pytest.raises(RuntimeError, match="dga_gemm"):
        gemm_with_config(off, b, config=GemmConfig(64, 64, 64), plan="ffma")


def _contiguous_operands(block_m, b_t, dev, seed):
    e, n, k = 3, 256, 384
    _, gids, _ = ggmod.make_contiguous_layout([70, 0, 130], block_m)
    gids = torch.from_numpy(np.append(gids, -1).astype(np.int32))
    m = gids.numel() * block_m
    g = _gen(seed, dev)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m, k, generator=g, device=dev))
    w = torch.randn((e, n, k) if b_t else (e, k, n), generator=g,
                    device=dev) / k ** 0.5
    b_q, b_s = quant.quantize_fp8_weight(w)
    return a_q, a_s, b_q, b_s, gids


@pytest.mark.parametrize("block_m", [64, 96, 128])
@pytest.mark.parametrize("b_layout", ["t", "n"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_contiguous_kernel_matches_plain(dev, block_m, b_layout,
                                                 out_dtype):
    """Layout tiles equal to, not a multiple of, and larger than the
    kernel's 64-row tile; the padding tile (-1) comes out exactly zero
    (the output comes from torch.empty)."""
    b_t = b_layout == "t"
    a_q, a_s, b_q, b_s, gids = _contiguous_operands(block_m, b_t, dev, 6)
    got = ggmod.m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s, gids,
                                          b_layout=b_layout,
                                          out_dtype=out_dtype)
    ref = ggmod.grouped_gemm_contiguous_plain(
        a_q, a_s, b_q, b_s.transpose(1, 2) if b_t else b_s, gids, b_t=b_t,
        out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert bool((got[-block_m:] == 0).all())
    (assert_bf16_close if out_dtype == torch.bfloat16 else assert_f32_close)(
        got, ref)


def test_grouped_contiguous_kernel_equals_masked_kernel(dev):
    """K8 and K3 run the same tile routine: the same rows through either
    give the same bits."""
    a_q, a_s, b_q, b_s, gids = _contiguous_operands(128, True, dev, 7)
    got = ggmod.m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s, gids,
                                          b_layout="t")
    rows = {0: slice(0, 128), 2: slice(128, 384)}
    for e, sl in rows.items():
        n_rows = sl.stop - sl.start
        masked = ggmod.m_grouped_gemm_masked(
            a_q[sl][None].expand(3, -1, -1).contiguous(),
            a_s[sl][None].expand(3, -1, -1).contiguous(), b_q, b_s,
            torch.full((3,), n_rows, dtype=torch.int32, device=dev),
            b_layout="t")
        torch.cuda.synchronize()
        assert torch.equal(got[sl], masked[e])


# ---- K8 on route wgmma16 and K9 on route wgmma (the contiguous layout on
# the Hopper main loops)


def _probe(a, b, dev):
    """The probe kernel (csrc/grouped_gemm.cu) on a (64, 128) and b (128,
    128) e4m3 bytes: the group partial by mma.sync, by wgmma with A from
    registers in mma.sync's k order, and in natural k order."""
    c = torch.empty(3, 64, 128, device=dev)
    rc = _kernels.entry("wgmma16_probe")(a.data_ptr(), b.data_ptr(),
                                        c.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(rc, "wgmma16_probe")
    torch.cuda.synchronize()
    return c


def test_wgmma16_probe_sums_a_group_as_mma_sync(dev):
    """The premise of route wgmma16: an f16 wgmma m64n128k16 with A from
    registers gives gemm_tile's group partial (eight mma.sync m16n8k16
    steps from 0) bit for bit, in mma.sync's k order inside a step and in
    natural order, on e4m3 bytes over the whole range (subnormals, the
    largest values: 16-product sums that f32 cannot hold exactly) and on
    quantized Gaussians. Each partial is also within f32 rounding of the
    exact float64 product, so no fragment is misplaced."""
    mismatches = [0, 0]
    for trial in range(24):
        g = _gen(trial, dev)
        if trial % 2 == 0:
            a, b = (torch.randint(0, 256, shape, generator=g, device=dev,
                                  dtype=torch.uint8)
                    for shape in ((64, 128), (128, 128)))
            a[(a & 0x7F) == 0x7F] = 0       # no NaN bytes
            b[(b & 0x7F) == 0x7F] = 0
        else:
            a = quant.quantize_fp8_act(torch.randn(
                64, 128, generator=g, device=dev) * 10)[0].view(torch.uint8)
            b = quant.quantize_fp8_weight(torch.randn(
                128, 128, generator=g, device=dev))[0].view(torch.uint8)
        c = _probe(a, b, dev)
        a64 = a.view(torch.float8_e4m3fn).double()
        b64 = b.view(torch.float8_e4m3fn).double()
        exact = a64 @ b64.t()
        scale = a64.abs() @ b64.abs().t()        # Σ|a·b| of each partial
        assert bool(((c[0].double() - exact).abs() <= 1e-5 * scale).all())
        mismatches[0] += int((c[1] != c[0]).sum())
        mismatches[1] += int((c[2] != c[0]).sum())
    assert mismatches == [0, 0]


@pytest.mark.parametrize("block_m", [64, 128, 256])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_contiguous_wgmma16_matches_plain_and_tile(dev, block_m,
                                                          out_dtype):
    """K8 on route wgmma16 (B stored (E, n, k), block_m 64 | 128 | 256):
    within one bf16 ulp of the plain version (f32 within the outlier
    gate), bit-equal to route tile on the same operands, and a padding
    tile in the middle of the layout and at its end exactly zero."""
    a_q, a_s, b_q, b_s, gids = _contiguous_operands(block_m, True, dev, 21)
    gids = torch.cat([gids[:1], torch.tensor([-1], dtype=torch.int32),
                      gids[1:]])
    m = gids.numel() * block_m
    a_q, a_s = (torch.cat([t[:block_m], t[:block_m], t[block_m:]])[:m]
                for t in (a_q, a_s))
    k8 = _kernels.COUNTERS["grouped_gemm_contiguous"]
    k8.plans.clear()
    got = ggmod.m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s, gids,
                                          b_layout="t", out_dtype=out_dtype)
    tile = ggmod._launch_contiguous(a_q, a_s, b_q, b_s.transpose(1, 2),
                                    fp8mod._SHIFT, gids, block_m, True,
                                    out_dtype, plan=("tile", 0))
    ref = ggmod.grouped_gemm_contiguous_plain(
        a_q, a_s, b_q, b_s.transpose(1, 2), gids, b_t=True,
        out_dtype=out_dtype)
    torch.cuda.synchronize()
    rows = ggmod.CONTIGUOUS_TILES[analytic.contiguous_tile(block_m)][0]
    assert k8.plans == {f"wgmma16 {rows}x128": 1, "tile": 1}
    assert torch.equal(got, tile)
    for pad in (slice(block_m, 2 * block_m), slice(m - block_m, m)):
        assert bool((got[pad] == 0).all())
    (assert_bf16_close if out_dtype == torch.bfloat16 else assert_f32_close)(
        got, ref)


def _routed_layout(e, tokens, block_m, dev, seed):
    """Expert loads of ``tokens`` x top-6 routed at random over ``e``
    experts, their contiguous layout, and its rows."""
    g = _gen(seed, dev)
    picks = torch.multinomial(torch.ones(e, device=dev), tokens * 6,
                              replacement=True, generator=g)
    counts = torch.bincount(picks, minlength=e).tolist()
    _, gids, _ = ggmod.make_contiguous_layout(counts, block_m)
    return counts, torch.from_numpy(gids.astype(np.int32)), gids.size * block_m


def test_grouped_contiguous_wgmma16_walks_many_tiles(dev):
    """More tiles than CTAs (a CTA walks several, its rings carried from
    tile to tile) on both wgmma16 tiles: equal to route tile, and each
    expert's rows equal to K3 (ring route) on the same rows."""
    e, n, k = 8, 512, 512
    counts, gids, m = _routed_layout(e, 1024, 128, dev, 22)
    g = _gen(23, dev)
    a_q, a_s = quant.quantize_fp8_act(torch.randn(m, k, generator=g,
                                                  device=dev))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=dev) / k ** 0.5)
    bs = b_s.transpose(1, 2)
    tile = ggmod._launch_contiguous(a_q, a_s, b_q, bs, fp8mod._SHIFT, gids,
                                    128, True, torch.bfloat16,
                                    plan=("tile", 0))
    for plan in (("wgmma16", 0), ("wgmma16", 1)):
        got = ggmod._launch_contiguous(a_q, a_s, b_q, bs, fp8mod._SHIFT,
                                       gids, 128, True, torch.bfloat16,
                                       plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, tile), plan
    cap = max(counts)
    starts = np.cumsum([0] + [-(-c // 128) * 128 for c in counts])
    a3 = torch.zeros(e, cap, k, dtype=a_q.dtype, device=dev)
    as3 = torch.zeros(e, cap, k // 128, device=dev)
    for ei, c in enumerate(counts):
        a3[ei, :c] = a_q[starts[ei]:starts[ei] + c]
        as3[ei, :c] = a_s[starts[ei]:starts[ei] + c]
    mm = torch.tensor(counts, dtype=torch.int32, device=dev)
    masked = ggmod.m_grouped_gemm_masked(a3, as3, b_q, b_s, mm, b_layout="t")
    torch.cuda.synchronize()
    for ei, c in enumerate(counts):
        assert torch.equal(masked[ei, :c], got[starts[ei]:starts[ei] + c]), ei


@pytest.mark.parametrize("block_m", [64, 128, 256])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_contiguous_wgmma_matches_plain_and_tile(dev, block_m,
                                                      out_dtype):
    """K9 on route wgmma (B stored (E, n, k), block_m 64 | 128 | 256):
    bit-equal to the plain version and to int8_tile, a padding tile in the
    middle and at the end zero; n and k end inside a tile and a stage."""
    e, n, k = 3, 320, 208
    _, gids, _ = ggmod.make_contiguous_layout([70, 0, 130], block_m)
    gids = torch.from_numpy(np.concatenate(
        [gids[:1], [-1], gids[1:], [-1]]).astype(np.int32))
    m = gids.numel() * block_m
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (e, n, k), True, dev,
                                        seed=block_m)
    k9 = _kernels.COUNTERS["int8_grouped_contiguous"]
    k9.plans.clear()
    got = i8mod.m_grouped_int8_gemm_contiguous(a_q, a_s, b_q, b_s, gids,
                                               b_layout="t",
                                               out_dtype=out_dtype)
    tile = i8mod._launch_contiguous(a_q, a_s, b_q, b_s, gids, block_m, True,
                                    out_dtype, plan=("int8_tile", 0))
    ref = i8mod.grouped_contiguous_plain(a_q, a_s, b_q, b_s, gids, b_t=True,
                                         out_dtype=out_dtype)
    torch.cuda.synchronize()
    label = i8mod.masked_plan_label("wgmma",
                                    analytic.contiguous_tile(block_m))
    assert k9.plans == {label: 1, "int8_tile": 1}
    assert torch.equal(got, ref) and torch.equal(got, tile)
    for pad in (slice(block_m, 2 * block_m), slice(m - block_m, m)):
        assert bool((got[pad] == 0).all())


def test_int8_contiguous_wgmma_equals_masked_kernel(dev):
    """K9 (route wgmma, both tiles, more tiles than CTAs) and K6 (its
    wgmma route) on the same rows: the same bits (both sums exact)."""
    e, n, k = 8, 512, 512
    counts, gids, m = _routed_layout(e, 1024, 128, dev, 24)
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (e, n, k), True, dev,
                                        seed=25)
    cap = max(counts)
    starts = np.cumsum([0] + [-(-c // 128) * 128 for c in counts])
    a6 = torch.zeros(e, cap, k, dtype=torch.int8, device=dev)
    as6 = torch.ones(e, cap, 1, device=dev)
    for ei, c in enumerate(counts):
        a6[ei, :c] = a_q[starts[ei]:starts[ei] + c]
        as6[ei, :c] = a_s[starts[ei]:starts[ei] + c]
    mm = torch.tensor(counts, dtype=torch.int32, device=dev)
    masked = i8mod.m_grouped_int8_gemm_masked(a6, as6, b_q, b_s, mm,
                                              b_layout="t", expected_m=cap)
    for tile in (0, 1):
        got = i8mod._launch_contiguous(a_q, a_s, b_q, b_s, gids, 128, True,
                                       torch.bfloat16, plan=("wgmma", tile))
        torch.cuda.synchronize()
        for ei, c in enumerate(counts):
            assert torch.equal(masked[ei, :c],
                               got[starts[ei]:starts[ei] + c]), (tile, ei)


def test_contiguous_entries_refuse_what_they_cannot_run(dev):
    """K8's and K9's C entries refuse their Hopper route for B stored
    (E, k, n), for a tile that does not divide block_m, an unknown route
    or tile and an operand TMA cannot describe (K8: a scale per column
    too); the wrappers then raise, with no fallback. The old routes take
    B stored (E, k, n)."""
    stream = _kernels.stream_ptr(dev)
    a_q, a_s, b_q, b_s, gids = _contiguous_operands(64, True, dev, 26)
    e, n, k = b_q.shape
    m = a_q.shape[0]
    gd = gids.to(dev)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    bs = b_s.transpose(1, 2)
    b_kn = b_q.transpose(1, 2).contiguous()
    bs_kn = bs.contiguous()
    k8 = _kernels.entry("grouped_gemm_contiguous")

    def args8(a, b, block_m, strides, scales, shift=fp8mod._SHIFT):
        return (a.data_ptr(), a_s.data_ptr(), b.data_ptr(), scales.data_ptr(),
                gd.data_ptr(), out.data_ptr(), m, n, k, block_m,
                b.stride(0), *strides, scales.stride(0), scales.stride(1),
                scales.stride(2), shift, 0, e)

    kmajor = args8(a_q, b_q, 64, (1, k), bs)
    assert k8(*kmajor, 1, 0, stream) == 0
    for bad in ((1, 1), (2, 0), (1, 2)):          # 128 rows in block_m 64
        assert k8(*kmajor, *bad, stream) != 0, bad
    assert k8(*args8(a_q, b_kn, 64, (n, 1), bs_kn), 1, 0, stream) != 0
    assert k8(*args8(a_q, b_kn, 64, (n, 1), bs_kn), 0, 0, stream) == 0
    panel = fp8mod.expand_weight_scales(b_s.transpose(1, 2), n).contiguous()
    assert k8(*args8(a_q, b_q, 64, (1, k), panel, shift=0), 1, 0,
              stream) != 0
    flat = torch.zeros(a_q.numel() + 16, dtype=torch.uint8, device=dev)
    a_off = flat[1:1 + a_q.numel()].view(a_q.shape).view(a_q.dtype)
    a_off.copy_(a_q)
    assert k8(*args8(a_off, b_q, 64, (1, k), bs), 1, 0, stream) != 0
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="CUDA error"):
        ggmod._launch_contiguous(a_q, a_s, b_q, bs, fp8mod._SHIFT, gids, 64,
                                 True, torch.bfloat16, plan=("wgmma16", 1))
    # K9: the same refusals, and k not a multiple of 16 on route wgmma.
    k9 = _kernels.entry("int8_grouped_contiguous")
    for kk in (256, 200):
        a8, as8, b8, bs8 = _int8_operands((m, kk), (e, n, kk), True, dev,
                                          seed=kk)
        b8_kn = b8.transpose(1, 2).contiguous()

        def args9(b, strides, block_m=64):
            return (a8.data_ptr(), as8.data_ptr(), b.data_ptr(),
                    bs8.data_ptr(), gd.data_ptr(), out.data_ptr(), m, n, kk,
                    block_m, n * kk, *strides, 0, e)

        if kk == 256:
            assert k9(*args9(b8, (1, kk)), 1, 0, stream) == 0
            for bad in ((1, 1), (2, 0), (1, 2)):
                assert k9(*args9(b8, (1, kk)), *bad, stream) != 0, bad
            assert k9(*args9(b8_kn, (n, 1)), 1, 0, stream) != 0
            assert k9(*args9(b8_kn, (n, 1)), 0, 0, stream) == 0
        else:
            assert k9(*args9(b8, (1, kk)), 1, 0, stream) != 0
            assert i8mod.contiguous_route(a8, b8, "t", 64) == "int8_tile"
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="CUDA error"):
        i8mod._launch_contiguous(a8, as8, b8, bs8, gids, 64, True,
                                 torch.bfloat16, plan=("wgmma", 0))


# ---- K12 (folded-scale fp8 GEMM), K5a/K5b (read-only decode), K4-stats


@pytest.mark.parametrize("m", [16, 100, 256])
@pytest.mark.parametrize("b_layout", ["t", "n"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_fp8_gemm_folded_kernel_matches_plain(dev, m, b_layout, out_dtype):
    """K12 folds the scales into bf16 operands exactly as its plain version
    does, so the two differ only in the f32 sum order: GEMM_REL_TOL of
    Σ|a_sc·b_sc| (plus one ulp for bf16). Within 5e-3 rel-L2 of K1."""
    b_t = b_layout == "t"
    a_q, a_s, b_q, b_s = _operands(m, 256, 512, b_t, dev, seed=11)
    bs_view = b_s.t() if b_t else b_s
    got = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                          out_dtype=out_dtype, scale_mode="folded",
                          allow_relaxed=True)
    ref = fp8mod.fp8_gemm_folded_plain(a_q, a_s, b_q, bs_view, b_t=b_t,
                                       out_dtype=out_dtype)
    k1 = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                         out_dtype=torch.float32)
    torch.cuda.synchronize()
    a_sc, b_sc = fp8mod.fold_operands(a_q, a_s, b_q, bs_view, b_t=b_t)
    assert got.dtype == out_dtype
    assert_gemm_close(got, ref, a_sc, b_sc)
    rel = float((got.float() - k1).norm() / k1.norm())
    assert rel < 5e-3


LITE_GEMMS = [(2048, 2048), (512, 2048), (22016, 2048), (2048, 11008),
              (2816, 2048), (2048, 1408)]


@pytest.mark.parametrize("m", [1, 16, 100, 2048])
@pytest.mark.parametrize("b_layout", ["t", "n"])
def test_fp8_gemm_folded_kernel_at_model_shapes(dev, m, b_layout):
    """K12 at V2_LITE's projection shapes (n, k) and both b_layouts, on the
    64-row tile (m = 1, 16), the 128-row tile with a ragged M (100) and 16
    row tiles (2048): the plain version's tolerance, and 5e-3 rel-L2 of
    K1."""
    b_t = b_layout == "t"
    for i, (n, k) in enumerate(LITE_GEMMS):
        a_q, a_s, b_q, b_s = _operands(m, n, k, b_t, dev, seed=20 + i)
        bs_view = b_s.t() if b_t else b_s
        got = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                              scale_mode="folded", allow_relaxed=True)
        ref = fp8mod.fp8_gemm_folded_plain(a_q, a_s, b_q, bs_view, b_t=b_t)
        k1 = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                             out_dtype=torch.float32)
        torch.cuda.synchronize()
        a_sc, b_sc = fp8mod.fold_operands(a_q, a_s, b_q, bs_view, b_t=b_t)
        assert_gemm_close(got, ref, a_sc, b_sc)
        assert float((got.float() - k1).norm() / k1.norm()) < 5e-3


def test_fp8_gemm_folded_expanded_panel_matches_compact(dev):
    a_q, a_s, b_q, b_s = _operands(64, 256, 256, False, dev, seed=12)
    panel = fp8mod.expand_weight_scales(b_s, 256)
    kw = dict(out_dtype=torch.float32, scale_mode="folded", allow_relaxed=True)
    c = _kernels.COUNTERS["fp8_gemm_folded"]
    before = c.launches
    got = fp8mod.fp8_gemm(a_q, a_s, b_q, panel, b_scales_expanded=True, **kw)
    ref = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and c.launches == before + 2


def _decode_query(b, kvh, g, hd, dev, seed):
    return torch.randn(b, kvh * g, hd, generator=_gen(seed, dev),
                       device=dev).to(torch.bfloat16)


def _abs_v(cache):
    """The cache with |v| for v: the plain versions run on it give the
    per-element rounding scale of ``state_close`` / ``output_close``."""
    k_q, k_s, v_q, v_s = cache
    return k_q, k_s, v_q.float().abs(), v_s


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("split_keys", [128, 512])
def test_flash_decode_read_and_state_kernels_match_plain(dev, g, split_keys,
                                                         hd):
    """K5a and K5b on route "span" (spans of ``split_keys`` keys) over
    lengths 0 (empty), ragged, on a span edge, S, and past S (clamped)."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    b, kvh, s_max = 5, 2, 320
    cache = _cache(b, kvh, s_max, hd, dev, 21)
    q = _decode_query(b, kvh, g, hd, dev, 22)
    lens = torch.tensor([0, 77, 256, s_max, s_max + 9], dtype=torch.int32,
                        device=dev)
    plan = ("span", split_keys)
    out = fdmod.flash_decode_gqa(q, *cache, lens, plan=plan)
    state = fdmod.flash_decode_gqa_state(q, *cache, lens, plan=plan)
    clamped = lens.clamp(max=s_max)
    ref = fdmod.flash_decode_plain(q, *cache, clamped).reshape(b, kvh * g, hd)
    ref_state = [x.reshape(b, kvh * g, *x.shape[3:]) for x in
                 fdmod.flash_decode_state_plain(q, *cache, clamped)]
    pv = fdmod.flash_decode_plain(q, *_abs_v(cache), clamped).reshape(
        b, kvh * g, hd)
    pv_state = fdmod.flash_decode_state_plain(q, *_abs_v(cache), clamped)[
        0].reshape(b, kvh * g, hd)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 2e-3
    assert output_close(out, ref, pv)
    assert not out[0].any()
    assert state_close(state, ref_state, pv_state)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 4])
def test_flash_decode_read_and_state_agree_with_inplace(dev, g, hd):
    """On the same cache: K5a over the cache with the new row already
    written equals K2 (route "live" at head size 128, "span" at 64); K5b
    over the rows before it, merged with the new token exactly (the JAX
    docstring's formula), equals K2 too."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    b, kvh, s_max = 4, 2, 384
    k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, hd, dev, 23)
    q = _decode_query(b, kvh, g, hd, dev, 24)
    gen = _gen(25, dev)
    k_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                          dtype=torch.int8)
    v_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                          dtype=torch.int8)
    ks_new = torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3
    vs_new = torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3
    lens = torch.tensor([1, 100, 257, s_max], dtype=torch.int32, device=dev)
    prior = [t.clone() for t in (k_q, k_s, v_q, v_s)]
    acc, m, l = fdmod.flash_decode_gqa_state(q, *prior, lens - 1)
    written = [t.clone() for t in (k_q, k_s, v_q, v_s)]
    want, *_ = fdmod.flash_decode_gqa_inplace(q, *written, k_new, v_new,
                                              ks_new, vs_new, lens)
    read = fdmod.flash_decode_gqa(q, *written, lens)
    merged = merge_current_token((acc, m, l), q, k_new, ks_new, v_new,
                                 vs_new)
    torch.cuda.synchronize()
    assert float((read - want).abs().max()) < 2e-3
    assert float((merged - want).abs().max()) < 2e-3


@pytest.mark.parametrize("blocks", [None, "heads+1", 64])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_flash_decode_read_live_equals_k2_live(dev, g, blocks):
    """K5a and K5b on route "live" (their own at head size 128, on the
    grid of live_blocks, on one spare block, or on 64 blocks): K5a over the
    cache K2 just wrote, at K2's lengths and grid, equals K2's output bit
    for bit; K5b's acc / l equals K5a's output bit for bit where l > 0,
    and an empty sequence's state is exactly (0, -1e30, 0); both agree
    with their plain versions per element, and with route "span" within
    the two routes' contracts summed.
    Lengths: empty, one token, a chunk's edges, ragged, S and past S."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    b, kvh, s_max, hd = 7, 2, 320, 128
    cache = _cache(b, kvh, s_max, hd, dev, 63)
    q = _decode_query(b, kvh, g, hd, dev, 64)
    gen = _gen(65, dev)
    new = (torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3,
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02 + 1e-3)
    lens = torch.tensor([0, 1, 64, 65, 200, s_max, s_max + 3],
                        dtype=torch.int32, device=dev)
    grid = {None: fdmod.live_blocks(b, kvh, s_max, 132),
            "heads+1": b * kvh + 1, 64: 64}[blocks]
    plan = None if blocks is None else ("live", grid)
    written = [t.clone() for t in cache]
    k2 = fdmod._launch_inplace(q, *written, *new, lens,
                               plan=("live", grid))[0]
    read_c, state_c = fdmod.READ_COUNTER, fdmod.STATE_COUNTER
    read_c.plans.clear()
    state_c.plans.clear()
    read = fdmod.flash_decode_gqa(q, *written, lens, plan=plan)
    acc, m, l = fdmod.flash_decode_gqa_state(q, *written, lens, plan=plan)
    plans = (list(read_c.plans), list(state_c.plans))
    span = fdmod.flash_decode_gqa(q, *written, lens, plan=("span", 128))
    span_state = fdmod.flash_decode_gqa_state(q, *written, lens,
                                              plan=("span", 128))
    clamped = lens.clamp(max=s_max)
    ref = fdmod.flash_decode_plain(q, *written, clamped).reshape(
        b, kvh * g, hd)
    ref_state = [x.reshape(b, kvh * g, *x.shape[3:]) for x in
                 fdmod.flash_decode_state_plain(q, *written, clamped)]
    pv = fdmod.flash_decode_plain(q, *_abs_v(written), clamped).reshape(
        b, kvh * g, hd)
    pv_state = fdmod.flash_decode_state_plain(q, *_abs_v(written), clamped)[
        0].reshape(b, kvh * g, hd)
    torch.cuda.synchronize()
    assert plans == ([f"live/{grid}"], [f"live/{grid}"])
    assert torch.equal(read, k2)
    live = l > 0
    assert torch.equal((acc / torch.where(live, l, torch.ones_like(l))[
        ..., None])[live], read[live])
    assert not live[0].any() and live[1:].all()
    assert bool((m[0] == -1e30).all()) and not acc[0].any()
    assert output_close(read, ref, pv)
    assert state_close((acc, m, l), ref_state, pv_state)
    # Against route "span": each route is within its per-element contract
    # of the plain version (output_close), so the two are within the sum
    # of both contracts of each other (a few keys' rows may pass 2e-3).
    span_l = span_state[2]
    span_out = span_state[0] / torch.where(span_l > 0, span_l,
                                           torch.ones_like(span_l))[..., None]
    both = 2 * (PV_ROUNDING * pv + 1e-4 * ref.abs())
    assert bool(((read - span).abs() <= both).all())
    assert bool(((read - span_out).abs() <= both).all())


def test_flash_decode_read_routes_by_head_size(dev):
    """K5a's and K5b's own route: "live" on its grid at head size 128,
    "span" on SPLIT_KEYS keys at 64 and where a cache is off 16 bytes."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    b, kvh, g, s_max = 3, 2, 4, 256
    lens = torch.tensor([5, 100, 256], dtype=torch.int32, device=dev)
    for hd, want in ((128, f"live/{fdmod.live_blocks(b, kvh, s_max, 132)}"),
                     (64, f"span/{fdmod.SPLIT_KEYS}")):
        cache = _cache(b, kvh, s_max, hd, dev, 66)
        q = _decode_query(b, kvh, g, hd, dev, 67)
        for fn, counter in ((fdmod.flash_decode_gqa, fdmod.READ_COUNTER),
                            (fdmod.flash_decode_gqa_state,
                             fdmod.STATE_COUNTER)):
            counter.plans.clear()
            fn(q, *cache, lens)
            assert list(counter.plans) == [want], hd
    k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, 128, dev, 68)
    flat = torch.zeros(k_q.numel() + 1, dtype=torch.int8, device=dev)
    off = flat[1:].view(k_q.shape)
    off.copy_(k_q)
    assert fdmod.read_route(off, v_q) == "span"
    assert fdmod.read_route(k_q, v_q) == "live"


def test_flash_decode_read_entries_refuse_what_they_cannot_run(dev):
    """K5a's and K5b's entries: route "live" refuses head size 64, a grid
    of no more blocks than (batch, kv head)s, no arrival counts, and (K5b)
    no m or l; no entry knows route 2. Each refusal launches nothing."""
    b, kvh, g, s_max = 2, 2, 4, 128
    stream = _kernels.stream_ptr(dev)
    lens = torch.full((b,), 100, dtype=torch.int32, device=dev)
    arrivals = torch.zeros(b * kvh, dtype=torch.int32, device=dev)
    outs = []
    for hd in (128, 64):
        k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, hd, dev, 69)
        q = _decode_query(b, kvh, g, hd, dev, 70)
        part = torch.zeros(64 * g * (hd + 2), device=dev)
        out = torch.zeros(b, kvh, g, hd, device=dev)
        m = torch.zeros(b, kvh, g, device=dev)
        l = torch.zeros_like(m)
        outs += [out, m, l]
        head = (q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
                v_s.data_ptr(), lens.data_ptr(), part.data_ptr(),
                out.data_ptr())

        def read(rt, split, arr=arrivals.data_ptr()):
            return _kernels.entry("flash_decode_read")(
                *head, arr, b, kvh, g, s_max, hd, rt, split, 0.1, stream)

        def state(rt, split, m_ptr=m.data_ptr()):
            return _kernels.entry("flash_decode_state")(
                *head, m_ptr, l.data_ptr(), arrivals.data_ptr(), b, kvh, g,
                s_max, hd, rt, split, 0.1, stream)

        if hd == 64:
            assert read(1, 16) == 1 and state(1, 16) == 1
            continue
        assert read(1, b * kvh) == 1 and state(1, b * kvh) == 1
        assert read(1, 16, arr=None) == 1
        assert state(1, 16, m_ptr=None) == 1
        assert read(2, 16) == 1 and state(2, 16) == 1
    torch.cuda.synchronize()
    assert not any(t.any() for t in outs) and not arrivals.any()


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", PREFILL_GROUPS)
@pytest.mark.parametrize("start", [0, 100, -8, -256, 256, 1000])
def test_flash_prefill_stats_kernel_matches_plain(dev, g, start, hd):
    """K4-stats: acc / l equals K4's output, (acc, m, l) the plain state;
    rows before position 0 (start < 0) are exactly (0, -1e30, 0); a start
    at or past the cache length sees every valid key."""
    b, kvh, s, s_max = 2, 2, 64, 256
    cache = _cache(b, kvh, s_max, hd, dev, 26)
    q = torch.randn(b, s, kvh * g, hd, generator=_gen(27, dev),
                    device=dev).to(torch.bfloat16)
    st = torch.tensor([start, start + 3], dtype=torch.int32, device=dev)
    lens = torch.full((b,), s_max, dtype=torch.int32, device=dev)
    c = _kernels.COUNTERS["flash_prefill_stats"]
    before = c.launches
    acc, m, l = flash_prefill_gqa(q, *cache, st, lens, return_stats=True)
    out = flash_prefill_gqa(q, *cache, st, lens)
    qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
    from deepgemm_ascend_tpu_torch.ops.flash_prefill import \
        flash_prefill_stats_plain
    to_rows = lambda x: x.permute(0, 3, 1, 2, *range(4, x.dim())).reshape(
        b, s, kvh * g, *x.shape[4:])
    ref = [to_rows(x)
           for x in flash_prefill_stats_plain(qg, *cache, st, lens)]
    pv = to_rows(flash_prefill_stats_plain(qg, *_abs_v(cache), st, lens)[0])
    torch.cuda.synchronize()
    assert c.launches == before + 1
    safe = torch.where(l > 0, l, torch.ones_like(l))[..., None]
    assert float((acc / safe - out).abs().max()) < 2e-3
    assert state_close((acc, m, l), ref, pv)
    if start < 0:
        assert bool((m[0, :-start] == -1e30).all())


def test_flash_kernels_refuse_an_unsupported_head_dim(dev):
    from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
    cache = _cache(1, 1, 128, 96, dev, 28)
    q = torch.zeros(1, 16, 1, 96, device=dev)
    lens = torch.full((1,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill_gqa(q, *cache, lens * 0, lens, return_stats=True)
    with pytest.raises(ValueError, match="head_dim"):
        fdmod.flash_decode_gqa(q[:, 0], *cache, lens)
    with pytest.raises(ValueError, match="group"):
        fdmod.flash_decode_gqa_state(torch.zeros(1, 3, 128, device=dev),
                                     *_cache(1, 1, 128, 128, dev, 29), lens)


@pytest.mark.parametrize("shape", [(8, 128), (1, 1), (3, 333), (32, 32)])
def test_copy_probe_kernel_is_a_bitwise_copy(dev, shape):
    from deepgemm_ascend_tpu_torch.ops import dispatch_probe as dp
    x = torch.randn(shape, generator=_gen(40, dev), device=dev)
    x.view(-1)[0] = float("nan")
    _kernels.reset_counters()
    got = dp.copy_probe(x)
    bare = torch.empty_like(x)
    entry, args = dp.raw_launch(x, bare)
    _kernels.check(entry(*args), "copy_probe")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), x.view(torch.int32))
    assert torch.equal(bare.view(torch.int32), x.view(torch.int32))
    assert dp.COUNTER.launches == 1 and dp.COUNTER.plain_calls == 0


def test_dispatch_floor_counts_its_bare_launches(dev):
    """The probe's bare-entry launches go to ``bare_launches``: a warm-up
    and `repeats` chains of the wrapper's `iters` on events, a warm-up and
    `launches` on the host clock — as many as through the wrapper."""
    from deepgemm_ascend_tpu_torch.scripts import straggler_probe
    _kernels.reset_counters()
    floor = straggler_probe.dispatch_floor(dev, 50, dict(iters=8, repeats=2))
    c = _kernels.COUNTERS["copy_probe"]
    assert c.bare_launches == c.launches == 1 + 2 * 8 + 1 + 50
    assert c.plain_calls == 0
    assert all(v > 0 for v in floor.values())


def test_timers_on_a_k1_call(dev):
    """bench.timing on the card: the warm chain grows to min_chain_seconds;
    a cold launch (L2 flushed) is no faster than a warm one."""
    from deepgemm_ascend_tpu_torch.bench import timing
    a_q, a_s, b_q, b_s = _operands(2048, 2048, 2048, True, dev)
    call = lambda: fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t")
    warm = timing.time_fn(call, (), iters=2, repeats=2,
                          min_chain_seconds=0.05, device=dev)
    assert warm.iters > 2 and warm.total_seconds >= 0.02
    assert warm.rpc_floor_seconds == 0.0 and 1e-6 < warm.seconds < 0.1
    cold = timing.cold_ms(call)
    assert 1e-3 < cold < 100
    assert cold >= 0.5 * warm.seconds * 1e3



# ---- serving on the card: the captured decode chunk, TINY_DENSE ----

def _to(obj, dev):
    """Parameters (dataclasses of tensors and lists) moved to ``dev``."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, list):
        return [_to(o, dev) for o in obj]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _state(eng):
    """Clones of the engine's state: caches, lengths, last tokens."""
    from deepgemm_ascend_tpu_torch.serving.engine import _CACHE_FIELDS
    return ([[getattr(c, n).clone() for n in _CACHE_FIELDS]
             for c in eng.caches],
            eng.seq_lens.clone(), eng.last_tokens.clone())


def _restore(eng, state):
    from deepgemm_ascend_tpu_torch.serving.engine import _CACHE_FIELDS
    caches, lens, last = state
    for c, saved in zip(eng.caches, caches):
        for n, t in zip(_CACHE_FIELDS, saved):
            getattr(c, n).copy_(t)
    eng.seq_lens.copy_(lens)
    eng.last_tokens.copy_(last)


def _served_chunk_engine(dev, **kw):
    """TINY on the card at decode_chunk=4, after serving three requests
    through four slots: its chunk is captured."""
    from deepgemm_ascend_tpu_torch.models import TINY, init_params
    from deepgemm_ascend_tpu_torch.serving import Engine
    eng = Engine(init_params(0, TINY, device=dev), TINY, max_slots=4,
                 max_seq_len=128, decode_chunk=4, device=dev, **kw)
    out = eng.generate([[5, 17, 301, 2, 44], list(range(100, 120)),
                        [7] * 17], max_new_tokens=10)
    assert [len(o) for o in out] == [10, 10, 10]
    assert eng.stats["graph_replays"] >= 1 and eng._graph is not None
    return eng


def test_chunk_graph_replay_equals_eager_chunk(dev):
    """From one engine state, the chunk run eagerly and the captured graph
    replayed give the same tokens and bit-equal caches, lengths and last
    tokens (every slot active)."""
    eng = _served_chunk_engine(dev)
    eng._mask.fill_(True)
    start = _state(eng)
    eng._decode_chunk(eng._mask, eng._out)
    eager_out, eager = eng._out.clone(), _state(eng)
    _restore(eng, start)
    eng._graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eng._out, eager_out)
    graph = _state(eng)
    for a, b in zip(eager[0], graph[0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(eager[1], graph[1]) and torch.equal(eager[2], graph[2])
    assert torch.equal(graph[1], start[1] + 4)


def test_chunk_graph_capture_launches_kernels_not_plain_versions(dev):
    """The capture ran every kernel of the decode path once a layer a step
    (K2) or more (K1, K3), and no plain version; a CUDA tensor never
    takes a plain version."""
    eng = _served_chunk_engine(dev)
    launches = {n: c for n, c in eng.graph_launches.items() if any(c)}
    assert set(launches) == {"fp8_gemm", "grouped_gemm", "flash_decode"}
    assert all(calls == 0 for _, calls in launches.values())
    assert launches["flash_decode"][0] == 4 * eng.cfg.num_layers
    assert all(n % 4 == 0 for n, _ in launches.values())


def test_chunk_graph_counters_count_the_replays(dev):
    """Over a served run the counters keep the capture's launches apart
    (``captured``: it ran nothing) and add one replay's launches at every
    replay (``replayed``), so ``on_card`` is what the card launched."""
    _kernels.reset_counters()
    eng = _served_chunk_engine(dev)
    reps = eng.stats["graph_replays"]
    for n, (per_replay, _) in eng.graph_launches.items():
        c = _kernels.COUNTERS[n]
        assert c.captured == per_replay
        assert c.replayed == reps * per_replay
        assert c.on_card() == c.launches + (reps - 1) * per_replay


def test_sampled_chunk_graph_draws_fresh_bits(dev):
    """Sampled chunked decode: the engine's generator is registered with
    the graph, so two replays from one state draw other tokens; every
    token is in the vocabulary."""
    eng = _served_chunk_engine(dev, temperature=1.0, seed=3)
    eng._mask.fill_(True)
    start = _state(eng)
    draws = []
    for _ in range(2):
        _restore(eng, start)
        eng._graph.replay()
        draws.append(eng._out.clone())
    assert not torch.equal(draws[0], draws[1])
    assert all(bool(((d >= 0) & (d < eng.cfg.vocab_size)).all())
               for d in draws)


def test_tiny_dense_serves_on_the_card(dev):
    """TINY_DENSE's head_dim 64 runs the attention kernels built for it
    (K4's kernel on the CUDA cores, K2's route "span"), one launch a layer
    and no plain version or fallback; the first decode logits lie within
    the card-vs-CPU rel-L2 bound of chip_smoke.py's phase 3 (0.25), and
    the engine serves through the same kernels."""
    from deepgemm_ascend_tpu_torch.models import (TINY_DENSE, decode_step,
                                                  forward, init_cache,
                                                  init_params)
    from deepgemm_ascend_tpu_torch.serving import Engine
    from deepgemm_ascend_tpu_torch.utils.logging import metrics
    cfg = TINY_DENSE
    cpu_params = init_params(0, cfg, device="cpu")

    def first_logits(d):
        params = _to(cpu_params, d)
        caches = init_cache(cfg, 1, 64, device=d)
        prompt = torch.arange(1, 17, dtype=torch.int32, device=d)[None]
        pos = torch.arange(16, dtype=torch.int32, device=d)[None]
        lens = torch.full((1,), 16, dtype=torch.int32, device=d)
        forward(params, prompt, caches, pos, lens, cfg,
                prefill_start=torch.zeros(1, dtype=torch.int32, device=d))
        logits, _ = decode_step(params, torch.tensor([7], dtype=torch.int32,
                                                     device=d), caches, lens,
                                cfg)
        return logits.float().cpu()

    def counts():
        return {n: (c.launches, c.plain_calls)
                for n, c in _kernels.COUNTERS.items()
                if c.launches or c.plain_calls}

    _kernels.reset_counters()
    metrics.reset()
    card = first_logits(dev)
    on_card = counts()
    plans = dict(_kernels.COUNTERS["flash_decode"].plans)
    fallback = metrics.snapshot().get("attention.xla_fallback_trace", 0)
    plain = first_logits("cpu")
    rel = float((card - plain).norm() / plain.norm())
    assert rel < 0.25, rel
    assert on_card["flash_decode"] == (cfg.num_layers, 0), on_card
    assert on_card["flash_prefill"] == (cfg.num_layers, 0), on_card
    assert not any(p for _, p in on_card.values()), on_card
    assert all(p.startswith("span/") for p in plans), plans
    assert fallback == 0
    _kernels.reset_counters()
    out = Engine(_to(cpu_params, dev), cfg, max_slots=2, max_seq_len=64,
                 device=dev).generate([[1, 2, 3], [4, 5]], max_new_tokens=4)
    served = counts()
    assert [len(o) for o in out] == [4, 4]
    assert all(0 <= t < cfg.vocab_size for o in out for t in o)
    assert served["flash_decode"][0] > 0 and served["flash_prefill"][0] > 0
    assert not any(p for _, p in served.values()), served


# ---- the compiled tile variants of K10/K11, K7 and K1 (tiling/analytic.py)

@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("mnk", [(16, 2048, 2048), (200, 1000, 640),
                                 (2048, 2048, 512)])
def test_every_k10_tile_matches_plain_and_the_default_tile(dev, layout,
                                                           dtype, mnk):
    """Each compiled tile of the route the operands take (wgmma for 16-bit,
    ffma for f32), in each layout: within the plain version's tolerance
    and, the K step being the same, equal bit for bit to the default
    tile's output."""
    m, n, k = mnk
    a_in, b_in, a, b = _dense(m, n, k, dtype, layout, dev, seed=m + k)
    rt = route(a_in, b_in, layout)
    assert rt == ("ffma" if dtype == torch.float32 else "wgmma")
    base = gemm_with_config(a_in, b_in, config=_cfg(a_in, b_in, layout),
                            layout=layout)
    ref = gemm_plain(a, b)
    k10 = _kernels.COUNTERS["gemm"]
    for bm, bn in analytic.TILES[("gemm", rt)]:
        k10.plans.clear()
        got = gemm_with_config(a_in, b_in, config=GemmConfig(bm, bn, 64),
                               layout=layout)
        torch.cuda.synchronize()
        assert list(k10.plans) == [f"{rt} {bm}x{bn}"]
        assert torch.equal(got, base), (bm, bn)
        assert_gemm_close(got, ref, a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("splits", [2, 8])
def test_every_k11_tile_matches_plain_at_one_split_count(dev, dtype, splits):
    """K11's tiles at one split count: the partial sums are the same, so
    every tile equals the default tile's output bit for bit, and the plain
    split version within tolerance."""
    m, n, k = 16, 2048, 11008
    a, b, _, _ = _dense(m, n, k, dtype, "nn", dev, seed=splits)
    rt = route(a, b)
    base = gemm_with_config(a, b, config=_cfg(a, b, splits=splits))
    ref = gemm_ksplit_plain(a, b, splits)
    k11 = _kernels.COUNTERS["gemm_ksplit"]
    for bm, bn in analytic.TILES[("gemm", rt)]:
        k11.plans.clear()
        got = gemm_with_config(a, b, config=GemmConfig(
            bm, bn, 64, kernel_type=KernelType.KSPLIT, k_split=splits))
        torch.cuda.synchronize()
        assert list(k11.plans) == [f"{rt} {bm}x{bn}"]
        assert torch.equal(got, base)
        assert_gemm_close(got, ref, a, b)


@pytest.mark.parametrize("m", [16, 200, 2048])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_every_k7_tile_equals_plain_bit_for_bit(dev, m, out_dtype):
    n, k = 2816, 2048
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k), True, dev, seed=m)
    ref = i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s, b_t=True,
                                out_dtype=out_dtype)
    for bm, bn in analytic.WGMMA_TILES:
        i8mod.K7.plans.clear()
        got = i8mod.int8_gemm_with_config(a_q, a_s, b_q, b_s,
                                          config=GemmConfig(bm, bn, 128),
                                          out_dtype=out_dtype, b_layout="t")
        torch.cuda.synchronize()
        assert list(i8mod.K7.plans) == [f"wgmma {bm}x{bn}"]
        assert torch.equal(got, ref), (bm, bn)


@pytest.mark.parametrize("m,n,k", [(16, 22016, 2048), (16, 512, 2048),
                                   (200, 2048, 1408), (2048, 2816, 2048)])
def test_every_k1_ring_tile_and_split_plan(dev, m, n, k):
    """K1's ring tiles unsplit equal each other bit for bit and the tile
    route's 64 x 64 (the same group arithmetic); split plans (1-8 CTAs)
    within one bf16 ulp of the plain version (another f32 order of the
    group sum)."""
    a_q, a_s, b_q, b_s = _operands(m, n, k, True, dev, seed=m + n)
    ref = fp8mod.fp8_gemm_plain(a_q, a_s, b_q, b_s.t(), b_t=True)
    outs = []
    for t, (bm, bn) in enumerate(fp8mod.RING_TILES):
        for s in (1, 2, 4, 8):
            if s > 1 and (k // 128) // s < analytic.MIN_SPLIT_GROUPS:
                continue
            cfg = GemmConfig(bm, bn, 128, kernel_type=(
                KernelType.KSPLIT if s > 1 else KernelType.COMMON), k_split=s)
            fp8mod.COUNTER.plans.clear()
            got = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, config=cfg,
                                  b_layout="t")
            torch.cuda.synchronize()
            assert list(fp8mod.COUNTER.plans) == [fp8mod.plan_label(
                "ring", t, s)]
            assert bf16_within_one_ulp(to_numpy(got), to_numpy(ref))
            if s == 1:
                outs.append(got)
    tile = fp8mod._launch(a_q, a_s, b_q, b_s.t(), fp8mod._SHIFT, True,
                          torch.bfloat16, plan=("tile", 0, 1))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], tile)


def test_a_config_outside_the_compiled_set_raises(dev):
    """A tile the route does not compile raises ValueError before any
    launch; nothing is substituted."""
    g = _gen(70, dev)
    a = torch.randn(64, 256, generator=g, device=dev)
    b = torch.randn(256, 128, generator=g, device=dev)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    off = torch.randn(64 * 256 + 8, generator=g, device=dev).to(
        torch.bfloat16)[1:1 + 64 * 256].view(64, 256)
    a_q, a_s, b_q, b_s = _int8_operands((16, 256), (128, 256), True, dev, 71)
    fa, fas, fb, fbs = _operands(16, 256, 256, True, dev, seed=72)
    before = {n: c.launches for n, c in _kernels.COUNTERS.items()}
    cases = [
        lambda: gemm_with_config(a16, b16, config=GemmConfig(256, 256, 64)),
        lambda: gemm_with_config(a, b, config=GemmConfig(128, 256, 64)),
        lambda: gemm_with_config(off, b16, config=GemmConfig(128, 256, 64)),
        lambda: gemm_with_config(a16, b16, config=GemmConfig(
            96, 96, 64, kernel_type=KernelType.KSPLIT, k_split=2)),
        lambda: i8mod.int8_gemm_with_config(a_q, a_s, b_q, b_s,
                                            config=GemmConfig(64, 128, 128),
                                            b_layout="t"),
        lambda: fp8mod.fp8_gemm(fa, fas, fb, fbs, b_layout="t",
                                config=GemmConfig(128, 128, 128)),
        lambda: fp8mod.fp8_gemm(fa, fas, fb.t().contiguous(),
                                fbs.t().contiguous(), config=GemmConfig(
                                    64, 64, 128,
                                    kernel_type=KernelType.KSPLIT,
                                    k_split=2)),
        lambda: fp8mod.fp8_gemm(fa, fas, fb, fbs, b_layout="t",
                                config=GemmConfig(
                                    16, 64, 128,
                                    kernel_type=KernelType.KSPLIT,
                                    k_split=9))]
    for i, case in enumerate(cases):
        with pytest.raises(ValueError):
            case()
    assert {n: c.launches for n, c in _kernels.COUNTERS.items()} == before


def test_a_cache_entry_changes_the_launched_tile(dev, tmp_path):
    """A cache entry for a shape (the autotuner's winner) is what gemm(),
    int8_gemm() and fp8_gemm() with no config launch: its tile, counted
    under its plan."""
    kind = cachemod.device_kind(dev)
    path = str(tmp_path / "t.jsonl")
    c = cachemod.TilingCache(path)
    entries = {
        ("gemm", 2048, 2048, 2048, "bfloat16", "float32"):
            GemmConfig(128, 128, 64),
        ("int8_gemm_nt", 2048, 2816, 2048, "int8", "bfloat16"):
            GemmConfig(128, 128, 128),
        ("fp8_gemm_nt", 16, 2048, 2048, "float8_e4m3fn", "bfloat16"):
            GemmConfig(64, 64, 128, kernel_type=KernelType.KSPLIT,
                       k_split=4)}
    for (op, m, n, k, i, o), cfg in entries.items():
        c.set(cachemod.cache_key(op, m, n, k, i, o, "g128"), cfg)
    try:
        cachemod.reset_global_cache(path, kind=kind)
        a, b, _, _ = _dense(2048, 2048, 2048, torch.bfloat16, "nn", dev, 73)
        k10 = _kernels.COUNTERS["gemm"]
        k10.plans.clear()
        got = gemm(a, b)
        assert list(k10.plans) == ["wgmma 128x128"]
        a_q, a_s, b_q, b_s = _int8_operands((2048, 2048), (2816, 2048), True,
                                            dev, 74)
        i8mod.K7.plans.clear()
        i8 = i8mod.int8_gemm(a_q, a_s, b_q, b_s, b_layout="t")
        assert list(i8mod.K7.plans) == ["wgmma 128x128"]
        fa, fas, fb, fbs = _operands(16, 2048, 2048, True, dev, seed=75)
        fp8mod.COUNTER.plans.clear()
        f = fp8mod.fp8_gemm(fa, fas, fb, fbs, b_layout="t")
        assert list(fp8mod.COUNTER.plans) == ["ring 64x64/4"]
        torch.cuda.synchronize()
        assert_gemm_close(got, gemm_plain(a, b), a, b)
        assert torch.equal(i8, i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s,
                                                     b_t=True))
        assert bf16_within_one_ulp(to_numpy(f), to_numpy(
            fp8mod.fp8_gemm_plain(fa, fas, fb, fbs.t(), b_t=True)))
    finally:
        cachemod.reset_global_cache(None, kind=kind)


@pytest.mark.parametrize("kind", ["act", "weight", "int8"])
def test_quantizers_on_the_card_equal_the_cpu_bit_for_bit(dev, kind):
    """The quantizers divide by a tensor on every device (a CUDA kernel
    dividing by a Python scalar multiplies by its reciprocal, rounding
    twice): the card's bytes and scales equal the CPU's, which equal the
    JAX package's."""
    g = torch.Generator().manual_seed(21)
    x = torch.randn(3, 256, 640, generator=g) * torch.logspace(
        -3, 3, 640)[None, None]
    fn = {"act": quant.quantize_fp8_act, "weight": quant.quantize_fp8_weight,
          "int8": lambda t: quant.quantize_int8(t, axis=-1)}[kind]
    for got, want in zip(fn(x.to(dev)), fn(x)):
        assert got.dtype == want.dtype
        assert torch.equal(got.cpu().view(torch.uint8),
                           want.view(torch.uint8))


def test_loader_on_the_card_equals_the_cpu(dev):
    """load_params quantizes on the device it is given: a TINY checkpoint
    loaded on the card equals the CPU load byte for byte."""
    import dataclasses
    from deepgemm_ascend_tpu_torch.models import TINY, load_params
    rng = np.random.default_rng(3)
    cfg = TINY
    h = cfg.hidden_size
    w = lambda *s: rng.standard_normal(s, dtype=np.float32) * 0.02
    state = {"model.embed_tokens.weight": w(cfg.vocab_size, h),
             "model.norm.weight": np.ones(h, np.float32),
             "lm_head.weight": w(cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = np.ones(h, np.float32)
        state[p + "post_attention_layernorm.weight"] = np.ones(h, np.float32)
        for n, o, k in (("q", cfg.q_dim, h), ("k", cfg.kv_dim, h),
                        ("v", cfg.kv_dim, h), ("o", h, cfg.q_dim)):
            state[p + f"self_attn.{n}_proj.weight"] = w(o, k)
        if i < cfg.first_dense_layers:
            pre = [("mlp.", cfg.dense_intermediate)]
        else:
            state[p + "mlp.gate.weight"] = w(cfg.num_experts, h)
            pre = [(f"mlp.experts.{j}.", cfg.moe_intermediate)
                   for j in range(cfg.num_experts)]
            pre.append(("mlp.shared_experts.", cfg.moe_intermediate))
        for q, inter in pre:
            state[p + q + "gate_proj.weight"] = w(inter, h)
            state[p + q + "up_proj.weight"] = w(inter, h)
            state[p + q + "down_proj.weight"] = w(h, inter)

    def leaves(obj):
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, list):
            for o in obj:
                yield from leaves(o)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                yield from leaves(getattr(obj, f.name))
    card = list(leaves(load_params(state, cfg, device=dev)))
    cpu = list(leaves(load_params(state, cfg, device="cpu")))
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        assert a.is_cuda and torch.equal(a.cpu().view(torch.uint8),
                                          b.view(torch.uint8))


def test_mesh_engine_on_a_local_mesh_serves_the_one_device_tokens(
        dev, tmp_path):
    """Engine(mesh=make_mesh(1, 1, 1)) over a one-rank NCCL group of this
    process — the sharded steps with every axis of size 1 — serves the
    one-device engine's tokens, and a chunk of decode steps is captured
    (no gloo group to force eager steps)."""
    import torch.distributed as dist
    from deepgemm_ascend_tpu_torch.models import TINY, init_params
    from deepgemm_ascend_tpu_torch.parallel import make_mesh, sharded
    from deepgemm_ascend_tpu_torch.serving import Engine
    params = init_params(0, TINY, device=dev)
    prompts = [[1, 2, 3], list(range(5, 40)), [7] * 20, [9, 8]]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, 1)
        for chunk in (1, 4):
            want = Engine(params, TINY, max_slots=4, max_seq_len=128,
                          decode_chunk=chunk, device=dev).generate(prompts, 8)
            eng = Engine(params, TINY, max_slots=4, max_seq_len=128,
                         decode_chunk=chunk, device=dev, mesh=mesh)
            assert eng.generate(prompts, 8) == want
            assert (eng._graph is not None) == (chunk > 1)
    finally:
        sharded.clear_program_memo()
        dist.destroy_process_group()


# ---- the grouped GEMMs' and K12's tiles from the tiling tiers


def _grouped_case(op, dev, seed):
    """(call(plan) → output, default call, rows, plans, counter) of one
    grouped op on the card: routed-like loads (0, 1, 15, 16, 40, 96 rows
    of M_max 96; expected_m 3) for the masked ops, the layout of 70, 0 and
    130 rows in 128-row m-tiles plus a padding tile for the contiguous
    ones; each compiled tile of the route as its (route, tile code)."""
    e, n, k = 6, 256, 384
    int8 = op.startswith("int8")
    masked = "masked" in op
    g = _gen(seed, dev)
    if masked:
        loads = [0, 1, 15, 16, 40, 96]
        a = torch.randn(e, 96, k, generator=g, device=dev)
        mm = torch.tensor(loads, dtype=torch.int32, device=dev)
    else:
        _, gids, _ = ggmod.make_contiguous_layout([70, 0, 130, 0, 0, 0], 128)
        ids = torch.from_numpy(np.append(gids, -1).astype(np.int32))
        a = torch.randn(ids.numel() * 128, k, generator=g, device=dev)
    w = torch.randn(e, n, k, generator=g, device=dev) / k ** 0.5
    if int8:
        a_q, a_s = quant.quantize_int8(a * 3, axis=-1)
        b_q, b_s = quant.quantize_int8(w, axis=-1)
        b_s = b_s.transpose(-1, -2)
        bs_view = b_s
    else:
        a_q, a_s = quant.quantize_fp8_act(a)
        b_q, b_s = quant.quantize_fp8_weight(w)
        bs_view = b_s.transpose(1, 2)
    rt = analytic.expected_route(op, 96 if masked else 128, n, k, a_q.dtype)
    plans = [analytic.kernel_plan(op, rt, *t)
             for _, t in analytic.route_tiles(op, rt)]
    bf16 = torch.bfloat16
    if masked and int8:
        call = lambda p: i8mod._launch_masked(a_q, a_s, b_q, b_s, mm, True,
                                              bf16, plan=p, expected_m=3)
        default = lambda: i8mod.m_grouped_int8_gemm_masked(
            a_q, a_s, b_q, b_s, mm, b_layout="t", expected_m=3)
        return call, default, loads, plans, i8mod.K6
    if masked:
        call = lambda p: ggmod._launch(a_q, a_s, b_q, bs_view, fp8mod._SHIFT,
                                       mm, True, bf16, plan=p, expected_m=3)
        default = lambda: ggmod.m_grouped_gemm_masked(
            a_q, a_s, b_q, b_s, mm, b_layout="t", expected_m=3)
        return call, default, loads, plans, ggmod.COUNTER
    if int8:
        call = lambda p: i8mod._launch_contiguous(a_q, a_s, b_q, b_s, ids,
                                                  128, True, bf16, plan=p)
        default = lambda: i8mod.m_grouped_int8_gemm_contiguous(
            a_q, a_s, b_q, b_s, ids, b_layout="t")
        return call, default, None, plans, i8mod.K9
    call = lambda p: ggmod._launch_contiguous(a_q, a_s, b_q, bs_view,
                                              fp8mod._SHIFT, ids, 128, True,
                                              bf16, plan=p)
    default = lambda: ggmod.m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s,
                                                      ids, b_layout="t")
    return call, default, None, plans, ggmod.K8


@pytest.mark.parametrize("op", ["grouped_gemm_masked_nt",
                                "int8_grouped_gemm_masked_nt",
                                "grouped_gemm_nt", "int8_grouped_gemm_nt"])
def test_every_grouped_tile_equals_the_default_tile(dev, op):
    """Each compiled tile of K3, K6, K8 and K9 on the card gives the
    default tile's bits on every row the kernel defines (a masked op's
    valid rows; every row of a contiguous one): the K step is the same on
    every tile and the int8 sums are exact."""
    call, default, loads, plans, _ = _grouped_case(op, dev, seed=90)
    want = default()
    for p in plans:
        got = call(p)
        torch.cuda.synchronize()
        if loads is None:
            assert torch.equal(got, want), p
        else:
            for e, rows in enumerate(loads):
                assert torch.equal(got[e, :rows], want[e, :rows]), (p, e)


@pytest.mark.parametrize("m", [16, 200, 2048])
@pytest.mark.parametrize("n", [512, 2944])
@pytest.mark.parametrize("b_layout", ["t", "n"])
def test_k12_tile_codes_each_match_the_plain_version(dev, m, n, b_layout):
    """K12 on every compiled tile (tile codes 0-2; 128 × 256 where 256
    divides n, and refused where it does not, by the wrapper and by the C
    entry) within the plain version's tolerance, through a caller's config
    and through the tile code alike."""
    b_t = b_layout == "t"
    k = 512
    a_q, a_s, b_q, b_s = _operands(m, n, k, b_t, dev, seed=91)
    bs_view = b_s.t() if b_t else b_s
    ref = fp8mod.fp8_gemm_folded_plain(a_q, a_s, b_q, bs_view, b_t=b_t)
    a_sc, b_sc = fp8mod.fold_operands(a_q, a_s, b_q, bs_view, b_t=b_t)
    kw = dict(b_layout=b_layout, scale_mode="folded", allow_relaxed=True)
    for code, (bm, bn) in enumerate(analytic.FOLDED_TILES):
        cfg = GemmConfig(bm, bn, 128)
        if n % bn:
            with pytest.raises(ValueError, match="256"):
                fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, config=cfg, **kw)
            with pytest.raises(RuntimeError, match="CUDA error"):
                fp8mod._launch(a_q, a_s, b_q, bs_view, fp8mod._SHIFT, b_t,
                               torch.bfloat16, folded=True, plan=code)
            continue
        got = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, config=cfg, **kw)
        by_code = fp8mod._launch(a_q, a_s, b_q, bs_view, fp8mod._SHIFT, b_t,
                                 torch.bfloat16, folded=True, plan=code)
        torch.cuda.synchronize()
        assert torch.equal(got, by_code)
        assert_gemm_close(got, ref, a_sc, b_sc)


def test_memoised_grouped_selection_moves_the_tiers_once_a_shape(dev):
    """A grouped wrapper called again at a shape it has seen pays a lookup:
    the tiers' counters move once a (shape, expected_m), the launches take
    the analytic tile (K3 16 × 64 at decode, 64 × 64 past 16 rows), and a
    cache entry for the shape moves the next launch to its tile."""
    from deepgemm_ascend_tpu_torch.tiling import platform, selector
    from deepgemm_ascend_tpu_torch.utils.logging import metrics
    a_q, a_s, b_q, b_s, mm = _masked_operands(96, [3] * 4, dev, seed=92)
    kind = platform.detect(dev).device_kind
    cachemod.reset_global_cache(None, kind=kind)
    selector.clear_predictors()
    try:
        metrics.reset()
        ggmod.COUNTER.plans.clear()
        for _ in range(4):
            for em in (3, 24):
                ggmod.m_grouped_gemm_masked(a_q, a_s, b_q, b_s, mm,
                                            b_layout="t", expected_m=em)
        torch.cuda.synchronize()
        snap = metrics.snapshot()
        assert snap.get("tiling.cache_miss") == 2
        assert snap.get("tiling.analytic_pick") == 2
        assert dict(ggmod.COUNTER.plans) == {"ring 16x64": 4,
                                             "ring 64x64": 4}
        key = cachemod.cache_key("grouped_gemm_masked_nt", 96, 256, 384,
                                 "float8_e4m3fn", "bfloat16", "g128e3")
        cachemod.global_cache(kind).set(key, GemmConfig(64, 64, 128),
                                        persist=False)
        ggmod.COUNTER.plans.clear()
        ggmod.m_grouped_gemm_masked(a_q, a_s, b_q, b_s, mm, b_layout="t",
                                    expected_m=3)
        torch.cuda.synchronize()
        assert dict(ggmod.COUNTER.plans) == {"ring 64x64": 1}
    finally:
        cachemod.reset_global_cache(None, kind=kind)


# ---- serving on the card: prefill forwards captured as CUDA graphs ----

# TINY with a dense FFN in every layer: the dense path at head_dim 128.
def _tiny_dense128():
    import dataclasses
    from deepgemm_ascend_tpu_torch.models import TINY
    return dataclasses.replace(TINY, num_experts=0, num_shared_experts=0,
                               top_k=0, moe_intermediate=0,
                               first_dense_layers=TINY.num_layers)


def _prefill_engine(dev, cfg, **kw):
    """An engine on the card whose caches hold random rows, so that a
    prefix hit attends a history."""
    from deepgemm_ascend_tpu_torch.models import init_params
    from deepgemm_ascend_tpu_torch.serving import Engine
    eng = Engine(init_params(0, cfg, device=dev), cfg, max_slots=8,
                 max_seq_len=256, device=dev, **kw)
    g = _gen(5, dev)
    for c in eng.caches:
        for q in (c.k_q, c.v_q):
            q.copy_(torch.randint(-127, 128, q.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        for s in (c.k_s, c.v_s):
            s.uniform_(0.001, 0.02, generator=g)
    return eng


def _prefill_group_arrays(cfg, bucket, rows, seed, hit=0, max_slots=8,
                          s_pad=1):
    """A bucket group's prefill arrays: ``rows`` prompts in random slots
    (the first with a prefix hit of ``hit`` tokens), padded to a power of
    two rows, at least ``s_pad``."""
    rng = np.random.default_rng(seed)
    while s_pad < rows:
        s_pad *= 2
    toks = np.zeros((s_pad, bucket), np.int32)
    total = np.ones((s_pad,), np.int32)
    last = np.zeros((s_pad,), np.int32)
    pstart = np.zeros((s_pad,), np.int32)
    slots = np.full((s_pad,), -1, np.int32)
    for i, slot in enumerate(rng.permutation(max_slots)[:rows]):
        n = int(rng.integers(1, bucket + 1))
        toks[i, :n] = rng.integers(1, cfg.vocab_size, size=n)
        start = hit if i == 0 else 0
        total[i], last[i], pstart[i], slots[i] = start + n, n - 1, start, slot
    return toks, total, last, pstart, slots


PREFILL_GROUPS = [(16, 1, 0), (32, 2, 0), (64, 3, 0), (32, 1, 64)]


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
@pytest.mark.parametrize("bucket,rows,hit", PREFILL_GROUPS,
                         ids=["b16_s1", "b32_s2", "b64_s4", "b32_hit64"])
def test_prefill_graph_replay_equals_eager_prefill(dev, moe, bucket, rows,
                                                   hit):
    """From one engine state, a bucket group's captured prefill replayed
    and the eager ``_prefill`` (then the engine's sampling) give the same
    sampled tokens and bit-equal caches, lengths and last tokens; a second
    group of the shape, staged into the same graph, too."""
    from deepgemm_ascend_tpu_torch.models import TINY
    from deepgemm_ascend_tpu_torch.serving.engine import (_prefill,
                                                          _PrefillGraph)
    cfg = TINY if moe else _tiny_dense128()
    eng = _prefill_engine(dev, cfg)
    start = _state(eng)
    pg = None
    for seed in (1, 2):
        arrays = _prefill_group_arrays(cfg, bucket, rows, seed, hit)
        _restore(eng, start)
        eager_tok = eng._sample(_prefill(eng.params, eng.caches, cfg,
                                         *arrays)).clone()
        eager = _state(eng)
        _restore(eng, start)
        if pg is None:
            pg = _PrefillGraph(*arrays[0].shape, dev)
            pg.stage(*arrays, eng.max_slots)
            eng._capture_prefill(pg)
        else:
            pg.stage(*arrays, eng.max_slots)
        pg.graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(pg.sampled, eager_tok)
        graph = _state(eng)
        for a, b in zip(eager[0], graph[0]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not all(torch.equal(x, y)
                       for x, y in zip(graph[0][0], start[0][0]))
    assert set(n for n, (l, _) in pg.launches.items() if l) == (
        {"fp8_gemm", "grouped_gemm", "flash_prefill"} if moe
        else {"fp8_gemm", "flash_prefill"})
    assert all(calls == 0 for _, calls in pg.launches.values())


def test_engine_prefill_runs_eager_then_captures_then_replays(dev):
    """Three groups of one shape through the engine: the first eager, the
    second captured and replayed, the third replayed; their tokens those
    of the eager prefill from the same states, each replay counted with
    its launches; a shape over the cap keeps no graph."""
    from deepgemm_ascend_tpu_torch.serving.engine import _prefill
    cfg = _tiny_dense128()
    eng = _prefill_engine(dev, cfg)
    _kernels.reset_counters()
    for i, seed in enumerate((1, 2, 3)):
        arrays = _prefill_group_arrays(cfg, 32, 2, seed)
        start = _state(eng)
        want = eng._sample(_prefill(eng.params, eng.caches, cfg,
                                    *arrays)).clone()
        eager = _state(eng)
        _restore(eng, start)
        got = eng._prefill_sampled(*arrays).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for a, b in zip(eager[0], _state(eng)[0]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert eng.stats["prefill_graph_replays"] == i
        assert eng.stats["prefill_graph_captures"] == min(i, 1)
    pg = eng._prefill_graphs[(2, 32)]
    for n, (per_replay, _) in pg.launches.items():
        assert _kernels.COUNTERS[n].captured == per_replay
        assert _kernels.COUNTERS[n].replayed == 2 * per_replay
    assert eng.stats["prefill_graph_capture_s"] > 0
    big = _prefill_group_arrays(cfg, 256, 8, 4, s_pad=16)  # 16 rows × 256
    eng._prefill_sampled(*big)
    eng._prefill_sampled(*big)
    assert list(eng._prefill_graphs) == [(2, 32)]
    eng.caches = None
    assert eng._prefill_graphs == {} and eng._prefill_pool is None


def test_engine_serves_through_prefill_graphs(dev):
    """An engine whose admissions repeat their shapes replays prefill
    graphs and serves the tokens of an engine that keeps none."""
    from deepgemm_ascend_tpu_torch.models import TINY, init_params
    from deepgemm_ascend_tpu_torch.serving import Engine
    params = init_params(0, TINY, device=dev)
    prompts = [[5, 17, 301, 2, 44], list(range(100, 120)), [7] * 17,
               [9, 8, 7], list(range(200, 221)), [3] * 9, [1, 2]]

    def serve(graphs):
        eng = Engine(params, TINY, max_slots=2, max_seq_len=128,
                     decode_chunk=4, device=dev)
        eng._prefill_graphs_on = graphs
        return eng, eng.generate(prompts, max_new_tokens=6)

    eng, got = serve(True)
    _, want = serve(False)
    assert got == want
    assert eng.stats["prefill_graph_replays"] >= 1


@pytest.mark.parametrize("positions", [
    [[0, 1, 2, 3], [8, 9, 10, 11]], [[28, 29, 30, 31], [30, 31, 32, 33]],
    [[32, 33, 34, 35], [40, 41, 42, 43]], [[-2, -1, 0, 1], [-4, -3, -2, -1]],
    [[31], [32]]], ids=["in_range", "straddle", "all_past", "negative",
                        "decode"])
def test_cache_write_on_the_card_equals_the_cpu_scatter(dev, positions):
    """The card's cache write (no count read back) leaves the cache as the
    CPU's ``nonzero`` scatter does, rows past the end dropped."""
    from deepgemm_ascend_tpu_torch.models.attention import KVCache
    pos = torch.tensor(positions, dtype=torch.int32)
    b, s = pos.shape
    g = torch.Generator().manual_seed(1)
    k, v = (torch.randn((b, s, 2, 128), generator=g) for _ in range(2))
    caches = {}
    for d in ("cpu", dev):
        c = KVCache.create(b, 32, 2, 128, device=d)
        c.k_q.fill_(3)
        c.v_s.fill_(0.5)
        caches[str(d)] = c.update(k.to(d), v.to(d), pos.to(d))
    for n in ("k_q", "k_s", "v_q", "v_s"):
        assert torch.equal(getattr(caches["cpu"], n),
                           getattr(caches["cuda"], n).cpu())


def test_a_host_sync_in_a_prefill_capture_raises(dev, monkeypatch):
    """A forward that reads a count back cannot be captured: the capture
    raises, and no forward falls back to eager. (Last in the file: the
    failed capture is left behind.)"""
    from deepgemm_ascend_tpu_torch.models.attention import KVCache
    from deepgemm_ascend_tpu_torch.serving.engine import _PrefillGraph
    cfg = _tiny_dense128()
    eng = _prefill_engine(dev, cfg)
    arrays = _prefill_group_arrays(cfg, 16, 1, 1)
    real = KVCache.write_quantized_no_sync

    def synced(self, k_q, k_s, v_q, v_s, positions):
        torch.nonzero(positions >= 0)
        return real(self, k_q, k_s, v_q, v_s, positions)

    monkeypatch.setattr(KVCache, "write_quantized_no_sync", synced)
    pg = _PrefillGraph(*arrays[0].shape, dev)
    pg.stage(*arrays, eng.max_slots)
    with pytest.raises(RuntimeError):
        eng._capture_prefill(pg)
    assert pg.graph is None
