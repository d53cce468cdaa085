"""The CPU-side pieces of the contiguous grouped GEMMs' Hopper routes, K8
(fp8, route "wgmma16") and K9 (int8, route "wgmma"): which route the
stored operands and the layout's ``block_m`` take, the tile beside it,
that a CPU tensor still runs only the plain version, and the plain
versions held against the JAX ops at the layouts the new routes take
(block_m 64, 128 and 256; a padding tile (-1) in the middle of the layout
and at its end; an expert with no rows).

The JAX side runs its Pallas kernels in interpret mode on the CPU.
Tolerances as in ``test_torch_grouped_gemm.py`` and
``test_torch_int8_gemm.py``: fp8 f32 outputs within the outlier gate,
bf16 ones within one bf16 ulp; int8 bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu.ops import grouped_gemm as jg
from deepgemm_ascend_tpu.ops import int8_gemm as ji
from deepgemm_ascend_tpu.ops import quant as jq
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as tg
from deepgemm_ascend_tpu_torch.ops import int8_gemm as ti
from deepgemm_ascend_tpu_torch.tiling import analytic
from torch_bridge import bf16_within_one_ulp, f32_close, to_numpy, to_torch


def _bytes(shape, dtype, offset=0):
    """Random bytes of ``shape`` viewed as ``dtype``, ``offset`` bytes into
    their storage."""
    n = int(np.prod(shape))
    g = torch.Generator().manual_seed(n + offset)
    raw = torch.randint(0, 120, (n + offset,), generator=g,
                        dtype=torch.uint8)
    return raw[offset:].view(dtype).view(*shape)


# ---- the routes and their tiles

ROUTE_CASES = {
    # case: (b_layout, block_m, k, A offset, B offset)
    "t block_m 128": ("t", 128, 256, 0, 0),
    "t block_m 64": ("t", 64, 256, 0, 0),
    "t block_m 256": ("t", 256, 256, 0, 0),
    "t block_m 192": ("t", 192, 256, 0, 0),
    "t block_m 96": ("t", 96, 256, 0, 0),
    "t block_m 32": ("t", 32, 256, 0, 0),
    "n block_m 128": ("n", 128, 256, 0, 0),
    "t a off 16 bytes": ("t", 128, 256, 1, 0),
    "t a off 32 bytes": ("t", 128, 256, 32, 0),
    "t b off 16 bytes": ("t", 128, 256, 0, 4),
    "t k 144": ("t", 128, 144, 0, 0),
    "t k 1000": ("t", 128, 1000, 0, 0),
}
# What each case takes: K8 (k a multiple of 128, its wrapper's own rule,
# or the tile route) and K9 (k a multiple of 16).
K8_WANT = {"t block_m 128": "wgmma16", "t block_m 64": "wgmma16",
           "t block_m 256": "wgmma16", "t block_m 192": "wgmma16",
           "t a off 32 bytes": "wgmma16"}
K9_WANT = {case: "wgmma" for case in (*K8_WANT, "t k 144")}


def _route_operands(case, dtype):
    b_layout, block_m, k, a_off, b_off = ROUTE_CASES[case]
    e, n = 3, 256
    a = _bytes((2 * block_m, k), dtype, a_off)
    b = _bytes((e, k, n) if b_layout == "n" else (e, n, k), dtype, b_off)
    return a, b, b_layout, block_m


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_k8_contiguous_route(case):
    """wgmma16 takes B stored K-major ('t') with a block_m that 64 divides
    (no tile spans two experts), k a multiple of 128 and 16-byte-aligned
    pointers; 'n', block_m 96 or 32, an operand off 16 bytes and a k that
    128 does not divide stay on the tile route."""
    a, b, b_layout, block_m = _route_operands(case, torch.float8_e4m3fn)
    assert tg.contiguous_route(a, b, b_layout, block_m) == K8_WANT.get(
        case, "tile")


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_k9_contiguous_route(case):
    """K9's wgmma takes what K7's does (B stored K-major, k a multiple of
    16, 16-byte-aligned pointers) with a block_m that 64 divides; else
    int8_tile."""
    a, b, b_layout, block_m = _route_operands(case, torch.int8)
    assert ti.contiguous_route(a, b, b_layout, block_m) == K9_WANT.get(
        case, "int8_tile")


def test_k8_contiguous_route_rejects_an_unknown_layout():
    a, b = _bytes((128, 128), torch.float8_e4m3fn), _bytes(
        (2, 128, 128), torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="b_layout"):
        tg.contiguous_route(a, b, "x", 128)


@pytest.mark.parametrize("block_m", [64, 128, 192, 256, 384, 512])
def test_contiguous_tile_divides_block_m(block_m):
    """The tile index of both Hopper routes: the 128-row tile where 128
    divides block_m, else the 64-row one; either way the tile's rows
    divide block_m, for K8's tiles (rows x 128) and K9's (64 x 64, 128 x
    256)."""
    tile = analytic.contiguous_tile(block_m)
    assert tile == int(block_m % 128 == 0)
    for tiles in (tg.CONTIGUOUS_TILES, ti.MASKED_WGMMA_TILES):
        assert block_m % tiles[tile][0] == 0
    rows = tg.CONTIGUOUS_TILES[tile][0]
    assert tg.contiguous_plan_label("wgmma16", tile) == f"wgmma16 {rows}x128"
    assert ti.masked_plan_label("wgmma", tile) == "wgmma {}x{}".format(
        *ti.MASKED_WGMMA_TILES[tile])
    assert tg.contiguous_plan_label("tile", 0) == "tile"
    assert ti.masked_plan_label("int8_tile", 0) == "int8_tile"


# ---- the plain versions against JAX at the new routes' layouts

# (expert loads, block_m, where the padding tiles go): an empty expert in
# every case; a padding tile in the middle of the layout and at its end.
LAYOUTS = {"block_m 64": ([70, 0, 130], 64),
           "block_m 128": ([130, 0, 70], 128),
           "block_m 256": ([0, 300, 20], 256)}


def _layout(case):
    """Tile ids of ``case``'s layout with a padding tile after the first
    tile and one at the end, and its rows."""
    counts, block_m = LAYOUTS[case]
    _, gids, _ = jg.make_contiguous_layout(counts, block_m)
    gids = np.concatenate([gids[:1], [-1], gids[1:], [-1]]).astype(np.int32)
    return gids, gids.size * block_m, block_m


@pytest.mark.parametrize("case", sorted(LAYOUTS))
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_k8_plain_matches_jax_at_the_wgmma16_layouts(case, out):
    """K8's plain version (B K-major, the wgmma16 route's layout) against
    the JAX op; both padding tiles exactly zero."""
    jd, td = ((jnp.float32, torch.float32) if out == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    gids, m, block_m = _layout(case)
    e, n, k = 3, 256, 256
    rng = np.random.default_rng(block_m)
    a_q, a_s = jq.quantize_fp8_act(jnp.asarray(
        rng.standard_t(df=4, size=(m, k)), jnp.float32))
    b_q, b_s = jq.quantize_fp8_weight(jnp.asarray(
        rng.normal(size=(e, n, k)) / k ** 0.5, jnp.float32))
    want = np.asarray(jg.m_grouped_gemm_contiguous(
        a_q, a_s, b_q, b_s, jnp.asarray(gids), out_dtype=jd, b_layout="t"),
        np.float32)
    k8 = tg.K8.plain_calls
    got = to_numpy(tg.m_grouped_gemm_contiguous(
        to_torch(a_q), to_torch(a_s), to_torch(b_q), to_torch(b_s),
        torch.from_numpy(gids), out_dtype=td, b_layout="t"))
    assert tg.K8.plain_calls == k8 + 1
    for pad in (slice(block_m, 2 * block_m), slice(m - block_m, m)):
        assert not got[pad].any() and not want[pad].any()
    if out == "f32":
        res = f32_close(got, want)
        assert res.ok, res
    else:
        assert bf16_within_one_ulp(got, want)


@pytest.mark.parametrize("case", sorted(LAYOUTS))
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_k9_plain_matches_jax_at_the_wgmma_layouts(case, out):
    """K9's plain version (B K-major) against the JAX op bit for bit; both
    padding tiles zero."""
    jd, td = ((jnp.float32, torch.float32) if out == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    gids, m, block_m = _layout(case)
    e, n, k = 3, 192, 208
    rng = np.random.default_rng(block_m + 1)
    a_q, a_s = jq.quantize_int8(jnp.asarray(
        rng.standard_t(df=4, size=(m, k)), jnp.float32), axis=-1)
    b_q, b_s = jq.quantize_int8(jnp.asarray(
        rng.normal(size=(e, k, n)) / k ** 0.5, jnp.float32), axis=-2)
    want = np.asarray(ji.m_grouped_int8_gemm_contiguous(
        a_q, a_s, b_q, b_s, jnp.asarray(gids), out_dtype=jd), np.float32)
    b_nk = torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(b_q), -1, -2)))
    k9 = ti.K9.plain_calls
    got = to_numpy(ti.m_grouped_int8_gemm_contiguous(
        to_torch(a_q), to_torch(a_s), b_nk, to_torch(b_s), gids,
        out_dtype=td, b_layout="t"))
    assert ti.K9.plain_calls == k9 + 1
    np.testing.assert_array_equal(got, want)
    for pad in (slice(block_m, 2 * block_m), slice(m - block_m, m)):
        assert not got[pad].any()


@pytest.mark.parametrize("op", ["fp8", "int8"])
def test_contiguous_on_the_cpu_runs_only_the_plain_version(op):
    """Operands that take the Hopper route on the card still run only the
    plain version on the CPU: no launch is counted."""
    gids, m, block_m = _layout("block_m 128")
    e, n, k = 3, 128, 256
    if op == "fp8":
        a = _bytes((m, k), torch.float8_e4m3fn)
        b = _bytes((e, n, k), torch.float8_e4m3fn)
        a_s, b_s = torch.ones(m, k // 128), torch.ones(e, n // 128, k // 128)
        assert tg.contiguous_route(a, b, "t", block_m) == "wgmma16"
        counter, run = tg.K8, lambda: tg.m_grouped_gemm_contiguous(
            a, a_s, b, b_s, gids, b_layout="t")
    else:
        a, b = _bytes((m, k), torch.int8), _bytes((e, n, k), torch.int8)
        a_s, b_s = torch.ones(m, 1), torch.ones(e, 1, n)
        assert ti.contiguous_route(a, b, "t", block_m) == "wgmma"
        counter, run = ti.K9, lambda: ti.m_grouped_int8_gemm_contiguous(
            a, a_s, b, b_s, gids, b_layout="t")
    plain, launches = counter.plain_calls, counter.launches
    out = run()
    assert (counter.plain_calls - plain, counter.launches - launches) == (1, 0)
    assert out.shape == (m, n) and not out[block_m:2 * block_m].any()
