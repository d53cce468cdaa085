"""The CPU-side pieces of the Hopper routes of K7 and K11, and the split
gate that chooses between K10 and K11.

K7's route (``ops.int8_gemm.route``) is decided on the stored operands;
on CPU tensors the decision is the same as on the card, though the CPU
runs the plain version whatever it says. K11 splits K into the ranges of
``ops.gemm.split_ranges``, which the wrapper passes to the kernel (its
``k_per``) and the plain version slices by: they are held against the JAX
kernel's own split (``_gemm_ksplit``: ``nk_per_split`` blocks a split,
the overrun clamped and zeroed), and the plain version against JAX's
``_gemm_ksplit`` run in interpret mode at a ragged K with an empty last
split. The sums of the two packages agree within GEMM_REL_TOL = 1e-5 of
Σ|a·b| (the same exact products of the rounded inputs, summed in f32 in
another order; ~√K·2⁻²⁴ ≈ 1.4e-6 at K ≤ 1088).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepgemm_ascend_tpu as jdga
from deepgemm_ascend_tpu.config import GemmConfig as JConfig
from deepgemm_ascend_tpu.config import KernelType as JKernelType
from deepgemm_ascend_tpu.utils import golden
import deepgemm_ascend_tpu_torch as tdga
from deepgemm_ascend_tpu_torch.config import KernelType
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import int8_gemm as i8mod
from deepgemm_ascend_tpu_torch.ops.gemm import (_split_depth,
                                                gemm_ksplit_plain,
                                                ksplit_partials_plain,
                                                split_ranges)
from deepgemm_ascend_tpu_torch.tiling import analytic, platform
from torch_bridge import to_numpy

GEMM_REL_TOL = 1e-5
K11 = _kernels.COUNTERS["gemm_ksplit"]


def _int8(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


# ---- K7's route


@pytest.mark.parametrize("case,want", [
    ("t aligned", "wgmma"),
    ("t k=16", "wgmma"),
    ("n", "int8_tile"),
    ("t k=1000", "int8_tile"),
    ("t a offset", "int8_tile"),
    ("t b offset", "int8_tile"),
])
def test_int8_route(case, want):
    """wgmma takes B stored K-major ('t'), k a multiple of 16 and 16-byte
    aligned data pointers; everything else stays on int8_tile."""
    m, n = 33, 200
    k = {"t k=16": 16, "t k=1000": 1000}.get(case, 512)
    a = _int8((m, k))
    b = _int8((k, n) if case == "n" else (n, k), seed=1)
    if case == "t a offset":
        a = _int8((m * k + 1,))[1:].view(m, k)
    if case == "t b offset":
        b = _int8((n * k + 1,), seed=1)[1:].view(n, k)
    assert a.is_contiguous() and b.is_contiguous()
    assert i8mod.route(a, b, "n" if case == "n" else "t") == want


def test_int8_route_rejects_an_unknown_layout():
    a, b = _int8((16, 64)), _int8((64, 64))
    with pytest.raises(ValueError, match="b_layout"):
        i8mod.route(a, b, "x")


@pytest.mark.parametrize("b_layout", ["t", "n"])
def test_int8_gemm_on_the_cpu_runs_the_plain_version(b_layout):
    """Whatever the route says, a CPU tensor runs K7's plain version (and
    only that): the wgmma route's operands give the same bits."""
    m, n, k = 16, 64, 256
    a = _int8((m, k))
    b = _int8((n, k) if b_layout == "t" else (k, n), seed=2)
    a_s = torch.rand(m, 1) * 0.02 + 1e-3
    b_s = torch.rand(1, n) * 0.02 + 1e-3
    k7 = i8mod.K7
    plain, launches = k7.plain_calls, k7.launches
    got = i8mod.int8_gemm(a, a_s, b, b_s, b_layout=b_layout)
    assert (k7.plain_calls - plain, k7.launches - launches) == (1, 0)
    want = i8mod.int8_gemm_plain(a, a_s, b, b_s, b_t=b_layout == "t")
    assert torch.equal(got, want)


# ---- K11's split ranges


def _jax_split_ranges(k, k_split, bk=64):
    """The element range each split of JAX's _gemm_ksplit sums
    (gemm.py:226-262): blocks [s·nps, (s+1)·nps) with nps = ceil(nk /
    k_split), a block at or past nk clamped and zeroed, the tail block
    masked at k."""
    nk = -(-k // bk)
    nps = -(-nk // k_split)
    return [(min(s * nps, nk) * bk if s * nps < nk else k,
             min((s + 1) * nps * bk, k)) for s in range(k_split)]


@pytest.mark.parametrize("k,k_split,want", [
    (576, 4, [(0, 192), (192, 384), (384, 576), (576, 576)]),   # nk=9
    (540, 4, [(0, 192), (192, 384), (384, 540), (540, 540)]),   # ragged
    (320, 4, [(0, 128), (128, 256), (256, 320), (320, 320)]),   # nk=5
    (1000, 3, [(0, 384), (384, 768), (768, 1000)]),
    (2048, 4, [(0, 512), (512, 1024), (1024, 1536), (1536, 2048)]),
    (11008, 8, [(i * 1408, (i + 1) * 1408) for i in range(7)]
     + [(9856, 11008)]),
])
def test_split_ranges_match_jax(k, k_split, want):
    got = split_ranges(k, k_split)
    assert got == want == _jax_split_ranges(k, k_split)
    assert got[0][1] == _split_depth(k, k_split) and got[-1][1] == k


@pytest.mark.parametrize("k,k_split", [(576, 4), (320, 4), (1000, 3)])
def test_ksplit_partials_plain_slices_by_the_ranges(k, k_split):
    """Each partial is the f32 product of its range (an empty range gives
    exact zeros), and the wrapper's sum of them is gemm_ksplit_plain."""
    m, n = 5, 24
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    parts = ksplit_partials_plain(a.to(torch.bfloat16), b.to(torch.bfloat16),
                                  k_split)
    assert parts.shape == (k_split, m, n) and parts.dtype == torch.float32
    a16, b16 = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    for s, (lo, hi) in enumerate(split_ranges(k, k_split)):
        if lo == hi:
            assert bool((parts[s] == 0).all())
        else:
            assert torch.equal(parts[s], a16[:, lo:hi] @ b16[lo:hi])
    summed = gemm_ksplit_plain(a.to(torch.bfloat16), b.to(torch.bfloat16),
                               k_split)
    assert torch.equal(summed, parts.sum(dim=0))


@pytest.mark.parametrize("k,k_split", [(540, 4), (576, 4), (1088, 3)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ksplit_plain_matches_jax_ksplit(k, k_split, dtype):
    """K11's plain version against JAX's _gemm_ksplit (interpret mode) on
    the same 64-deep blocks: k = 540 and 576 have 9 blocks, so the last of
    4 splits is empty (JAX clamps it and zeroes A); 1088 = 17 blocks in 3
    uneven splits."""
    m, n = 16, 128
    a, b, _ = golden.gen_golden_gemm(m, n, k, seed=k)
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f32": (jnp.float32, torch.float32)}[dtype]
    ja, jb = jnp.asarray(a, jd), jnp.asarray(b, jd)
    a32, b32 = np.array(ja, np.float32), np.array(jb, np.float32)
    want = np.asarray(jdga.gemm_with_config(ja, jb, config=JConfig(
        block_m=m, block_n=128, block_k=64,
        kernel_type=JKernelType.KSPLIT, k_split=k_split)), np.float32)
    before = K11.plain_calls
    got = gemm_ksplit_plain(torch.from_numpy(a32).to(td),
                            torch.from_numpy(b32).to(td), k_split)
    assert K11.plain_calls == before + 1
    scale = np.abs(a32.astype(np.float64)) @ np.abs(b32.astype(np.float64))
    np.testing.assert_array_less(np.abs(to_numpy(got) - want),
                                 GEMM_REL_TOL * scale + 1e-30)


# ---- the split gate (tiling/analytic.py), case by case

H100 = platform.PlatformInfo("NVIDIA H100 80GB HBM3", 132)


@pytest.mark.parametrize("m,n,k,want", [
    # Each split the gate picks, with scripts/ksplit_sweep.py's cold ms of
    # K11 at that count and of K10 on an H100 (analytic's docstring).
    (16, 512, 11008, (KernelType.KSPLIT, 16)),   # 0.0172 vs 0.0401
    (16, 1024, 11008, (KernelType.KSPLIT, 16)),  # 0.0224 vs 0.0413
    (16, 2048, 10944, (KernelType.KSPLIT, 8)),   # 0.0325 vs 0.0458
    (1, 1024, 4096, (KernelType.KSPLIT, 16)),    # 0.0152 vs 0.0195
    (64, 1024, 4096, (KernelType.KSPLIT, 6)),    # 0.0159 vs 0.0195
    (128, 2048, 11008, (KernelType.KSPLIT, 4)),  # 0.0372 vs 0.0470
    (256, 512, 11008, (KernelType.KSPLIT, 8)),   # 0.0221 vs 0.0407
    # ... and where it does not: K11's best against K10.
    (16, 2048, 2048, (KernelType.COMMON, 1)),    # 0.0148 vs 0.0140
    (16, 2048, 1408, (KernelType.COMMON, 1)),    # 0.0135 vs 0.0120
    (16, 4096, 4096, (KernelType.COMMON, 1)),    # 0.0265: 1.11x, < margin
    (256, 2048, 11008, (KernelType.COMMON, 1)),  # 0.0433: 1.10x, < margin
    (128, 22016, 2048, (KernelType.COMMON, 1)),  # 128 x 256 tiles
    (2048, 512, 2048, (KernelType.COMMON, 1)),   # 256 tiles: a full wave
])
def test_split_gate_case_by_case(m, n, k, want):
    assert analytic.select_kernel_type(m, n, k, 64, 64, 64, H100) == want


@pytest.mark.parametrize("m,n,want", [(64, 22016, False), (129, 22016, True),
                                      (2048, 2048, True), (2048, 512, False),
                                      (1280, 2560, True), (1152, 2560, False)])
def test_large_tile_mirrors_the_kernels_rule(m, n, want):
    """sm90::large_tile: m > 64 and ceil(m/128)·ceil(n/256) >= 100."""
    assert analytic.large_tile(m, n) == want


def test_split_gate_on_the_cpu_never_splits():
    """A CPU tensor counts as one core (two slots): a split only adds
    waves, so the gate answers COMMON where the card splits."""
    cpu = platform.detect("cpu")
    for m, n, k in [(16, 512, 11008), (16, 2048, 11008), (1, 1024, 4096)]:
        assert analytic.select_kernel_type(m, n, k, 64, 64, 64, cpu) == (
            KernelType.COMMON, 1)
        assert tdga.select_config(m, n, k, device="cpu").kernel_type == \
            KernelType.COMMON
