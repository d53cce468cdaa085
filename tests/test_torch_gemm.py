"""Port gemm / bgemm / gemm_with_config (K10 and K11's CPU paths) and the
port's tiling vs the JAX package's.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the
port runs the kernels' plain versions (one f32 matmul, or one per split).
Both sum exact products of the rounded inputs in f32, in different orders:
an f32 output must lie within GEMM_REL_TOL = 1e-5 of Σ|a·b| of JAX's
(a reordered f32 sum over K terms moves by at most K·2⁻²⁴ of Σ|a·b|, and by
~√K·2⁻²⁴ for random rounding: 2e-6 at the K ≤ 1024 used here). A bf16
output may differ by one bf16 ulp: two such f32 sums can round to
neighbouring bf16 values.
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
from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType, SwizzleDir
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops.gemm import route
from deepgemm_ascend_tpu_torch.tiling import analytic, platform, selector
from torch_bridge import bf16_within_one_ulp, to_numpy

GEMM_REL_TOL = 1e-5
K10 = _kernels.COUNTERS["gemm"]
K11 = _kernels.COUNTERS["gemm_ksplit"]
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16),
          "f32": (jnp.float32, torch.float32)}
# tests/test_gemm.py's shapes: aligned, ragged M/N/K tails, skinny decode M
# and prime-ish tails.
SHAPES = [(128, 128, 128), (256, 512, 384), (96, 1536, 608), (8, 256, 736),
          (100, 130, 70), (257, 129, 257)]


def _operands(m, n, k, dtype, seed):
    """Heavy-tailed inputs rounded to ``dtype``, as JAX arrays and CPU
    tensors with the same bits, and their f32 values."""
    a, b, _ = golden.gen_golden_gemm(m, n, k, seed=seed)
    jd, td = DTYPES[dtype]
    ja, jb = jnp.asarray(a, jd), jnp.asarray(b, jd)
    a32 = np.array(ja, np.float32)
    b32 = np.array(jb, np.float32)
    return ja, jb, torch.from_numpy(a32).to(td), torch.from_numpy(b32).to(td), \
        a32, b32


def assert_matches(got, want, a32, b32):
    """f32: within GEMM_REL_TOL of Σ|a·b| (the module docstring); bf16: one
    bf16 ulp."""
    is_f32 = got.dtype == torch.float32
    got, want = to_numpy(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if is_f32:
        scale = np.abs(a32.astype(np.float64)) @ np.abs(b32.astype(np.float64))
        np.testing.assert_array_less(np.abs(got - want), GEMM_REL_TOL * scale
                                     + 1e-30)
    else:
        assert bf16_within_one_ulp(got, want)


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", ["bf16", "fp16", "f32"])
def test_gemm_matches_jax(m, n, k, dtype):
    ja, jb, ta, tb, a32, b32 = _operands(m, n, k, dtype, seed=m * 7 + n)
    want = jdga.gemm(ja, jb)
    before = K10.plain_calls
    got = tdga.gemm(ta, tb)
    assert got.dtype == torch.float32
    assert K10.plain_calls == before + 1       # CPU: K10's plain version
    assert_matches(got, want, a32, b32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_gemm_bf16_out_matches_jax(dtype):
    ja, jb, ta, tb, a32, b32 = _operands(100, 130, 70, dtype, seed=2)
    want = np.asarray(jdga.gemm(ja, jb, out_dtype=jnp.bfloat16), np.float32)
    got = tdga.gemm(ta, tb, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert bf16_within_one_ulp(to_numpy(got), want)


@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("m,n,k", [(128, 256, 384), (64, 128, 736),
                                   (100, 130, 128)])
def test_gemm_layouts_match_jax(layout, m, n, k):
    ja, jb, ta, tb, a32, b32 = _operands(m, n, k, "bf16", seed=m + n + k)
    ja, ta = (ja.T, ta.t().contiguous()) if layout[0] == "t" else (ja, ta)
    jb, tb = (jb.T, tb.t().contiguous()) if layout[1] == "t" else (jb, tb)
    want = jdga.gemm(ja, jb, layout=layout)
    got = tdga.gemm(ta, tb, layout=layout)
    assert_matches(got, want, a32, b32)


@pytest.mark.parametrize("k_split,m,n,k", [(4, 32, 128, 1024),
                                           (3, 16, 128, 900)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_gemm_ksplit_matches_jax(k_split, m, n, k, dtype):
    """tests/test_gemm.py's split-K cases: 4 even splits, and 3 uneven ones
    over a ragged K. The port runs K11's plain version (its own 64-deep
    blocks; JAX splits 128-deep blocks)."""
    ja, jb, ta, tb, a32, b32 = _operands(m, n, k, dtype, seed=9)
    want = jdga.gemm_with_config(ja, jb, config=JConfig(
        block_m=m, block_n=128, block_k=128,
        kernel_type=JKernelType.KSPLIT, k_split=k_split))
    before = K11.plain_calls
    got = tdga.gemm_with_config(ta, tb, config=GemmConfig(
        kernel_type=KernelType.KSPLIT, k_split=k_split))
    assert K11.plain_calls == before + 1
    assert_matches(got, want, a32, b32)


@pytest.mark.parametrize("case", ["layout_nt", "too_few_blocks", "split_1"])
def test_ksplit_falls_back_to_k10_as_jax_does(case):
    """KSPLIT runs K11 only for nn with k_split > 1 and at least k_split
    K blocks (JAX gemm.py:171-173); otherwise K10."""
    a = torch.ones(16, 128)
    b = torch.ones(128, 64)
    layout, cfg = "nn", GemmConfig(kernel_type=KernelType.KSPLIT, k_split=4)
    if case == "layout_nt":
        layout, b = "nt", b.t().contiguous()
    elif case == "too_few_blocks":
        cfg = cfg.replace(k_split=3)              # 128 = 2 blocks of 64
    else:
        cfg = cfg.replace(k_split=1)
    k10, k11 = K10.plain_calls, K11.plain_calls
    out = tdga.gemm_with_config(a, b, config=cfg, layout=layout)
    assert (K10.plain_calls - k10, K11.plain_calls - k11) == (1, 0)
    assert torch.equal(out, torch.full((16, 64), 128.0))


@pytest.mark.parametrize("kind", ["pad_k", "xla", "swizzle"])
def test_gemm_config_knobs_match_jax(kind):
    """pad_k pads K with zeros (exact), KernelType.XLA is one f32 product
    outside the kernels, and the raster order changes no value."""
    ja, jb, ta, tb, a32, b32 = _operands(64, 128, 300, "bf16", seed=5)
    jcfg, tcfg = JConfig(block_m=64, block_n=128, block_k=128), GemmConfig()
    if kind == "pad_k":
        jcfg, tcfg = jcfg.replace(pad_k=True), tcfg.replace(pad_k=True)
    elif kind == "xla":
        jcfg = jcfg.replace(kernel_type=JKernelType.XLA)
        tcfg = tcfg.replace(kernel_type=KernelType.XLA)
    else:
        from deepgemm_ascend_tpu.config import SwizzleDir as JSwizzle
        jcfg = jcfg.replace(swizzle=JSwizzle.N_MAJOR)
        tcfg = tcfg.replace(swizzle=SwizzleDir.N_MAJOR)
    want = jdga.gemm_with_config(ja, jb, config=jcfg)
    got = tdga.gemm_with_config(ta, tb, config=tcfg)
    assert_matches(got, want, a32, b32)


@pytest.mark.parametrize("ksplit", [False, True])
def test_bgemm_matches_jax(ksplit):
    """tests/test_gemm.py's batch of 3, and a 2 × 2 batch (one launch on
    the card: the flattened batch is the kernel's third grid axis)."""
    rng = np.random.default_rng(1)
    for lead in ((3,), (2, 2)):
        a = rng.normal(size=(*lead, 32, 200)).astype(np.float32)
        b = rng.normal(size=(*lead, 200, 128)).astype(np.float32)
        jcfg = tcfg = None
        if ksplit:
            jcfg = JConfig(block_m=32, block_n=128, block_k=128,
                           kernel_type=JKernelType.KSPLIT, k_split=2)
            tcfg = GemmConfig(kernel_type=KernelType.KSPLIT, k_split=2)
        want = np.asarray(jdga.bgemm(jnp.asarray(a), jnp.asarray(b),
                                     config=jcfg))
        got = tdga.bgemm(torch.from_numpy(a), torch.from_numpy(b),
                         config=tcfg)
        assert got.shape == (*lead, 32, 128)
        for idx in np.ndindex(*lead):
            assert_matches(got[idx], want[idx], a[idx], b[idx])


ERRORS = {
    "inner_dims": ((4, 8), (9, 4), "nn"),
    "bad_layout": ((16, 32), (32, 16), "xy"),
    "layout_inner_dims": ((16, 32), (48, 16), "nt"),
    "rank_3": ((2, 4, 8), (2, 8, 4), "nn"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
@pytest.mark.parametrize("entry", ["gemm", "gemm_with_config"])
def test_gemm_raises_as_jax(case, entry):
    sa, sb, layout = ERRORS[case]
    kw = {"layout": layout}
    jfn, tfn = jdga.gemm, tdga.gemm
    if entry == "gemm_with_config":
        jfn, tfn = jdga.gemm_with_config, tdga.gemm_with_config
        kw_j, kw_t = dict(kw, config=JConfig()), dict(kw, config=GemmConfig())
    else:
        kw_j = kw_t = kw
    with pytest.raises(ValueError):
        jfn(jnp.zeros(sa, jnp.bfloat16), jnp.zeros(sb, jnp.bfloat16), **kw_j)
    with pytest.raises(ValueError):
        tfn(torch.zeros(sa, dtype=torch.bfloat16),
            torch.zeros(sb, dtype=torch.bfloat16), **kw_t)


def test_bgemm_rank_mismatch_raises_as_jax():
    with pytest.raises(ValueError):
        jdga.bgemm(jnp.zeros((2, 4, 8)), jnp.zeros((2, 2, 8, 4)))
    with pytest.raises(ValueError):
        tdga.bgemm(torch.zeros(2, 4, 8), torch.zeros(2, 2, 8, 4))


# ---------------------------------------------------------------- tiling

H100 = platform.PlatformInfo("NVIDIA H100 80GB HBM3", 132)


# K10's route (ops/gemm.py:route): the stored operands and what TMA needs.
# Each case: (m, n, k, offset of A's data, offset of B's data, batch), in
# elements; the expected route follows from the stored row pitches.
ROUTE_CASES = {
    "aligned": (64, 128, 256, 0, 0, 1),
    "edges": (130, 136, 1000, 0, 0, 1),       # pitches 1000/136 or 130
    "unaligned_a": (64, 128, 256, 1, 0, 1),
    "unaligned_b": (64, 128, 256, 0, 3, 1),
    "odd_m": (65, 128, 256, 0, 0, 1),         # a pitch only when A is (k, m)
    "odd_k": (64, 128, 1001, 0, 0, 1),        # a pitch of A (m, k) or B (n, k)
    "odd_n": (64, 97, 256, 0, 0, 1),          # a pitch only when B is (k, n)
    "batch": (200, 136, 1000, 0, 0, 3),
    "k0": (64, 128, 0, 0, 0, 1),
}


def _stored(shape, dtype, offset):
    """A contiguous tensor of ``shape`` whose data starts ``offset``
    elements into its buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(*shape)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
@pytest.mark.parametrize("dtype", ["bf16", "fp16", "f32"])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
def test_route_is_wgmma_where_tma_describes_both_operands(case, dtype,
                                                          layout):
    m, n, k, off_a, off_b, batch = ROUTE_CASES[case]
    td = DTYPES[dtype][1]
    lead = (batch,) if batch > 1 else ()
    a_t, b_t = layout[0] == "t", layout[1] == "t"
    a = _stored((*lead, *((k, m) if a_t else (m, k))), td, off_a)
    b = _stored((*lead, *((n, k) if b_t else (k, n))), td, off_b)
    pitches = (m if a_t else k, k if b_t else n)
    # f32 takes route ffma where 16-byte loads can read both operands:
    # aligned data and row pitches of whole 16-byte chunks (4 elements).
    if dtype == "f32":
        want = ("ffma" if off_a % 4 == 0 and off_b % 4 == 0
                and all(p % 4 == 0 for p in pitches) else "mma_tile")
    else:
        want = ("wgmma" if k > 0 and off_a % 8 == 0 and off_b % 8 == 0
                and all(p % 8 == 0 for p in pitches) else "mma_tile")
    assert route(a, b, layout) == want
    if case in ("aligned", "edges", "batch") and dtype != "f32":
        assert want == ("mma_tile" if case == "edges" and a_t else "wgmma")


@pytest.mark.parametrize("offset,pitch,want", [
    (0, 256, "ffma"),          # aligned, whole 16-byte row chunks
    (4, 256, "ffma"),          # 16 bytes into the buffer: still aligned
    (2, 256, "mma_tile"),      # 8 bytes off
    (1, 256, "mma_tile"),
    (0, 258, "mma_tile"),      # a row pitch of 1032 bytes
    (0, 4, "ffma"),
])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn", "tt"])
def test_f32_route_is_ffma_where_16_byte_loads_read_both(offset, pitch,
                                                         want, layout):
    """f32 takes route ffma where 16-byte cp.async can read both stored
    operands (16-byte aligned data, stored last dims that are multiples of
    4), else mma_tile; the offset and the stored last dim here are A's (and
    B's where it is stored (n, k)); 16-bit or mixed operands never take
    it."""
    a_t, b_t = layout[0] == "t", layout[1] == "t"
    k = 64 if a_t else pitch
    a = _stored((k, pitch) if a_t else (64, pitch), torch.float32, offset)
    b = _stored((96, k) if b_t else (k, 96), torch.float32, 0)
    assert route(a, b, layout) == want
    assert route(a.to(torch.bfloat16), b.to(torch.bfloat16), layout) != "ffma"
    assert route(a, b.to(torch.bfloat16), layout) == "mma_tile"


@pytest.mark.parametrize("rt", [None, "mma_tile", "ffma", "wgmma"])
@pytest.mark.parametrize("ksplit", [False, True])
def test_a_cpu_tensor_runs_the_plain_version_whatever_the_route(rt, ksplit):
    """On the CPU K10's and K11's wrappers run their plain versions
    whatever route is asked for: no launch, no route counted."""
    from deepgemm_ascend_tpu_torch.ops.gemm import (gemm_ksplit_plain,
                                                    gemm_plain)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(16, 640)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(640, 96)).astype(np.float32))
    cfg = (GemmConfig(kernel_type=KernelType.KSPLIT, k_split=4) if ksplit
           else GemmConfig())
    counter = K11 if ksplit else K10
    before = (counter.launches, counter.plain_calls, dict(counter.plans))
    got = tdga.gemm_with_config(a, b, config=cfg, plan=rt)
    assert (counter.launches, counter.plain_calls, counter.plans) == (
        before[0], before[1] + 1, before[2])
    want = gemm_ksplit_plain(a, b, 4) if ksplit else gemm_plain(a, b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("entry", ["gemm", "gemm_with_config", "bgemm"])
def test_an_unknown_plan_is_refused_before_any_product(entry):
    """``plan`` names one of ``ROUTES``; another name raises, on the CPU
    too, before the plain version runs."""
    a = torch.ones(2, 16, 32)
    b = torch.ones(2, 32, 8)
    before = (K10.launches, K10.plain_calls)
    call = {"gemm": lambda: tdga.gemm(a[0], b[0], plan="tf32"),
            "gemm_with_config": lambda: tdga.gemm_with_config(
                a[0], b[0], config=GemmConfig(), plan="tf32"),
            "bgemm": lambda: tdga.bgemm(a, b, plan="tf32")}[entry]
    with pytest.raises(ValueError, match="plan must be one of"):
        call()
    assert (K10.launches, K10.plain_calls) == before


@pytest.mark.parametrize("m,n,k", [(16, 2048, 11008), (16, 512, 2048),
                                   (2048, 22016, 2048), (1, 1, 1)])
def test_select_config_on_cpu_is_common(m, n, k):
    """A CPU tensor counts as one core: never split (JAX's one-core
    answer), and a single tile is SMALL."""
    cfg = tdga.select_config(m, n, k, torch.bfloat16, torch.float32,
                             device="cpu")
    want = KernelType.SMALL if (m, n, k) == (1, 1, 1) else KernelType.COMMON
    assert (cfg.kernel_type, cfg.k_split) == (want, 1)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == (
        selector.TILE_M, selector.TILE_N, selector.TILE_K)


@pytest.mark.parametrize("m,n,k,want", [
    # 32 tiles, 172 K blocks: K11/8 0.0319 ms, K10 0.0460 on the card
    (16, 2048, 11008, (KernelType.KSPLIT, 8)),
    # 44 tiles, 32 K blocks: K10 0.0144, K11 at best 0.0157 (3 splits)
    (16, 2816, 2048, (KernelType.COMMON, 1)),
    # 8 tiles, 32 K blocks: K11/8 0.0119 against K10's 0.0129, below the
    # model's margin
    (16, 512, 2048, (KernelType.COMMON, 1)),
    (16, 22016, 2048, (KernelType.COMMON, 1)),   # 344 tiles fill the card
    (2048, 2048, 2048, (KernelType.COMMON, 1)),  # 128 x 256 tiles
    (16, 2048, 192, (KernelType.COMMON, 1)),     # 3 K blocks: too shallow
    (64, 64, 64, (KernelType.SMALL, 1)),
])
def test_select_kernel_type_on_an_h100(m, n, k, want):
    """The split gate at V2_LITE's decode shapes; the times are
    scripts/ksplit_sweep.py's on an H100 (analytic's docstring)."""
    got = analytic.select_kernel_type(m, n, k, 64, 64, 64, H100)
    assert got == want


def test_select_kernel_type_minimises_the_makespan():
    """The modelled time over the allowed split counts (SPLITS, each split
    at least MIN_BLOCKS_PER_SPLIT blocks deep), ties to fewer splits; KSPLIT
    only below MARGIN of K10's modelled time, and never where K10 runs
    128 x 256 tiles."""
    for m, n, k in [(16, 2048, 11008), (16, 2816, 2048), (32, 1024, 4096),
                    (16, 2048, 1408), (256, 512, 11008), (2048, 512, 2048)]:
        kt, s = analytic.select_kernel_type(m, n, k, 64, 64, 64, H100)
        nk = -(-k // 64)
        cost = {c: analytic.model_seconds(m, n, k, c, 64, 64, 64, H100)
                for c in analytic.SPLITS
                if nk // c >= analytic.MIN_BLOCKS_PER_SPLIT}
        best = min(cost, key=lambda c: (cost[c], c))
        k10 = analytic.model_seconds(m, n, k, 1, 64, 64, 64, H100)
        split = (cost[best] <= analytic.MARGIN * k10
                 and not analytic.large_tile(m, n))
        assert (kt, s) == ((KernelType.KSPLIT, best) if split
                           else (KernelType.COMMON, 1))


def test_select_config_override_wins_and_ksplit_is_nn_only(monkeypatch):
    cfg = GemmConfig(block_m=8, kernel_type=KernelType.KSPLIT, k_split=7)
    assert tdga.select_config(16, 2048, 11008, override=cfg,
                              device="cpu") is cfg
    monkeypatch.setattr(platform, "detect", lambda device: H100)
    assert tdga.select_config(16, 2048, 11008, op="gemm").k_split == 8
    assert tdga.select_config(16, 2048, 11008, op="gemm_nt").kernel_type == \
        KernelType.COMMON


def test_platform_envelope_of_the_cpu():
    info = platform.detect("cpu")
    assert info.num_cores == 1 and info.device_kind == "cpu"
