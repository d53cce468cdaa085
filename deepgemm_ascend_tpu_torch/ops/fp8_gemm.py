"""FP8 blockwise-scaled GEMM (kernels K1 and K12).

Port of ``deepgemm_ascend_tpu/ops/fp8_gemm.py``. A carries per-(token,
128-channel) scales, B per-(128×128 block) scales. Two scale modes:

* ``scale_mode="accum"`` (K1, the default): the scales are applied to the
  f32 accumulator once per 128-deep K group, in group order:

      C = Σ_g (A_g · B_g) · a_s[:, g] · b_s[g, :]

* ``scale_mode="folded"`` (K12, opt-in with ``allow_relaxed=True``): the
  scales are folded into the operands, which are rounded to bf16, and one
  bf16 product with an f32 sum follows:

      C = Σ bf16(a · a_s) · bf16(b · b_s)

  The two roundings (at most 2⁻⁸ relative each) keep it within a 5e-3
  rel-L2 of K1 but outside the strict outlier gate, hence the opt-in.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/fp8_gemm.cu``. K1 takes one of two routes (:func:`route`): "ring"
— a TMA ring of 128-deep scale groups fed by a producer warp — where TMA
can read the operands (B stored K-major, ``b_layout='t'``, the port's
weights), else "tile" (64×64 tiles, synchronous loads); both keep one
output element's arithmetic, so they agree bit for bit unless the ring
splits K. K1's config (the caller's, else ``select_config``'s under op
``fp8_gemm_nt`` / ``fp8_gemm``, whose analytic answer is
:func:`ring_plan`'s) sets the ring's row tile (``block_m × block_n``, one
of :data:`RING_TILES`; the tile route takes 64 × 64 only, anything else
raises ``ValueError``) and its split plan (``KernelType.KSPLIT`` with
``k_split`` CTAs of a cluster, at most 8; the tile route never splits).
``KernelType.XLA`` (accum mode only) is the JAX realization outside
Pallas in plain torch ops: each 128-deep group's product in f32, scaled,
summed over the groups. K12 runs on the Hopper main loop of
``csrc/sm90_gemm.cuh`` (TMA loads of the e4m3 bytes, a fold into bf16
overlapped with wgmma) on route "folded": a 64 × 64, 128 × 128 or
128 × 256 tile (the last where 256 divides n), the caller's config's or
the tiling tiers' (``select_config`` under the same op with the route in
its key; the analytic answer is the rule the kernel compiled in before,
``tiling.analytic.folded_tile``); a caller's K12 tile is checked on every
device (:func:`folded_tile_code`). On a CPU tensor they run
:func:`fp8_gemm_plain` or :func:`fp8_gemm_folded_plain`, the same
arithmetic in PyTorch.

``mxu_dtype`` (JAX's type for each group's dot, on the TPU's MXU): e4m3
converts exactly to f16, bf16 and f32, and K1 already sums each group on
f16 tensor cores with f32 accumulation, so ``None`` and those three run
the same kernel, and the plain version the same arithmetic (JAX's cast of
each group's operands to the type changes no value). The public entries
check it: any other type raises ``ValueError``, as does
``KernelType.XLA`` with an ``mxu_dtype`` (JAX's message); the folded mode
ignores it, as JAX's does.

The TPU package lane-expands B's block scales to a (k/128, n) panel for its
kernel; the port keeps them compact and addresses them through strides.
:func:`expand_weight_scales` and ``b_scales_expanded=True`` remain for
callers that hold such a panel.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..config import GemmConfig, KernelType
from ..tiling import analytic, platform
from ..tiling.analytic import (MAX_SPLIT_GROUPS, MAX_SPLITS,  # noqa: F401
                               MIN_SPLIT_GROUPS, RING_TILES, ring_plan,
                               ring_splits, ring_tile)
from ..tiling.selector import FOLDED, launch_config
from ..tiling.padding import pad_fp8_operands, pad_fp8_operands_nt
from . import _kernels
from .quant import BLOCK, FP8

__all__ = ["fp8_gemm", "fp8_gemm_with_config", "fp8_gemm_plain",
           "fp8_gemm_folded_plain", "fp8_gemm_xla", "fold_operands",
           "expand_weight_scales", "exact_mode", "route", "ring_plan",
           "config_plan", "plan_label"]

COUNTER = _kernels.COUNTERS["fp8_gemm"]
FOLDED_COUNTER = _kernels.COUNTERS["fp8_gemm_folded"]
SCALE_MODES = ("accum", "folded")
# The types a group's dot may take (mxu_dtype): each holds e4m3 exactly.
MXU_DTYPES = (torch.float16, torch.bfloat16, torch.float32)
_SHIFT = BLOCK.bit_length() - 1        # column → scale-block index: col >> 7

# K1's (and K3's) routes, numbered as the C entries number them.
ROUTES = ("tile", "ring")
# The ring's tiles (rows, columns), in the order of the C entries' index
# (csrc/fp8_gemm.cuh: Tile16, Tile64), its split rule and K1's default
# plan live in tiling/analytic.py (RING_TILES, ring_tile, ring_splits,
# ring_plan; MAX_SPLITS CTAs of a portable cluster).
H100_SMS = platform.H100_SMS

# Route fp8 GEMMs (dense + grouped) through an exact emulated-dequant f32
# matmul instead of the kernels: the golden model at model scale. Read at
# call time (the port has no tracing).
_exact = False


@contextlib.contextmanager
def exact_mode():
    """Context manager: fp8 ops compute the emulated-dequant f32 reference
    (≙ ops/reference.py, in PyTorch) for its duration."""
    global _exact
    prev, _exact = _exact, True
    try:
        yield
    finally:
        _exact = prev


def exact_enabled() -> bool:
    return _exact


def expand_weight_scales(b_scales: torch.Tensor, n: int) -> torch.Tensor:
    """(kb, nb) → (kb, n): repeat each block scale across its 128 columns."""
    kb, nb = b_scales.shape[-2:]
    if nb * BLOCK < n:
        raise ValueError(f"b_scales cover {nb * BLOCK} cols < n={n}")
    return torch.repeat_interleave(b_scales.to(torch.float32), BLOCK,
                                   dim=-1)[..., :n]


def _scale_panel(bs_view: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """(…, kb, n) f32 panel from a scale view indexed [g, col >> shift]."""
    bs = bs_view.to(torch.float32)
    return (torch.repeat_interleave(bs, 1 << shift, dim=-1)[..., :n]
            if shift else bs)


def _dequant_a(a_q: torch.Tensor, a_scales: torch.Tensor) -> torch.Tensor:
    k = a_q.shape[-1]
    s = torch.repeat_interleave(a_scales.to(torch.float32), BLOCK,
                                dim=-1)[..., :k]
    return a_q.to(torch.float32) * s


def _exact_gemm(a_q, a_scales, b_q, bs_view, shift, b_t, out_dtype):
    """Emulated-dequant f32 golden: dequantize both operands, one matmul."""
    n = b_q.shape[-2] if b_t else b_q.shape[-1]
    panel = _scale_panel(bs_view, shift, n)                   # (…, kb, n)
    b_kn = b_q.transpose(-1, -2) if b_t else b_q
    b = b_kn.to(torch.float32) * torch.repeat_interleave(panel, BLOCK, dim=-2)
    return torch.matmul(_dequant_a(a_q, a_scales), b).to(out_dtype)


def _plain_gemm(a_q, a_scales, b_q, panel, b_t, out_dtype):
    """Group-by-group f32 accumulation, in group order, as the kernel does."""
    m, k = a_q.shape
    n = panel.shape[-1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_q.device)
    a_s = a_scales.to(torch.float32)
    for g in range(k // BLOCK):
        sl = slice(g * BLOCK, (g + 1) * BLOCK)
        a_g = a_q[:, sl].to(torch.float32)
        b_g = (b_q[:, sl].to(torch.float32).t() if b_t
               else b_q[sl].to(torch.float32))
        p = a_g @ b_g
        acc = acc + (p * a_s[:, g:g + 1]) * panel[g:g + 1]
    return acc.to(out_dtype)


def fp8_gemm_plain(a_q, a_scales, b_q, bs_view, *, shift: int = _SHIFT,
                   b_t: bool = False, out_dtype=torch.bfloat16):
    """Plain PyTorch version of K1: the kernel's function on any device.

    ``bs_view`` is indexed ``[g, col >> shift]``: the compact (kb, nb) scales
    with ``shift=7`` (for ``b_t`` pass the transposed view of (nb, kb)), or
    an expanded (kb, n) panel with ``shift=0``."""
    COUNTER.plain_calls += 1
    n = b_q.shape[0] if b_t else b_q.shape[1]
    return _plain_gemm(a_q, a_scales, b_q, _scale_panel(bs_view, shift, n),
                       b_t, out_dtype)


def fold_operands(a_q, a_scales, b_q, bs_view, *, shift: int = _SHIFT,
                  b_t: bool = False):
    """K12's operands: each e4m3 value times its block scale in f32, rounded
    once to bf16. Returns (a (m, k), b (k, n)) bf16; ``bs_view`` as in
    :func:`fp8_gemm_plain`."""
    n = b_q.shape[0] if b_t else b_q.shape[1]
    panel = torch.repeat_interleave(_scale_panel(bs_view, shift, n), BLOCK,
                                    dim=0)                        # (k, n)
    b_kn = (b_q.t() if b_t else b_q).to(torch.float32)
    return (_dequant_a(a_q, a_scales).to(torch.bfloat16),
            (b_kn * panel).to(torch.bfloat16))


def fp8_gemm_folded_plain(a_q, a_scales, b_q, bs_view, *, shift: int = _SHIFT,
                          b_t: bool = False, out_dtype=torch.bfloat16):
    """Plain PyTorch version of K12: :func:`fold_operands`, then one f32
    product of the bf16 values."""
    FOLDED_COUNTER.plain_calls += 1
    a_sc, b_sc = fold_operands(a_q, a_scales, b_q, bs_view, shift=shift,
                               b_t=b_t)
    return torch.matmul(a_sc.to(torch.float32),
                        b_sc.to(torch.float32)).to(out_dtype)


def _check_scale_mode(scale_mode: str, allow_relaxed: bool) -> None:
    """Numerics gate: ``folded`` trades ~2^-9 multiplicand rounding for one
    full-block dot per step — within its documented 5e-3 rel-L2 contract but
    OUTSIDE the strict outlier-ratio ≤ 1e-4 acceptance gate on heavy-tail
    data. Require explicit opt-in so nobody picks it expecting gate-clean
    output. (An unknown mode raises here; the JAX package would run it as
    ``folded``.)"""
    if scale_mode not in SCALE_MODES:
        raise ValueError(f"scale_mode must be one of {SCALE_MODES}, got "
                         f"{scale_mode!r}")
    if scale_mode == "folded" and not allow_relaxed:
        raise ValueError(
            "scale_mode='folded' fails the strict outlier-ratio <=1e-4 "
            "acceptance gate (documented ~2^-9 operand rounding; 5e-3 "
            "rel-L2 contract). Pass allow_relaxed=True to opt in, or use "
            "the default scale_mode='accum' (gate-clean, dequant in the "
            "f32 accumulator).")


def _check_cuda_operands(name, tensors, device):
    for label, t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def ring_route_ok(a_q, b_q, b_t: bool) -> bool:
    """Whether TMA can read K1's or K3's operands (``a_q`` (…, m, k),
    ``b_q`` (…, n, k) if ``b_t``): B stored K-major, k a positive multiple
    of 128 (each 128-byte box one scale group; the row pitches are then
    multiples of 16 bytes) and 16-byte-aligned data pointers."""
    k = a_q.shape[-1]
    return (b_t and k > 0 and k % BLOCK == 0 and a_q.data_ptr() % 16 == 0
            and b_q.data_ptr() % 16 == 0)


def check_tile_alignment(name, a_q, b_q, b_t: bool) -> None:
    """The tile route reads A, and B stored K-major, in 16-byte words (B
    stored (k, n) byte by byte): raise for a ``data_ptr`` off 16 bytes
    there, which the card would fault on."""
    for label, t in (("a_q", a_q), ("b_q", b_q))[:2 if b_t else 1]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte "
                             f"boundary (the kernel reads it in 16-byte "
                             f"words)")


def route(a_q, b_q, b_layout: str = "n") -> str:
    """K1's route for the stored operands ``a_q`` (m, k) and ``b_q``:
    ``"ring"`` where TMA can read them (:func:`ring_route_ok`: B stored
    K-major, ``b_layout='t'``; k a multiple of 128; 16-byte-aligned
    pointers), else ``"tile"`` (``b_layout='n'``, an offset view)."""
    return "ring" if ring_route_ok(a_q, b_q, _check_layout(b_layout)) \
        else "tile"


def plan_label(rt: str, tile: int, splits: int = 1) -> str:
    """A launch's plan as its wrapper counts it (``Counter.plans``):
    ``"tile"``, or ``"ring RxC"`` with ``"/S"`` for S > 1 splits."""
    if rt != "ring":
        return rt
    label = "ring {}x{}".format(*RING_TILES[tile])
    return label if splits == 1 else f"{label}/{splits}"


def config_plan(config: GemmConfig, rt: str):
    """K1's (tile index, splits) on route ``rt`` from a config: its
    ``block_m × block_n`` one of the route's compiled tiles (the ring's
    :data:`RING_TILES`, the tile route's 64 × 64; else ``ValueError``), its
    splits ``k_split`` for ``KernelType.KSPLIT`` (at most MAX_SPLITS, and
    on the ring only), else 1."""
    tile = analytic.tile_code("fp8_gemm", rt, config.block_m, config.block_n)
    splits = (config.k_split if config.kernel_type == KernelType.KSPLIT
              else 1)
    if splits > 1 and (rt != "ring" or splits > MAX_SPLITS):
        raise ValueError(f"fp8_gemm: {splits} splits on route {rt!r} (the "
                         f"ring takes at most {MAX_SPLITS}, the tile route "
                         f"none)")
    return tile, splits


def folded_tile_code(config: GemmConfig, m: int, n: int, b_t: bool) -> int:
    """K12's tile code of a config: its ``block_m × block_n`` one of the
    folded route's compiled tiles that can run an (m, n) output
    (``analytic.tile_admits``: 128 × 256 only where 256 divides n); else
    ``ValueError``."""
    op = "fp8_gemm_nt" if b_t else "fp8_gemm"
    code = analytic.tile_code(op, FOLDED, config.block_m, config.block_n)
    if not analytic.tile_admits(op, FOLDED, config.block_m, config.block_n,
                                m, n):
        raise ValueError(f"fp8_gemm: the folded {config.block_m}x"
                         f"{config.block_n} tile needs n % 256 == 0, got "
                         f"n={n}")
    return code


def _launch(a_q, a_scales, b_q, bs_view, shift, b_t, out_dtype,
            folded=False, plan=None, config=None):
    """Run K1 (or K12 if ``folded``) on ``a_q``'s device: the kernel for
    CUDA, the plain version for the CPU. Shapes are validated by the
    callers. ``plan``: K1's (route, tile, splits), or K12's tile code, in
    place of :func:`route`'s and the config's (for tests and sweeps, and
    K12's for a caller's config: :func:`folded_tile_code`; the C entry
    refuses what it cannot run); ``config``: K1's tile and splits
    (:func:`config_plan`), else :func:`ring_plan`'s; K12 with no plan
    takes the tiers' tile on route "folded"."""
    dev = a_q.device
    if dev.type == "cpu":
        plain = fp8_gemm_folded_plain if folded else fp8_gemm_plain
        return plain(a_q, a_scales, b_q, bs_view, shift=shift, b_t=b_t,
                     out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fp8_gemm: unsupported device {dev}")
    if a_q.dtype != FP8 or b_q.dtype != FP8:
        raise ValueError(f"fp8_gemm: operands must be {FP8}, got "
                         f"{a_q.dtype}/{b_q.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fp8_gemm: out_dtype must be bf16 or f32 on CUDA, "
                         f"got {out_dtype}")
    a_s = a_scales.to(torch.float32).contiguous()
    bs = bs_view.to(torch.float32)
    _check_cuda_operands("fp8_gemm", [("a_q", a_q), ("a_scales", a_s),
                                      ("b_q", b_q)], dev)
    if bs.device != dev:
        raise ValueError(f"fp8_gemm: b_scales on {bs.device}, expected {dev}")
    m, k = a_q.shape
    n = b_q.shape[0] if b_t else b_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    sbk, sbn = (1, k) if b_t else (n, 1)
    args = (a_q.data_ptr(), a_s.data_ptr(), b_q.data_ptr(), bs.data_ptr(),
            out.data_ptr(), m, n, k, sbk, sbn, bs.stride(0), bs.stride(1),
            shift, int(out_dtype == torch.float32))
    if folded:
        if plan is None:
            op = "fp8_gemm_nt" if b_t else "fp8_gemm"
            plan = folded_tile_code(
                launch_config(m, n, k, FP8, out_dtype, op=op, device=dev,
                              route=FOLDED, k_granularity=BLOCK), m, n, b_t)
        rc = _kernels.entry("fp8_gemm_folded")(*args, plan,
                                               _kernels.stream_ptr(dev))
        _kernels.check(rc, "fp8_gemm_folded")
        FOLDED_COUNTER.launches += 1
        return out
    if plan is None:
        rt = route(a_q, b_q, "t" if b_t else "n")
        if config is not None:
            tile, splits = config_plan(config, rt)
        else:
            tile, splits = (ring_plan(m, n, k, platform.detect(dev).num_cores)
                            if rt == "ring" else (0, 1))
        plan = rt, tile, splits
    rt, tile, splits = plan
    if rt == "tile":
        check_tile_alignment("fp8_gemm", a_q, b_q, b_t)
    rc = _kernels.entry("fp8_gemm")(*args, ROUTES.index(rt), tile, splits,
                                    _kernels.stream_ptr(dev))
    _kernels.check(rc, "fp8_gemm")
    COUNTER.launches += 1
    COUNTER.count_plan(plan_label(rt, tile, splits))
    return out


def check_mxu_dtype(mxu_dtype) -> None:
    """``mxu_dtype`` must be None or a type that holds e4m3 exactly
    (:data:`MXU_DTYPES`)."""
    if mxu_dtype is not None and mxu_dtype not in MXU_DTYPES:
        raise ValueError(
            "mxu_dtype must be None or one of torch.float16, torch.bfloat16, "
            f"torch.float32 (each holds e4m3 exactly), got {mxu_dtype!r}")


def check_config(config: GemmConfig, scale_mode: str = "accum",
                 mxu_dtype=None) -> None:
    """A config must be a ``GemmConfig``; ``KernelType.XLA`` computes
    accum-mode math only, and raises with another ``scale_mode`` or an
    ``mxu_dtype`` (JAX's ValueError)."""
    if not isinstance(config, GemmConfig):
        raise TypeError(f"config must be a GemmConfig, got {type(config)}")
    if config.kernel_type == KernelType.XLA and (scale_mode != "accum"
                                                 or mxu_dtype is not None):
        # As in the JAX package: its XLA realization computes accum-mode
        # math only, and must not stand in for an explicit opt-in.
        raise ValueError(
            "KernelType.XLA supports only the default scale_mode="
            f"'accum' / mxu_dtype=None (got {scale_mode!r}/{mxu_dtype})")


def is_xla(config: Optional[GemmConfig]) -> bool:
    return config is not None and config.kernel_type == KernelType.XLA


def fp8_gemm_xla(a_q, a_scales, b_q, panel, *, b_t: bool,
                 out_dtype=torch.bfloat16):
    """The XLA family (``KernelType.XLA``), JAX's ``_fp8_gemm_xla`` in torch
    ops (no kernel): each 128-deep group's product of the e4m3 values in
    f32 (exact products; JAX upcasts to bf16, which holds e4m3 exactly, and
    accumulates in f32), scaled ``(partial · a_s) · b_s`` per group, then
    the f32 sum over the groups. ``panel``: B's scales as a (…, kb, n) f32
    panel. Leading dims of ``a_q``, ``b_q`` and ``panel`` are a batch."""
    m, k = a_q.shape[-2:]
    kb = k // BLOCK
    n = panel.shape[-1]
    lead = a_q.shape[:-2]
    a3 = a_q.to(torch.float32).reshape(*lead, m, kb, BLOCK)
    if b_t:
        b3 = b_q.to(torch.float32).reshape(*lead, n, kb, BLOCK)
        partial = torch.einsum("...mbk,...nbk->...bmn", a3, b3)
    else:
        b3 = b_q.to(torch.float32).reshape(*lead, kb, BLOCK, n)
        partial = torch.einsum("...mbk,...bkn->...bmn", a3, b3)
    a_s = a_scales.to(torch.float32).transpose(-1, -2)[..., :, :, None]
    scaled = (partial * a_s) * panel.to(torch.float32)[..., :, None, :]
    return scaled.sum(dim=-3).to(out_dtype)


def _check_layout(b_layout: str) -> bool:
    if b_layout not in ("n", "t"):
        raise ValueError(f"b_layout must be 'n' or 't', got {b_layout!r}")
    return b_layout == "t"


def _check_shapes(a_q, a_scales, b_q, b_t, b_layout):
    m, k = a_q.shape
    if b_t:
        n, k2 = b_q.shape
    else:
        k2, n = b_q.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)} (b_layout={b_layout})")
    if k % BLOCK:
        raise ValueError(f"fp8_gemm requires k % {BLOCK} == 0, got k={k}")
    if n % BLOCK:
        raise ValueError(f"fp8_gemm requires n % {BLOCK} == 0, got n={n}")
    if tuple(a_scales.shape) != (m, k // BLOCK):
        raise ValueError(f"a_scales must be {(m, k // BLOCK)}, got "
                         f"{tuple(a_scales.shape)}")
    return m, n, k


def fp8_gemm_with_config(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales_expanded: torch.Tensor,
    *,
    config: GemmConfig,
    out_dtype=torch.bfloat16,
    scale_mode: str = "accum",
    allow_relaxed: bool = False,
    b_layout: str = "n",
    mxu_dtype=None,
) -> torch.Tensor:
    """FP8 GEMM with an explicit config; ``b_scales_expanded`` is the (kb, n)
    f32 panel regardless of ``b_layout``. K1 takes its ring tile and splits
    from the config, K12 its tile (module docstring); ``KernelType.XLA``
    runs :func:`fp8_gemm_xla` (with ``scale_mode='folded'`` or an
    ``mxu_dtype``, JAX's ValueError)."""
    _check_scale_mode(scale_mode, allow_relaxed)
    check_mxu_dtype(mxu_dtype)
    b_t = _check_layout(b_layout)
    m, n, k = _check_shapes(a_q, a_scales, b_q, b_t, b_layout)
    if tuple(b_scales_expanded.shape) != (k // BLOCK, n):
        raise ValueError(f"expanded b_scales must be {(k // BLOCK, n)}, got "
                         f"{tuple(b_scales_expanded.shape)}")
    check_config(config, scale_mode, mxu_dtype)
    if is_xla(config):
        return fp8_gemm_xla(a_q, a_scales, b_q, b_scales_expanded, b_t=b_t,
                            out_dtype=out_dtype)
    if scale_mode == "folded":
        return _launch(a_q, a_scales, b_q, b_scales_expanded, 0, b_t,
                       out_dtype, folded=True,
                       plan=folded_tile_code(config, m, n, b_t))
    return _launch(a_q, a_scales, b_q, b_scales_expanded, 0, b_t, out_dtype,
                   config=config)


def fp8_gemm(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales: torch.Tensor,
    *,
    out_dtype=torch.bfloat16,
    config: Optional[GemmConfig] = None,
    b_scales_expanded: bool = False,
    scale_mode: str = "accum",
    allow_relaxed: bool = False,
    auto_pad: bool = False,
    b_layout: str = "n",
    mxu_dtype=None,
) -> torch.Tensor:
    """Blockwise-scaled FP8 GEMM (DeepGEMM ``gemm_fp8_fp8_bf16_nt`` analogue).

    a_q: (m, k) e4m3 with a_scales (m, k/128) f32;
    b_q: (k, n) e4m3 with b_scales (k/128, n/128) f32 — or (k/128, n) if
    ``b_scales_expanded``.
    ``b_layout='t'``: B stored (n, k) with b_scales (n/128, k/128) —
    DeepGEMM's NT call and the layout of the port's weights.
    Ragged n/k raise, unless ``auto_pad``: then the operands are lifted
    into the kernel's contract by zero values and one scales
    (``tiling/padding.py``; scales (m, ⌈k/128⌉) and (⌈k/128⌉, ⌈n/128⌉)),
    and the output is sliced back to the original n.
    ``scale_mode='folded'`` (K12) requires ``allow_relaxed=True``; under
    :func:`exact_mode` either mode computes the exact golden.
    ``mxu_dtype``: None, f16, bf16 or f32 (module docstring).
    """
    _check_scale_mode(scale_mode, allow_relaxed)
    check_mxu_dtype(mxu_dtype)
    b_t = _check_layout(b_layout)
    if b_t and b_scales_expanded:
        raise ValueError("b_layout='t' requires unexpanded (n/128, k/128) "
                         "b_scales — the expanded panel layout is "
                         "kernel-internal")
    if auto_pad:
        if b_scales_expanded:
            raise ValueError("auto_pad requires unexpanded b_scales (the pad "
                             "helper re-expands them; pass "
                             "b_scales_expanded=False)")
        pad = pad_fp8_operands_nt if b_t else pad_fp8_operands
        a_q, a_scales, b_q, b_scales, n_orig = pad(a_q, a_scales, b_q,
                                                   b_scales)
        out = fp8_gemm(a_q, a_scales, b_q, b_scales, out_dtype=out_dtype,
                       config=config, scale_mode=scale_mode,
                       allow_relaxed=allow_relaxed, b_layout=b_layout,
                       mxu_dtype=mxu_dtype)
        return out[:, :n_orig]
    m, n, k = _check_shapes(a_q, a_scales, b_q, b_t, b_layout)
    kb, nb = k // BLOCK, n // BLOCK
    if b_scales_expanded:
        want, bs_view, shift = (kb, n), b_scales, 0
    elif b_t:
        want, bs_view, shift = (nb, kb), b_scales.t(), _SHIFT
    else:
        want, bs_view, shift = (kb, nb), b_scales, _SHIFT
    if tuple(b_scales.shape) != want:
        raise ValueError(f"b_scales must be {want}, got "
                         f"{tuple(b_scales.shape)}")
    if _exact:
        return _exact_gemm(a_q, a_scales, b_q, bs_view, shift, b_t,
                           out_dtype)
    if config is not None:
        check_config(config, scale_mode, mxu_dtype)
    if scale_mode == "folded":
        plan = None if config is None else folded_tile_code(config, m, n,
                                                            b_t)
        return _launch(a_q, a_scales, b_q, bs_view, shift, b_t, out_dtype,
                       folded=True, plan=plan)
    cfg = _selected(a_q, b_q, m, n, k, b_t, out_dtype, config)
    if is_xla(cfg):
        check_config(cfg, scale_mode, mxu_dtype)
        return fp8_gemm_xla(a_q, a_scales, b_q, _scale_panel(bs_view, shift, n),
                            b_t=b_t, out_dtype=out_dtype)
    return _launch(a_q, a_scales, b_q, bs_view, shift, b_t, out_dtype,
                   config=cfg)


def _selected(a_q, b_q, m, n, k, b_t, out_dtype, config):
    """K1's config: the caller's, else ``select_config``'s (memoised:
    ``selector.launch_config``; op
    ``fp8_gemm_nt`` for B stored K-major, else ``fp8_gemm``; 128-deep
    granularity) — where an offset view sends the operands to the tile
    route and that config's tile is the ring's, the tile route's analytic
    config."""
    if config is not None:
        return config
    op = "fp8_gemm_nt" if b_t else "fp8_gemm"
    rt = (route(a_q, b_q, "t" if b_t else "n")
          if a_q.device.type == "cuda" else None)
    return launch_config(m, n, k, FP8, out_dtype, op=op, device=a_q.device,
                         route=rt, k_granularity=BLOCK)
