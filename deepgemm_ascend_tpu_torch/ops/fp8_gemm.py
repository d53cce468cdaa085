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
— a TMA ring of 128-deep scale groups fed by a producer warp, its tile
and group splits from :func:`ring_plan` — where TMA can read the operands
(B stored K-major, ``b_layout='t'``, the port's weights), else "tile"
(fixed 64×64 tiles, synchronous loads); both keep one output element's
arithmetic, so they agree bit for bit unless the ring splits K. K12 runs
on the Hopper main loop of ``csrc/sm90_gemm.cuh`` (TMA loads of the e4m3
bytes, a fold into bf16 overlapped with wgmma; its tiles follow the
shape). The tiling knobs of a ``GemmConfig`` are not read. On a CPU
tensor they run :func:`fp8_gemm_plain` or :func:`fp8_gemm_folded_plain`,
the same arithmetic in PyTorch. ``mxu_dtype`` (a TPU MXU knob) is not ported.

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
from ..tiling import platform
from ..tiling.padding import pad_fp8_operands, pad_fp8_operands_nt
from ..utils.common import ceil_div
from . import _kernels
from .quant import BLOCK, FP8

__all__ = ["fp8_gemm", "fp8_gemm_with_config", "fp8_gemm_plain",
           "fp8_gemm_folded_plain", "fold_operands", "expand_weight_scales",
           "exact_mode", "route", "ring_plan", "plan_label"]

COUNTER = _kernels.COUNTERS["fp8_gemm"]
FOLDED_COUNTER = _kernels.COUNTERS["fp8_gemm_folded"]
SCALE_MODES = ("accum", "folded")
_SHIFT = BLOCK.bit_length() - 1        # column → scale-block index: col >> 7

# K1's (and K3's) routes, numbered as the C entries number them.
ROUTES = ("tile", "ring")
# The ring's tiles (rows, columns), in the order of the C entries' index
# (csrc/fp8_gemm.cuh: Tile16, Tile64).
RING_TILES = ((16, 64), (64, 64))
H100_SMS = 132
MAX_SPLITS = 8            # CTAs of a portable cluster
MIN_SPLIT_GROUPS = 2      # 128-deep scale groups a split runs at least
MAX_SPLIT_GROUPS = 12     # ... and at most, where more splits can share K

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


def ring_tile(m: int) -> int:
    """Index into :data:`RING_TILES` for m rows: 16 rows at decode (m ≤ 16:
    mma's own M, no padded rows), else 64 × 64 (measured faster than a
    128 × 128 tile at prefill, ``scripts/ring_sweep.py``)."""
    return 0 if m <= 16 else 1


def ring_splits(m: int, n: int, k: int, tile: int,
                sms: int = H100_SMS) -> int:
    """CTAs that split K1's 128-deep groups on the ring: 1 where the tiles
    fill at least half the card's SMs; else as many as put one CTA on
    about every SM, or as keep each split to MAX_SPLIT_GROUPS groups if
    that is more (deep K), at most MAX_SPLITS (a cluster) and with at
    least MIN_SPLIT_GROUPS groups each."""
    bm, bn = RING_TILES[tile]
    tiles = ceil_div(m, bm) * (n // bn)
    groups = k // BLOCK
    if 2 * tiles > sms:
        return 1
    return max(1, min(MAX_SPLITS, groups // MIN_SPLIT_GROUPS,
                      max(sms // tiles, ceil_div(groups, MAX_SPLIT_GROUPS))))


def plan_label(rt: str, tile: int, splits: int = 1) -> str:
    """A launch's plan as its wrapper counts it (``Counter.plans``):
    ``"tile"``, or ``"ring RxC"`` with ``"/S"`` for S > 1 splits."""
    if rt != "ring":
        return rt
    label = "ring {}x{}".format(*RING_TILES[tile])
    return label if splits == 1 else f"{label}/{splits}"


def ring_plan(m: int, n: int, k: int, sms: int = H100_SMS):
    """(tile index, splits) of K1's ring route for an (m, k) × (k, n)
    product on a card of ``sms`` SMs."""
    tile = ring_tile(m)
    return tile, ring_splits(m, n, k, tile, sms)


def _launch(a_q, a_scales, b_q, bs_view, shift, b_t, out_dtype,
            folded=False, plan=None):
    """Run K1 (or K12 if ``folded``) on ``a_q``'s device: the kernel for
    CUDA, the plain version for the CPU. Shapes are validated by the
    callers. ``plan``: K1's (route, tile, splits) in place of
    :func:`route` and :func:`ring_plan`'s (for tests and sweeps; the C
    entry refuses what it cannot run)."""
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
        rc = _kernels.entry("fp8_gemm_folded")(*args,
                                               _kernels.stream_ptr(dev))
        _kernels.check(rc, "fp8_gemm_folded")
        FOLDED_COUNTER.launches += 1
        return out
    if plan is None:
        rt = route(a_q, b_q, "t" if b_t else "n")
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


def check_config(config: GemmConfig, scale_mode: str = "accum") -> None:
    """The fixed-tile kernels read only ``kernel_type`` of a config."""
    if not isinstance(config, GemmConfig):
        raise TypeError(f"config must be a GemmConfig, got {type(config)}")
    if config.kernel_type == KernelType.XLA:
        if scale_mode != "accum":
            # As in the JAX package: its XLA realization computes accum-mode
            # math only, and must not stand in for an explicit opt-in.
            raise ValueError(
                "KernelType.XLA supports only the default scale_mode="
                f"'accum' / mxu_dtype=None (got {scale_mode!r}/None)")
        raise NotImplementedError(
            "KernelType.XLA arrives with the port's tiling slice")


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
) -> torch.Tensor:
    """FP8 GEMM with an explicit config; ``b_scales_expanded`` is the (kb, n)
    f32 panel regardless of ``b_layout``. The kernels' tiles are fixed, so
    of the config only ``kernel_type`` is read: ``KernelType.XLA`` (plain
    XLA ops on the TPU) belongs to the tiling slice and raises here (with
    ``scale_mode='folded'``, JAX's ValueError first)."""
    _check_scale_mode(scale_mode, allow_relaxed)
    b_t = _check_layout(b_layout)
    m, n, k = _check_shapes(a_q, a_scales, b_q, b_t, b_layout)
    if tuple(b_scales_expanded.shape) != (k // BLOCK, n):
        raise ValueError(f"expanded b_scales must be {(k // BLOCK, n)}, got "
                         f"{tuple(b_scales_expanded.shape)}")
    check_config(config, scale_mode)
    return _launch(a_q, a_scales, b_q, b_scales_expanded, 0, b_t, out_dtype,
                   folded=scale_mode == "folded")


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
    """
    _check_scale_mode(scale_mode, allow_relaxed)
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
                       allow_relaxed=allow_relaxed, b_layout=b_layout)
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
        check_config(config, scale_mode)
    return _launch(a_q, a_scales, b_q, bs_view, shift, b_t, out_dtype,
                   folded=scale_mode == "folded")
