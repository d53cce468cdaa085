"""W8A8 int8 GEMMs: dense (K7), contiguous grouped (K9), masked grouped (K6).

Port of ``deepgemm_ascend_tpu/ops/int8_gemm.py``. Per-token activation
scales (m, 1) and per-channel weight scales (1, n) factor out of the K sum:

    out[i, j] = (Σ_k a_q[i, k] · b_q[k, j]) · a_s[i] · b_s[j]

one exact integer sum, then one f32 epilogue ``(acc·a_s)·b_s``. On a CUDA
tensor the wrappers launch the kernels of ``csrc/int8_gemm.cu``; on a CPU
tensor they run the plain versions, the same arithmetic in PyTorch. The
integer sum is exact in any order, so kernel, plain version and the JAX
package's kernels agree bit for bit, whatever the tile. Of a
``GemmConfig`` K7 reads its tile (``block_m × block_n``, one of
:data:`WGMMA_TILES` on route wgmma, 64 × 64 on int8_tile; else
``ValueError``), the contiguous path ``block_m`` (the layout's m-tile),
and every op ``kernel_type``: ``KernelType.XLA`` is JAX's product outside
Pallas in plain torch ops (the int32-exact sum as f64, the same f32
epilogue: bit-equal to the kernels), for the dense and the masked op;
the contiguous layout has none (``ValueError``, as in JAX). Without a
config K7 takes ``select_config``'s under op ``int8_gemm_nt`` (B stored
K-major) or ``int8_gemm``.

K7 takes one of two routes, decided here by :func:`route` and passed to
the kernel, which refuses a route it cannot take: ``"wgmma"`` (the Hopper
main loop of ``csrc/sm90_gemm.cuh`` with 8-bit stages: TMA and
``wgmma`` s8 on 64 × 64, 128 × 128 or 128 × 256 tiles; B stored K-major
only) or ``"int8_tile"`` (``mma.sync`` on 64 × 64 tiles: every layout and
shape). K9 takes the same two routes (:func:`contiguous_route`): "wgmma"
— K6's wgmma route with the contiguous map, the expert of each tile read
by the producer, on 64 × 64 or 128 × 256 tiles whose rows divide block_m
— for B stored K-major with a ``block_m``
that 64 divides, else ``"int8_tile"``.

K6 with B stored K-major takes one of two kernels by its tile:
``"ring"`` (16 × 64 tiles, a TMA ring fed by a producer warp, ``mma.sync``
s8 into int32 accumulators) or ``"wgmma"`` (K7's Hopper main loop over
the experts, 64 × 64 or 128 × 256 tiles); in both a CTA walks the m-tiles
of its (expert, n-tile), reads ``masked_m[e]`` on the card and zeroes the
tiles past it. ``b_layout='n'`` and operands TMA cannot describe keep
``"int8_tile"``.

The grouped wrappers' tile: a caller's config's (for K9 as for K8,
``grouped_gemm.caller_contiguous_tile``), else the tiling tiers' under op
``int8_grouped_gemm_masked[_nt]`` (keyed on M_max and ``expected_m``,
DeepGEMM's hint of the rows an expert is expected to hold, which the MoE
layer passes and which changes no result) and ``int8_grouped_gemm[_nt]``
(keyed on the layout's block_m). With no cache and no predictor that is
the rule the wrappers used before: ``tiling.analytic.masked_plan`` (ring
at decode, 64 × 64 up to 64 rows an expert, 128 × 256 beyond) and
``tiling.analytic.contiguous_tile``. A caller's config is checked on
every device (``grouped_gemm.caller_plan``).

``b_layout='t'`` takes B stored K-major, (n, k) / (E, n, k): the layout of
the port's int8 weights, which the tensor cores' B operand wants. The
scales keep their shapes in both layouts.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import GemmConfig
from ..tiling import analytic
from ..tiling.selector import launch_config
from . import _kernels
from .fp8_gemm import _check_cuda_operands, check_config, exact_enabled, \
    is_xla
from .grouped_gemm import (caller_plan, contiguous_op, contiguous_tiles,
                           masked_op, selected_tile)

__all__ = ["int8_gemm", "int8_gemm_with_config", "int8_gemm_xla", "route",
           "m_grouped_int8_gemm_contiguous", "m_grouped_int8_gemm_masked",
           "int8_gemm_plain", "grouped_contiguous_plain",
           "grouped_masked_plain", "contiguous_route"]

K7 = _kernels.COUNTERS["int8_gemm"]
K9 = _kernels.COUNTERS["int8_grouped_contiguous"]
K6 = _kernels.COUNTERS["int8_grouped_masked"]
# K7's route codes, and the tiles of its wgmma route (tile codes).
ROUTES = ("int8_tile", "wgmma")
WGMMA_TILES = analytic.WGMMA_TILES
# K6's route codes and the tiles of its wgmma route (rows, columns).
MASKED_ROUTES = ("int8_tile", "ring", "wgmma")
MASKED_WGMMA_TILES = analytic.GROUPED_WGMMA_TILES
# K9 takes K7's route codes (ROUTES) and K6's wgmma tiles
# (MASKED_WGMMA_TILES; the rows of a tile divide block_m, so that no tile
# spans two experts).


def _layout(b_layout: str) -> bool:
    if b_layout not in ("n", "t"):
        raise ValueError(f"b_layout must be 'n' or 't', got {b_layout!r}")
    return b_layout == "t"


def _kn(b_q: torch.Tensor, b_t: bool) -> torch.Tensor:
    """B as (…, k, n) (a view)."""
    return b_q.transpose(-1, -2) if b_t else b_q


def _int_sum(a_q: torch.Tensor, b_kn: torch.Tensor) -> torch.Tensor:
    """Σ_k a·b, exact, rounded once to f32. float64 holds every partial sum
    exactly (|acc| ≤ 127²·k < 2^53) in any order and on any device, where
    ``int8 @ int8`` wraps in int8 and the card has no int32 matmul; the
    final cast rounds to nearest as cvt.rn.f32.s32 does."""
    return torch.matmul(a_q.to(torch.float64),
                        b_kn.to(torch.float64)).to(torch.float32)


def _dequant(a_q, a_scales, b_q, b_scales, b_t):
    """Both operands dequantized to f32, B as (…, k, n): the inputs of the
    exact-mode golden."""
    return (a_q.to(torch.float32) * a_scales.to(torch.float32),
            _kn(b_q, b_t).to(torch.float32) * b_scales.to(torch.float32))


def _epilogue(acc, a_s, b_s, out_dtype):
    """(acc·a_s)·b_s in f32, in that order, then the output cast."""
    return ((acc * a_s.to(torch.float32)) * b_s.to(torch.float32)).to(
        out_dtype)


def int8_gemm_plain(a_q, a_scales, b_q, b_scales, *, b_t: bool = False,
                    out_dtype=torch.bfloat16):
    """Plain PyTorch version of K7 on any device."""
    K7.plain_calls += 1
    return _epilogue(_int_sum(a_q, _kn(b_q, b_t)), a_scales, b_scales,
                     out_dtype)


def grouped_contiguous_plain(a_q, a_scales, b_q, b_scales, tile_group_ids,
                             *, b_t: bool = False, out_dtype=torch.bfloat16):
    """Plain PyTorch version of K9: rows of m-tile t use expert
    ``tile_group_ids[t]``; padding tiles (-1) are zero."""
    K9.plain_calls += 1
    m = a_q.shape[0]
    b_kn = _kn(b_q, b_t)
    gids = torch.as_tensor(tile_group_ids).to(device=a_q.device,
                                               dtype=torch.int64)
    row_gid = torch.repeat_interleave(gids, m // gids.numel())
    out = torch.zeros((m, b_kn.shape[-1]), dtype=out_dtype,
                      device=a_q.device)
    for e in torch.unique(gids[gids >= 0]).tolist():
        rows = torch.nonzero(row_gid == e)[:, 0]
        out[rows] = _epilogue(_int_sum(a_q[rows], b_kn[e]), a_scales[rows],
                              b_scales[e], out_dtype)
    return out


def grouped_masked_plain(a_q, a_scales, b_q, b_scales, masked_m, *,
                         b_t: bool = False, out_dtype=torch.bfloat16):
    """Plain PyTorch version of K6: the first ``masked_m[e]`` rows of each
    expert; rows at or past it are zero."""
    K6.plain_calls += 1
    e, m_max, _ = a_q.shape
    b_kn = _kn(b_q, b_t)
    out = torch.zeros((e, m_max, b_kn.shape[-1]), dtype=out_dtype,
                      device=a_q.device)
    for ei, rows in enumerate(masked_m.tolist()):
        rows = min(int(rows), m_max)
        if rows > 0:
            out[ei, :rows] = _epilogue(_int_sum(a_q[ei, :rows], b_kn[ei]),
                                       a_scales[ei, :rows], b_scales[ei],
                                       out_dtype)
    return out


def route(a_q, b_q, b_layout: str = "n") -> str:
    """K7's route for the stored operands ``a_q`` (m, k) and ``b_q``:
    ``"wgmma"`` where ``wgmma`` and TMA can take both — B stored K-major
    (``b_layout='t'``: ``wgmma`` reads 8-bit operands K-major only), k a
    positive multiple of 16 (a 16-byte row pitch) and 16-byte aligned
    ``data_ptr``s — else ``"int8_tile"``."""
    k = a_q.shape[-1]
    if (not _layout(b_layout) or k == 0 or k % 16 or a_q.data_ptr() % 16
            or b_q.data_ptr() % 16):
        return "int8_tile"
    return "wgmma"


def contiguous_route(a_q, b_q, b_layout: str = "n", block_m: int = 128) -> str:
    """K9's route for the stored operands ``a_q`` (M_total, k) and ``b_q``
    laid out in ``block_m``-row tiles: ``"wgmma"`` where K7's wgmma route
    takes the operands (:func:`route`: B stored K-major, k a multiple of
    16, 16-byte aligned pointers) and a 64-row tile divides ``block_m``,
    else ``"int8_tile"`` (``'n'``, block_m 96)."""
    if route(a_q, b_q, b_layout) == "int8_tile" or block_m % 64:
        return "int8_tile"
    return "wgmma"


def masked_plan_label(rt: str, tile: int) -> str:
    """A K6 (or K9) launch's plan as its wrapper counts it
    (``Counter.plans``)."""
    if rt == "ring":
        return "ring 16x64"
    if rt == "wgmma":
        return "wgmma {}x{}".format(*MASKED_WGMMA_TILES[tile])
    return rt


def _cuda_operands(name, a_q, a_scales, b_q, b_scales, out_dtype):
    """Checks the kernel's operands; returns the f32 scales."""
    dev = a_q.device
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise ValueError(f"{name}: operands must be int8, got "
                         f"{a_q.dtype}/{b_q.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bf16 or f32 on CUDA, "
                         f"got {out_dtype}")
    a_s = a_scales.to(torch.float32).contiguous()
    b_s = b_scales.to(torch.float32).contiguous()
    _check_cuda_operands(name, [("a_q", a_q), ("a_scales", a_s),
                                ("b_q", b_q), ("b_scales", b_s)], dev)
    return a_s, b_s


def _strides(b_t: bool, n: int, k: int):
    """(k stride, n stride) of B inside one expert."""
    return (1, k) if b_t else (n, 1)


def _on_device(name: str, a_q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if a_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a_q.device}")
    return a_q.device.type == "cuda"


def int8_gemm_xla(a_q, a_scales, b_q, b_scales, *, b_t: bool = False,
                  out_dtype=torch.bfloat16):
    """The XLA family (``KernelType.XLA``), JAX's ``dot_general`` with int32
    accumulation in torch ops (no kernel): the exact integer sum (as f64,
    :func:`_int_sum`), then ``(acc · a_s) · b_s`` in f32 — bit for bit the
    kernels' result. Leading dims are a batch (the masked op's experts)."""
    return _epilogue(_int_sum(a_q, _kn(b_q, b_t)), a_scales, b_scales,
                     out_dtype)


def plan_label(rt: str, block_m: int, block_n: int) -> str:
    """A K7 launch's plan as its wrapper counts it (``Counter.plans``)."""
    return f"{rt} {block_m}x{block_n}"


def _selected(a_q, b_q, m, n, k, b_t, out_dtype, config):
    """K7's config: the caller's, else ``select_config``'s (memoised:
    ``selector.launch_config``; op
    ``int8_gemm_nt`` for B stored K-major, else ``int8_gemm``) — where an
    offset view sends the operands to route int8_tile with a wgmma tile,
    that route's analytic config."""
    if config is not None:
        return config
    op = "int8_gemm_nt" if b_t else "int8_gemm"
    rt = (route(a_q, b_q, "t" if b_t else "n")
          if a_q.device.type == "cuda" else None)
    return launch_config(m, n, k, torch.int8, out_dtype, op=op,
                         device=a_q.device, route=rt)


def _launch_dense(a_q, a_scales, b_q, b_scales, b_t, out_dtype, config,
                  plan=None):
    """K7 with ``config``'s tile on ``a_q``'s device; ``plan``: the route in
    place of :func:`route`'s (for tests and sweeps)."""
    if is_xla(config):
        return int8_gemm_xla(a_q, a_scales, b_q, b_scales, b_t=b_t,
                             out_dtype=out_dtype)
    if not _on_device("int8_gemm", a_q):
        return int8_gemm_plain(a_q, a_scales, b_q, b_scales, b_t=b_t,
                               out_dtype=out_dtype)
    a_s, b_s = _cuda_operands("int8_gemm", a_q, a_scales, b_q, b_scales,
                              out_dtype)
    m, k = a_q.shape
    n = b_s.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if out.numel() == 0:
        return out
    rt = plan or route(a_q, b_q, "t" if b_t else "n")
    tile = analytic.tile_code("int8_gemm", rt, config.block_m, config.block_n)
    rc = _kernels.entry("int8_gemm")(
        a_q.data_ptr(), a_s.data_ptr(), b_q.data_ptr(), b_s.data_ptr(),
        out.data_ptr(), m, n, k, *_strides(b_t, n, k),
        int(out_dtype == torch.float32), ROUTES.index(rt), tile,
        _kernels.stream_ptr(a_q.device))
    _kernels.check(rc, "int8_gemm")
    K7.launches += 1
    K7.count_plan(plan_label(rt, config.block_m, config.block_n))
    return out


def _check_dense(a_q, a_scales, b_q, b_scales, b_t):
    m, k = a_q.shape
    k2, n = _kn(b_q, b_t).shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)} (b_layout="
                         f"{'t' if b_t else 'n'})")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise ValueError(f"int8_gemm needs int8 operands, got "
                         f"{a_q.dtype}/{b_q.dtype}")
    if tuple(a_scales.shape) != (m, 1):
        raise ValueError(f"a_scales must be {(m, 1)}, got "
                         f"{tuple(a_scales.shape)}")
    if tuple(b_scales.shape) != (1, n):
        raise ValueError(f"b_scales must be {(1, n)}, got "
                         f"{tuple(b_scales.shape)}")


def int8_gemm_with_config(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales: torch.Tensor,
    *,
    config: GemmConfig,
    out_dtype=torch.bfloat16,
    b_layout: str = "n",
    plan: Optional[str] = None,
) -> torch.Tensor:
    """W8A8 GEMM with an explicit config: K7 on its tile, or
    :func:`int8_gemm_xla` for ``KernelType.XLA``; ``plan``: one of
    ``ROUTES`` in place of :func:`route`'s (the kernel refuses a route it
    cannot take).

    a_q (m, k) int8 with a_scales (m, 1) f32 (per token); b_q (k, n) int8
    (or (n, k) with ``b_layout='t'``) with b_scales (1, n) f32 (per output
    channel)."""
    b_t = _layout(b_layout)
    _check_dense(a_q, a_scales, b_q, b_scales, b_t)
    check_config(config)
    return _launch_dense(a_q, a_scales, b_q, b_scales, b_t, out_dtype,
                         config, plan)


def int8_gemm(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales: torch.Tensor,
    *,
    out_dtype=torch.bfloat16,
    config: Optional[GemmConfig] = None,
    b_layout: str = "n",
) -> torch.Tensor:
    """W8A8 GEMM: per-token × per-channel scaled int8 (layouts as in
    :func:`int8_gemm_with_config`). Quantize with
    ``quant.quantize_int8(a, axis=-1)`` (per token) and
    ``quant.quantize_int8(b, axis=0)`` (per channel).

    Under ``fp8_gemm.exact_mode()`` both operands are dequantized and
    multiplied in f32: the emulated-dequant golden of the JAX package."""
    b_t = _layout(b_layout)
    _check_dense(a_q, a_scales, b_q, b_scales, b_t)
    if exact_enabled():
        return torch.matmul(*_dequant(a_q, a_scales, b_q, b_scales,
                                      b_t)).to(out_dtype)
    if config is not None:
        check_config(config)
    m, k = a_q.shape
    cfg = _selected(a_q, b_q, m, b_scales.shape[-1], k, b_t, out_dtype,
                    config)
    return _launch_dense(a_q, a_scales, b_q, b_scales, b_t, out_dtype, cfg)


def _grouped_shapes(a_q, b_q, b_t):
    """(E, rows per expert or in all, n, A's k, B's k) of a grouped call."""
    m, k = a_q.shape[-2:]
    e, k2, n = _kn(b_q, b_t).shape
    return e, m, n, k, k2


def m_grouped_int8_gemm_contiguous(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales: torch.Tensor,
    tile_group_ids,
    *,
    out_dtype=torch.bfloat16,
    config: Optional[GemmConfig] = None,
    b_layout: str = "n",
) -> torch.Tensor:
    """Contiguous grouped W8A8 GEMM (MoE prefill layout).

    a_q (M_total, K) int8, rows grouped by expert in spans aligned to
    block_m (plan with ``grouped_gemm.make_contiguous_layout``); a_scales
    (M_total, 1) f32 per token; b_q (E, K, N) int8 (or (E, N, K) with
    ``b_layout='t'``); b_scales (E, 1, N) f32 per expert output channel;
    tile_group_ids (M_total/block_m,) int, -1 = padding tile (zeros).
    block_m and the checks on the ids: ``grouped_gemm.contiguous_tiles``.
    """
    b_t = _layout(b_layout)
    e, m, n, k, k2 = _grouped_shapes(a_q, b_q, b_t)
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)}")
    if tuple(a_scales.shape) != (m, 1):
        raise ValueError(f"a_scales must be {(m, 1)}, got "
                         f"{tuple(a_scales.shape)}")
    if tuple(b_scales.shape) != (e, 1, n):
        raise ValueError(f"b_scales must be {(e, 1, n)}, got "
                         f"{tuple(b_scales.shape)}")
    block_m, ids = contiguous_tiles(m, e, tile_group_ids, config)
    if exact_enabled():
        a, b = _dequant(a_q, a_scales, b_q, b_scales, b_t)
        row_gid = torch.repeat_interleave(ids, block_m).to(a_q.device)
        y = torch.zeros((m, n), dtype=torch.float32, device=a_q.device)
        for ei in range(e):
            rows = torch.nonzero(row_gid == ei)[:, 0]
            y[rows] = torch.matmul(a[rows], b[ei])
        return y.to(out_dtype)
    plan = None if config is None else caller_plan(
        contiguous_op(b_t, int8=True),
        contiguous_route(a_q, b_q, b_layout, block_m), config)
    return _launch_contiguous(a_q, a_scales, b_q, b_scales, ids, block_m,
                              b_t, out_dtype, plan=plan)


def _launch_contiguous(a_q, a_scales, b_q, b_scales, ids, block_m, b_t,
                       out_dtype, plan=None):
    """K9 on ``a_q``'s device. ``plan``: (route, tile) in place of
    :func:`contiguous_route` and the tiers' tile (an index into
    MASKED_WGMMA_TILES): a caller's config's
    (``grouped_gemm.caller_plan``), or a test's or a sweep's (the C entry
    refuses what it cannot run)."""
    if not _on_device("m_grouped_int8_gemm_contiguous", a_q):
        return grouped_contiguous_plain(a_q, a_scales, b_q, b_scales, ids,
                                        b_t=b_t, out_dtype=out_dtype)
    a_s, b_s = _cuda_operands("m_grouped_int8_gemm_contiguous", a_q,
                              a_scales, b_q, b_scales, out_dtype)
    dev = a_q.device
    e, m, n, k, _ = _grouped_shapes(a_q, b_q, b_t)
    if plan is None:
        rt = contiguous_route(a_q, b_q, "t" if b_t else "n", block_m)
        op = contiguous_op(b_t, int8=True)
        tile = selected_tile(op, rt, block_m, n, k, torch.int8, out_dtype,
                             dev)
        plan = rt, analytic.tile_code(op, rt, *tile)
    # The ids' copy to the card waits for the stream: the host work above
    # runs before it.
    ids_dev = ids.to(device=dev, dtype=torch.int32)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    rc = _kernels.entry("int8_grouped_contiguous")(
        a_q.data_ptr(), a_s.data_ptr(), b_q.data_ptr(), b_s.data_ptr(),
        ids_dev.data_ptr(), out.data_ptr(), m, n, k, block_m, n * k,
        *_strides(b_t, n, k), int(out_dtype == torch.float32), e,
        ROUTES.index(plan[0]), plan[1], _kernels.stream_ptr(dev))
    _kernels.check(rc, "int8_grouped_contiguous")
    K9.launches += 1
    K9.count_plan(masked_plan_label(*plan))
    return out


def m_grouped_int8_gemm_masked(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales: torch.Tensor,
    masked_m: torch.Tensor,
    *,
    out_dtype=torch.bfloat16,
    config: Optional[GemmConfig] = None,
    b_layout: str = "n",
    expected_m: Optional[int] = None,
) -> torch.Tensor:
    """Masked grouped W8A8 GEMM (MoE decode and prefill, fixed shapes).

    a_q (E, M_max, K) int8 with a_scales (E, M_max, 1) f32 per token; b_q
    (E, K, N) int8 (or (E, N, K) with ``b_layout='t'``) with b_scales
    (E, 1, N) f32; masked_m (E,) int. Rows ≥ masked_m[e] are unspecified
    (whole inactive tiles are zeroed), as in the fp8 twin.
    ``expected_m``: the rows an expert is expected to hold, a hint that
    picks the kernel's route and tile (the selection key carries it; the
    analytic rule is ``tiling.analytic.masked_plan``) and changes no
    result.
    ``config``: its tile (16 × 64 runs the ring kernel), or
    ``KernelType.XLA``.
    """
    b_t = _layout(b_layout)
    e, m_max, n, k, k2 = _grouped_shapes(a_q, b_q, b_t)
    if a_q.shape[0] != e or k != k2:
        raise ValueError(f"bad shapes: a {tuple(a_q.shape)}, b "
                         f"{tuple(b_q.shape)} (b_layout={b_layout})")
    if tuple(a_scales.shape) != (e, m_max, 1):
        raise ValueError(f"a_scales must be {(e, m_max, 1)}, got "
                         f"{tuple(a_scales.shape)}")
    if tuple(b_scales.shape) != (e, 1, n):
        raise ValueError(f"b_scales must be {(e, 1, n)}, got "
                         f"{tuple(b_scales.shape)}")
    if exact_enabled():
        y = torch.matmul(*_dequant(a_q, a_scales, b_q, b_scales, b_t))
        rows = torch.arange(m_max, device=a_q.device)[None, :, None]
        y = torch.where(rows < masked_m.to(a_q.device)[:, None, None], y,
                        0.0)
        return y.to(out_dtype)
    if config is not None:
        check_config(config)
    if is_xla(config):
        # JAX's XLA family: one batched product, rows at or past
        # masked_m[e] zeroed (JAX int8_gemm.py:412-422).
        y = int8_gemm_xla(a_q, a_scales, b_q, b_scales, b_t=b_t,
                          out_dtype=torch.float32)
        rows = torch.arange(m_max, device=a_q.device)[None, :, None]
        y = torch.where(rows < masked_m.to(a_q.device)[:, None, None], y,
                        0.0)
        return y.to(out_dtype)
    plan = None if config is None else caller_plan(
        masked_op(b_t, int8=True), route(a_q, b_q, b_layout), config)
    return _launch_masked(a_q, a_scales, b_q, b_scales, masked_m, b_t,
                          out_dtype, plan=plan, expected_m=expected_m)


def _launch_masked(a_q, a_scales, b_q, b_scales, masked_m, b_t, out_dtype,
                   plan=None, expected_m=None):
    """K6 on ``a_q``'s device. ``plan``: (kernel route, tile) in place of
    :func:`route` and the tiers' tile (``grouped_gemm.selected_tile``): a
    caller's config's (``grouped_gemm.caller_plan``), or a test's or a
    sweep's (the C entry refuses what it cannot run)."""
    if not _on_device("m_grouped_int8_gemm_masked", a_q):
        return grouped_masked_plain(a_q, a_scales, b_q, b_scales, masked_m,
                                    b_t=b_t, out_dtype=out_dtype)
    a_s, b_s = _cuda_operands("m_grouped_int8_gemm_masked", a_q, a_scales,
                              b_q, b_scales, out_dtype)
    dev = a_q.device
    e, m_max, k = a_q.shape
    n = b_s.shape[-1]
    mm = masked_m.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((e, m_max, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if plan is None:
        rt = route(a_q, b_q, "t" if b_t else "n")
        op = masked_op(b_t, int8=True)
        tile = selected_tile(op, rt, m_max, n, k, torch.int8, out_dtype, dev,
                             expected_m)
        plan = analytic.kernel_plan(op, rt, *tile)
    rc = _kernels.entry("int8_grouped_masked")(
        a_q.data_ptr(), a_s.data_ptr(), b_q.data_ptr(), b_s.data_ptr(),
        mm.data_ptr(), out.data_ptr(), e, m_max, n, k, n * k,
        *_strides(b_t, n, k), int(out_dtype == torch.float32),
        MASKED_ROUTES.index(plan[0]), plan[1], _kernels.stream_ptr(dev))
    _kernels.check(rc, "int8_grouped_masked")
    K6.launches += 1
    K6.count_plan(masked_plan_label(*plan))
    return out
