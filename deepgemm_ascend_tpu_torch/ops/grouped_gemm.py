"""Grouped FP8 GEMMs for MoE: masked (kernel K3) and contiguous (kernel
K8), and the contiguous layout planner.

Port of ``deepgemm_ascend_tpu/ops/grouped_gemm.py``: ``m_grouped_gemm_masked``,
``m_grouped_gemm_contiguous`` and ``make_contiguous_layout`` (which also
plans the layout of the int8 contiguous GEMM, K9). Both GEMMs keep K1's
blockwise scale math for each output element (``csrc/grouped_gemm.cu``,
``csrc/fp8_gemm.cuh``), so a row gets the same bits through either:

* masked: per expert e, the first ``masked_m[e]`` rows of a fixed-shape
  (E, M_max, K) activation buffer; the kernel skips every tile at or past
  ``masked_m[e]`` before any load;
* contiguous: one flat (M_total, K) matrix whose rows are grouped by
  expert in spans aligned to ``block_m``, with one expert id per m-tile
  (-1: a padding tile, whose output is zero).

On a CUDA tensor the wrappers launch the kernels; on a CPU tensor they run
:func:`grouped_gemm_masked_plain` and :func:`grouped_gemm_contiguous_plain`.
The masked kernel takes K1's routes (:func:`route`): "ring" (a TMA ring of
scale groups on 16×64 or 64×64 tiles; never split, so that it stays
bit-equal to the contiguous kernel) for B stored K-major, else "tile". The
contiguous kernel takes :func:`contiguous_route`: "wgmma16" (f16 ``wgmma``
on the e4m3 operands converted exactly, each 128-deep group's partial from
0 promoted as K1 does — an f16 ``wgmma`` sums a group bit for bit as K1's
``mma.sync`` steps do, which ``tests/test_torch_gpu.py`` probes on the
card; 64×128 or 128×128 tiles) for B stored K-major with a ``block_m``
that 64 divides, else K1's 64×64 tile routine.

The tile: a caller's config names it (``block_m × block_n``, one of the
route's compiled tiles, ``tiling/analytic.py:TILES``; else
``ValueError``), else the tiling tiers' (``selector.launch_config``, op
``grouped_gemm_masked[_nt]`` keyed on M_max and ``expected_m``, op
``grouped_gemm[_nt]`` keyed on the layout's block_m, as in JAX); with no
cache and no predictor that is the rule the wrappers used before
(``tiling.analytic.masked_ring_tile``, ``contiguous_tile``). The
contiguous layout fixes block_m, so a caller's config there names the
layout's m-tile in ``block_m`` (JAX's meaning) and the tile of the route
with ``block_n`` columns whose rows are the largest that divide it
(:func:`caller_contiguous_tile`); the tiers' config names the tile itself.
A caller's config is checked on every device (:func:`caller_plan`), so a
CPU tensor refuses the configs the card refuses.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import GemmConfig, KernelType
from ..tiling import analytic
from ..tiling.selector import launch_config
from ..utils.common import round_up
from . import _kernels
from .fp8_gemm import (ROUTES, _SHIFT, _check_cuda_operands, _exact_gemm,
                       _plain_gemm, _scale_panel, check_config,
                       check_tile_alignment, exact_enabled, fp8_gemm_xla,
                       is_xla, plan_label, ring_route_ok)
from .quant import BLOCK, FP8

__all__ = ["m_grouped_gemm_masked", "grouped_gemm_masked_plain",
           "m_grouped_gemm_contiguous", "grouped_gemm_contiguous_plain",
           "make_contiguous_layout", "contiguous_tiles", "route",
           "contiguous_route"]

COUNTER = _kernels.COUNTERS["grouped_gemm"]
K8 = _kernels.COUNTERS["grouped_gemm_contiguous"]
# K8's routes, numbered as its C entry numbers them, and the tiles of its
# wgmma16 route (rows, columns).
CONTIGUOUS_ROUTES = ("tile", "wgmma16")
CONTIGUOUS_TILES = analytic.WGMMA16_TILES


def route(a_q, b_q, b_layout: str = "n") -> str:
    """K3's route for the stored operands ``a_q`` (E, M_max, k) and
    ``b_q``: ``"ring"`` where TMA can read them (B stored K-major,
    ``b_layout='t'``; k a multiple of 128; 16-byte-aligned pointers; the
    expert pitch of B then is too), else ``"tile"``."""
    if b_layout not in ("n", "t"):
        raise ValueError(f"b_layout must be 'n' or 't', got {b_layout!r}")
    return "ring" if ring_route_ok(a_q, b_q, b_layout == "t") else "tile"


def contiguous_route(a_q, b_q, b_layout: str = "n",
                     block_m: int = 128) -> str:
    """K8's route for the stored operands ``a_q`` (M_total, k) and ``b_q``
    laid out in ``block_m``-row tiles: ``"wgmma16"`` where TMA can read
    them (:func:`~.fp8_gemm.ring_route_ok`: B stored K-major,
    ``b_layout='t'``; k a multiple of 128; 16-byte-aligned pointers) and a
    64-row tile divides ``block_m``, so that no tile spans two experts;
    else ``"tile"`` (``b_layout='n'``, block_m 96, an offset view)."""
    if b_layout not in ("n", "t"):
        raise ValueError(f"b_layout must be 'n' or 't', got {b_layout!r}")
    if not ring_route_ok(a_q, b_q, b_layout == "t") or block_m % 64:
        return "tile"
    return "wgmma16"


def masked_op(b_t: bool, int8: bool = False) -> str:
    """The selector op of a masked grouped GEMM (JAX's name, ``_nt`` for B
    stored K-major)."""
    return ("int8_" if int8 else "") + "grouped_gemm_masked" + (
        "_nt" if b_t else "")


def contiguous_op(b_t: bool, int8: bool = False) -> str:
    """The selector op of a contiguous grouped GEMM (JAX's name, keyed on
    the layout's m-tile)."""
    return ("int8_" if int8 else "") + "grouped_gemm" + ("_nt" if b_t
                                                         else "")


def caller_contiguous_tile(op: str, rt: str, block_m: int,
                           block_n: int) -> Tuple[int, int]:
    """The kernel tile a caller's config names for a contiguous layout of
    ``block_m``-row m-tiles: the compiled tile of route ``rt`` with
    ``block_n`` columns whose rows are the largest that divide block_m (on
    the tile routes, whose one 64 × 64 tile takes any block_m, that tile).
    None such raises ``ValueError`` naming the compiled tiles."""
    tiles = [t for _, t in analytic.route_tiles(op, rt)]
    fits = [t for t in tiles if t[1] == block_n
            and analytic.tile_admits(op, rt, *t, block_m, block_n)]
    if not fits:
        raise ValueError(
            f"{op}: no compiled tile of {block_n} columns whose rows divide "
            f"block_m={block_m} on route {rt!r}; compiled: "
            f"{', '.join('%dx%d' % t for t in tiles)}")
    return max(fits)


def caller_plan(op: str, rt: str, config: GemmConfig) -> Tuple[str, int]:
    """(kernel route, tile code) of the tile a caller's config names on
    route ``rt``: its block_m × block_n (a contiguous op's:
    :func:`caller_contiguous_tile` of its layout's block_m), one of the
    route's compiled tiles, else ``ValueError`` naming them. The wrappers
    call it before they branch on the device."""
    if analytic.family(op) in analytic.CONTIGUOUS:
        tile = caller_contiguous_tile(op, rt, config.block_m, config.block_n)
    else:
        tile = config.block_m, config.block_n
    return analytic.kernel_plan(op, rt, *tile)


def selected_tile(op: str, rt: str, m: int, n: int, k: int, in_dtype,
                  out_dtype, dev,
                  expected_m: Optional[int] = None) -> Tuple[int, int]:
    """(block_m, block_n) a grouped wrapper launches on route ``rt`` with
    no config: the tiers' (memoised: ``selector.launch_config``; ``m``
    M_max or the layout's block_m)."""
    cfg = launch_config(m, n, k, in_dtype, out_dtype, op=op, device=dev,
                        route=rt, k_granularity=BLOCK, expected_m=expected_m)
    return cfg.block_m, cfg.block_n


def contiguous_plan_label(rt: str, tile: int) -> str:
    """A K8 launch's plan as its wrapper counts it (``Counter.plans``)."""
    if rt == "wgmma16":
        return "wgmma16 {}x{}".format(*CONTIGUOUS_TILES[tile])
    return rt


def make_contiguous_layout(
    tokens_per_expert: Sequence[int], block_m: int,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Plan the contiguous layout: (m_total_padded, tile_group_ids, row_map).

    ``row_map[i]`` = source row feeding padded row i (or -1 for padding);
    ``tile_group_ids[t]`` = expert of m-tile t (or -1 for padding tiles).
    Each expert's span is padded to a multiple of ``block_m``.
    """
    tile_ids, row_map = [], []
    src = 0
    for e, cnt in enumerate(tokens_per_expert):
        padded = round_up(int(cnt), block_m) if cnt else 0
        for r in range(padded):
            row_map.append(src + r if r < cnt else -1)
        src += int(cnt)
        tile_ids.extend([e] * (padded // block_m))
    m_total = len(row_map)
    return m_total, np.asarray(tile_ids, np.int32), np.asarray(row_map,
                                                               np.int32)


def contiguous_tiles(m: int, e: int, tile_group_ids,
                     config: Optional[GemmConfig]) -> Tuple[int, torch.Tensor]:
    """(block_m, expert id of every m-tile as a host int64 tensor) of a
    contiguous layout of ``m`` rows over ``e`` experts, for the fp8 (K8)
    and int8 (K9) contiguous GEMMs. block_m is m / len(tile_group_ids), or
    ``config.block_m`` (JAX's meaning; the tile a caller's config names:
    :func:`caller_contiguous_tile`). The ids are read on the host — one
    device-to-host copy when they lie on the card — and an id outside
    [-1, e) raises: the kernels index the expert weights with it."""
    ids = torch.as_tensor(tile_group_ids).to(torch.int64).cpu()
    n_tiles = ids.numel()
    if ids.dim() != 1 or n_tiles == 0 or m % n_tiles:
        raise ValueError(f"tile_group_ids must be one id per m-tile of "
                         f"M_total={m}: a non-empty 1-D array whose length "
                         f"divides M_total, got shape {tuple(ids.shape)}")
    if config is not None:
        if config.kernel_type == KernelType.XLA:
            raise ValueError("KernelType.XLA is not supported for the "
                             "grouped contiguous layout")
        check_config(config)
    block_m = config.block_m if config is not None else m // n_tiles
    if m % block_m:
        raise ValueError(f"M_total={m} must be a multiple of "
                         f"block_m={block_m}")
    if n_tiles != m // block_m:
        raise ValueError(f"tile_group_ids must be ({m // block_m},) for "
                         f"block_m={block_m}, got {tuple(ids.shape)}")
    if bool(((ids < -1) | (ids >= e)).any()):
        raise ValueError(f"tile_group_ids must lie in [-1, {e}), got "
                         f"{ids.tolist()}")
    return block_m, ids


def grouped_gemm_masked_plain(a_q, a_scales, b_q, bs_view, masked_m, *,
                              shift: int = _SHIFT, b_t: bool = False,
                              out_dtype=torch.bfloat16):
    """Plain PyTorch version of K3: K1's group-by-group accumulation for the
    valid rows of each expert; rows at or past ``masked_m[e]`` are zero.
    ``bs_view`` is (E, kb, ·) indexed ``[e, g, col >> shift]``."""
    COUNTER.plain_calls += 1
    e, m_max, _ = a_q.shape
    n = b_q.shape[1] if b_t else b_q.shape[2]
    panel = _scale_panel(bs_view, shift, n)
    out = torch.zeros((e, m_max, n), dtype=out_dtype, device=a_q.device)
    for ei, rows in enumerate(masked_m.tolist()):
        rows = min(int(rows), m_max)
        if rows > 0:
            out[ei, :rows] = _plain_gemm(a_q[ei, :rows], a_scales[ei, :rows],
                                         b_q[ei], panel[ei], b_t, out_dtype)
    return out


def _launch(a_q, a_scales, b_q, bs_view, shift, masked_m, b_t, out_dtype,
            plan=None, expected_m=None):
    """Run K3 on ``a_q``'s device: the kernel for CUDA, the plain version
    for the CPU. ``plan``: (route, ring tile) in place of :func:`route`
    and the tiers' tile (:func:`selected_tile`): a caller's config's
    (:func:`caller_plan`), or a test's or a sweep's."""
    dev = a_q.device
    if dev.type == "cpu":
        return grouped_gemm_masked_plain(a_q, a_scales, b_q, bs_view,
                                         masked_m, shift=shift, b_t=b_t,
                                         out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"m_grouped_gemm_masked: unsupported device {dev}")
    if a_q.dtype != FP8 or b_q.dtype != FP8:
        raise ValueError(f"m_grouped_gemm_masked: operands must be {FP8}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("m_grouped_gemm_masked: out_dtype must be bf16 or "
                         f"f32 on CUDA, got {out_dtype}")
    a_s = a_scales.to(torch.float32).contiguous()
    bs = bs_view.to(torch.float32)
    mm = masked_m.to(device=dev, dtype=torch.int32).contiguous()
    _check_cuda_operands("m_grouped_gemm_masked",
                         [("a_q", a_q), ("a_scales", a_s), ("b_q", b_q)], dev)
    if bs.device != dev:
        raise ValueError(f"m_grouped_gemm_masked: b_scales on {bs.device}")
    e, m_max, k = a_q.shape
    n = b_q.shape[1] if b_t else b_q.shape[2]
    out = torch.empty((e, m_max, n), dtype=out_dtype, device=dev)
    sbk, sbn = (1, k) if b_t else (n, 1)
    if plan is None:
        rt = route(a_q, b_q, "t" if b_t else "n")
        op = masked_op(b_t)
        tile = selected_tile(op, rt, m_max, n, k, FP8, out_dtype, dev,
                             expected_m)
        plan = rt, analytic.tile_code(op, rt, *tile)
    if plan[0] == "tile":
        check_tile_alignment("m_grouped_gemm_masked", a_q, b_q, b_t)
    rc = _kernels.entry("grouped_gemm")(
        a_q.data_ptr(), a_s.data_ptr(), b_q.data_ptr(), bs.data_ptr(),
        mm.data_ptr(), out.data_ptr(), e, m_max, n, k, b_q.stride(0), sbk,
        sbn, bs.stride(0), bs.stride(1), bs.stride(2), shift,
        int(out_dtype == torch.float32), ROUTES.index(plan[0]), plan[1],
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "grouped_gemm")
    COUNTER.launches += 1
    COUNTER.count_plan(plan_label(plan[0], plan[1]))
    return out


def m_grouped_gemm_masked(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales: torch.Tensor,
    masked_m: torch.Tensor,
    *,
    out_dtype=torch.bfloat16,
    config: Optional[GemmConfig] = None,
    b_scales_expanded: bool = False,
    b_layout: str = "n",
    expected_m: Optional[int] = None,
) -> torch.Tensor:
    """Masked grouped FP8 GEMM (MoE decode and prefill, fixed shapes).

    a_q: (E, M_max, K) e4m3; a_scales: (E, M_max, K/128) f32;
    b_q: (E, K, N) e4m3; b_scales: (E, K/128, N/128) f32 (or (E, K/128, N)
    if ``b_scales_expanded``); masked_m: (E,) int32 — rows ≥ masked_m[e]
    are ignored and their output is UNSPECIFIED (whole inactive tiles are
    zeroed; gather only valid slots, as models/moe.py does).

    ``b_layout='t'``: b_q (E, N, K) with b_scales (E, N/128, K/128) —
    DeepGEMM's ``m_grouped_gemm_fp8_fp8_bf16_nt_masked`` convention and the
    layout of the port's expert weights.

    ``expected_m``: the rows an expert is expected to hold, a hint that
    picks the kernel's tile (the selection key carries it; the analytic
    rule is ``tiling.analytic.masked_ring_tile``) and changes no result.
    ``config``: its tile, one of the route's compiled tiles (module
    docstring), or ``KernelType.XLA``.
    """
    if b_layout not in ("n", "t"):
        raise ValueError(f"b_layout must be 'n' or 't', got {b_layout!r}")
    b_t = b_layout == "t"
    if b_t and b_scales_expanded:
        raise ValueError("b_layout='t' requires unexpanded (E, N/128, K/128) "
                         "b_scales")
    if config is not None:
        check_config(config)
    e, m_max, k = a_q.shape
    if b_t:
        e2, n, k2 = b_q.shape
    else:
        e2, k2, n = b_q.shape
    if e != e2 or k != k2 or k % BLOCK or n % BLOCK:
        raise ValueError(f"bad shapes: a {tuple(a_q.shape)}, b "
                         f"{tuple(b_q.shape)} (b_layout={b_layout}; k and n "
                         f"must be multiples of {BLOCK})")
    kb, nb = k // BLOCK, n // BLOCK
    if b_scales_expanded:
        want, bs_view, shift = (e, kb, n), b_scales, 0
    elif b_t:
        want, bs_view, shift = (e, nb, kb), b_scales.transpose(1, 2), _SHIFT
    else:
        want, bs_view, shift = (e, kb, nb), b_scales, _SHIFT
    if tuple(b_scales.shape) != want:
        raise ValueError(f"b_scales must be {want}, got "
                         f"{tuple(b_scales.shape)}")
    if tuple(a_scales.shape) != (e, m_max, kb):
        raise ValueError(f"a_scales must be {(e, m_max, kb)}, got "
                         f"{tuple(a_scales.shape)}")
    if exact_enabled():
        y = _exact_gemm(a_q, a_scales, b_q, bs_view, shift, b_t,
                        torch.float32)
        rows = torch.arange(m_max, device=a_q.device)[None, :, None]
        y = torch.where(rows < masked_m.to(a_q.device)[:, None, None], y, 0.0)
        return y.to(out_dtype)
    if is_xla(config):
        # JAX's XLA family: the dense realization over the experts, rows at
        # or past masked_m[e] zeroed per row (JAX grouped_gemm.py:347-358).
        y = fp8_gemm_xla(a_q, a_scales, b_q, _scale_panel(bs_view, shift, n),
                         b_t=b_t, out_dtype=torch.float32)
        rows = torch.arange(m_max, device=a_q.device)[None, :, None]
        y = torch.where(rows < masked_m.to(a_q.device)[:, None, None], y, 0.0)
        return y.to(out_dtype)
    plan = None if config is None else caller_plan(
        masked_op(b_t), route(a_q, b_q, b_layout), config)
    return _launch(a_q, a_scales, b_q, bs_view, shift, masked_m, b_t,
                   out_dtype, plan=plan, expected_m=expected_m)


def grouped_gemm_contiguous_plain(a_q, a_scales, b_q, bs_view, tile_group_ids,
                                  *, shift: int = _SHIFT, b_t: bool = False,
                                  out_dtype=torch.bfloat16):
    """Plain PyTorch version of K8: rows of m-tile t (M_total / #tiles rows
    each) get K1's group-by-group accumulation with expert
    ``tile_group_ids[t]``; padding tiles (-1) are zero. ``bs_view`` is
    (E, kb, ·) indexed ``[e, g, col >> shift]``."""
    K8.plain_calls += 1
    m = a_q.shape[0]
    n = b_q.shape[1] if b_t else b_q.shape[2]
    panel = _scale_panel(bs_view, shift, n)
    gids = torch.as_tensor(tile_group_ids).to(device=a_q.device,
                                               dtype=torch.int64)
    row_gid = torch.repeat_interleave(gids, m // gids.numel())
    out = torch.zeros((m, n), dtype=out_dtype, device=a_q.device)
    for e in torch.unique(gids[gids >= 0]).tolist():
        rows = torch.nonzero(row_gid == e)[:, 0]
        out[rows] = _plain_gemm(a_q[rows], a_scales[rows], b_q[e], panel[e],
                                b_t, out_dtype)
    return out


def _launch_contiguous(a_q, a_scales, b_q, bs_view, shift, ids, block_m, b_t,
                       out_dtype, plan=None):
    """Run K8 on ``a_q``'s device: the kernel for CUDA, the plain version
    for the CPU. ``plan``: (route, tile) in place of
    :func:`contiguous_route` and the tiers' tile (:func:`selected_tile`):
    a caller's config's (:func:`caller_plan`), or a test's or a sweep's
    (the C entry refuses what it cannot run)."""
    dev = a_q.device
    if dev.type == "cpu":
        return grouped_gemm_contiguous_plain(a_q, a_scales, b_q, bs_view, ids,
                                             shift=shift, b_t=b_t,
                                             out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"m_grouped_gemm_contiguous: unsupported device "
                         f"{dev}")
    if a_q.dtype != FP8 or b_q.dtype != FP8:
        raise ValueError(f"m_grouped_gemm_contiguous: operands must be {FP8}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("m_grouped_gemm_contiguous: out_dtype must be bf16 "
                         f"or f32 on CUDA, got {out_dtype}")
    a_s = a_scales.to(torch.float32).contiguous()
    bs = bs_view.to(torch.float32)
    _check_cuda_operands("m_grouped_gemm_contiguous",
                         [("a_q", a_q), ("a_scales", a_s), ("b_q", b_q)], dev)
    if bs.device != dev:
        raise ValueError(f"m_grouped_gemm_contiguous: b_scales on "
                         f"{bs.device}")
    m, k = a_q.shape
    e = b_q.shape[0]
    n = b_q.shape[1] if b_t else b_q.shape[2]
    if plan is None:
        rt = contiguous_route(a_q, b_q, "t" if b_t else "n", block_m)
        op = contiguous_op(b_t)
        tile = selected_tile(op, rt, block_m, n, k, FP8, out_dtype, dev)
        plan = rt, analytic.tile_code(op, rt, *tile)
    if plan[0] == "tile":
        check_tile_alignment("m_grouped_gemm_contiguous", a_q, b_q, b_t)
    # The ids' copy to the card waits for the stream: the host work above
    # runs before it.
    gids = ids.to(device=dev, dtype=torch.int32)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    sbk, sbn = (1, k) if b_t else (n, 1)
    rc = _kernels.entry("grouped_gemm_contiguous")(
        a_q.data_ptr(), a_s.data_ptr(), b_q.data_ptr(), bs.data_ptr(),
        gids.data_ptr(), out.data_ptr(), m, n, k, block_m, b_q.stride(0), sbk,
        sbn, bs.stride(0), bs.stride(1), bs.stride(2), shift,
        int(out_dtype == torch.float32), e, CONTIGUOUS_ROUTES.index(plan[0]),
        plan[1], _kernels.stream_ptr(dev))
    _kernels.check(rc, "grouped_gemm_contiguous")
    K8.launches += 1
    K8.count_plan(contiguous_plan_label(*plan))
    return out


def m_grouped_gemm_contiguous(
    a_q: torch.Tensor,
    a_scales: torch.Tensor,
    b_q: torch.Tensor,
    b_scales: torch.Tensor,
    tile_group_ids,
    *,
    out_dtype=torch.bfloat16,
    config: Optional[GemmConfig] = None,
    b_scales_expanded: bool = False,
    b_layout: str = "n",
) -> torch.Tensor:
    """Contiguous grouped FP8 GEMM (MoE prefill).

    a_q: (M_total, K) e4m3, rows grouped by expert, group spans aligned to
    block_m; a_scales: (M_total, K/128) f32; b_q: (E, K, N) e4m3; b_scales:
    (E, K/128, N/128) f32 (or (E, K/128, N) if ``b_scales_expanded``);
    tile_group_ids: (M_total/block_m,) int expert id per m-tile, -1 for
    padding tiles (zeros). Returns (M_total, N). Plan the layout with
    :func:`make_contiguous_layout`. block_m and the checks on the ids:
    :func:`contiguous_tiles`; a config's tile: module docstring.

    ``b_layout='t'``: b_q (E, N, K) with b_scales (E, N/128, K/128) —
    DeepGEMM's ``m_grouped_gemm_fp8_fp8_bf16_nt_contiguous`` convention.
    """
    if b_layout not in ("n", "t"):
        raise ValueError(f"b_layout must be 'n' or 't', got {b_layout!r}")
    b_t = b_layout == "t"
    if b_t and b_scales_expanded:
        raise ValueError("b_layout='t' requires unexpanded (E, N/128, K/128) "
                         "b_scales")
    m, k = a_q.shape
    if b_t:
        e, n, k2 = b_q.shape
    else:
        e, k2, n = b_q.shape
    if k != k2 or k % BLOCK or n % BLOCK:
        raise ValueError(f"bad shapes: a {tuple(a_q.shape)}, b "
                         f"{tuple(b_q.shape)} (b_layout={b_layout}; k and n "
                         f"must be multiples of {BLOCK})")
    kb, nb = k // BLOCK, n // BLOCK
    if b_scales_expanded:
        want, bs_view, shift = (e, kb, n), b_scales, 0
    elif b_t:
        want, bs_view, shift = (e, nb, kb), b_scales.transpose(1, 2), _SHIFT
    else:
        want, bs_view, shift = (e, kb, nb), b_scales, _SHIFT
    if tuple(b_scales.shape) != want:
        raise ValueError(f"b_scales must be {want}, got "
                         f"{tuple(b_scales.shape)}")
    if tuple(a_scales.shape) != (m, kb):
        raise ValueError(f"a_scales must be {(m, kb)}, got "
                         f"{tuple(a_scales.shape)}")
    block_m, ids = contiguous_tiles(m, e, tile_group_ids, config)
    if exact_enabled():
        row_gid = torch.repeat_interleave(ids, block_m).to(a_q.device)
        y = torch.zeros((m, n), dtype=torch.float32, device=a_q.device)
        for ei in range(e):
            rows = torch.nonzero(row_gid == ei)[:, 0]
            y[rows] = _exact_gemm(a_q[rows], a_scales[rows], b_q[ei],
                                  bs_view[ei], shift, b_t, torch.float32)
        return y.to(out_dtype)
    plan = None if config is None else caller_plan(
        contiguous_op(b_t), contiguous_route(a_q, b_q, b_layout, block_m),
        config)
    return _launch_contiguous(a_q, a_scales, b_q, bs_view, shift, ids,
                              block_m, b_t, out_dtype, plan=plan)
