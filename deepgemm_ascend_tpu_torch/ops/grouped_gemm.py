"""Masked grouped FP8 GEMM for MoE (kernel K3) and the contiguous layout
planner.

Port of the masked path of ``deepgemm_ascend_tpu/ops/grouped_gemm.py``
(``m_grouped_gemm_masked``) and of ``make_contiguous_layout``, which plans
the row layout of the contiguous grouped GEMMs (the int8 one, K9, is
ported; the fp8 one waits for a later slice).
Per expert e, the first ``masked_m[e]`` rows of a fixed-shape (E, M_max, K)
activation buffer are multiplied by that expert's weight with K1's
blockwise scale math. On a CUDA tensor the wrapper launches
``csrc/grouped_gemm.cu``, which skips every tile at or past
``masked_m[e]`` before any load; on a CPU tensor it runs
:func:`grouped_gemm_masked_plain`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import GemmConfig
from ..utils.common import round_up
from . import _kernels
from .fp8_gemm import (_SHIFT, _check_cuda_operands, _exact_gemm,
                       _plain_gemm, _scale_panel, check_config,
                       exact_enabled)
from .quant import BLOCK, FP8

__all__ = ["m_grouped_gemm_masked", "grouped_gemm_masked_plain",
           "make_contiguous_layout"]

COUNTER = _kernels.COUNTERS["grouped_gemm"]


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


def _launch(a_q, a_scales, b_q, bs_view, shift, masked_m, b_t, out_dtype):
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
    rc = _kernels.entry("grouped_gemm")(
        a_q.data_ptr(), a_s.data_ptr(), b_q.data_ptr(), bs.data_ptr(),
        mm.data_ptr(), out.data_ptr(), e, m_max, n, k, b_q.stride(0), sbk,
        sbn, bs.stride(0), bs.stride(1), bs.stride(2), shift,
        int(out_dtype == torch.float32), _kernels.stream_ptr(dev))
    _kernels.check(rc, "grouped_gemm")
    COUNTER.launches += 1
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
    return _launch(a_q, a_scales, b_q, bs_view, shift, masked_m, b_t,
                   out_dtype)
