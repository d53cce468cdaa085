"""DeepGEMM-style API aliases (upstream deepseek-ai/DeepGEMM names).

Port of ``deepgemm_ascend_tpu/compat/deep_gemm.py``: DeepGEMM's calling
convention — ``(tensor, scales)`` tuples, an explicit ``out`` buffer, NT
(K-major (n, k)) weights — over the port's FP8 ops:

* ``gemm_fp8_fp8_bf16_nt`` → ``fp8_gemm(auto_pad=True, b_layout="t")``,
  bf16 out (kernel K1; ragged n and k are padded, ``tiling/padding.py``);
* ``m_grouped_gemm_fp8_fp8_bf16_nt_contiguous`` →
  ``m_grouped_gemm_contiguous`` (kernel K8), after converting DeepGEMM's
  per-row ``m_indices`` into per-tile expert ids at the 128-row alignment;
* ``m_grouped_gemm_fp8_fp8_bf16_nt_masked`` → ``m_grouped_gemm_masked``
  (kernel K3); its ``expected_m`` hint picks the kernel's tile and
  changes no result.

Inputs are torch tensors or numpy arrays, placed as in
``compat.run_mmad_*``; a torch ``out`` gets the result copied in and is
returned, otherwise the result is returned.
``get_col_major_tma_aligned_tensor`` is the identity, as in the JAX
package: the port's wrappers make their scale tensors contiguous
themselves, and upstream DeepGEMM's TMA re-layout of the scales is not what
they read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.fp8_gemm import fp8_gemm
from ..ops.grouped_gemm import m_grouped_gemm_contiguous, m_grouped_gemm_masked
from ..ops.quant import BLOCK
from ..utils.common import ceil_div  # re-export: deep_gemm.ceil_div
from . import _check_out_shape, _deliver, _device, _to_torch

__all__ = [
    "ceil_div",
    "gemm_fp8_fp8_bf16_nt",
    "get_col_major_tma_aligned_tensor",
    "get_m_alignment_for_contiguous_layout",
    "m_grouped_gemm_fp8_fp8_bf16_nt_contiguous",
    "m_grouped_gemm_fp8_fp8_bf16_nt_masked",
]


def get_m_alignment_for_contiguous_layout() -> int:
    """Row-group alignment of the contiguous layout (= the scale block, as
    in DeepGEMM): group every expert's rows to multiples of this."""
    return BLOCK


def get_col_major_tma_aligned_tensor(x):
    """The identity (see the module docstring)."""
    return x


def _tensors(*groups, out=None):
    """Every array of ``groups`` (tuples and single arrays) as a tensor on
    one device: that of the first tensor among them or ``out``, else cuda."""
    flat = [x for g in groups for x in (g if isinstance(g, tuple) else (g,))]
    dev = _device(*flat, out)
    return [_to_torch(x, dev) for x in flat]


def gemm_fp8_fp8_bf16_nt(lhs: Tuple, rhs: Tuple, out=None):
    """``out = lhs @ rhs.T`` — DeepGEMM's dense NT entry point.

    lhs: (a_q (m, k) e4m3, a_scales (m, ⌈k/128⌉) f32); rhs: (b_q (n, k)
    e4m3, b_scales (⌈n/128⌉, ⌈k/128⌉) f32); out: (m, n) buffer (a tensor
    is written in place). Ragged n and k are padded (``auto_pad``)."""
    a_q, a_s, b_q, b_s = _tensors(lhs, rhs, out=out)
    _check_out_shape((a_q.shape[0], b_q.shape[0]), out)
    res = fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t", auto_pad=True,
                   out_dtype=torch.bfloat16)
    return _deliver(res, out)


def _tile_ids_from_m_indices(m_indices: torch.Tensor) -> torch.Tensor:
    """Per-ROW group ids (DeepGEMM ``m_indices``, -1 = padding row) → the
    per-TILE ids of the 128-row contiguous layout. Every tile must hold
    one id; the check reads ``m_indices`` on the host (one device-to-host
    copy per call when it lies on the card), as the JAX package does on
    concrete input."""
    bm = get_m_alignment_for_contiguous_layout()
    m_total = m_indices.shape[0]
    if m_total % bm:
        raise ValueError(
            f"m_indices length {m_total} must be a multiple of "
            f"{bm} (get_m_alignment_for_contiguous_layout())")
    tiles = m_indices.to(device="cpu", dtype=torch.int32).reshape(
        m_total // bm, bm)
    if not bool((tiles == tiles[:, :1]).all()):
        raise ValueError(
            "each 128-row tile must map to a single group id (align every "
            "expert's rows to get_m_alignment_for_contiguous_layout())")
    return tiles[:, 0]


def m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(lhs: Tuple, rhs: Tuple, out,
                                              m_indices):
    """Grouped NT GEMM over expert-contiguous rows (MoE prefill).

    lhs: (a_q (m_sum, k), a_scales (m_sum, k/128)); rhs: (b_q (num_groups,
    n, k), b_scales (num_groups, n/128, k/128)); m_indices: (m_sum,) int
    group id per row, -1 for padding rows (their output is zero). Rows of
    one group are contiguous and 128-aligned, as in DeepGEMM."""
    a_q, a_s, b_q, b_s, rows = _tensors(lhs, rhs, m_indices, out=out)
    if rows.shape[0] != a_q.shape[0]:
        raise ValueError(f"m_indices has {rows.shape[0]} rows, lhs "
                         f"{a_q.shape[0]}")
    tile_ids = _tile_ids_from_m_indices(rows)
    _check_out_shape((a_q.shape[0], b_q.shape[1]), out)
    res = m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s, tile_ids,
                                    b_layout="t", out_dtype=torch.bfloat16)
    return _deliver(res, out)


def m_grouped_gemm_fp8_fp8_bf16_nt_masked(lhs: Tuple, rhs: Tuple, out,
                                          masked_m,
                                          expected_m: Optional[int] = None):
    """Grouped NT GEMM with per-group valid-row counts (MoE decode).

    lhs: (a_q (num_groups, m_max, k), a_scales (num_groups, m_max, k/128));
    rhs as in the contiguous call; masked_m: (num_groups,) int. Rows ≥
    masked_m[g] are unspecified, as in DeepGEMM. ``expected_m``: the rows
    a group is expected to hold (picks K3's tile)."""
    a_q, a_s, b_q, b_s, mm = _tensors(lhs, rhs, masked_m, out=out)
    _check_out_shape((*a_q.shape[:2], b_q.shape[1]), out)
    res = m_grouped_gemm_masked(a_q, a_s, b_q, b_s, mm, b_layout="t",
                                out_dtype=torch.bfloat16,
                                expected_m=expected_m)
    return _deliver(res, out)
