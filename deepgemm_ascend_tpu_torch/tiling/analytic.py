"""Kernel-family choice for the dense GEMM (``select_kernel_type``).

Port of ``select_kernel_type`` of ``deepgemm_ascend_tpu/tiling/analytic.py``
(:290-325) and nothing else of that module: its roofline tiler, VMEM
budget and candidate enumeration are TPU models and wait for the port's
tiling slice. The tile reasoned over is the mma_tile route's fixed tile
(``csrc/gemm.cu``: 64 × 64 output, 64-deep K blocks), on which K11
splits; K10's wgmma route, with its own tiles, is not modelled yet.

The objective is the JAX package's: over split counts ``s``, minimise the
per-core makespan ``ceil(s·nm·nn / cores) · ceil(nk / s)`` (ties go to
fewer splits, i.e. a smaller f32 partials buffer).

The gate is re-derived for Hopper. The JAX gate, ``nm·nn < cores and
nk >= 2·cores`` (:317), was written for a TPU with one or two TensorCores;
with the H100's 132 SMs its second half asks for K ≥ 16896 at a 64-deep
block, so a decode GEMM such as m=16, n=2048, k=11008 (32 tiles on 132 SMs)
would never split. What makes split-K pay on a GPU is an underfilled card:
the port splits when the output tiles fill less than half the SMs
(``2·nm·nn <= cores``), so that at least two splits of every tile fit in
one wave, and only into splits of at least ``MIN_BLOCKS_PER_SPLIT`` K blocks
(256 deep), so that each split still streams enough of K to amortise
writing and re-reading its f32 partial tile.
"""

from __future__ import annotations

from typing import Tuple

from ..config import KernelType
from ..utils.common import ceil_div
from .platform import PlatformInfo

MIN_BLOCKS_PER_SPLIT = 4


def select_kernel_type(
    m: int, n: int, k: int, bm: int, bn: int, bk: int,
    info: PlatformInfo,
) -> Tuple[KernelType, int]:
    """(kernel family, split count) for an (m, n, k) GEMM on (bm, bn, bk)
    tiles: SMALL for a single tile, KSPLIT with the best split count on an
    underfilled card (gate above), else COMMON."""
    nm, nn, nk = ceil_div(m, bm), ceil_div(n, bn), ceil_div(k, bk)
    if nm == 1 and nn == 1 and nk == 1:
        return KernelType.SMALL, 1
    cores = info.num_cores
    max_s = min(nk // MIN_BLOCKS_PER_SPLIT, cores)
    if 2 * nm * nn <= cores and max_s >= 2:
        best_s, best_cost = 1, nk
        for s in range(2, max_s + 1):
            cost = ceil_div(s * nm * nn, cores) * ceil_div(nk, s)
            if cost < best_cost:
                best_s, best_cost = s, cost
        if best_s > 1:
            return KernelType.KSPLIT, best_s
    return KernelType.COMMON, 1
