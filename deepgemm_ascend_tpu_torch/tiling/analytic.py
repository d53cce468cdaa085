"""Kernel-family choice for the dense GEMM (``select_kernel_type``).

Port of ``select_kernel_type`` of ``deepgemm_ascend_tpu/tiling/analytic.py``
(:290-325) and nothing else of that module: its roofline tiler, VMEM
budget and candidate enumeration are TPU models and wait for the port's
tiling slice.

The JAX function minimises a per-core makespan over split counts, with a
gate (``nm·nn < cores and nk >= 2·cores``, :317) written for a TPU with
one or two TensorCores. The port instead models the two kernels as they
run on the card — K10 and K11 on the wgmma route of ``csrc/gemm.cu`` —
and sends a shape to KSPLIT only where the model, fitted to measured
times, says K11 wins clearly:

* the tile: where K10 takes 128 × 256 tiles (``sm90::large_tile``: m > 64
  and at least :data:`FULL_GRID` of them) the card is full and nothing
  splits. Otherwise both kernels run bm × bn (64 × 64) tiles,
  :data:`SLOTS_PER_SM` blocks an SM;
* a kernel of ``blocks`` blocks, each streaming ``stages`` bk-deep K
  stages of its tile, takes :data:`LAUNCH_S` plus the
  :data:`NORM`-norm of two limits: the blocks' streams, ``ceil(blocks /
  slots) · stages · STAGE_S``, and the operand bytes over
  :data:`HBM_RATE`. K10 is ``tiles`` blocks of ``nk`` stages; K11 with s
  splits ``s·tiles`` blocks of ``ceil(nk / s)`` stages, plus
  :data:`REDUCE_S` for the wrapper's sum and the f32 partials written and
  read again (2·s·m·n·4 bytes);
* KSPLIT takes the fastest split count of :data:`SPLITS` whose splits
  are at least :data:`MIN_BLOCKS_PER_SPLIT` stages deep, if the model
  puts it below :data:`MARGIN` of K10's time; ties go to fewer splits.

The constants were fitted to ``scripts/ksplit_sweep.py``'s times of K10
and of K11 at every split count of :data:`SPLITS`, bf16, m ∈ {1, 16, 32,
64, 128, 256} over eleven (n, k) (NVIDIA H100 80GB HBM3, 700 W): the
model's RMS error over the 520 times it models is 6.7 %, and at each of
the 26 of those 66 shapes where it splits, K11 at the chosen count beat
K10, by 1.22-2.39× (``PERF.md`` §6). At decode the splits pay where K is
deep and the tiles are few (m = 16: n = 2048, k = 11008; n = 512 or
1024, k ≥ 4096); at k ≤ 2048 the sum's launch costs more than the
shorter streams save.
"""

from __future__ import annotations

from typing import Tuple

from ..config import KernelType
from ..utils.common import ceil_div
from .platform import PlatformInfo

# sm90::large_tile (csrc/sm90_gemm.cuh): K10's 128 × 256 tile where m > 64
# and there are at least FULL_GRID of them.
LARGE_TILE = (128, 256)
FULL_GRID = 100
# Blocks of the 64 × 64 wgmma instance an SM holds (its launch bounds).
SLOTS_PER_SM = 2
# The fitted model (module docstring).
STAGE_S = 0.18e-6        # one block's time for one bk-deep stage
LAUNCH_S = 7.0e-6        # launch, pipeline fill and epilogue of a kernel
REDUCE_S = 3.5e-6        # K11's extra: the wrapper's sum of the partials
HBM_RATE = 2.5e12        # bytes a second the streams reach together
NORM = 1.5
SPLITS = (2, 3, 4, 6, 8, 12, 16)
MIN_BLOCKS_PER_SPLIT = 4
MARGIN = 0.85


def large_tile(m: int, n: int) -> bool:
    """K10 runs 128 × 256 tiles (``sm90::large_tile``)."""
    return m > 64 and (ceil_div(m, LARGE_TILE[0])
                       * ceil_div(n, LARGE_TILE[1])) >= FULL_GRID


def model_seconds(m: int, n: int, k: int, splits: int, bm: int, bn: int,
                  bk: int, info: PlatformInfo) -> float:
    """The modelled time of K10 (``splits`` = 1) or of K11 with ``splits``
    splits on bm × bn tiles of bk-deep stages (module docstring)."""
    tiles, nk = ceil_div(m, bm) * ceil_div(n, bn), ceil_div(k, bk)
    slots = SLOTS_PER_SM * info.num_cores
    nbytes = (m * k + k * n) * 2
    extra = 0.0
    if splits > 1:
        nbytes += 2 * splits * m * n * 4
        extra = REDUCE_S
    stream = ceil_div(splits * tiles, slots) * ceil_div(nk, splits) * STAGE_S
    limits = stream ** NORM + (nbytes / HBM_RATE) ** NORM
    return LAUNCH_S + extra + limits ** (1 / NORM)


def select_kernel_type(
    m: int, n: int, k: int, bm: int, bn: int, bk: int,
    info: PlatformInfo,
) -> Tuple[KernelType, int]:
    """(kernel family, split count) for an (m, n, k) GEMM whose small tile
    is bm × bn with bk-deep stages: SMALL for a single tile, KSPLIT with
    the modelled fastest split count where the model puts K11 below
    MARGIN of K10, else COMMON."""
    nm, nn, nk = ceil_div(m, bm), ceil_div(n, bn), ceil_div(k, bk)
    if nm == 1 and nn == 1 and nk == 1:
        return KernelType.SMALL, 1
    if large_tile(m, n):
        return KernelType.COMMON, 1
    cost = {s: model_seconds(m, n, k, s, bm, bn, bk, info)
            for s in SPLITS if nk // s >= MIN_BLOCKS_PER_SPLIT}
    if cost:
        best = min(cost, key=lambda s: (cost[s], s))
        if cost[best] <= MARGIN * model_seconds(m, n, k, 1, bm, bn, bk,
                                                info):
            return KernelType.KSPLIT, best
    return KernelType.COMMON, 1
