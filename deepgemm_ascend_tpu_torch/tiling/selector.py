"""Tile-config front door of the dense GEMM (``select_config``).

Port of ``deepgemm_ascend_tpu/tiling/selector.py``, override-only: a
caller's config wins (as at JAX ``selector.py:108-109``); otherwise the
answer is the 64 × 64 × 64 config with the family that
``select_kernel_type`` picks for the device (its model of K10 and K11 on
the card). The JAX front door's persistent cache, learned
predictor and TPU data files belong to the port's tiling slice; this
module reads no data file.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import GemmConfig, KernelType
from . import analytic, platform

# The small tile and the K block the selector reasons with: 64 × 64 output
# tiles and 64-deep K blocks, the tile K10 and K11 run on either route
# wherever K10 does not take 128 × 256 (analytic.large_tile), and the K
# block K11 splits in (csrc/gemm.cu: s9::kBK, kBK; ops/gemm.py:_split_depth).
TILE_M = TILE_N = TILE_K = 64
# The ops whose K11 path exists: split-K is nn only (ops/gemm.py).
_KSPLIT_OPS = ("gemm", "bgemm")


def select_config(
    m: int, n: int, k: int,
    in_dtype=torch.bfloat16,
    out_dtype=torch.float32,
    *,
    op: str = "gemm",
    override: Optional[GemmConfig] = None,
    device="cuda",
) -> GemmConfig:
    """The tile config of an (m, n, k) GEMM of ``op`` on ``device``.

    The family model is fitted to 16-bit operands on the wgmma route and
    serves every input and output type, so ``in_dtype`` and ``out_dtype``
    do not change the answer; they stay in the signature of the JAX front
    door, whose cache keys on them. KSPLIT is chosen only for the nn ops
    (``gemm``, ``bgemm``), the only layout K11 runs."""
    if override is not None:
        return override
    kt, s = analytic.select_kernel_type(m, n, k, TILE_M, TILE_N, TILE_K,
                                        platform.detect(device))
    if kt == KernelType.KSPLIT and op not in _KSPLIT_OPS:
        kt, s = KernelType.COMMON, 1
    return GemmConfig(block_m=TILE_M, block_n=TILE_N, block_k=TILE_K,
                      kernel_type=kt, k_split=s)
