"""Time split-K (K11) against the dense GEMM (K10) on the card, shape by shape.

For each (m, n, k) of the grid, K10 (the COMMON config) and K11 at each
split count (the KSPLIT config; the wrapper's sum of the f32 partials
included, as a caller pays it), bf16 operands, f32 output, both through
``ops.gemm.gemm_with_config`` and timed cold (``bench.timing.cold_ms``:
L2 flushed, median of 10). Every K11 result is held against K10's within
the dense GEMM's tolerance (1e-5 of Σ|a·b|), or the run fails. Prints one
JSON line per shape: K10's time, K11's at each split count, the fastest
split, and what ``select_config`` picks there — the data that the split
gate of ``tiling/analytic.py`` is fitted to. The card only.

    python -m deepgemm_ascend_tpu_torch.scripts.ksplit_sweep \\
        [--m 16 64 ...] [--nk 2048x11008 ...] [--splits 2 3 4 ...]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..bench import timing
from ..config import GemmConfig, KernelType
from ..ops.gemm import gemm_with_config
from ..tiling.selector import TILE_K, select_config
from ..utils.common import ceil_div

M = (1, 16, 32, 64, 128, 256)
# V2_LITE's projections (n, k) — attention q/o, kv, the dense FFN's
# gate∥up and down, an expert's gate∥up and down —, other widths, and
# V2_LITE_FULL's dense down projection (k = 10944).
NK = ("2048x2048", "512x2048", "22016x2048", "2048x11008", "2816x2048",
      "2048x1408", "1024x4096", "4096x4096", "512x11008", "1024x11008",
      "2048x10944")
SPLITS = (2, 3, 4, 6, 8, 12, 16)
COMMON = GemmConfig(block_m=64, block_n=64, block_k=64)
REL_TOL = 1e-5


def ksplit_config(splits: int) -> GemmConfig:
    return COMMON.replace(kernel_type=KernelType.KSPLIT, k_split=splits)


def measure(m: int, n: int, k: int, splits, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    k10 = gemm_with_config(a, b, config=COMMON)
    tol = REL_TOL * torch.matmul(a.float().abs(), b.float().abs())
    row = {"m": m, "n": n, "k": k,
           "k10_ms": timing.cold_ms(
               lambda: gemm_with_config(a, b, config=COMMON)),
           "k11_ms": {}}
    for s in splits:
        if s > ceil_div(k, TILE_K):
            continue
        cfg = ksplit_config(s)
        got = gemm_with_config(a, b, config=cfg)
        torch.cuda.synchronize()
        if not bool(((got - k10).abs() <= 2 * tol).all()):
            raise RuntimeError(f"m={m} n={n} k={k}: K11 with {s} splits "
                               f"differs from K10")
        row["k11_ms"][str(s)] = timing.cold_ms(
            lambda: gemm_with_config(a, b, config=cfg))
    if row["k11_ms"]:
        best = min(row["k11_ms"], key=row["k11_ms"].get)
        row["best_split"], row["best_k11_ms"] = int(best), row["k11_ms"][best]
    cfg = select_config(m, n, k, torch.bfloat16, torch.float32, device=dev)
    row["picked"] = cfg.kernel_type.name + (
        f"/{cfg.k_split}" if cfg.k_split > 1 else "")
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--m", type=int, nargs="+", default=list(M))
    parser.add_argument("--nk", nargs="+", default=list(NK),
                        help="n x k")
    parser.add_argument("--splits", type=int, nargs="+",
                        default=list(SPLITS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ksplit_sweep: CUDA is not available (it times "
                           "kernels on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for nk in args.nk:
        n, k = (int(x) for x in nk.split("x"))
        for m in args.m:
            print(json.dumps(measure(m, n, k, args.splits)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
