"""Time K12, the folded-scale fp8 GEMM, with parts of its fold taken out.

K12 (``csrc/fp8_gemm.cu``) folds each stage's e4m3 bytes into bf16 between
the TMA loads and the wgmma products. To see which part of the fold costs
the time K12 spends above the dense GEMM (K10) on the same tile, this
script builds ``csrc/fp8_gemm.cu`` once for each ``-DDGA_K12_ABLATION=``
value (one ``nvcc`` each, all started together):

  0  the kernel as the package builds it;
  1  no conversion: the raw bytes stored where the bf16 values go (the same
     shared-memory reads and writes, no cvt or multiply);
  2  the conversions without their bf16 stores (48 KB fewer shared-memory
     writes a 128 × 256 stage);
  3  no fold: the raw bytes neither read, converted nor stored — only the
     rings, their barriers and the products.

Each variant runs through the package's K12 wrapper (``fp8_gemm(...,
scale_mode="folded")``, its C entry swapped for the variant's) at each
shape, timed cold (``bench.timing.cold_ms``: L2 flushed, median of 10),
beside K10 with bf16 output on bf16 operands of the same m, n, k. Variants
1-3 compute wrong products by design; variant 0 must equal the package's
own K12 bit for bit, or the run fails. Prints one JSON line per shape.
The card only.

    python -m deepgemm_ascend_tpu_torch.scripts.k12_fold_ablation \\
        [--shapes 2048x22016x2048:t 2048x2048x2048:n ...]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from ..bench import timing
from ..config import GemmConfig
from ..ops import _kernels, quant
from ..ops import fp8_gemm as fp8mod
from ..ops.gemm import gemm_with_config

VARIANTS = {0: "as built", 1: "no conversion", 2: "no bf16 stores",
            3: "no fold"}
SHAPES = ("2048x22016x2048:t", "2048x2048x2048:t", "2048x2048x2048:n",
          "16x22016x2048:t")
K10 = GemmConfig(block_m=64, block_n=64, block_k=64)


def build_variants(out: Path) -> dict:
    """The K12 C entry of every variant, built from ``csrc/fp8_gemm.cu``
    into ``out``. Each variant compiles from a copy under a name of its
    own: nvcc names a file's anonymous namespace after the file's path,
    so from the same path a variant's kernels would share their mangled
    names, and with them ``sm90::launch``'s once-per-instance static (a
    process-wide unique symbol), with the package's own K12 library: the
    variant's shared-memory attribute would never be set."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in VARIANTS:
        so = out / f"libfp8_gemm_ablation{v}.so"
        src = out / f"fp8_gemm_ablation{v}.cu"
        src.write_bytes((_kernels.CSRC / "fp8_gemm.cu").read_bytes())
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS,
               "-I", str(_kernels.CSRC), f"-DDGA_K12_ABLATION={v}",
               "-o", str(so), str(src)]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    entries = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {v}: nvcc rc {proc.returncode}\n{log}")
        fn = ctypes.CDLL(str(so)).dga_fp8_gemm_folded
        fn.argtypes = _kernels.KERNELS["fp8_gemm_folded"][2]
        fn.restype = ctypes.c_int
        entries[v] = fn
    return entries


@contextlib.contextmanager
def k12_entry(fn):
    """The K12 wrapper launches ``fn`` instead of the package's entry."""
    real = _kernels.entry
    _kernels.entry = lambda name: fn if name == "fp8_gemm_folded" \
        else real(name)
    try:
        yield
    finally:
        _kernels.entry = real


def measure(shape: str, entries: dict, seed: int = 0) -> dict:
    dims, b_layout = shape.split(":")
    m, n, k = (int(x) for x in dims.split("x"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b_t = b_layout == "t"
    a_q, a_s = quant.quantize_fp8_act(torch.randn(m, k, generator=g,
                                                  device=dev))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn((n, k) if b_t else (k, n), generator=g, device=dev)
        / math.sqrt(k))
    run = lambda: fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                                  scale_mode="folded", allow_relaxed=True)
    want = run()
    row = {"shape": f"m={m} n={n} k={k} b_layout={b_layout}"}
    for v, fn in entries.items():
        with k12_entry(fn):
            got = run()
            torch.cuda.synchronize()
            if v == 0 and not torch.equal(got, want):
                raise RuntimeError(f"{shape}: variant 0 differs from K12")
            row[f"ms_{v}"] = timing.cold_ms(run)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
    row["k10_bf16_out_ms"] = timing.cold_ms(
        lambda: gemm_with_config(a, b, config=K10, out_dtype=torch.bfloat16))
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES),
                        help="m x n x k : b_layout (t or n)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k12_fold_ablation: CUDA is not available (it "
                           "builds and times kernels on the card)")
    entries = build_variants(_kernels.BUILD_ROOT / "k12_ablation"
                             / _kernels._source_hash())
    print(json.dumps({"variants": VARIANTS}), flush=True)
    for shape in args.shapes:
        print(json.dumps(measure(shape, entries)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
