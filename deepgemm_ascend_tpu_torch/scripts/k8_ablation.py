"""Time K8's route "wgmma16" with parts of it taken out.

K8 (``csrc/grouped_gemm.cu``, namespace ``w16``) converts each 128-deep
group's e4m3 operands to f16, runs the group's products on the tensor
cores and promotes the partials on the CUDA cores. To see what each part
costs, this script builds ``csrc/grouped_gemm.cu`` once for each
``-DDGA_K8_ABLATION=`` value (one ``nvcc`` each, all started together):

  0  the route as the package builds it;
  1  no promotion (the partials copied into the sums);
  2  no B conversion (the f16 stages keep what they held);
  3  no products;
  4  none of 1-3 and no A reads: the loads, barriers and stores alone.

Each variant runs through the package's K8 wrapper (its C entry swapped
for the variant's) on a MoE prefill layout: 2048 tokens × top-6 routed at
random over E experts, block_m 128, B stored (E, n, k); timed cold
(``bench.timing.cold_ms``: L2 flushed, median of 10) beside route tile on
the same operands. Variants 1-4 compute wrong products by design; variant
0 must equal the package's own K8 bit for bit, or the run fails. Prints one
JSON line per row. The card only.

    python -m deepgemm_ascend_tpu_torch.scripts.k8_ablation \\
        [--rows 32x2816x2048 32x2048x1408 ...]
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
from ..ops import _kernels, quant
from ..ops import fp8_gemm as fp8mod
from ..ops import grouped_gemm as ggmod

VARIANTS = {0: "as built", 1: "no promotion", 2: "no B conversion",
            3: "no products", 4: "loads, barriers and stores only"}
ROWS = ("32x2816x2048", "32x2048x1408")
TOKENS, TOP_K, BLOCK_M = 2048, 6, 128


def build_variants(out: Path) -> dict:
    """The K8 C entry of every variant, built from ``csrc/grouped_gemm.cu``
    into ``out``, each from a copy under a name of its own (as
    ``k12_fold_ablation.build_variants`` does, for the same reason: the
    anonymous namespace, and with it ``sm90::launch``'s static, is named
    after the file's path)."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in VARIANTS:
        so = out / f"libgrouped_gemm_ablation{v}.so"
        src = out / f"grouped_gemm_ablation{v}.cu"
        src.write_bytes((_kernels.CSRC / "grouped_gemm.cu").read_bytes())
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS,
               "-I", str(_kernels.CSRC), f"-DDGA_K8_ABLATION={v}",
               "-o", str(so), str(src)]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    entries = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {v}: nvcc rc {proc.returncode}\n"
                               f"{log}")
        fn = ctypes.CDLL(str(so)).dga_grouped_gemm_contiguous
        fn.argtypes = _kernels.KERNELS["grouped_gemm_contiguous"][2]
        fn.restype = ctypes.c_int
        entries[v] = fn
    return entries


@contextlib.contextmanager
def k8_entry(fn):
    """The K8 wrapper launches ``fn`` instead of the package's entry."""
    real = _kernels.entry
    _kernels.entry = lambda name: fn if name == "grouped_gemm_contiguous" \
        else real(name)
    try:
        yield
    finally:
        _kernels.entry = real


def measure(row: str, entries: dict, seed: int = 0) -> dict:
    e, n, k = (int(x) for x in row.split("x"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    picks = torch.multinomial(torch.ones(e, device=dev), TOKENS * TOP_K,
                              replacement=True, generator=g)
    counts = torch.bincount(picks, minlength=e).tolist()
    m, gids, _ = ggmod.make_contiguous_layout(counts, BLOCK_M)
    ids = torch.from_numpy(gids)
    a_q, a_s = quant.quantize_fp8_act(torch.randn(m, k, generator=g,
                                                  device=dev))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=dev) / math.sqrt(k))
    run = lambda: ggmod.m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s, ids,
                                                  b_layout="t")
    want = run()
    out = {"row": f"E={e} M_total={m} n={n} k={k} block_m={BLOCK_M}"}
    for v, fn in entries.items():
        with k8_entry(fn):
            got = run()
            torch.cuda.synchronize()
            if v == 0 and not torch.equal(got, want):
                raise RuntimeError(f"{row}: variant 0 differs from K8")
            out[f"ms_{v}"] = timing.cold_ms(run)
    out["tile_ms"] = timing.cold_ms(lambda: ggmod._launch_contiguous(
        a_q, a_s, b_q, b_s.transpose(1, 2), fp8mod._SHIFT, ids, BLOCK_M,
        True, torch.bfloat16, plan=("tile", 0)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", nargs="+", default=list(ROWS),
                        help="E x n x k")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k8_ablation: CUDA is not available (it builds "
                           "and times kernels on the card)")
    entries = build_variants(_kernels.BUILD_ROOT / "k8_ablation"
                             / _kernels._source_hash())
    print(json.dumps({"variants": VARIANTS}), flush=True)
    for row in args.rows:
        print(json.dumps(measure(row, entries)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
