"""Profile one GEMM: its time, TFLOP/s and share of the H100's peak.

Port of ``scripts/profile_kernel.py``: run one GEMM configuration, time it
warm and back to back (``bench.timing.time_gemm_like``), and print µs,
TFLOP/s and the % of the card's peak for the input type
(``tiling.platform.peak_ops``). ``--check`` first gates the kernel against
the golden model with the reference's outlier-ratio acceptance (fp8:
``ops.reference.fp8_gemm_reference`` in f64 on the first 512 rows; bf16:
an f32 ``torch.matmul``; ``utils.verify``), and fails the run if it does
not pass. ``--trace-dir`` writes a ``torch.profiler`` chrome trace of one
call (the counterpart of ``jax.profiler.trace``).

``--op fp8_gemm`` runs K1 with B K-major ((n, k), 128×128 scales), as the
port's weights are stored; ``--op gemm`` runs the dense bf16 GEMM, K10 or
K11 as ``select_config`` (or ``--block`` with ``--k-split``) says. The
kernels' tiles are fixed: of a ``--block`` config only the kernel type and
the split count are read.

    python -m deepgemm_ascend_tpu_torch.scripts.profile_kernel \\
        --op fp8_gemm -m 4096 -n 4096 -k 4096 --check
"""

from __future__ import annotations

import argparse
import functools
import os

import torch

from ..bench import timing
from ..config import GemmConfig, KernelType
from ..ops import fp8_gemm as fp8mod
from ..ops import quant, reference
from ..ops.gemm import gemm as dense_gemm
from ..tiling import platform as plat
from ..utils import golden, verify
from ..utils.common import resolve_device


def _fp8_check(fn, a_q, a_s, b_q, b_s) -> verify.VerifyResult:
    """K1 on the first (up to) 512 rows against the f64 golden."""
    rows = min(a_q.shape[0], 512)
    out = fn(a_q[:rows], a_s[:rows], b_q, b_s)
    f32 = lambda t: t.float().cpu().numpy()
    ref = reference.fp8_gemm_reference(f32(a_q[:rows]), f32(a_s[:rows]),
                                       f32(b_q).T, f32(b_s).T)
    return verify.verify(f32(out), ref, rtol=1e-2, atol=1e-2, max_ratio=1e-4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--op", default="fp8_gemm", choices=["gemm", "fp8_gemm"])
    ap.add_argument("-m", type=int, required=True)
    ap.add_argument("-n", type=int, required=True)
    ap.add_argument("-k", type=int, required=True)
    ap.add_argument("--block", nargs=3, type=int, default=None,
                    metavar=("BM", "BN", "BK"),
                    help="explicit config (default: the selector's); the "
                         "fixed-tile kernels read its type and split only")
    ap.add_argument("--k-split", type=int, default=1)
    ap.add_argument("--iters", type=int, default=128)
    ap.add_argument("--min-chain", type=float, default=0.25,
                    help="grow iters until the timed chain lasts at least "
                         "this many seconds")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler chrome trace of one call "
                         "here")
    ap.add_argument("--check", action="store_true",
                    help="gate against the golden model first")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    m, n, k = args.m, args.n, args.k
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[profile] device={kind}")

    cfg = None
    if args.block:
        bm, bn, bk = args.block
        cfg = GemmConfig(bm, bn, bk,
                         kernel_type=(KernelType.KSPLIT if args.k_split > 1
                                      else KernelType.COMMON),
                         k_split=args.k_split)

    a = torch.from_numpy(golden.gen_heavy_tail((m, k), seed=0)).to(dev)
    b = torch.from_numpy(golden.gen_heavy_tail((k, n), seed=1)).to(dev)
    if args.op == "fp8_gemm":
        a_q, a_s = quant.quantize_fp8_act(a)
        b_q, b_s = quant.quantize_fp8_weight(b.t().contiguous())  # (n, k)
        fn = functools.partial(fp8mod.fp8_gemm, config=cfg, b_layout="t")
        call_args = (a_q, a_s, b_q, b_s)
        if args.check:
            res = _fp8_check(fn, *call_args)
    else:
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        fn = functools.partial(dense_gemm, config=cfg)
        call_args = (a, b)
        if args.check:
            ref = torch.matmul(a.float(), b.float())
            res = verify.verify(fn(a, b).cpu().numpy(), ref.cpu().numpy(),
                                rtol=1e-3, atol=1e-2, max_ratio=1e-4)
    if args.check:
        print(f"[profile] correctness: ok={res.ok} "
              f"ratio={res.mismatch_ratio:.2e}")
        if not res.ok:
            return 1

    t = timing.time_gemm_like(fn, *call_args, iters=args.iters, repeats=3,
                              min_chain_seconds=args.min_chain)
    flops = 2.0 * m * n * k
    peak = plat.peak_ops(call_args[0].dtype) / 1e12
    tf = t.tflops(flops)
    share = (f"({100 * tf / peak:.1f}% of {peak:.0f} TF/s peak)"
             if dev.type == "cuda" else "(a CPU run: no device peak)")
    print(f"[profile] {args.op} {m}x{n}x{k} cfg={cfg or 'auto'}: "
          f"{t.seconds * 1e6:.1f} us  {tf:.1f} TF/s  {share}")

    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            fn(*call_args)
            timing.synchronize(dev)
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
