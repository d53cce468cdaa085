"""Autotune sweep of the compiled tile variants over a shape suite.

Port of ``scripts/autotune_sweep.py`` (≙ the reference's
``framework/benchmark/benchmark.py`` flow), restricted to the ported ops
whose kernels have tile variants: the dense GEMM (``gemm``, ``gemm_nt``,
``gemm_tn``, ``gemm_tt``: K10/K11), W8A8 (``int8_gemm_nt``, ``int8_gemm``:
K7), blockwise fp8 (``fp8_gemm_nt``, ``fp8_gemm``: K1) and the grouped
GEMMs under JAX's sweep names: ``grouped_gemm_masked[_nt]`` (K3),
``grouped_gemm_contiguous[_nt]`` (K8, whose key is the selector's op
``grouped_gemm[_nt]``), ``int8_grouped_gemm_masked[_nt]`` (K6) and
``int8_grouped_gemm_contiguous[_nt]`` (K9, op ``int8_grouped_gemm[_nt]``).
The suites are JAX's (``reference``, ``dynamic``, ``headline``; for the
grouped ops ``grouped``, JAX's (E, M, N, K) prefill and decode shapes)
and ``v2_lite`` (the port's serving rows: V2_LITE's projections at 16 and
2048 rows), or ``--shapes M N K ...`` (E M N K quadruples for a grouped
op).

A grouped op runs on routed loads (``bench.loads``: tokens that each
pick 6 distinct experts at random, as the MoE layer's router sends them),
so that its winner is timed on the skewed traffic it will serve. A
masked op's shape is E experts of M_max rows; ``--expected-m`` sweeps it
at each given count of rows an expert is expected to hold: the tokens
that give an expert that many rows on average (M_max without the hint),
an expert's rows past M_max dropped; the winner's key carries the hint,
as the selector keys it. A contiguous op's shape is E experts of M
tokens on average, routed the same way or with ``--uneven`` JAX's
lognormal split of E·M tokens, laid out in min(128, M)-row m-tiles; its
key's m is the layout's m-tile, and its candidates are the route's
compiled tiles whose rows divide it.

Each shape runs in a child process (this script with ``--child``), so a
candidate that faults the CUDA context ends that child alone: the parent
reruns it (``--retries``), and the child's resume records the candidate
that was in flight as poisoned. The child makes the operands on the
device from ``--seed``, holds every candidate against the op's plain
version (``tiling.autotune``'s gate: K10/K11 within 1e-5 of Σ|a·b|, K7 bit
for bit, K1 within one bf16 ulp), times it with ``bench.timing.cold_ms``
and appends ``<out-dir>/<op>_<m>x<n>x<k>.jsonl``; the winner goes into
the tiling cache (``--cache``, default ``<out-dir>/tilings.jsonl``), which
``select_config`` reads through ``DGA_CACHE_FILE_PATH``. One JSON line a
shape: each candidate's ms, the analytic default's and the winner's.

    python -m deepgemm_ascend_tpu_torch.scripts.autotune_sweep \\
        --op gemm --suite headline --out-dir sweep

``--device cpu`` runs the plain versions with a host clock (a rehearsal:
no time it prints is a device time).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

GROUPED_OPS = tuple(f"{p}grouped_gemm_{kind}{sfx}" for p in ("", "int8_")
                    for kind in ("masked", "contiguous") for sfx in ("", "_nt"))
OPS = ("gemm", "gemm_nt", "gemm_tn", "gemm_tt", "int8_gemm_nt", "int8_gemm",
       "fp8_gemm_nt", "fp8_gemm") + GROUPED_OPS
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
# The port's serving rows: V2_LITE's dense projections (n, k) at a decode
# batch of 16 and a 2048-token prefill chunk.
V2_LITE_NK = ((2048, 2048), (512, 2048), (22016, 2048), (2048, 11008),
              (2816, 2048), (2048, 1408))
GEMM_REL_TOL = 1e-5


def suite(name: str) -> List[Tuple[int, ...]]:
    from ..bench import shapes
    return {"reference": shapes.REFERENCE_SUITE,
            "dynamic": shapes.DYNAMIC_SWEEP,
            "headline": [shapes.HEADLINE],
            "grouped": shapes.GROUPED_PREFILL + shapes.GROUPED_DECODE,
            "v2_lite": [(m, n, k) for n, k in V2_LITE_NK
                        for m in (16, 2048)]}[name]


def selector_op(op: str) -> str:
    """The selector's op of a sweep op: a contiguous op is keyed as
    ``[int8_]grouped_gemm[_nt]`` (JAX's names)."""
    return op.replace("grouped_gemm_contiguous", "grouped_gemm")


def uneven_tokens(e: int, m_per: int) -> List[int]:
    """JAX's ``--uneven`` split: a lognormal split of E·M tokens (seed
    12345), at least one an expert, drift repaired on the largest."""
    rng = np.random.default_rng(12345)
    w = rng.lognormal(0.0, 1.0, e)
    toks = np.maximum((w / w.sum() * e * m_per).astype(int), 1)
    drift = e * m_per - int(toks.sum())
    order = np.argsort(-toks)
    i = 0
    while drift != 0:
        j = order[i % e]
        step = 1 if drift > 0 else (-1 if toks[j] > 1 else 0)
        toks[j] += step
        drift -= step
        i += 1
    return [int(t) for t in toks]


def io_dtypes(op: str, dtype: str):
    """(input, output) types of an op's sweep: the types its callers use
    (K1, K7 and the grouped GEMMs bf16 out, K10 f32 out)."""
    if op.startswith(("fp8", "grouped")):
        return torch.float8_e4m3fn, torch.bfloat16
    if op.startswith("int8"):
        return torch.int8, torch.bfloat16
    return DTYPES[dtype], torch.float32


def problem(op: str, m: int, n: int, k: int, dtype: str, seed: int, dev):
    """(call(config), plain(), close(got, ref)) of one shape: the wrapper
    on the operands, the op's plain version, and the gate."""
    from ..ops import fp8_gemm as fp8mod
    from ..ops import int8_gemm as i8mod
    from ..ops import quant
    from ..ops.gemm import gemm_plain, gemm_with_config
    g = torch.Generator(device=dev).manual_seed(seed)
    if op.startswith("fp8"):
        b_t = op.endswith("_nt")
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.randn(n, k, generator=g, device=dev) / k ** 0.5
        a_q, a_s = quant.quantize_fp8_act(x)
        b_q, b_s = quant.quantize_fp8_weight(w if b_t else w.t().contiguous())
        bs_view = b_s.t() if b_t else b_s
        panel = fp8mod._scale_panel(bs_view, fp8mod._SHIFT, n)
        lay = "t" if b_t else "n"
        return (lambda cfg: fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, config=cfg,
                                            b_layout=lay),
                lambda: fp8mod._plain_gemm(a_q, a_s, b_q, panel, b_t,
                                           torch.bfloat16),
                _within_one_bf16_ulp)
    if op.startswith("int8"):
        b_t = op.endswith("_nt")
        a_q = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                            dtype=torch.int8)
        b_q = torch.randint(-127, 128, (n, k) if b_t else (k, n),
                            generator=g, device=dev, dtype=torch.int8)
        a_s = torch.rand(m, 1, generator=g, device=dev) / 127
        b_s = torch.rand(1, n, generator=g, device=dev) / 127
        lay = "t" if b_t else "n"
        return (lambda cfg: i8mod.int8_gemm(a_q, a_s, b_q, b_s, config=cfg,
                                            b_layout=lay),
                lambda: i8mod._epilogue(i8mod._int_sum(
                    a_q, i8mod._kn(b_q, b_t)), a_s, b_s, torch.bfloat16),
                torch.equal)
    layout = {"gemm": "nn"}.get(op, op[-2:])
    a_t, b_t = layout[0] == "t", layout[1] == "t"
    dt = DTYPES[dtype]
    a = torch.randn(*((k, m) if a_t else (m, k)), generator=g,
                    device=dev).to(dt)
    b = (torch.randn(*((n, k) if b_t else (k, n)), generator=g, device=dev)
         / k ** 0.5).to(dt)
    mag = torch.matmul((a.t() if a_t else a).float().abs(),
                       (b.t() if b_t else b).float().abs())
    return (lambda cfg: gemm_with_config(a, b, config=cfg, layout=layout),
            lambda: gemm_plain(a, b, a_t=a_t, b_t=b_t),
            lambda got, ref: bool(((got.float() - ref.float()).abs()
                                   <= GEMM_REL_TOL * mag).all()))


def grouped_problem(op: str, e: int, m: int, n: int, k: int, seed: int,
                    dev, expected_m: Optional[int] = None,
                    uneven: bool = False):
    """(call(config), plain(), close(got, ref), key m, flops scale) of one
    grouped shape on routed loads (module docstring): ``op``'s wrapper on
    its operands with a candidate tile
    (a masked op's config; a contiguous op's tile as the plan of its
    launch, since a caller's config there names the layout), the op's
    plain version, the gate on the rows the kernels define (K3 and K8
    within one bf16 ulp, K6 and K9 bit for bit), the selection key's m
    (M_max, or the layout's m-tile) and the experts or m-tiles the
    light-speed screen counts (the valid rows over M_max)."""
    from ..bench import loads
    from ..ops import grouped_gemm as gg
    from ..ops import int8_gemm as i8mod
    from ..ops import quant
    from ..tiling import analytic
    g = torch.Generator(device=dev).manual_seed(seed)
    b_t = op.endswith("_nt")
    lay = "t" if b_t else "n"
    int8 = op.startswith("int8")
    masked = "masked" in op
    if masked:
        rows = m if expected_m is None else max(0, min(m, expected_m))
        mm = loads.routed_masked_m(e, m, rows, generator=g, device=dev)
        a_shape = (e, m, k)
    else:
        toks = uneven_tokens(e, m) if uneven else loads.routed_counts(
            e, m, generator=g, device=dev)
        m_total, ids, _ = gg.make_contiguous_layout(toks, min(128, m))
        ids = torch.from_numpy(ids)
        a_shape = (m_total, k)
    b_shape = (e, n, k) if b_t else (e, k, n)
    if int8:
        a_q = torch.randint(-127, 128, a_shape, generator=g, device=dev,
                            dtype=torch.int8)
        b_q = torch.randint(-127, 128, b_shape, generator=g, device=dev,
                            dtype=torch.int8)
        a_s = torch.rand(*a_shape[:-1], 1, generator=g, device=dev) / 127
        b_s = torch.rand(e, 1, n, generator=g, device=dev) / 127
        bs_view, close = b_s, torch.equal
    else:
        a_q, a_s = quant.quantize_fp8_act(torch.randn(
            *a_shape, generator=g, device=dev))
        w = torch.randn(e, n, k, generator=g, device=dev) / k ** 0.5
        b_q, b_s = quant.quantize_fp8_weight(w if b_t else w.transpose(
            1, 2).contiguous())
        bs_view = b_s.transpose(1, 2) if b_t else b_s
        close = _within_one_bf16_ulp
    if masked:
        valid = torch.arange(m, device=dev)[None, :] < mm[:, None]
        fn = i8mod.m_grouped_int8_gemm_masked if int8 \
            else gg.m_grouped_gemm_masked
        call = lambda cfg: fn(a_q, a_s, b_q, b_s, mm, config=cfg,
                              b_layout=lay, expected_m=expected_m)
        plain = ((lambda: i8mod.grouped_masked_plain(
            a_q, a_s, b_q, b_s, mm, b_t=b_t)) if int8 else
            (lambda: gg.grouped_gemm_masked_plain(a_q, a_s, b_q, bs_view,
                                                  mm, b_t=b_t)))
        return (call, plain, lambda got, ref: close(got[valid], ref[valid]),
                m, float(mm.sum()) / max(m, 1))
    key_m = m_total // ids.numel()
    sop = selector_op(op)
    if int8:
        rt = i8mod.contiguous_route(a_q, b_q, lay, key_m)
        call = lambda cfg: i8mod._launch_contiguous(
            a_q, a_s, b_q, b_s, ids, key_m, b_t, torch.bfloat16,
            plan=(rt, analytic.tile_code(sop, rt, cfg.block_m, cfg.block_n)))
        plain = lambda: i8mod.grouped_contiguous_plain(a_q, a_s, b_q, b_s,
                                                       ids, b_t=b_t)
    else:
        rt = gg.contiguous_route(a_q, b_q, lay, key_m)
        call = lambda cfg: gg._launch_contiguous(
            a_q, a_s, b_q, bs_view, 7, ids, key_m, b_t, torch.bfloat16,
            plan=(rt, analytic.tile_code(sop, rt, cfg.block_m, cfg.block_n)))
        plain = lambda: gg.grouped_gemm_contiguous_plain(
            a_q, a_s, b_q, bs_view, ids, b_t=b_t)
    return call, plain, close, key_m, ids.numel()


def _within_one_bf16_ulp(got, ref) -> bool:
    """Each element within one bf16 ulp of the larger magnitude, plus 1e-6
    of the largest |ref| for values near zero (``chip_smoke.py``'s fp8
    gate)."""
    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    tiny = 1e-6 * float(r.abs().max())
    return bool(torch.isfinite(g).all() and ((g - r).abs() <= ulp + tiny)
                .all())


def _host_ms(fn: Callable, reps: int = 3) -> float:
    """The CPU rehearsal's clock: the median of ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def sweep_one(op: str, *shape: int, dtype: str = "bf16",
              out_dir: str, cache_path: str, seed: int = 0,
              device: str = "cuda", max_candidates: Optional[int] = None,
              retry_failed: bool = False, expected_m: Optional[int] = None,
              uneven: bool = False) -> Dict:
    """Sweep one shape — (M, N, K), or a grouped op's (E, M, N, K) — in
    this process; returns its summary."""
    from ..bench.timing import cold_ms
    from ..tiling import analytic, autotune, platform
    from ..tiling.cache import TilingCache
    from ..utils.common import resolve_device
    dev = resolve_device(device)
    info = platform.detect(dev)
    in_dt, out_dt = io_dtypes(op, dtype)
    grouped = op in GROUPED_OPS
    sop = selector_op(op)
    if grouped:
        e, m_in, n, k = shape
        call, plain, close, m, scale = grouped_problem(
            op, e, m_in, n, k, seed, dev, expected_m, uneven)
        tag = (f"{op}_{e}x{m_in}x{n}x{k}"
               + (f"_e{expected_m}" if expected_m is not None else "")
               + ("_uneven" if uneven else ""))
    else:
        m, n, k = shape
        call, plain, close = problem(op, m, n, k, dtype, seed, dev)
        scale = 1.0
        tag = f"{op}_{m}x{n}x{k}" + ("" if op.startswith(("fp8", "int8"))
                                     else f"_{dtype}")
    ref = plain()
    cuda = dev.type == "cuda"

    def check(cfg) -> bool:
        got = call(cfg)
        if cuda:
            torch.cuda.synchronize()
        return close(got, ref)

    def time_s(cfg) -> float:
        ms = cold_ms(lambda: call(cfg)) if cuda else _host_ms(
            lambda: call(cfg))
        return ms / 1e3

    tuner = autotune.Autotuner(
        time_s, op=sop, check_fn=check, info=info,
        results_path=os.path.join(out_dir, f"{tag}.jsonl"),
        checkpoint_path=os.path.join(out_dir, f"{tag}.ckpt.json"),
        cache=TilingCache(cache_path), retry_failed=retry_failed)
    win = tuner.sweep_shape(m, n, k, in_dtype=in_dt, out_dtype=out_dt,
                            max_candidates=max_candidates, verbose=True,
                            flops_scale=scale, expected_m=expected_m)
    default = analytic.get_best_config(m, n, k, in_dt, out_dt, op=sop,
                                       info=info, expected_m=expected_m)
    rows = {}
    with open(os.path.join(out_dir, f"{tag}.jsonl")) as f:
        for line in f:
            r = autotune.SweepResult.from_json(line)
            rows[autotune.describe(type(default).from_dict(r.config))] = (
                r.time_s * 1e3 if r.time_s > 0 else None)
    extra = ({"e": shape[0], "shape_m": shape[1],
              "expected_m": expected_m, "uneven": uneven} if grouped else {})
    return {"op": op, "m": m, "n": n, "k": k, **extra, "dtype": str(in_dt),
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "clock": "cold_ms" if cuda else "host (rehearsal)",
            "candidates_ms": rows,
            "default": autotune.describe(default),
            "default_ms": rows.get(autotune.describe(default)),
            "winner": None if win is None else autotune.describe(win),
            "winner_ms": None if win is None else rows.get(
                autotune.describe(win)),
            "winner_config": None if win is None else win.to_dict()}


def _child_argv(args, shape, expected_m) -> List[str]:
    argv = [sys.executable, "-m", __spec__.name if __spec__ else
            "deepgemm_ascend_tpu_torch.scripts.autotune_sweep", "--child",
            "--op", args.op, "--dtype", args.dtype, "--out-dir",
            args.out_dir, "--cache", args.cache, "--seed", str(args.seed),
            "--device", args.device, "--shapes", *map(str, shape)]
    if args.max_candidates:
        argv += ["--max-candidates", str(args.max_candidates)]
    if expected_m is not None:
        argv += ["--expected-m", str(expected_m)]
    if args.uneven:
        argv.append("--uneven")
    return argv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--op", default="gemm", choices=OPS)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES),
                    help="the dense GEMM's input type")
    ap.add_argument("--suite", default=None,
                    choices=["reference", "dynamic", "headline", "grouped",
                             "v2_lite"],
                    help="default: headline, or grouped for a grouped op")
    ap.add_argument("--shapes", nargs="*", type=int, default=None,
                    help="explicit M N K triples (a flat list; E M N K "
                         "quadruples for a grouped op)")
    ap.add_argument("--expected-m", nargs="*", type=int, default=None,
                    help="masked grouped ops: sweep each shape at each of "
                         "these rows an expert is expected to hold")
    ap.add_argument("--uneven", action="store_true",
                    help="contiguous grouped ops: JAX's lognormal split of "
                         "E*M tokens over the experts, 128-row m-tiles")
    ap.add_argument("--out-dir", default="autotune_results_port")
    ap.add_argument("--cache", default=None,
                    help="tiling cache (default <out-dir>/tilings.jsonl)")
    ap.add_argument("--max-candidates", type=int, default=None)
    ap.add_argument("--retries", type=int, default=2,
                    help="reruns of a child that dies (each resumes, the "
                         "candidate in flight poisoned)")
    ap.add_argument("--retry-poisoned", action="store_true")
    ap.add_argument("--child-timeout", type=float, default=3600,
                    help="seconds a shape's child may take")
    ap.add_argument("--in-process", action="store_true",
                    help="sweep every shape in this process")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune_sweep: CUDA is not available (it times "
                           "kernels on the card; --device cpu rehearses)")
    args.cache = args.cache or os.path.join(args.out_dir, "tilings.jsonl")
    os.makedirs(args.out_dir, exist_ok=True)
    grouped = args.op in GROUPED_OPS
    args.suite = args.suite or ("grouped" if grouped else "headline")
    if not args.shapes and (args.suite == "grouped") != grouped:
        ap.error(f"--suite {args.suite} is not a suite of --op {args.op}")
    width = 4 if grouped else 3
    shapes = ([tuple(args.shapes[i:i + width])
               for i in range(0, len(args.shapes), width)]
              if args.shapes else suite(args.suite))
    hints = (args.expected_m or [None]) if "masked" in args.op else [None]
    for shape, hint in ((s, h) for s in shapes for h in hints):
        if args.child or args.in_process:
            row = sweep_one(args.op, *shape, dtype=args.dtype,
                            out_dir=args.out_dir, cache_path=args.cache,
                            seed=args.seed, device=args.device,
                            max_candidates=args.max_candidates,
                            retry_failed=args.retry_poisoned,
                            expected_m=hint, uneven=args.uneven)
            print(json.dumps(row), flush=True)
            continue
        for attempt in range(args.retries + 1):
            proc = subprocess.run(_child_argv(args, shape, hint),
                                  capture_output=True, text=True,
                                  timeout=args.child_timeout)
            sys.stdout.write(proc.stdout)
            if proc.returncode == 0:
                break
            sys.stderr.write(proc.stderr[-2000:])
            print(f"[DGA] autotune_sweep: {args.op} {shape} child exited "
                  f"{proc.returncode} (attempt {attempt + 1})", flush=True)
        else:
            raise RuntimeError(f"autotune_sweep: {args.op} {shape} failed "
                               f"{args.retries + 1} times")
    return 0


if __name__ == "__main__":
    sys.exit(main())
