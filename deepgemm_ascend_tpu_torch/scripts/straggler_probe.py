"""The dispatch floor, and the probe rows, each as a share of light speed.

Port of ``scripts/straggler_probe.py``. First the floor under every launch,
through P0 (``ops/dispatch_probe.py``, one block copying an (8, 128) f32
tile), four ways: device µs per launch (CUDA events around N back-to-back
launches) and host µs per launch (the host clock around N launches and one
``synchronize()``), each through the wrapper ``copy_probe`` and through
the bare ``ctypes`` entry. Then the JAX probe's four rows at its shapes,
each variant as µs and % of the row's H100 light speed
(``bench/roofline.py``: fp8 at the fp8 rate, bf16 at bf16's):

* ``fp8small`` (64×512×2048): K1 (the selector's config, then each of
  its compiled variants — ring tiles and split plans,
  ``tiling.analytic.enumerate_candidates`` — in place of the JAX probe's
  Pallas blocks), its XLA family (plain torch ops), K12
  (``scale_mode="folded"``), and the scale fold plus ``torch.matmul`` as
  the library yardstick;
* ``masked`` (E=8, 128×2048×512): K3 (the selector's tile, then each of
  its compiled tiles under its plan label, in place of the JAX probe's
  Pallas blocks, whose six tags print as not expressible), K8 on the same
  tokens (one 128-row tile per expert), and the fold plus a batched
  ``torch.matmul``;
* ``primes`` (three prime shapes): K10 or K11 as ``select_config`` picks
  (the padding tier pads K and N's pitch where it pays:
  ``tiling/padding.py``), the unpadded mma_tile route, the selector's
  config on K and N padded to 128 inside the timed call, and
  ``torch.matmul``;
* ``bf16cube`` (4096³): ``select_config``'s pick, each compiled wgmma
  tile of K10 and its XLA family in place of the JAX probe's blocks, and
  ``torch.matmul``.

The fp8 rows take B K-major, (n, k) with (n/128, k/128) scales, as the
port's weights are stored. The JAX masked row's block-size and
coalescing variants are Pallas blocks and expert coalescing, which no
compiled K3 tile expresses; each prints as "n/a: a TPU block". There is
no
``try``/``except`` around a variant: the JAX probe's ``timed()`` survives
Mosaic rejecting a block, which has no counterpart here, so a failure
fails the run.

    python -m deepgemm_ascend_tpu_torch.scripts.straggler_probe [--rows ...]
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Dict, List, Sequence, Tuple

import torch

from ..bench import roofline, timing
from ..config import GemmConfig, KernelType
from ..ops import _kernels, quant
from ..ops import fp8_gemm as fp8mod
from ..ops import grouped_gemm as gg
from ..ops.dispatch_probe import PROBE_SHAPE, copy_probe, raw_launch
from ..ops.gemm import gemm_with_config
from ..tiling import analytic, platform
from ..tiling.autotune import describe
from ..tiling.selector import select_config
from ..utils import golden
from ..utils.common import resolve_device, round_up

ROWS = ("fp8small", "masked", "primes", "bf16cube")
# The JAX probe's shapes (straggler_probe.py:104, :141, :199-200, :234).
FP8SMALL = (64, 512, 2048)
MASKED = (8, 128, 2048, 512)
PRIMES = ((1279, 5003, 7681), (3511, 6151, 8191), (5119, 6997, 9901))
BF16CUBE = 4096
TPU_BLOCK = "n/a: a TPU block"
FP8 = torch.float8_e4m3fn
BF16 = torch.bfloat16


def light_speed(m, n, k, in_dtype, out_dtype, extra_bytes=0.0) -> float:
    """Seconds: the (m, n, k) product's roofline with ``extra_bytes`` of
    scales read besides."""
    rl = roofline.gemm_roofline(m, n, k, in_dtype, out_dtype)
    return max(rl.compute_bound_s,
               (rl.bytes + extra_bytes) / rl.peak_bytes_per_s)


def _report(tag: str, t: timing.Timing, ls: float) -> Dict:
    print(f"[probe]   {tag:38s} {t.seconds * 1e6:9.2f} us  "
          f"{ls / t.seconds * 100:5.1f}% LS", flush=True)
    return {"tag": tag, "us": t.seconds * 1e6, "pct_ls": 100 * ls / t.seconds}


def _not_expressible(tag: str, why: str = TPU_BLOCK) -> Dict:
    print(f"[probe]   {tag:38s} {why}", flush=True)
    return {"tag": tag, "na": why}


def _host_us(call, launches: int, dev: torch.device) -> Tuple[float, List]:
    """Host µs per call over ``launches`` calls ended by one synchronize,
    and the calls' results."""
    call()
    timing.synchronize(dev)
    t0 = time.perf_counter()
    results = [call() for _ in range(launches)]
    timing.synchronize(dev)
    return (time.perf_counter() - t0) / launches * 1e6, results


def dispatch_floor(dev: torch.device, launches: int, t_kw: Dict) -> Dict:
    """P0's launch cost: device and host µs per launch through the wrapper
    and, on the card, through the bare ``ctypes`` entry. (On the CPU, where
    there is no device, the back-to-back chain is ``cpu_chain_us``.) The
    bare launches, which no wrapper counts, are added to P0's counter as
    ``bare_launches``."""
    x = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device=dev)
    wrapped = timing.time_fn(copy_probe, (x,), **t_kw)
    out = {"device_us" if dev.type == "cuda" else "cpu_chain_us":
           wrapped.seconds * 1e6}
    out["host_us"], _ = _host_us(functools.partial(copy_probe, x), launches,
                                 dev)
    if dev.type == "cuda":
        entry, args = raw_launch(x, torch.empty_like(x))
        bare = functools.partial(entry, *args)
        # The wrapper's chain length, not grown again, so that the count is
        # known: one warm-up call and `repeats` chains.
        repeats = t_kw.get("repeats", 3)
        out["bare_device_us"] = timing.time_fn(
            bare, (), iters=wrapped.iters, repeats=repeats,
            device=dev).seconds * 1e6
        out["bare_host_us"], rcs = _host_us(bare, launches, dev)
        _kernels.check(next((rc for rc in rcs if rc), 0), "copy_probe")
        _kernels.COUNTERS["copy_probe"].bare_launches += (
            1 + repeats * wrapped.iters + 1 + launches)
    print(f"[probe] dispatch floor (P0, {PROBE_SHAPE} f32): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def _fold_dot(aq, asc, bq, bs):
    """The scale fold and one ``torch.matmul``: A (…, m, k) e4m3 with
    (…, m, k/128) scales, B K-major (…, n, k) with (…, n/128, k/128)
    scales; each operand times its scales in f32, rounded to bf16."""
    a = (aq.float() * asc.repeat_interleave(quant.BLOCK, -1)).to(BF16)
    panel = bs.repeat_interleave(quant.BLOCK, -2).repeat_interleave(
        quant.BLOCK, -1)
    b = (bq.float() * panel).to(BF16)
    return torch.matmul(a, b.transpose(-1, -2))


def _fp8_operands(a_shape, b_kn_shape, dev):
    """Heavy-tail A and B (the JAX probe's seeds), quantized; B stored
    K-major. Returns a_q, a_s, b_q (…, n, k), b_s (…, n/128, k/128)."""
    a = torch.from_numpy(golden.gen_heavy_tail(a_shape, seed=0)).to(dev)
    b = torch.from_numpy(golden.gen_heavy_tail(b_kn_shape, seed=1)).to(dev)
    a_q, a_s = quant.quantize_fp8_act(a)
    b_q, b_s = quant.quantize_fp8_weight(b.transpose(-1, -2).contiguous())
    return a_q, a_s, b_q, b_s


def _variants(op: str, m: int, n: int, k: int, in_dtype, out_dtype, dev):
    """(tag, config) of each compiled variant of the op's kernel at this
    shape, and its XLA family."""
    info = platform.detect(dev)
    out = [(f"variant {describe(c)}", c) for c in
           analytic.enumerate_candidates(op, m, n, k, in_dtype, out_dtype,
                                         info) if not c.pad_k]
    return out + [("XLA family (plain torch ops)",
                   GemmConfig(kernel_type=KernelType.XLA))]


def row_fp8small(m: int, n: int, k: int, dev, t_kw: Dict) -> List[Dict]:
    print(f"[probe] fp8_gemm {m}x{n}x{k}", flush=True)
    kb = k // quant.BLOCK
    ls = light_speed(m, n, k, FP8, BF16,
                     extra_bytes=(m * kb + (n // quant.BLOCK) * kb) * 4)
    ops = _fp8_operands((m, k), (k, n), dev)
    res = [_report(f"K1 {tag}", timing.time_gemm_like(functools.partial(
        fp8mod.fp8_gemm, b_layout="t", config=cfg), *ops, **t_kw), ls)
        for tag, cfg in _variants("fp8_gemm_nt", m, n, k, FP8, BF16, dev)]
    k1 = functools.partial(fp8mod.fp8_gemm, b_layout="t")
    k12 = functools.partial(fp8mod.fp8_gemm, b_layout="t",
                            scale_mode="folded", allow_relaxed=True)
    for tag, fn in (("K1 fp8_gemm", k1), ("K12 fp8_gemm folded", k12),
                    ("scale-fold + torch.matmul", _fold_dot)):
        res.append(_report(tag, timing.time_gemm_like(fn, *ops, **t_kw), ls))
    return res


def row_masked(e: int, m: int, n: int, k: int, dev, t_kw: Dict) -> List[Dict]:
    print(f"[probe] grouped_masked E{e} {m}x{n}x{k}", flush=True)
    kb = k // quant.BLOCK
    ls = e * light_speed(m, n, k, FP8, BF16,
                         extra_bytes=(m * kb + (n // quant.BLOCK) * kb) * 4)
    a_q, a_s, b_q, b_s = _fp8_operands((e, m, k), (e, k, n), dev)
    mm = torch.full((e,), m, dtype=torch.int32, device=dev)
    res = [_not_expressible(tag) for tag in (
        "swept best 128x2048x512", "full-K 128x1024x512",
        "wide 128x2048x512 nmajor", "coalesce ec=2 128x2048x512",
        "coalesce ec=4 128x1024x512", "coalesce ec=8 128x512x512")]
    k3 = functools.partial(gg.m_grouped_gemm_masked, b_layout="t")
    res.append(_report("K3 masked", timing.time_fn(
        k3, (a_q, a_s, b_q, b_s, mm), **t_kw), ls))
    op = gg.masked_op(True)
    rt = gg.route(a_q, b_q, "t") if dev.type == "cuda" else \
        analytic.expected_route(op, m, n, k, FP8)
    for cfg in analytic.enumerate_candidates(op, m, n, k, FP8, BF16,
                                             platform.detect(dev), route=rt):
        label = fp8mod.plan_label(rt, analytic.tile_code(
            op, rt, cfg.block_m, cfg.block_n))
        res.append(_report(f"K3 {label}", timing.time_fn(
            functools.partial(k3, config=cfg), (a_q, a_s, b_q, b_s, mm),
            **t_kw), ls))
    # K8 on the same tokens: the E blocks of m rows laid end to end, one
    # m-row tile per expert.
    ids = torch.arange(e, dtype=torch.int32)
    k8 = functools.partial(gg.m_grouped_gemm_contiguous, b_layout="t")
    res.append(_report("K8 contiguous, same tokens", timing.time_fn(
        k8, (a_q.reshape(e * m, k), a_s.reshape(e * m, kb), b_q, b_s, ids),
        **t_kw), ls))
    res.append(_report("scale-fold + batched torch.matmul", timing.time_fn(
        _fold_dot, (a_q, a_s, b_q, b_s), **t_kw), ls))
    return res


def _bf16_operands(m, n, k, dev):
    a = torch.from_numpy(golden.gen_heavy_tail((m, k), seed=0)).to(dev)
    b = torch.from_numpy(golden.gen_heavy_tail((k, n), seed=1)).to(dev)
    return a.to(BF16), b.to(BF16)


def _picked(cfg) -> str:
    return "selected " + cfg.kernel_type.name + (
        f"/{cfg.k_split}" if cfg.kernel_type == KernelType.KSPLIT else "") + \
        f" {describe(cfg)}"


def row_primes(shapes: Sequence, dev, t_kw: Dict) -> List[Dict]:
    res = []
    for m, n, k in shapes:
        print(f"[probe] bf16 gemm {m}x{n}x{k} (prime)", flush=True)
        ls = light_speed(m, n, k, BF16, torch.float32)
        a, b = _bf16_operands(m, n, k, dev)
        best = select_config(m, n, k, BF16, torch.float32, device=dev)
        sel = functools.partial(gemm_with_config, config=best)
        res.append(_report(_picked(best), timing.time_gemm_like(
            sel, a, b, **t_kw), ls))
        res.append(_report("unpadded, mma_tile 64x64", timing.time_gemm_like(
            functools.partial(gemm_with_config, config=GemmConfig(64, 64, 64),
                              plan="mma_tile"), a, b, **t_kw), ls))
        k_pad, n_pad = round_up(k, 128), round_up(n, 128)

        def padded(x, y, c=best, n=n, k_pad=k_pad, n_pad=n_pad):
            xp = torch.nn.functional.pad(x, (0, k_pad - x.shape[1]))
            yp = torch.nn.functional.pad(y, (0, n_pad - n, 0,
                                             k_pad - y.shape[0]))
            return gemm_with_config(xp, yp, config=c)[:, :n]

        res.append(_report("in-graph padded K,N (same cfg)",
                           timing.time_gemm_like(padded, a, b, **t_kw), ls))
        res.append(_report("torch.matmul", timing.time_gemm_like(
            torch.matmul, a, b, **t_kw), ls))
    return res


def row_bf16cube(size: int, dev, t_kw: Dict) -> List[Dict]:
    m = n = k = size
    print(f"[probe] bf16 gemm {size}^3", flush=True)
    ls = light_speed(m, n, k, BF16, torch.float32)
    a, b = _bf16_operands(m, n, k, dev)
    best = select_config(m, n, k, BF16, torch.float32, device=dev)
    res = [_report(_picked(best), timing.time_gemm_like(
        functools.partial(gemm_with_config, config=best), a, b, **t_kw), ls)]
    res += [_report(tag, timing.time_gemm_like(functools.partial(
        gemm_with_config, config=cfg), a, b, **t_kw), ls)
        for tag, cfg in _variants("gemm", m, n, k, BF16, torch.float32, dev)]
    res.append(_report("torch.matmul", timing.time_gemm_like(
        torch.matmul, a, b, **t_kw), ls))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--min-chain", type=float, default=0.25)
    ap.add_argument("--rows", nargs="*", default=None, choices=ROWS,
                    help="subset of the rows (default: all)")
    ap.add_argument("--launches", type=int, default=1000,
                    help="launches per host-clock reading of the floor")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = args.rows or ROWS
    t_kw = dict(iters=args.iters, repeats=2,
                min_chain_seconds=args.min_chain)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "dispatch_floor": dispatch_floor(dev, args.launches, t_kw)}
    if "fp8small" in rows:
        out["fp8small"] = row_fp8small(*FP8SMALL, dev, t_kw)
    if "masked" in rows:
        out["masked"] = row_masked(*MASKED, dev, t_kw)
    if "primes" in rows:
        out["primes"] = row_primes(PRIMES, dev, t_kw)
    if "bf16cube" in rows:
        out["bf16cube"] = row_bf16cube(BF16CUBE, dev, t_kw)
    print(json.dumps({"probe": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
