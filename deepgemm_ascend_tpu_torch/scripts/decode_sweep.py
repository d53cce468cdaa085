"""Time K2's block counts and K6's routes and tiles on the card, beside the routes before them.

K2 (``flash_decode_gqa_inplace``): for each (b, kvh, g, S) row and its
lengths (``decode_lengths``: phase 2's, phase 4's, one key a sequence or
full caches) route "live" on
grids of one block per (batch, kv head) plus each count of ``--per-sm``
blocks an SM (``flash_decode._launch_inplace``'s ``plan``) and route
"span" (the 512-key spans of the kernel before it),
each timed cold (``bench.timing.cold_ms``: L2 flushed, median of 10) and
held against the plain version (2e-3; caches bit for bit). K6
(``m_grouped_int8_gemm_masked``, B stored (E, n, k)): for each (E, M_max,
n, k, expected_m) row, loads of routing M_max / 6 tokens to 6 distinct
experts at random, every route and tile — int8_tile (the route before),
ring 16x64, wgmma 64x64 and 128x256 — timed the same way and each equal
bit for bit to int8_tile on the valid rows, beside ``Tensor.zero_`` on
the output buffer (its write rate). One JSON line per row, with what
``live_blocks`` / ``tiling.analytic.masked_plan`` pick there: the data
those plan functions are chosen from. The card only.

    python -m deepgemm_ascend_tpu_torch.scripts.decode_sweep \\
        [--k2 16x4x4x4096 16x4x4x4096:serving ...] \\
        [--k6 32x96x2816x2048x3 ...] [--per-sm 1 2 3 4]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..bench import loads, timing
from ..ops import flash_decode as fdmod
from ..ops import int8_gemm as i8mod
from ..tiling import analytic, platform

TOP_K = loads.TOP_K
# K2: V2_LITE (group 4) at phase 2's and phase 4's lengths, V2_LITE_FULL
# (group 1) and V3_STYLE (group 8) at phase 2's, serve_bench scan's batch
# 64, and V2_LITE with one key a sequence and with full caches. K6:
# V2_LITE's experts at decode (16 slots), at serve_bench scan's batch 64,
# at phase 4's prefill forwards (s_pad x bucket = 128, 256, 512 and 1024
# tokens: 24 to 192 rows an expert) and at one prefill chunk (2048
# tokens), and V2_LITE_FULL's 64 experts at decode; capacity 6 rows a
# token, expected_m as the MoE layer passes it.
K2 = ("16x4x4x4096", "16x4x4x4096:serving", "16x16x1x4096", "16x16x8x4096",
      "64x4x4x4096", "16x4x4x4096:ones", "16x4x4x4096:full")
K6 = tuple(f"{e}x{TOP_K * t}x{nk}x{-(-TOP_K * t // e)}"
           for e, t in ((32, 16), (32, 64), (32, 128), (32, 256), (32, 512),
                        (32, 1024), (32, 2048), (64, 16))
           for nk in ("2816x2048", "2048x1408"))
PER_SM = (0.5, 1, 2, 3, 4, 6)
ATTN_TOL = 2e-3


def decode_lengths(b: int, s_max: int, kind: str = "", seed: int = 0):
    """Lengths of a K2 row: phase 2's (``""``), phase 4's (``serving``:
    16..1056), one key each (``ones``: the fixed cost) or the whole cache
    (``full``: the streaming rate)."""
    rng = np.random.default_rng(seed)
    if kind == "serving":
        return rng.integers(16, 1024 + 33, size=b)
    if kind in ("ones", "full"):
        return np.full(b, 1 if kind == "ones" else s_max)
    lens = rng.integers(1, s_max + 1, size=b)
    lens[:3] = [1, s_max, s_max]
    return lens


def measure_k2(b: int, kvh: int, g: int, s_max: int, lengths: str, per_sm,
               seed: int = 0) -> dict:
    dev = torch.device("cuda")
    hd = 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = [torch.randint(-127, 128, (b, kvh, s_max, hd), generator=gen,
                           device=dev, dtype=torch.int8),
             torch.rand(b, kvh, s_max, generator=gen, device=dev) * 0.02,
             torch.randint(-127, 128, (b, kvh, s_max, hd), generator=gen,
                           device=dev, dtype=torch.int8),
             torch.rand(b, kvh, s_max, generator=gen, device=dev) * 0.02]
    q = torch.randn(b, kvh * g, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    new = (torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=dev,
                         dtype=torch.int8),
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02,
           torch.rand(b, kvh, generator=gen, device=dev) * 0.02)
    lens_np = decode_lengths(b, s_max, lengths, seed)
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    plain_cache = [t.clone() for t in cache]
    ref = fdmod.flash_decode_inplace_plain(
        q, *plain_cache, *new, lens.clamp(max=s_max)).reshape(b, kvh * g, hd)

    def timed(plan):
        caches = [t.clone() for t in cache]
        run = lambda: fdmod._launch_inplace(q, *caches, *new, lens,
                                            plan=plan)[0]
        got = run()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if err >= ATTN_TOL or not all(torch.equal(x, y) for x, y in
                                      zip(caches, plain_cache)):
            raise RuntimeError(f"K2 b={b} kvh={kvh} g={g} S={s_max}: plan "
                               f"{plan} disagrees (err {err:.3g})")
        return timing.cold_ms(run)

    sms = platform.detect(dev).num_cores
    grids = sorted({b * kvh + max(1, round(x * sms)) for x in per_sm})
    row = {"kernel": "K2", "b": b, "kvh": kvh, "g": g, "S": s_max,
           "lengths": lengths or "phase 2",
           "sum_len": int(np.minimum(lens_np, s_max).sum()),
           "plan": fdmod.live_blocks(b, kvh, s_max, sms),
           "span_ms": timed(("span", fdmod.SPLIT_KEYS)),
           "live_ms": {n: timed(("live", n)) for n in grids}}
    row["best"] = min(row["live_ms"], key=row["live_ms"].get)
    row["best_ms"] = row["live_ms"][row["best"]]
    return row


def measure_k6(e: int, cap: int, n: int, k: int, expected_m, seed: int = 0
               ) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = max(1, cap // TOP_K)
    masked_m = loads.routed_loads(e, tokens, TOP_K, g, dev)
    a_q = torch.randint(-127, 128, (e, cap, k), generator=g, device=dev,
                        dtype=torch.int8)
    b_q = torch.randint(-127, 128, (e, n, k), generator=g, device=dev,
                        dtype=torch.int8)
    a_s = torch.rand(e, cap, 1, generator=g, device=dev) * 0.02 + 1e-3
    b_s = torch.rand(e, 1, n, generator=g, device=dev) * 0.02 + 1e-3
    rows = masked_m.tolist()
    run = lambda plan: (lambda: i8mod._launch_masked(
        a_q, a_s, b_q, b_s, masked_m, True, torch.bfloat16, plan=plan))
    want = run(("int8_tile", 0))()
    row = {"kernel": "K6", "e": e, "cap": cap, "n": n, "k": k,
           "expected_m": expected_m, "valid_rows": sum(rows),
           "max_rows": max(rows),
           "plan": i8mod.masked_plan_label(*analytic.masked_plan(
               cap, expected_m)),
           "route_ms": {}}
    for plan in (("int8_tile", 0), ("ring", 0), ("wgmma", 0), ("wgmma", 1)):
        got = run(plan)()
        torch.cuda.synchronize()
        for ei, r in enumerate(rows):
            if not torch.equal(got[ei, :r], want[ei, :r]):
                raise RuntimeError(f"K6 E={e} cap={cap} n={n} k={k}: "
                                   f"{plan} differs at expert {ei}")
        row["route_ms"][i8mod.masked_plan_label(*plan)] = timing.cold_ms(
            run(plan))
    row["best"] = min(row["route_ms"], key=row["route_ms"].get)
    row["best_ms"] = row["route_ms"][row["best"]]
    # The card's rate of writing the whole output buffer (zeros), for the
    # prefill rows, where most of it is zeros past masked_m.
    row["zero_fill_ms"] = timing.cold_ms(want.zero_)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k2", nargs="*", default=list(K2),
                        help="BxKVHxGxS[:serving|ones|full] (decode_lengths)")
    parser.add_argument("--k6", nargs="*", default=list(K6),
                        help="ExCAPxNxKxEXPECTED_M (EXPECTED_M 'none': no "
                             "hint)")
    parser.add_argument("--per-sm", type=float, nargs="+",
                        default=list(PER_SM), help="blocks an SM beyond one "
                        "per (batch, kv head), of K2's grids")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decode_sweep: CUDA is not available (it times "
                           "kernels on the card)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia-smi": smi}), flush=True)
    for spec in args.k2:
        shape, _, lengths = spec.partition(":")
        b, kvh, g, s_max = (int(x) for x in shape.split("x"))
        print(json.dumps(measure_k2(b, kvh, g, s_max, lengths,
                                    args.per_sm)), flush=True)
    for spec in args.k6:
        e, cap, n, k, hint = spec.split("x")
        print(json.dumps(measure_k6(
            int(e), int(cap), int(n), int(k),
            None if hint == "none" else int(hint))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
