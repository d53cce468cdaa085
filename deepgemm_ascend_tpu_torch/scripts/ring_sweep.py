"""Time K1's and K3's ring route plan by plan on the card, beside the tile route.

For each K1 shape (m, n, k) — e4m3 operands, B stored K-major as the
port's weights are, bf16 output — the tile route (``gemm_tile``, B given
(k, n)) and the ring route at every tile of ``fp8_gemm.RING_TILES`` that
fits and every split count of ``--splits`` (``fp8_gemm._launch``'s
``plan``), each timed cold (``bench.timing.cold_ms``: L2 flushed, median
of 10). Without splits the ring must equal the tile route bit for bit;
with them each output must lie within one bf16 ulp (plus 1e-6 of the
largest) of the plain version, or the run fails. The same for K3 (E
experts, M_max rows each, loads of routing M_max / top_k tokens to top_k
distinct experts at random: ``bench.loads``) at every ring tile,
bit-equal on the valid rows. Prints one JSON line per shape, with what
``ring_plan`` (or ``tiling.analytic.masked_ring_tile``, given the MoE
layer's ``expected_m``) picks there: the data those functions are chosen
from. The card only.

    python -m deepgemm_ascend_tpu_torch.scripts.ring_sweep \\
        [--k1 16x2048x2048 ...] [--k3 32x96x2816x2048 ...] [--splits 1 2 4]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch

from ..bench import loads, timing
from ..ops import fp8_gemm as fp8mod
from ..ops import grouped_gemm as ggmod
from ..ops import quant
from ..tiling import analytic, platform

# V2_LITE's projections (n, k) at decode, the scripts' batch and prefill;
# its experts at decode (16 and 32 tokens × top-6), the scripts' batch
# (64), 128 and 256 tokens, and one prefill chunk (2048 tokens).
K1 = tuple(f"{m}x{nk}" for m in (16, 64, 2048)
           for nk in ("2048x2048", "512x2048", "22016x2048", "2048x11008",
                      "2816x2048", "2048x1408"))
K3 = tuple(f"32x{cap}x{nk}" for cap in (96, 192, 384, 768, 1536, 12288)
           for nk in ("2816x2048", "2048x1408"))
SPLITS = (1, 2, 3, 4, 6, 8)
TOP_K = loads.TOP_K


def _within_one_ulp(got, ref) -> bool:
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return bool(((got - ref).abs() <= ulp + 1e-6 * float(
        ref.abs().max())).all())


def _k1_operands(m, n, k, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    a_q, a_s = quant.quantize_fp8_act(torch.randn(m, k, generator=g,
                                                  device=dev))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(n, k, generator=g, device=dev) / math.sqrt(k))
    return a_q, a_s, b_q, b_s


def measure_k1(m: int, n: int, k: int, splits, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    a_q, a_s, b_q, b_s = _k1_operands(m, n, k, seed)
    b_kn, bs_view = b_q.t().contiguous(), b_s.t()
    tile = lambda: fp8mod._launch(a_q, a_s, b_kn, bs_view, fp8mod._SHIFT,
                                  False, torch.bfloat16)
    want = tile()
    plain = fp8mod.fp8_gemm_plain(a_q, a_s, b_q, bs_view, b_t=True)
    row = {"kernel": "K1", "m": m, "n": n, "k": k, "ring_ms": {},
           "plan": list(fp8mod.ring_plan(m, n, k,
                                         platform.detect(dev).num_cores)),
           "tile_ms": timing.cold_ms(tile)}
    for t, (bm, bn) in enumerate(fp8mod.RING_TILES):
        if n % bn:
            continue
        for s in splits:
            if s > k // 128:
                continue
            plan = ("ring", t, s)
            run = lambda: fp8mod._launch(a_q, a_s, b_q, bs_view,
                                         fp8mod._SHIFT, True, torch.bfloat16,
                                         plan=plan)
            got = run()
            torch.cuda.synchronize()
            ok = torch.equal(got, want) if s == 1 else \
                _within_one_ulp(got, plain)
            if not ok:
                raise RuntimeError(f"K1 m={m} n={n} k={k}: ring {plan} "
                                   f"disagrees")
            row["ring_ms"][f"{bm}x{bn}/{s}"] = timing.cold_ms(run)
    row["best"] = min(row["ring_ms"], key=row["ring_ms"].get)
    row["best_ms"] = row["ring_ms"][row["best"]]
    return row


def measure_k3(e: int, cap: int, n: int, k: int, seed: int = 0,
               full: bool = False) -> dict:
    """``full``: every row of every expert valid (the probe's masked row)
    instead of routed loads, and no ``expected_m``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = max(1, cap // TOP_K)
    masked_m = loads.routed_loads(e, tokens, TOP_K, g, dev)
    expected_m = None if full else -(-tokens * min(TOP_K, e) // e)
    if full:
        masked_m = torch.full((e,), cap, dtype=torch.int32, device=dev)
    a_q, a_s = quant.quantize_fp8_act(torch.randn(e, cap, k, generator=g,
                                                  device=dev))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=dev) / math.sqrt(k))
    b_kn, bs_view = b_q.transpose(1, 2).contiguous(), b_s.transpose(1, 2)
    tile = lambda: ggmod._launch(a_q, a_s, b_kn, bs_view, fp8mod._SHIFT,
                                 masked_m, False, torch.bfloat16)
    want = tile()
    rows = masked_m.tolist()
    row = {"kernel": "K3", "e": e, "cap": cap, "n": n, "k": k,
           "valid_rows": sum(rows), "max_rows": max(rows), "full": full,
           "expected_m": expected_m, "ring_ms": {},
           "plan": analytic.masked_ring_tile(cap, expected_m),
           "tile_ms": timing.cold_ms(tile)}
    for t, (bm, bn) in enumerate(fp8mod.RING_TILES):
        if n % bn:
            continue
        plan = ("ring", t)
        run = lambda: ggmod._launch(a_q, a_s, b_q, bs_view, fp8mod._SHIFT,
                                    masked_m, True, torch.bfloat16, plan=plan)
        got = run()
        torch.cuda.synchronize()
        for ei, r in enumerate(rows):
            if not torch.equal(got[ei, :r], want[ei, :r]):
                raise RuntimeError(
                    f"K3 E={e} cap={cap} n={n} k={k}: ring tile {bm}x{bn} "
                    f"differs from the tile route at expert {ei}")
            if r < cap and not bool(
                    (got[ei, math.ceil(r / bm) * bm:] == 0).all()):
                raise RuntimeError(f"K3 ring tile {bm}x{bn}: a tile past "
                                   f"masked_m is not zero (expert {ei})")
        row["ring_ms"][f"{bm}x{bn}"] = timing.cold_ms(run)
    row["best"] = min(row["ring_ms"], key=row["ring_ms"].get)
    row["best_ms"] = row["ring_ms"][row["best"]]
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k1", nargs="*", default=list(K1), help="MxNxK")
    parser.add_argument("--k3", nargs="*", default=list(K3),
                        help="ExCAPxNxK, or ExCAPxNxKxfull for every row "
                             "valid")
    parser.add_argument("--splits", type=int, nargs="+",
                        default=list(SPLITS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ring_sweep: CUDA is not available (it times "
                           "kernels on the card)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia-smi": smi}), flush=True)
    for shape in args.k1:
        m, n, k = (int(x) for x in shape.split("x"))
        print(json.dumps(measure_k1(m, n, k, args.splits)), flush=True)
    for shape in args.k3:
        dims = shape.split("x")
        e, cap, n, k = (int(x) for x in dims[:4])
        print(json.dumps(measure_k3(e, cap, n, k, full=dims[4:] == ["full"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
