"""Compare two checkouts' kernels on one card: chip_smoke.py phase 2, in turns.

Each ``--run TREE:LABEL`` runs, in a process of its own and in the order
given, phases 1 and 2 of the ``chip_smoke.py`` at the root of checkout
``TREE`` (that checkout's package and kernels, built into its own
``_build/``), and writes its phase-2 rows to ``OUT/phase2_<LABEL>.json``.
Every run is timed with this checkout's ``bench.timing.cold_ms``, put in
place of the one that checkout's ``chip_smoke.py`` imported, so that two
commits are measured by one timer. Give the runs alternately (parent,
change, change, parent): two commits are compared only inside one call, on
one card. ``--serving`` also runs that checkout's serving phase (phase 4:
fp8 experts, then int8) after phase 2 and keeps each run's profiled decode
step (device and wall ms, launches), launch counts and profiled prefill
forward of the 1024 bucket (``bench.prefill_profile``: this checkout's,
for a tree from before it). The card only. Each run also keeps the
sha256 of K2's output and updated caches on fixed inputs (``k2_digests``:
V2_LITE's decode row and phase 4's lengths, through that checkout's
package), so that the summary shows whether the two commits' K2 give the
same bits.

After the runs (or, given no ``--run``, alone) it prints the summary of
``OUT``'s files: runs whose labels differ only in their trailing digits
form one side (parent1 and parent2: "parent"); each phase-2 row that
every side ran, with each side's mean ms, the ratio of the last side to
the first (``parent`` first where there is one) and the plans of the
last; then each side's profiled decode steps, with the device ms per step
of the port's own kernels among the profile's top 12, and its profiled
prefill forwards (wall, device and K4 ms).

    python -m deepgemm_ascend_tpu_torch.scripts.phase2_ab --out OUT \\
        [--serving] --run ../parent:parent1 --run .:change1 \\
        --run .:change2 --run ../parent:parent2
    python -m deepgemm_ascend_tpu_torch.scripts.phase2_ab --out OUT
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_BENCH = Path(__file__).resolve().parents[1] / "bench"
_TIMING = _BENCH / "timing.py"


def _load(path: Path, name: str):
    """A module of this checkout, loaded by path (beside another
    checkout's package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _child(tree: str, label: str, out: str, serving: bool) -> None:
    """Phases 1-2 (and 4 if ``serving``) of ``tree``'s chip_smoke.py with
    this checkout's timer."""
    timing = _load(_TIMING, "phase2_ab_timing")
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import chip_smoke
    chip_smoke.cold_ms = timing.cold_ms
    prefills = []
    if serving and not hasattr(chip_smoke, "_profile_prefill_forward"):
        # A tree from before the prefill profile: this checkout's, run on
        # that tree's engine right after its decode step's.
        profiler = _load(_BENCH / "prefill_profile.py",
                         "phase2_ab_prefill_profile")
        decode_step = chip_smoke._profile_decode_step

        def both(eng):
            out = decode_step(eng)
            prefills.append(profiler.profile_bucket(eng, 1024))
            return out
        chip_smoke._profile_decode_step = both
    t0 = time.perf_counter()
    device = chip_smoke.phase_device()
    checks = chip_smoke.phase_kernels()["checks"]
    runs = [chip_smoke.phase_serving(device, experts)
            for experts in ("fp8", "int8")] if serving else []
    for run, prefill in zip(runs, prefills):
        run["prefill_profile"] = prefill
    with open(os.path.join(out, f"phase2_{label}.json"), "w") as f:
        json.dump({"label": label, "tree": tree, "device": device,
                   "checks": checks, "serving": runs,
                   "k2_digests": _k2_digests(),
                   "seconds": time.perf_counter() - t0}, f, default=str)


def _k2_digests() -> dict:
    """sha256 (16 hex digits) of K2's output and the four caches it
    updates, on inputs made from seed 7 on the card: V2_LITE's decode row
    (16 sequences of 1..4096 keys, 4 kv heads, group 4) and phase 4's
    lengths (16..1056), through the package this process imported."""
    import hashlib

    import numpy as np
    import torch

    from deepgemm_ascend_tpu_torch.ops import flash_decode as fd
    b, kvh, g, s_max, hd = 16, 4, 4, 4096, 128
    digests = {}
    for label, (lo, hi) in (("v2_lite", (1, s_max)), ("serving", (16, 1056))):
        gen = torch.Generator(device="cuda").manual_seed(7)
        ints = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                            device="cuda", dtype=torch.int8)
        scales = lambda *shape: torch.rand(*shape, generator=gen,
                                           device="cuda") * 0.02 + 1e-3
        cache = (ints(b, kvh, s_max, hd), scales(b, kvh, s_max),
                 ints(b, kvh, s_max, hd), scales(b, kvh, s_max))
        q = torch.randn(b, kvh * g, hd, generator=gen, device="cuda").to(
            torch.bfloat16)
        new = (ints(b, kvh, hd), ints(b, kvh, hd), scales(b, kvh),
               scales(b, kvh))
        lens = np.random.default_rng(7).integers(lo, hi, endpoint=True,
                                                 size=b)
        out = fd.flash_decode_gqa_inplace(
            q, *cache, *new, torch.from_numpy(lens.astype(np.int32)).cuda())
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        digests[label] = h.hexdigest()[:16]
    return digests


def _side(label: str) -> str:
    return label.rstrip("0123456789") or label


def _own_kernel(name: str) -> str:
    """The function name of one of the port's kernels in a profile, or ''
    for PyTorch's own (``at::``) and library kernels."""
    if "at::" in name[:40] or "(anonymous namespace)" not in name:
        return ""
    head = name.removeprefix("void ").replace("(anonymous namespace)", "_")
    return head.split("<", 1)[0].split("(", 1)[0].rsplit("::", 1)[-1]


def summary(out: str) -> list:
    """The lines of the summary of ``out``'s phase2_<label>.json files."""
    runs = {}
    for path in sorted(Path(out).glob("phase2_*.json")):
        with open(path) as f:
            d = json.load(f)
        runs.setdefault(_side(d["label"]), []).append(d)
    sides = sorted(runs, key=lambda side: side != "parent")
    lines = ["sides: " + ", ".join(
        f"{s} ({', '.join(d['label'] for d in runs[s])})" for s in sides)]
    rows = {}
    for side in sides:
        for d in runs[side]:
            for name, checks in d["checks"].items():
                for r in checks:
                    rows.setdefault((name, r["shape"]), {}).setdefault(
                        side, []).append(r)
    digests = {d["label"]: d.get("k2_digests") for side in sides
               for d in runs[side]}
    if all(digests.values()):
        same = len({json.dumps(v, sort_keys=True)
                    for v in digests.values()}) == 1
        lines.append(f"K2 digests {'equal' if same else 'DIFFER'}: "
                     f"{digests}")
    for (name, shape), by_side in rows.items():
        if len(by_side) < len(sides):
            continue
        means = {s: sum(r["ms"] for r in by_side[s]) / len(by_side[s])
                 for s in sides}
        plans = sorted({str(r.get("route", "")) for r in by_side[sides[-1]]})
        ratio = (means[sides[-1]] / means[sides[0]] if means[sides[0]]
                 else float("nan"))
        lines.append(f"{name:24s} {shape:58s} "
                     + " ".join(f"{s} {means[s]:.4f}" for s in sides)
                     + f" ratio {ratio:.3f} {' '.join(p for p in plans if p)}")
    for side in sides:
        for d in runs[side]:
            for run in d.get("serving", []):
                prof = run["profile"]
                own = {}
                for k in prof.get("top", []):
                    fn = _own_kernel(k["kernel"])
                    if fn:
                        ms, n = own.get(fn, (0.0, 0))
                        own[fn] = (ms + k["ms"], n + k["count"])
                lines.append(
                    f"serving {run['run']:4s} {d['label']:10s} device_ms "
                    f"{prof['device_ms']:.3f} wall_ms {prof['wall_ms']:.2f} "
                    f"launches {prof['launches']} decode_tok_s "
                    f"{run['decode_tok_s']:.1f} plans {run.get('plans')} "
                    + " ".join(f"{fn} {ms:.3f} ms/{n}" for fn, (ms, n)
                               in sorted(own.items())))
        for d in runs[side]:
            for run in d.get("serving", []):
                pre = run.get("prefill_profile")
                if pre:
                    lines.append(
                        f"prefill {run['run']:4s} {d['label']:10s} bucket "
                        f"{pre['bucket']} wall_ms {pre['wall_ms']:.2f} "
                        f"unprofiled_wall_ms {pre['unprofiled_wall_ms']:.2f} "
                        f"device_ms {pre['device_ms']:.3f} k4_ms "
                        f"{pre['k4_ms']:.3f} k4_launches {pre['k4_launches']}"
                        f" prefill_tok_s {run.get('prefill_tok_s', 0):.1f}")
        steps = {}
        for d in runs[side]:
            for run in d.get("serving", []):
                steps.setdefault(run["run"], []).append(
                    run["profile"]["device_ms"])
        for experts, ms in steps.items():
            lines.append(f"serving {experts:4s} {side} mean device_ms "
                         f"{sum(ms) / len(ms):.3f}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run", action="append", default=[],
                        metavar="TREE:LABEL")
    parser.add_argument("--out", required=True, help="directory for the "
                        "phase2_<LABEL>.json files")
    parser.add_argument("--serving", action="store_true",
                        help="also run each checkout's serving phase")
    parser.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    out = os.path.abspath(args.out)
    if args.child:
        _child(*args.child, out, args.serving)
        return 0
    if not args.run:
        print("\n".join(summary(out)), flush=True)
        return 0
    os.makedirs(out, exist_ok=True)
    failed = []
    for run in args.run:
        tree, label = run.rsplit(":", 1)
        # By path, not with -m: the child must import no package before
        # the checkout's own.
        rc = subprocess.call([sys.executable, str(Path(__file__).resolve()),
                              "--run", run, "--out", out,
                              *(["--serving"] if args.serving else []),
                              "--child", tree, label])
        print(f"{label} ({tree}): rc {rc}", flush=True)
        if rc:
            failed.append(label)
    if not failed:
        print("\n".join(summary(out)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
