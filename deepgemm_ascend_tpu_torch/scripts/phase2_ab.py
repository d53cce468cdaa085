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
step (device and wall ms, launches) and launch counts. The card only.

    python -m deepgemm_ascend_tpu_torch.scripts.phase2_ab --out OUT \\
        [--serving] --run ../parent:parent1 --run .:change1 \\
        --run .:change2 --run ../parent:parent2
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

_TIMING = Path(__file__).resolve().parents[1] / "bench" / "timing.py"


def _child(tree: str, label: str, out: str, serving: bool) -> None:
    """Phases 1-2 (and 4 if ``serving``) of ``tree``'s chip_smoke.py with
    this checkout's timer."""
    spec = importlib.util.spec_from_file_location("phase2_ab_timing", _TIMING)
    timing = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = timing
    spec.loader.exec_module(timing)
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(tree)
    import chip_smoke
    chip_smoke.cold_ms = timing.cold_ms
    t0 = time.perf_counter()
    device = chip_smoke.phase_device()
    checks = chip_smoke.phase_kernels()["checks"]
    runs = [chip_smoke.phase_serving(device, experts)
            for experts in ("fp8", "int8")] if serving else []
    with open(os.path.join(out, f"phase2_{label}.json"), "w") as f:
        json.dump({"label": label, "tree": tree, "device": device,
                   "checks": checks, "serving": runs,
                   "seconds": time.perf_counter() - t0}, f, default=str)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run", action="append", required=True,
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
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
