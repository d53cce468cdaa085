"""The readings that a cell's correctness limit is set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 --seconds 10 \
        [--control 3] [--faults control,altered_token --fault-seeds 7,8]

For each seed, in one process (kernels built and the card set up once):
a run's set-up and a window at the cell's own load, then the check's
sample judged by the configuration's reference in its stated precision
(the program's readings), and for the first ``--control`` seeds also by
the control, that reference in its ``CONTROL`` precision (int4 for fp8
and int8) in the program's place (its readings prefixed ``control_``).
One JSON line a seed. Then, for each of ``--faults`` and each of
``--fault-seeds``, a whole run (:func:`benchmark.run.run`) with that fault
planted (:mod:`benchmark.faults`; ``control`` puts the control in the
program's place in the run's own comparison): one JSON line each, with the
run's ``correct`` and the numbers it compared. The benchmark's own runs never
run the control or a fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
from pathlib import Path

from benchmark import check, faults, program, registry, run
from benchmark.run import end_to_end, log, serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = registry.load(Path(os.getcwd()), args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",") if s):
        t = time.perf_counter()
        rec = serve(cell, seed, args.seconds, False, device, t_setup0=t)
        e2e, info = end_to_end(rec)
        peak = torch.cuda.max_memory_allocated()
        picked = check.sample(rec.server.finished, seed)
        program.free(rec.engine)
        rec.engine = rec.server.engine = None
        torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        r = check.judge(cell.config, seed, device, picked, control=i < args.control)
        out = {"workload": args.workload, "seed": seed, **r, "failed": len(rec.server.failed),
               "reference_s": time.perf_counter() - t_ref, "setup_s": rec.setup_s,
               "memory_peak_bytes": peak, "window": info,
               **{k: v for k, v in e2e.items() if k != "setup_s"}}
        print(json.dumps(out), flush=True)
        del rec, picked
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for fault in (f for f in args.faults.split(",") if f):
        for seed in (int(s) for s in args.fault_seeds.split(",") if s):
            undo = None if fault == "control" else faults.PLANTS[fault]()
            lines = []
            try:
                rc = run.run(["--workload", args.workload, "--seed", str(seed),
                              "--seconds", str(args.seconds)],
                             judge_fn=faults.control_judge if fault == "control" else None,
                             emit=lines.append)
            finally:
                if undo is not None:
                    undo()
            res = json.loads(lines[-1]) if lines else {}
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "rc": rc, "correct": res.get("correct"),
                              "checks": res.get("checks")}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    log("done")


if __name__ == "__main__":
    main()
