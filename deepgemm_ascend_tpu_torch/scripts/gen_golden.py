"""Generate GEMM golden data files.

Port of ``scripts/gen_golden.py`` (≙ the reference's ``gen_golden.py``:
CLI M N K → ``input/x1_gm.bin``, ``input/x2_gm.bin``,
``output/golden.bin``): inputs in the chosen dtype, golden = the float64
product of the *rounded* inputs, stored f32. bf16 inputs are rounded with
torch (round to nearest even, as the JAX script's cast) and stored as f32,
since numpy has no bf16; every file is byte-equal to the JAX script's.

    python -m deepgemm_ascend_tpu_torch.scripts.gen_golden 2048 2048 2048 \\
        --dtype bfloat16 --out-dir golden/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils import golden


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("m", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("k", type=int)
    ap.add_argument("--dtype", default="float16",
                    choices=["float16", "bfloat16", "float32"])
    ap.add_argument("--heavy-tail", action="store_true",
                    help="lognormal inputs (device-test style) instead of "
                         "uniform [1,10)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)

    if args.dtype == "bfloat16":
        def cast(x):
            return torch.from_numpy(x).to(torch.bfloat16).to(
                torch.float32).numpy()
        store_dtype = np.float32
    else:
        dt = np.dtype(args.dtype)
        cast = lambda x: x.astype(dt)
        store_dtype = dt

    gen = golden.gen_heavy_tail if args.heavy_tail else golden.gen_uniform
    a = cast(gen((args.m, args.k), seed=args.seed))
    b = cast(gen((args.k, args.n), seed=args.seed + 1))
    gold = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)

    os.makedirs(os.path.join(args.out_dir, "input"), exist_ok=True)
    os.makedirs(os.path.join(args.out_dir, "output"), exist_ok=True)
    a.astype(store_dtype).tofile(os.path.join(args.out_dir, "input",
                                              "x1_gm.bin"))
    b.astype(store_dtype).tofile(os.path.join(args.out_dir, "input",
                                              "x2_gm.bin"))
    gold.tofile(os.path.join(args.out_dir, "output", "golden.bin"))
    print(f"wrote input/x1_gm.bin ({a.nbytes}B) input/x2_gm.bin ({b.nbytes}B) "
          f"output/golden.bin ({gold.nbytes}B)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
