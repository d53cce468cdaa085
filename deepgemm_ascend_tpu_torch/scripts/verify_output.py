"""Verify a GEMM output file against a golden file.

Port of ``scripts/verify_output.py`` (≙ the reference's ``verify.py``):
length check, bounded diff dump, outlier-ratio acceptance (at most
``--max-ratio`` of the elements outside rtol/atol). Exit code 0 on PASS,
1 on FAIL, 2 on a size mismatch, with the JAX script's lines.

    python -m deepgemm_ascend_tpu_torch.scripts.verify_output \\
        output/out.bin output/golden.bin
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils import verify


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("output_bin")
    ap.add_argument("golden_bin")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--rtol", type=float, default=verify.DEFAULT_RTOL)
    ap.add_argument("--atol", type=float, default=verify.DEFAULT_ATOL)
    ap.add_argument("--max-ratio", type=float,
                    default=verify.DEFAULT_MAX_RATIO)
    ap.add_argument("--print-diffs", type=int, default=10)
    args = ap.parse_args(argv)

    out = np.fromfile(args.output_bin, dtype=np.dtype(args.dtype))
    gold = np.fromfile(args.golden_bin, dtype=np.float32)
    if out.size != gold.size:
        print(f"[DGA-TPU] size mismatch: output {out.size} vs golden "
              f"{gold.size}")
        return 2
    res = verify.verify(out, gold, rtol=args.rtol, atol=args.atol,
                        max_ratio=args.max_ratio, name=args.output_bin,
                        print_diffs=args.print_diffs)
    status = "PASS" if res.ok else "FAIL"
    print(f"[DGA-TPU] {status}: mismatch_ratio={res.mismatch_ratio:.3e} "
          f"({res.num_mismatched}/{res.num_total}), "
          f"max_abs={res.max_abs_err:.4g} max_rel={res.max_rel_err:.4g}")
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
