"""Cross-check: the same GEMM through ``torch.matmul`` on the device.

Twin of ``scripts/xla_matmul.py``, under the reference's own name (≙ its
``scripts/torch_matmul.py``: ``torch.matmul`` as an independent
calibration baseline). Reads the bins ``gen_golden`` wrote, multiplies the
inputs upcast to f32 (exact products of 16-bit inputs, f32 sums; TF32
off) and writes ``output/torch_out.bin`` (f32), for ``verify_output``.
A yardstick beside the kernels, never on their path.

    python -m deepgemm_ascend_tpu_torch.scripts.torch_matmul 2048 2048 2048 \\
        --dtype float16 --dir golden/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils.common import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("m", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("k", type=int)
    ap.add_argument("--dtype", default="float16",
                    help="the stored inputs' dtype (bf16 inputs are stored "
                         "as float32)")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def load(name, shape):
        x = np.fromfile(os.path.join(args.dir, "input", name),
                        dtype=np.dtype(args.dtype)).reshape(shape)
        return torch.from_numpy(x).to(dev, torch.float32)

    a = load("x1_gm.bin", (args.m, args.k))
    b = load("x2_gm.bin", (args.k, args.n))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    out.cpu().numpy().tofile(os.path.join(args.dir, "output",
                                          "torch_out.bin"))
    print(f"wrote output/torch_out.bin ({args.m}x{args.n} f32)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
