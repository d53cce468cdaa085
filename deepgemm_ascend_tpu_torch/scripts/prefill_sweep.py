"""Time K4, the causal flash prefill, in each of its design variants on the card.

K4 (``csrc/flash_prefill.cu``) takes three design constants, each a
``-D`` define that the package leaves at its default: the query rows a
block (``DGA_K4_WARPS``: 12 warps, three warpgroups, 192 rows, as the
package builds it; 8, 128 rows; 4, 64 rows), the int8 TMA stages in
flight (``DGA_K4_STAGES``) and the launch order (``DGA_K4_HEAVY_FIRST``:
the q blocks with the most keys first, or q order). This script builds
``csrc/flash_prefill.cu`` once for each variant (one ``nvcc`` each, all started together), runs
each through the package's K4 wrapper (its C entry swapped for the
variant's) at the shapes that matter, and times it cold
(``bench.timing.cold_ms``: L2 flushed, median of 10):

  phase2-start0, phase2-start1000  chip_smoke.py phase 2's rows: b=4 s=512
      over a 4096-key cache, V2_LITE's 4 kv heads of group 4;
  bucket1024  phase 4's largest prefill bucket: b=8 s=1024, the 1024-bucket
      prompts of its draw and a padding row of length 1;
  cp16384  phase 6's prompt: b=1, 16384 tokens, one K4 over the whole cache.

Every variant must equal the package's own K4 bit for bit (each row's
arithmetic does not depend on the variant), and the package's K4 its plain
version within 2e-3 and ``flash_common.output_close`` (but at cp16384,
whose plain scores would take 17 GB). One JSON line per shape, with its
bound (``bench.roofline.bound_ms``) and each variant's ms. The card only.

    python -m deepgemm_ascend_tpu_torch.scripts.prefill_sweep \\
        [--shapes phase2-start0 cp16384 ...] \\
        [--variants 192x2:heavy 128x3:q ...]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..bench import timing
from ..bench.roofline import bound_ms
from ..ops import _kernels
from ..ops import flash_prefill as fpmod
from ..ops.flash_common import output_close
from ..tiling.platform import BF16_OPS_PER_S

# (b, kvh, g, s, S, starts, lengths) of each shape.
SHAPES = {
    "phase2-start0": (4, 4, 4, 512, 4096, [0] * 4, [512] * 4),
    "phase2-start1000": (4, 4, 4, 512, 4096, [1000] * 4, [1512] * 4),
    "bucket1024": (8, 4, 4, 1024, 4096, [0] * 8,
                   [861, 837, 621, 836, 751, 1017, 904, 1]),
    "cp16384": (1, 4, 4, 16384, 16384, [0], [16384]),
}
# ROWSxSTAGES:ORDER; the package builds 192x2:heavy.
VARIANTS = ("192x2:heavy", "192x2:q", "192x3:heavy", "128x2:heavy",
            "128x2:q", "64x2:heavy")
PLAIN_SHAPES = ("phase2-start0", "phase2-start1000", "bucket1024")
ATTN_TOL = 2e-3


def defines(variant: str) -> list:
    """The -D flags of one variant."""
    dims, order = variant.split(":")
    rows, stages = (int(x) for x in dims.split("x"))
    if rows not in (64, 128, 192) or order not in ("heavy", "q"):
        raise ValueError(f"variant {variant}: rows 64, 128 or 192, order "
                         f"heavy or q")
    return [f"-DDGA_K4_WARPS={rows // 16}", f"-DDGA_K4_STAGES={stages}",
            f"-DDGA_K4_HEAVY_FIRST={int(order == 'heavy')}"]


def build_variants(variants, out: Path) -> dict:
    """The K4 C entry of every variant, built from ``csrc/flash_prefill.cu``
    into ``out``, each from a copy under a name of its own (nvcc names a
    file's anonymous namespace after its path: from one path, a variant's
    kernels, and ``sm90::launch``'s once-per-instance static, would be the
    package's own). Also returns each build's registers and spills."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        so = out / f"libflash_prefill_v{i}.so"
        src = out / f"flash_prefill_v{i}.cu"
        src.write_bytes((_kernels.CSRC / "flash_prefill.cu").read_bytes())
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
               str(_kernels.CSRC), *defines(v), "-o", str(so), str(src)]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    entries, ptxas = {}, {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {v}: nvcc rc {proc.returncode}\n{log}")
        ptxas[v] = sorted({ln.rsplit(":", 1)[-1].strip() for ln in
                           log.splitlines() if "registers" in ln
                           or "spill" in ln})
        fn = ctypes.CDLL(str(so)).dga_flash_prefill
        fn.argtypes = _kernels.KERNELS["flash_prefill"][2]
        fn.restype = ctypes.c_int
        entries[v] = fn
    return entries, ptxas


@contextlib.contextmanager
def k4_entry(fn):
    """The K4 wrapper launches ``fn`` instead of the package's entry."""
    real = _kernels.entry
    _kernels.entry = lambda name: fn if name == "flash_prefill" \
        else real(name)
    try:
        yield
    finally:
        _kernels.entry = real


def k4_bound(b, kvh, g, s, s_max, starts, lens, hd=128, stats=False):
    """K4's least time on the card for these inputs: q read, the keys its
    rows need read once, the f32 output (K4-stats: also m and l) written
    (bytes); 4·hd operations a (query row, visible key) (operations, at
    the bf16 peak)."""
    keys = rows_read = 0
    for st, ln in zip(starts, lens):
        limit = min(ln, s_max)
        keys += sum(max(0, min(st + i + 1, limit)) for i in range(s))
        rows_read += max(0, min(limit, st + s))
    nbytes = (b * s * kvh * g * (hd * (2 + 4) + (8 if stats else 0))
              + kvh * rows_read * (2 * hd + 8))
    return bound_ms(nbytes, 4.0 * kvh * g * hd * keys, BF16_OPS_PER_S)


def measure(name: str, entries: dict, seed: int = 0) -> dict:
    b, kvh, g, s, s_max, starts, lens = SHAPES[name]
    dev = torch.device("cuda")
    hd = 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = [torch.randint(-127, 128, (b, kvh, s_max, hd), generator=gen,
                           device=dev, dtype=torch.int8),
             torch.rand(b, kvh, s_max, generator=gen, device=dev) * 0.02
             + 1e-3,
             torch.randint(-127, 128, (b, kvh, s_max, hd), generator=gen,
                           device=dev, dtype=torch.int8),
             torch.rand(b, kvh, s_max, generator=gen, device=dev) * 0.02
             + 1e-3]
    q = torch.randn(b, s, kvh * g, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    run = lambda: fpmod.flash_prefill_gqa(q, *cache, st, ln)
    want = run()
    row = {"shape": name, "b": b, "kvh": kvh, "g": g, "s": s, "S": s_max,
           "starts": sorted(set(starts)), "lens": lens}
    if name in PLAIN_SHAPES:
        qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
        rows = lambda x: x.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd)
        ref = rows(fpmod.flash_prefill_plain(qg, *cache, st, ln))
        pv = rows(fpmod.flash_prefill_plain(
            qg, cache[0], cache[1], cache[2].float().abs(), cache[3], st, ln))
        torch.cuda.synchronize()
        err = float((want - ref).abs().max())
        if not (err < ATTN_TOL and output_close(want, ref, pv)):
            raise RuntimeError(f"{name}: K4 disagrees with its plain version "
                               f"(err {err:.3g})")
        row["max_abs_err_vs_plain"] = err
        del ref, pv
    row["bound_ms"], row["bound_by"] = k4_bound(b, kvh, g, s, s_max, starts,
                                                lens)
    row["package_ms"] = timing.cold_ms(run)
    row["variant_ms"] = {}
    for v, fn in entries.items():
        with k4_entry(fn):
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name}: variant {v} differs from the "
                                   f"package's K4")
            row["variant_ms"][v] = timing.cold_ms(run)
    row["best"] = min(row["variant_ms"], key=row["variant_ms"].get)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES),
                        choices=list(SHAPES))
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS),
                        help="ROWSxSTAGES:ORDER (rows 64, 128 or 192, "
                             "order heavy or q)")
    args = parser.parse_args(argv)
    for v in args.variants:
        defines(v)
    if not torch.cuda.is_available():
        raise RuntimeError("prefill_sweep: CUDA is not available (it builds "
                           "and times kernels on the card)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    entries, ptxas = build_variants(
        args.variants, _kernels.BUILD_ROOT / "prefill_sweep"
        / _kernels._source_hash())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia-smi": smi, "ptxas": ptxas}), flush=True)
    for name in args.shapes:
        print(json.dumps(measure(name, entries)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
