"""Physical-plausibility screening for sweep records, against the H100.

Port of ``deepgemm_ascend_tpu/bench/records.py``: the same rules, priced by
this card's envelope (``tiling/platform.py``) instead of a TPU's. A record
is a dict with ``op``, ``m``, ``n``, ``k``, ``time_s`` and, for grouped
sweeps, E-scaled ``tflops``; a record that claims a time below its shape's
light speed cannot be real, and :func:`plausible` rejects it before any
argmin could crown it. On the TPU the screen guarded a timing method that
subtracted a measured RPC floor; the port's timer subtracts nothing
(``bench/timing.py``), but a sweep's records are screened all the same.

The rates differ from the JAX package's in one place by design: fp8 is
priced at the H100's fp8 rate, not at the bf16 rate
(:func:`tiling.platform.peak_ops`).
"""

from __future__ import annotations

import torch

from . import roofline as _roofline
from ..tiling import platform as _plat

_FP8 = torch.float8_e4m3fn
# op → (in_dtype, out_dtype) — sweep records don't carry dtypes; the op
# determines them (mirrors the selector's cache keying).
OP_DTYPES = {
    "fp8_gemm": (_FP8, torch.bfloat16),
    "fp8_gemm_nt": (_FP8, torch.bfloat16),
    "gemm": (torch.bfloat16, torch.float32),
    "gemm_nt": (torch.bfloat16, torch.float32),
    "gemm_tn": (torch.bfloat16, torch.float32),
    "gemm_tt": (torch.bfloat16, torch.float32),
    "int8_gemm": (torch.int8, torch.bfloat16),
    "int8_grouped_gemm": (torch.int8, torch.bfloat16),
    "int8_grouped_gemm_masked": (torch.int8, torch.bfloat16),
    "grouped_gemm": (_FP8, torch.bfloat16),
    "grouped_gemm_nt": (_FP8, torch.bfloat16),
    "grouped_gemm_masked": (_FP8, torch.bfloat16),
    "grouped_gemm_masked_nt": (_FP8, torch.bfloat16),
    "grouped_masked": (_FP8, torch.bfloat16),  # legacy op key
}

# Tolerance on the roofline fraction: a real record tops out just under
# 1.0; the margin absorbs rounding in the data-sheet constants.
DEFAULT_TOL = 1.05


def is_xla(config: dict) -> bool:
    """True iff a sweep-record config dict is the XLA kernel family
    (``config.KernelType.XLA``), whose block fields mean nothing."""
    from ..config import KernelType
    return config.get("kernel_type", 1) == int(KernelType.XLA)


def flops_scale(r: dict) -> float:
    """Expert count E for grouped records, 1.0 for dense.

    Grouped sweeps store per-expert (m, n, k) but E-scaled tflops, so
    E = tflops · t / (2·m·n·k) exactly (both written by the same process).
    """
    t, tf = r.get("time_s", 0.0), r.get("tflops", 0.0)
    if t <= 0 or not tf:
        return 1.0
    return max(1.0, round(tf * 1e12 * t / (2.0 * r["m"] * r["n"] * r["k"])))


def light_speed_floor_s(op: str, m: int, n: int, k: int,
                        in_dtype, out_dtype, scale: float) -> float:
    """A physical lower bound on the runtime of one sweep record.

    Dense: ``scale`` = 1 → the plain max(compute, memory) roofline.
    Grouped CONTIGUOUS: ``scale`` counts m-tiles, which can exceed the
    expert count, and only experts carry distinct B panels; so compute and
    the A/out traffic scale by ``scale`` and the B panel counts ONCE (a
    bound valid for any expert count). Grouped MASKED: ``scale`` = E
    exactly, and the kernel streams E distinct B panels, each counted.
    """
    rl = _roofline.gemm_roofline(m, n, k, in_dtype, out_dtype)
    if scale <= 1 or "grouped" not in op:   # int8_grouped_* counts too
        return rl.light_speed_s * scale
    isz, osz = in_dtype.itemsize, out_dtype.itemsize
    comp = rl.compute_bound_s * scale
    b_panels = scale if "masked" in op else 1.0
    bytes_lb = (scale * (m * k * isz + m * n * osz)
                + b_panels * k * n * isz)
    return max(comp, bytes_lb / _plat.HBM_BYTES_PER_S)


def roofline_fraction(r: dict) -> float:
    """floor_s / measured_s for one record (>1 ⇒ faster than light)."""
    op = r.get("op", "gemm")
    in_dt, out_dt = OP_DTYPES.get(op, (torch.bfloat16, torch.float32))
    floor = light_speed_floor_s(op, r["m"], r["n"], r["k"], in_dt, out_dt,
                                flops_scale(r))
    return floor / max(r["time_s"], 1e-12)


def plausible(r: dict, tol: float = DEFAULT_TOL) -> bool:
    """True iff the record's time is physically achievable for its shape."""
    if r.get("time_s", -1.0) <= 0:
        return False
    if r.get("op", "gemm") not in OP_DTYPES:
        return True  # unknown op: cannot score, do not silently drop
    return roofline_fraction(r) <= tol
