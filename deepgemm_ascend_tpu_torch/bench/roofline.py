"""Roofline accounting for GEMM benchmarks, against the H100's envelope.

Port of ``deepgemm_ascend_tpu/bench/roofline.py``: the same formula (2mnk
operations; each operand and the output touched once) over torch dtypes,
priced by ``tiling/platform.py`` (:data:`HBM_BYTES_PER_S`,
:func:`peak_ops`). :func:`bound_ms` is the same max(bytes, operations)
bound for any kernel whose bytes and operations the caller counts.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..tiling import platform as plat


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: int
    bytes: int
    peak_flops: float
    peak_bytes_per_s: float

    @property
    def compute_bound_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_bound_s(self) -> float:
        return self.bytes / self.peak_bytes_per_s

    @property
    def light_speed_s(self) -> float:
        return max(self.compute_bound_s, self.memory_bound_s)

    def fraction(self, measured_s: float) -> float:
        """Fraction of the roofline achieved (1.0 = speed of light)."""
        return self.light_speed_s / max(measured_s, 1e-12)


def gemm_roofline(m: int, n: int, k: int, in_dtype, out_dtype) -> Roofline:
    """The roofline of an (m, k)·(k, n) product with ``in_dtype`` operands
    and an ``out_dtype`` output (torch dtypes)."""
    flops = 2 * m * n * k
    # Minimal traffic: each operand + output touched once.
    nbytes = m * k * in_dtype.itemsize + k * n * in_dtype.itemsize \
        + m * n * out_dtype.itemsize
    return Roofline(flops, nbytes, plat.peak_ops(in_dtype),
                    plat.HBM_BYTES_PER_S)


def bound_ms(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """(ms, what bounds it): the least time for ``nbytes`` of device memory
    traffic and ``ops`` operations at ``peak`` operations per second — the
    larger of the two times, and "bytes" or "operations"."""
    t_bytes, t_ops = nbytes / plat.HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
