"""The port's measurement layer: rooflines, shape suites, record screening
and timers (port of ``deepgemm_ascend_tpu/bench/``, with its exports)."""

from . import roofline, shapes, timing
from .roofline import Roofline, gemm_roofline
from .timing import Timing, time_fn, time_gemm_like

__all__ = ["roofline", "shapes", "timing", "Roofline", "gemm_roofline",
           "Timing", "time_fn", "time_gemm_like"]
