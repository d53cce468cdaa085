"""Structured logging + lightweight metrics.

Port of ``deepgemm_ascend_tpu/utils/logging.py`` (pure Python, copied). The
JAX package bumps its ``attention.*_trace`` counters once per trace; the
port runs eagerly, so the same names count calls.

Upgrades the reference's ad-hoc ``[DGA] [ERROR]`` stderr prints
(``exception.hpp:35-43``, ``catlass_dynamic_matmul_tiling.cpp:44``) to a
stdlib logger with a stable prefix, plus a process-local counter registry
(the reference had "no metrics registry, no structured logging" —
SURVEY.md §5).

:func:`span` names a stretch of the host's work in a running
``torch.profiler`` trace, on the profiler's own clock, beside the card's
kernels and copies; with no profiler running it costs one check.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from typing import Dict

import torch

_LOGGER_NAME = "dga_tpu"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[DGA-TPU] [%(levelname)s] %(asctime)s %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("DGA_LOG_LEVEL", "WARNING").upper())
        logger.propagate = False
    return logger


class Metrics:
    """Thread-safe counters/gauges for engine & tiling observability."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    @contextlib.contextmanager
    def timer(self, name: str):
        """Adds the host seconds of the ``with`` body to the counter
        ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.inc(name, time.perf_counter() - t0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


metrics = Metrics()


_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    torch profiler runs (it lands in the trace as a ``user_annotation``
    event); otherwise a shared no-op. Names begin with ``engine.`` or
    ``model.``."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN

