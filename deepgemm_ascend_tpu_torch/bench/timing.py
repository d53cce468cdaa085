"""Kernel timing on the card: warm back-to-back chains and cold launches.

Port of ``deepgemm_ascend_tpu/bench/timing.py``. Two timers, for two
questions:

* :func:`time_fn` / :func:`time_gemm_like` — *warm, back to back*: the
  per-call time of ``iters`` calls issued one after another, as the JAX
  scripts measured (``scripts/``, ``bench.py`` → ``scripts/headline.py``).
  Inputs stay in L2 where they fit; between calls the card waits only for
  the host. This is what the measurement scripts report.
* :func:`cold_ms` — *cold, per launch*: the median of single launches,
  each after a 256 MB write that flushes the 50 MB L2, as a caller that
  touches its operands once finds them. This is what ``chip_smoke.py``'s
  kernel table reports. The timed calls queue up behind a spin kernel, so
  the card runs them back to back whatever their host cost: the events
  time the device alone.

The JAX timer works around a TPU runtime that acknowledged
``block_until_ready`` before the device finished: it chained ``iters``
calls through a ``lax.scan`` with a scalar readback and subtracted a
measured RPC floor (``timing.py:40-148``). None of that is carried over.
On the card, kernels launched on one stream run in order, so one pair of
CUDA events around ``iters`` plain calls, then ``synchronize()``, times
them; nothing is chained and no floor is subtracted
(:attr:`Timing.rpc_floor_seconds` is 0.0). On a CPU tensor (the tests)
the same structure runs on ``time.perf_counter``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Sequence

import torch

# cold_ms's flush: 256 MB of int32, five times the H100's 50 MB L2.
_FLUSH_INT32 = 64 * 2 ** 20
# cold_ms's hold: a spin of 4e7 SM cycles (~20 ms at the H100's clocks),
# during which the host queues every timed call.
_HOLD_CYCLES = 40_000_000


@dataclasses.dataclass(frozen=True)
class Timing:
    seconds: float          # per-call time, best of the repeats
    total_seconds: float    # the best repeat's whole chain
    rpc_floor_seconds: float
    iters: int

    def tflops(self, flops: float) -> float:
        return flops / self.seconds / 1e12 if self.seconds > 0 else float("inf")

    def gbps(self, nbytes: float) -> float:
        return nbytes / self.seconds / 1e9 if self.seconds > 0 else float("inf")


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(args) -> torch.device:
    """The device of the first tensor among ``args``; the CPU if there is
    none."""
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


def _chain_seconds(fn: Callable, args: Sequence, n: int, cuda: bool) -> float:
    """Seconds for ``n`` back-to-back calls of ``fn(*args)``: between CUDA
    events then ``synchronize()`` on the card, on the host clock on the
    CPU."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return time.perf_counter() - t0


def time_fn(
    fn: Callable,
    args: Sequence,
    iters: int = 32,
    repeats: int = 3,
    min_chain_seconds: float = 0.0,
    max_iters: int = 65536,
    device=None,
) -> Timing:
    """Time ``fn(*args)`` per call, warm and back to back.

    One warm-up call, then, while a chain of ``iters`` calls lasts less
    than ``min_chain_seconds`` (and ``iters < max_iters``), ``iters`` grows
    in proportion and the chain is timed again (at most four times); then
    the best of ``repeats`` chains, divided by ``iters``. The device is
    ``device`` or that of the first tensor among ``args``: CUDA events on
    the card, the host clock on the CPU.
    """
    dev = torch.device(device) if device is not None else _device_of(args)
    cuda = dev.type == "cuda"
    fn(*args)
    synchronize(dev)
    for _ in range(4):
        if not (min_chain_seconds > 0 and iters < max_iters):
            break
        chain = _chain_seconds(fn, args, iters, cuda)
        if chain >= min_chain_seconds:
            break
        scale = min_chain_seconds / max(chain, 1e-9)
        iters = int(min(max_iters, max(iters + 1, iters * scale)))
    best = min(_chain_seconds(fn, args, iters, cuda) for _ in range(repeats))
    return Timing(seconds=max(best / iters, 1e-12), total_seconds=best,
                  rpc_floor_seconds=0.0, iters=iters)


def time_gemm_like(fn: Callable, *args, **kw) -> Timing:
    """The JAX package's name for ``time_fn(fn, args, **kw)``. (The JAX
    version chains a scalar tap of each output into the next call; calls
    on one stream need no chain.)"""
    return time_fn(fn, args, **kw)


def cold_ms(fn: Callable, reps: int = 10, warmup: int = 2) -> float:
    """Median device time in ms of one call of ``fn()``, the L2 cache
    flushed by a 256 MB write before every timed launch (CUDA events; the
    card only).

    The reps are queued behind a ~20 ms spin kernel (``torch.cuda._sleep``)
    so that the card reaches them only once the host has queued them all:
    a call whose host side outlasts the flush (a wrapper with several
    launches, such as K11's kernel and sum) would otherwise leave the card
    idle between its events, and the idle time would be counted. A call
    that synchronizes inside is still timed with its host wait."""
    flush = torch.empty(_FLUSH_INT32, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(_HOLD_CYCLES)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
