"""One batched prefill forward of a serving engine under ``torch.profiler``.

No JAX twin (the JAX package's serving benchmarks time whole runs). The
forward is the one ``Engine.step`` runs for one bucket of its admissions:
the prompts of ``chip_smoke.py`` phase 4's draw (``numpy`` generator seed
2, 24 prompts of 16..1024 tokens), those of the first ``max_slots``
admitted that fall in ``bucket``, padded to a power of two rows with
padding rows of length 1, into slots 0, 1, ... of the engine's cache.
:func:`profile_bucket` reports its wall time (host clock, ended by a
synchronize; unprofiled, median of 3, and profiled), the device time of
its kernels, K4's share (kernels named ``flash_prefill``) and the kernels
that take the most.

It imports nothing of its own package at module level, so that
``scripts/phase2_ab.py`` can load it by path beside another checkout's
package; it runs that engine's own ``serving.engine._prefill``.
"""

from __future__ import annotations

import importlib
import statistics
import time

import numpy as np
import torch

SEED = 2
REQUESTS = 24


def kernel_rows(prof):
    """(name, device ms, launches) of every kernel in a finished profile,
    most device time first (kernel events only: an operator's own row
    repeats its kernels' time, and a ``record_function`` range's device
    row spans the kernels launched inside it)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not e.is_user_annotation]
    rows.sort(key=lambda r: -r[1])
    return rows


def bucket_batch(eng, bucket: int):
    """The engine's prefill arguments (tokens, lengths, last indices,
    starts, slots) for ``bucket``'s prompts among the first admissions."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(16, 1025, size=REQUESTS)
    prompts = [rng.integers(1, eng.cfg.vocab_size, size=int(n))
               for n in lengths]
    group = [p for p in prompts[:eng.max_slots]
             if eng._prompt_bucket(len(p)) == bucket]
    if not group:
        raise ValueError(f"no prompt of the draw falls in bucket {bucket}")
    s_pad = 1
    while s_pad < len(group):
        s_pad *= 2
    toks = np.zeros((s_pad, bucket), np.int32)
    total = np.ones((s_pad,), np.int32)
    last = np.zeros((s_pad,), np.int32)
    slots = np.full((s_pad,), -1, np.int32)
    for i, p in enumerate(group):
        toks[i, :len(p)] = p
        total[i] = len(p)
        last[i] = len(p) - 1
        slots[i] = i
    return toks, total, last, np.zeros((s_pad,), np.int32), slots


def profile_bucket(eng, bucket: int = 1024) -> dict:
    """Wall and device time of one prefill forward of ``bucket`` (module
    docstring); writes the rows of slots 0.. of the engine's cache."""
    from torch.profiler import ProfilerActivity, profile
    prefill = importlib.import_module(type(eng).__module__)._prefill
    args = (eng.params, eng.caches, eng.cfg, *bucket_batch(eng, bucket))
    run = lambda: prefill(*args)
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    device_ms = sum(r[1] for r in rows)
    k4 = [r for r in rows if "flash_prefill" in r[0]]
    return {"bucket": bucket, "rows": int(args[3].shape[0]),
            "lengths": args[4].tolist(),
            "unprofiled_wall_ms": statistics.median(walls),
            "wall_ms": wall_ms, "device_ms": device_ms,
            "launches": sum(r[2] for r in rows),
            "k4_ms": sum(r[1] for r in k4), "k4_launches": sum(r[2] for r in k4),
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for k, ms, c in rows[:8]]}
