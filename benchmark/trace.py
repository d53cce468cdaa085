"""The device trace of a steady stretch of the window (``--trace 1``).

``torch.profiler`` records the host's operators and the card's kernels,
copies and sets over a stretch that starts and ends between two engine
steps. The trace goes to a temporary file under ``TMPDIR``, is read back
into sums (busy time as the union of the device's intervals, kernel time
by name, the idle gaps and what the host was doing in each) and deleted.
The benchmark's own spans (``bench.step.*``, around each ``Engine.step``)
name what the harness was driving.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "bench.stretch"
NAME_CHARS = 160


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def warm_profiler(device) -> None:
    """Start and stop the profiler once during set-up: its first start
    loads and sets up the device tracer, which takes seconds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        _sync()


class Stretch:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.span = None

    def start(self) -> None:
        _sync()
        self.prof.__enter__()
        self.span = torch.profiler.record_function(STRETCH)
        self.span.__enter__()

    def stop(self) -> Dict:
        _sync()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans: List[Tuple[float, float, str]], t: float) -> str:
    best, width = None, None
    for a, b, name in spans:
        if a <= t <= b and (width is None or b - a < width):
            best, width = name, b - a
    return best


def summarize(events: List[dict]) -> Dict:
    """Sums of a chrome trace: ``window_s`` (the stretch), ``busy_s``,
    ``kernels`` [(name, seconds, grid)], ``device_ops`` and ``idle_gaps``
    (each the ten largest [name, seconds])."""
    win = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no stretch span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels, cpu, steps = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            if cat == "kernel":
                grid = (e.get("args") or {}).get("grid") or [0, 0, 0]
                kernels.append((e.get("name", "?"), (b - a) * 1e-6, list(grid)))
        elif cat == "cpu_op":
            cpu.append((a, b, e.get("name", "?")))
        elif cat == "user_annotation" and e.get("name", "").startswith("bench.step"):
            steps.append((a, b, e["name"]))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    idle = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        step = _innermost(steps, mid) or "between steps"
        op = _innermost(cpu, mid) or "python"
        idle.append([f"{step}: {op}"[:NAME_CHARS], (b - a) * 1e-6])
    by_name: Dict[str, float] = {}
    for name, dur, _ in kernels:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s, "kernels": kernels,
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops], "idle_gaps": idle,
            "kernel_count": len(kernels)}
