"""The card's idle time put under the program's spans (``--trace 1``).

The port names its phases with ``torch.profiler.record_function`` ranges
(``deepgemm_ascend_tpu_torch.utils.logging.span``: names that begin with
``engine.`` or ``model.``). They land in the stretch's chrome trace beside
the card's kernels, copies and sets, on the profiler's clock.
:func:`idle_by_span` sums every idle gap of the stretch, in one sweep over
sorted intervals, by the path of the innermost program span open at that
moment (``engine.step>engine.prefill>model.ffn``; ``(no program span)``
where none is). :func:`labelled_gaps` labels the largest gaps as
``trace.summarize`` does, with the innermost program span put in;
:func:`prefill_idle_share` and :func:`setup_program_s` are the readings of
``device.prefill_idle_share`` and ``setup.program_s``. Pure functions of a
trace's events and of the program's counters; nothing here runs a cell.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark import trace

PREFIXES = ("engine.", "model.")
NO_SPAN = "(no program span)"
SEP = ">"


def _stretch(events: List[dict]) -> Tuple[float, float]:
    win = [e for e in events if e.get("name") == trace.STRETCH and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no stretch span")
    w0 = float(win[0]["ts"])
    return w0, w0 + float(win[0]["dur"])


def idle_gaps(events: List[dict]) -> Tuple[float, float, List[Tuple[float, float]]]:
    """(w0, w1, gaps): the stretch and its idle gaps (µs), the complement
    of the union of the card's intervals in it, as ``trace.summarize``
    takes them."""
    w0, w1 = _stretch(events)
    dev = []
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in trace.DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
    gaps, t = [], w0
    for a, b in trace._union(dev):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return w0, w1, gaps


def program_spans(events: List[dict]) -> List[Tuple[float, float, str]]:
    """(start, end, name) of the program's spans, in µs."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events
            if e.get("ph") == "X" and "dur" in e and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIXES)]


def segments(spans: List[Tuple[float, float, str]], w0: float, w1: float
             ) -> List[Tuple[float, float, str]]:
    """[w0, w1] cut where the innermost open program span changes:
    (a, b, path) in order, covering the stretch. A span opened inside
    another is its child; spans are closed in any order."""
    marks = []
    for i, (a, b, _) in enumerate(spans):
        marks.append((a, 1, -(b - a), i))       # opens: the wider first
        marks.append((b, 0, b - a, i))          # closes before opens
    marks.sort()
    stack: List[Tuple[int, str]] = []
    out, t, path = [], w0, NO_SPAN
    for at, is_open, _, i in marks:
        at = min(max(at, w0), w1)
        if at > t:
            out.append((t, at, path))
            t = at
        if is_open:
            parent = stack[-1][1] + SEP if stack else ""
            stack.append((i, parent + spans[i][2]))
        else:
            stack = [s for s in stack if s[0] != i]
        path = stack[-1][1] if stack else NO_SPAN
    if w1 > t:
        out.append((t, w1, path))
    return out


def idle_by_span(events: List[dict]) -> Dict[str, float]:
    """Idle seconds of the stretch by the innermost program span's path;
    the values sum to ``window_s - busy_s``."""
    w0, w1, gaps = idle_gaps(events)
    return _idle_under(gaps, segments(program_spans(events), w0, w1))


def _idle_under(gaps: List[Tuple[float, float]], segs: List[Tuple[float, float, str]]
                ) -> Dict[str, float]:
    """Seconds of ``gaps`` under each key of ``segs`` (both sorted by
    start, each disjoint)."""
    out: Dict[str, float] = {}
    i = 0
    for a, b in gaps:                         # both lists sorted, disjoint
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if hi > lo:
                out[segs[j][2]] = out.get(segs[j][2], 0.0) + (hi - lo) * 1e-6
            j += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def labelled_gaps(events: List[dict], n: int = 10) -> List[list]:
    """The ``n`` largest idle gaps [label, seconds], labelled as
    ``trace.summarize`` labels them with the innermost program span put in:
    ``bench.step.admit > engine.prefill: python``."""
    w0, w1, gaps = idle_gaps(events)
    steps, cpu = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        iv = (a, a + float(e["dur"]), e.get("name", "?"))
        if e.get("cat") == "cpu_op":
            cpu.append(iv)
        elif e.get("cat") == "user_annotation" and iv[2].startswith("bench.step"):
            steps.append(iv)
    prog = program_spans(events)
    out = []
    for a, b in sorted(gaps, key=lambda g: -(g[1] - g[0]))[:n]:
        mid = (a + b) / 2
        step = trace._innermost(steps, mid) or "between steps"
        inner = trace._innermost(prog, mid)
        op = trace._innermost(cpu, mid) or "python"
        where = f"{step} > {inner}" if inner else step
        out.append([f"{where}: {op}"[:trace.NAME_CHARS], (b - a) * 1e-6])
    return out


def prefill_idle_share(by_span: Dict[str, float], window_s: float) -> float:
    """Percent of the stretch idle under an ``engine.prefill`` span (its
    nested spans included)."""
    under = sum(s for path, s in by_span.items()
                if "engine.prefill" in path.split(SEP))
    return 100.0 * under / window_s


SETUP_PARTS = ("metrics.setup.load_params_s", "stats.prefill_time_s",
               "stats.decode_time_s", "stats.graph_capture_s")


def setup_program_s(counters: Dict[str, float]) -> float:
    """The program's share of set-up from its counters at the window's
    start: the loader and the engine's prefill, decode and capture
    seconds. The kernel libraries are built or loaded at the first launch,
    inside the first prefill forward, so their seconds are already in the
    engine's prefill time and are not added again."""
    return sum(counters.get(k, 0.0) for k in SETUP_PARTS)
