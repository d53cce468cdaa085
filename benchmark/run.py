"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run builds the cell's configuration on
the card from the seed (weights through the port's checkpoint loader),
warms the prompt buckets its traffic can use and admits the traffic's
first wave, all counted as set-up; then it drives
``deepgemm_ascend_tpu_torch.serving.Engine`` for ``--seconds`` through
``Engine.scheduler.submit`` and ``Engine.step``, closes the window, reads
the peak memory, frees the program's state and compares a sample of the
served requests with the plain reference (:mod:`benchmark.check`). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

# The port and its libraries read these; a run keeps its build and kernel
# caches inside the checkout and loads nothing of JAX.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "deepgemm_ascend_tpu")
EXIT_NO_CHIP = 3
EXIT_FORBIDDEN = 4
STRETCH_S = 3.0         # the traced stretch that follows the window


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``deepgemm_ascend_tpu_torch`` is not ``deepgemm_ascend_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- serving ----------------------------------------------------------------------

class Server:
    """Drives the engine: submits the source's requests, steps, records each
    token's time and asks the source for what follows a finished request."""

    def __init__(self, engine, source, counters, replica):
        self.engine = engine
        self.source = source
        self.counters = counters
        self.replica = replica
        self.live = {}
        self.requests = []
        self.finished = []
        self.failed = []
        self.steps = []

    def submit(self, req):
        req.submit_t = time.perf_counter()
        req.engine_id = self.engine.scheduler.submit(req.prompt, req.max_new)
        self.live[req.engine_id] = req
        self.requests.append(req)

    def step(self, label_fn=None):
        import torch
        before = self.counters(self.engine)
        t_a = time.perf_counter()
        if label_fn is not None:
            with torch.profiler.record_function(label_fn()):
                emitted = self.engine.step()
        else:
            emitted = self.engine.step()
        t = time.perf_counter()
        after = self.counters(self.engine)
        admitted = sorted((eid for eid in emitted if not self.live[eid].tokens))
        hits = self.replica.admit([self.live[e].prompt for e in admitted])
        for eid, h in zip(admitted, hits):
            self.live[eid].hit = h
        for eid, toks in emitted.items():
            r = self.live[eid]
            if r.first_t is None:
                r.first_t = t
            r.tokens.extend(int(x) for x in toks)
            r.token_t.extend([t] * len(toks))
            r.last_t = t
        sched = self.engine.scheduler
        for eid in list(emitted):
            if eid not in sched.finished:
                continue
            r = self.live.pop(eid)
            out = sched.pop_result(eid).output
            r.done_t = t
            if out != r.tokens or len(r.tokens) != r.max_new:
                self.failed.append(r)
            self.finished.append(r)
            if r.client < 0:        # a warm-up request: no client follows it
                continue
            for nxt in self.source.on_finish(r, t):
                self.submit(nxt)
        self.steps.append({"t0": t_a, "t1": t, "admitted": len(admitted),
                           "delta": {k: after[k] - before.get(k, 0.0) for k in after}})
        return t


def warm(server, source, max_seq_len: int, vocab: int, seed: int) -> None:
    """Prefill one prompt in each of the engine's prompt buckets
    (``Engine._prompt_bucket``) that the traffic's prompt lengths fall in,
    then a chunk of decode steps, which captures the decode graph; then
    admit the traffic's first wave in batches."""
    import numpy as np
    from benchmark.kinds.common import Req
    rng = np.random.default_rng([seed, 99])
    chunk = server.engine.decode_chunk
    longest = {}
    for n in source.prompt_lengths():
        n = min(n, max_seq_len - chunk - 2)
        b = server.engine._prompt_bucket(n)
        longest[b] = max(n, longest.get(b, 0))
    for n in longest.values():
        server.submit(Req(-1, -1, rng.integers(1, vocab, size=n).tolist(), chunk + 1))
    while server.engine.scheduler.has_work:
        server.step()
    wave = source.setup_requests()
    batch = max(1, getattr(source, "admit_batch", len(wave) or 1))
    for i in range(0, len(wave), batch):
        for r in wave[i:i + batch]:
            server.submit(r)
        server.step()
    while server.engine.scheduler.waiting:
        server.step()


def _delta(a: dict, b: dict) -> dict:
    return {k: b.get(k, 0.0) - a.get(k, 0.0) for k in b}


def serve(cell, seed: int, seconds: float, trace: bool, device, *, t_setup0=None):
    """Set-up and window of one run. Returns the record the result and the
    check are made from; the engine is still alive in it."""
    import torch
    from benchmark import check, program
    from benchmark.accounting import PrefixReplica
    hf, srv = cell.config, cell.config["serving"]
    check.reference(hf)     # a reference that is not there fails here, not after the window
    torch.manual_seed(seed)
    engine = program.build(hf, cell.settings, seed, device)
    kind = cell.kind()
    source = kind.Source(cell.traffic, seed=seed, vocab=hf["vocab_size"],
                         slots=int(cell.settings["max_slots"]),
                         max_seq_len=int(srv["max_seq_len"]))
    replica = PrefixReplica(int(cell.settings.get("prefix_cache_slots", 0)),
                            int(srv["max_seq_len"]))
    server = Server(engine, source, program.engine_counters, replica)
    warm(server, source, int(srv["max_seq_len"]), hf["vocab_size"], seed)
    n_setup_steps = len(server.steps)
    if device.type == "cuda":
        torch.cuda.synchronize()

    tracer = None
    if trace:
        from benchmark.trace import Stretch, warm_profiler
        warm_profiler(device)
        tracer = Stretch()

    c0 = program.engine_counters(engine)
    t0 = time.perf_counter()
    setup_s = process_age() if t_setup0 is None else t0 - t_setup0
    source.start(t0)
    deadline = t0 + seconds
    drive(server, source, deadline)
    n_window = len(server.steps)
    t1 = max(time.perf_counter(), server.steps[-1]["t1"] if n_window > n_setup_steps else t0)
    for r in source.poll(min(t1, deadline)):
        server.submit(r)
    c1 = program.engine_counters(engine)
    stretch, stretch_counters = None, None
    if tracer is not None:
        # A steady stretch after the window, so that the window's own
        # numbers carry no profiler.
        tracer.start()
        t_s = time.perf_counter()
        drive(server, source, t_s + STRETCH_S, label=lambda: (
            "bench.step.admit" if engine.scheduler.waiting else "bench.step.decode"))
        stretch = tracer.stop()
        stretch_counters = _delta(c1, program.engine_counters(engine))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    return types.SimpleNamespace(
        engine=engine, server=server, source=source, t0=t0, t1=t1, deadline=deadline,
        setup_s=setup_s, counters=_delta(c0, c1),
        window_steps=server.steps[n_setup_steps:n_window], stretch=stretch,
        stretch_steps=server.steps[n_window:], stretch_counters=stretch_counters,
        memory_peak_bytes=int(peak), replica=replica)


def drive(server, source, until: float, label=None) -> None:
    """Serve until ``until``: submit what is due, step while there is work,
    wait for the next arrival while there is none."""
    engine = server.engine
    while True:
        now = time.perf_counter()
        if now >= until:
            return
        for r in source.poll(now):
            server.submit(r)
        if not engine.scheduler.has_work:
            nd = source.next_due()
            if nd is None:
                return
            time.sleep(max(0.0, min(nd, until) - now))
            continue
        server.step(label)


# -- metrics ---------------------------------------------------------------------

def end_to_end(rec) -> dict:
    """The end-to-end readings of a window, and what is printed beside
    them: sample counts, medians and the tails of the time to first token
    and of the time per output token, which no cell keeps as a metric
    yet."""
    from benchmark.registry import percentile
    t0, t1, deadline = rec.t0, rec.t1, rec.deadline
    window_s = t1 - t0
    reqs = rec.server.requests
    tokens = sum(1 for r in reqs for t in r.token_t if t0 < t <= t1)
    due = [r for r in reqs if r.due is not None and t0 <= r.due <= deadline]
    ttft = [((r.first_t if r.first_t is not None and r.first_t <= t1 else t1) - r.due) * 1e3
            for r in due]
    tpot = []
    for r in reqs:
        if r.done_t is None or not t0 < r.done_t <= t1:
            continue
        inside = [t for t in r.token_t if t0 < t <= t1]
        if len(inside) >= 2:
            tpot.append((inside[-1] - inside[0]) * 1e3 / (len(inside) - 1))
    out = {"output_tok_s": tokens / window_s, "setup_s": rec.setup_s}
    info = {"window_s": window_s, "tokens": tokens, "requests_due": len(due),
            "ttft_samples": len(ttft), "tpot_samples": len(tpot),
            "ttft_p50_ms": percentile(ttft, 50), "ttft_p95_ms": percentile(ttft, 95),
            "tpot_p50_ms": percentile(tpot, 50), "tpot_p95_ms": percentile(tpot, 95),
            "still_waiting": sum(1 for r in due if r.first_t is None or r.first_t > t1),
            "finished_in_window": sum(1 for r in reqs if r.done_t is not None and t0 < r.done_t <= t1)}
    late = [(r.submit_t - r.due) * 1e3 for r in due if r.submit_t is not None]
    if late:
        info["generator_late_p50_ms"] = percentile(late, 50)
        info["generator_late_max_ms"] = max(late)
    return out, info


def context(cell, rec):
    from benchmark import work
    from benchmark.accounting import useful_work
    from benchmark.weights import Shapes
    s = Shapes(cell.config)
    spans, positions = useful_work(rec.server.requests, rec.t0, rec.t1)
    ctx = types.SimpleNamespace(
        cell=cell, shapes=s, work=work, window_s=rec.t1 - rec.t0,
        counters=rec.counters, steps=rec.window_steps, prefill_spans=spans,
        decode_positions=positions, stretch=rec.stretch,
        stretch_counters=rec.stretch_counters, stretch_steps=rec.stretch_steps)
    return ctx


# -- the run ---------------------------------------------------------------------

def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_chip(chips: int) -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device: this benchmark runs only on the card "
                         f"(torch {torch.__version__})")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} are present")
    return torch.cuda.get_device_name(0)


def run(argv=None, *, root=None, device=None, judge_fn=None, emit=None) -> int:
    """The whole run; returns the exit code. ``device`` (a CPU device, for
    tests) skips the look for a chip; ``judge_fn`` replaces the check's
    reference comparison and ``emit`` receives the result line (tests)."""
    args = parse(argv)
    root = Path(root or os.getcwd())
    from benchmark import registry
    cell = registry.load(root, args.workload)
    import torch
    if device is None:
        try:
            kind_name = check_chip(cell.chips)
        except SystemExit as e:
            log(str(e))
            return EXIT_NO_CHIP
        device = torch.device("cuda", 0)
        platform = "gpu"
    else:
        device = torch.device(device)
        kind_name, platform = "cpu", "cpu"
    torch.set_num_threads(min(4, torch.get_num_threads()))

    rec = serve(cell, args.seed, args.seconds, bool(args.trace), device,
                t_setup0=None if platform == "gpu" else _T_IMPORT)
    e2e, info = end_to_end(rec)
    log("window " + json.dumps(info, sort_keys=True))
    log("counters " + json.dumps({k: v for k, v in rec.counters.items() if v}, sort_keys=True))
    replica_reuse = sum(r.hit for r in rec.server.requests if r.first_t and rec.t0 < r.first_t <= rec.t1)
    log(f"prefix reuse: engine {rec.counters.get('metrics.engine.prefix_tokens_reused', 0.0)}"
        f" replica {replica_reuse}")

    metrics = {}
    breakdown = None
    device_info = {"platform": platform, "kind": kind_name, "count": cell.chips,
                   "memory_peak_bytes": rec.memory_peak_bytes}
    if args.trace:
        ctx = context(cell, rec)
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec.stretch is not None:
            device_info["busy_s"] = rec.stretch["busy_s"]
            device_info["window_s"] = rec.stretch["window_s"]
            breakdown = {"device_ops": rec.stretch["device_ops"],
                         "idle_gaps": rec.stretch["idle_gaps"]}
            log(f"trace: {rec.stretch['kernel_count']} kernels, "
                f"{len(rec.stretch_steps)} steps in {rec.stretch['window_s']:.3f} s")
    else:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    finished = list(rec.server.finished)
    failed = len(rec.server.failed)
    attempted = info["requests_due"]
    from benchmark import check, program
    picked = check.sample(finished, args.seed)
    program.free(rec.engine)
    rec.engine = None
    t_ref = time.perf_counter()
    readings = (judge_fn or check.judge)(cell.config, args.seed, device, picked)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s, "
        f"{readings.get('requests_compared', 0)} requests, "
        f"{readings.get('served_compared', 0)} served tokens")

    limits = cell.settings["limits"]
    checks = {name: {"value": readings.get(name, math.inf), "limit": limit}
              for name, limit in limits.items() if name.endswith("_logit_gap")}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    checks["served_compared"] = {"value": readings.get("served_compared", 0),
                                 "limit": limits["served_compared_min"]}
    correct = (all(c["value"] <= c["limit"] for k, c in checks.items()
                   if k != "served_compared")
               and checks["served_compared"]["value"] >= checks["served_compared"]["limit"])
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return EXIT_FORBIDDEN
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    log("gaps " + json.dumps({k: v for k, v in readings.items() if k.endswith("_gap")}))
    for k, v in checks.items():
        op = ">=" if k == "served_compared" else "<="
        log(f"check {k} = {v['value']} (must be {op} {v['limit']})")
    (emit or (lambda line: print(line, flush=True)))(json.dumps(result))
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
