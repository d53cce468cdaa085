"""Share of the engine's prefill forwards over the window that replayed a
captured CUDA graph: ``Engine.stats`` prefill_graph_replays (a capturing
forward replays too) over the metrics registry's
engine.prefill_dispatches (one a bucket group)."""


def read(ctx):
    n = ctx.counters.get("metrics.engine.prefill_dispatches", 0.0)
    if n <= 0 or "stats.prefill_graph_replays" not in ctx.counters:
        return None
    return 100.0 * ctx.counters["stats.prefill_graph_replays"] / n
