"""Share of the engine's serving time spent in prefill over the window:
``Engine.stats`` prefill_time_s / (prefill_time_s + decode_time_s), both
host clocks around work that ends in a read-back."""


def read(ctx):
    p = ctx.counters.get("stats.prefill_time_s", 0.0)
    d = ctx.counters.get("stats.decode_time_s", 0.0)
    if p + d <= 0:
        return None
    return 100.0 * p / (p + d)
