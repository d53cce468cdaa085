"""Host time of one decode step over the window: ``Engine.stats``
decode_time_s / decode_steps (a chunk of steps is timed whole, replay
and read-back included)."""


def read(ctx):
    n = ctx.counters.get("stats.decode_steps", 0.0)
    if n <= 0:
        return None
    return 1e3 * ctx.counters.get("stats.decode_time_s", 0.0) / n
