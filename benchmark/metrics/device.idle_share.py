"""Share of the traced stretch in which no kernel, copy or set ran on the
card: 1 - (union of the device's intervals) / stretch, from the profiler's
trace (``benchmark/trace.py``)."""


def read(ctx):
    st = ctx.stretch
    if not st or st["window_s"] <= 0 or st["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
