"""Mean wait of a request admitted in the window between its submission
and its admission, by the program's own clocks: ``Engine.stats``
queue_wait_s (the sum of each request's ``admit_t - submit_t``) over
admitted."""


def read(ctx):
    n = ctx.counters.get("stats.admitted", 0.0)
    if n <= 0:
        return None
    return 1e3 * ctx.counters.get("stats.queue_wait_s", 0.0) / n
