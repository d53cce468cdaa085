"""Mean wait of a request admitted in the window between its admission and
its first token on the host, by the program's own clocks: ``Engine.stats``
first_token_wait_s (the sum of each request's ``first_token_t - admit_t``:
its own prefill group and the groups before it in the step) over
admitted."""


def read(ctx):
    n = ctx.counters.get("stats.admitted", 0.0)
    if n <= 0:
        return None
    return 1e3 * ctx.counters.get("stats.first_token_wait_s", 0.0) / n
