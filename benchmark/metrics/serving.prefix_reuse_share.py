"""Share of the prompt tokens admitted in the window that the prefix cache
served: the engine's ``engine.prefix_tokens_reused`` over its
``stats.prefill_tokens`` (every admitted prompt's whole length)."""


def read(ctx):
    total = ctx.counters.get("stats.prefill_tokens", 0.0)
    if total <= 0:
        return None
    return 100.0 * ctx.counters.get("metrics.engine.prefix_tokens_reused", 0.0) / total
