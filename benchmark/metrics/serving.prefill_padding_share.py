"""Share of the tokens the engine's prefill forwards ran that were padding,
over the window: ``Engine.stats`` prefill_tokens_padding over
prefill_tokens_run (each forward's rows × bucket; prompts padded to their
power-of-two bucket, the rows to a power of two, padded rows counted
whole)."""


def read(ctx):
    run = ctx.counters.get("stats.prefill_tokens_run", 0.0)
    if run <= 0:
        return None
    return 100.0 * ctx.counters.get("stats.prefill_tokens_padding", 0.0) / run
