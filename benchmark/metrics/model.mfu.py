"""Model FLOP/s utilization of the window: the operations the served
tokens need (``benchmark/work.py:model_ops``: each prompt computed past its
cached prefix, each decoded token at its position, weights as published),
over the window's seconds at the card's fp8 peak."""


def read(ctx):
    ops = ctx.work.model_ops(ctx.shapes, ctx.prefill_spans, ctx.decode_positions)
    if ops <= 0:
        return None
    return 100.0 * ops / (ctx.window_s * ctx.work.FP8_OPS_PER_S)
