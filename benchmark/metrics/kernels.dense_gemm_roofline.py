"""The dense fp8 projections (K1: attention, dense FFN) against their
roofline over the traced stretch: the least time their work needs
(``benchmark/work.py:dense_gemm_bound_s``, each forward's useful tokens)
over the device time of K1's kernels: the fp8 GEMM kernels named below
launched with one grid plane (grid z = 1).

Forwards in the stretch: each decode step, over the tokens it emitted;
each step's admissions as one prefill forward over the prompt tokens it
computed (a lower bound of the work)."""

NAMES = ("ring_kernel", "fp8_gemm_kernel", "folded_sm90_kernel")


def is_k1(name, grid):
    return any(n in name for n in NAMES) and len(grid) == 3 and grid[2] == 1


def read(ctx):
    st = ctx.stretch
    if not st:
        return None
    busy = sum(dur for name, dur, grid in st["kernels"] if is_k1(name, grid))
    if busy <= 0:
        return None
    need = 0.0
    for step in ctx.stretch_steps:
        d = step["delta"]
        steps = d.get("stats.decode_steps", 0.0)
        if steps > 0:
            need += steps * ctx.work.dense_gemm_bound_s(
                ctx.shapes, d.get("stats.decode_tokens", 0.0) / steps)
        computed = d.get("stats.prefill_tokens", 0.0) - d.get(
            "metrics.engine.prefix_tokens_reused", 0.0)
        if computed > 0:
            need += ctx.work.dense_gemm_bound_s(ctx.shapes, computed)
    return 100.0 * need / busy
