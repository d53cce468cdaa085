"""The routed experts' grouped GEMMs (K3) against their roofline over the
traced stretch: the least time their work needs (``benchmark/work.py:
expert_gemm_bound_s``, each forward's useful tokens) over the device time
of the kernels that do it.

K3's kernels are the fp8 GEMM kernels named below launched with one grid
plane an expert (grid z = n_routed_experts). Forwards in the stretch: each
decode step, over the tokens it emitted; each step's admissions as one
prefill forward over the prompt tokens it computed (a lower bound of the
work: a step that prefills several buckets reads the weights once here).
"""

NAMES = ("ring_kernel", "masked_gemm_kernel", "masked_sm90", "masked_wgmma")


def is_k3(name, grid, experts):
    return any(n in name for n in NAMES) and len(grid) == 3 and grid[2] == experts


def forwards(ctx):
    """(useful tokens) of every forward in the stretch."""
    out = []
    for st in ctx.stretch_steps:
        d = st["delta"]
        steps = d.get("stats.decode_steps", 0.0)
        if steps > 0:
            per = d.get("stats.decode_tokens", 0.0) / steps
            out += [per] * int(steps)
        computed = d.get("stats.prefill_tokens", 0.0) - d.get(
            "metrics.engine.prefix_tokens_reused", 0.0)
        if computed > 0:
            out.append(computed)
    return out


def read(ctx):
    st = ctx.stretch
    if not st or not ctx.shapes.experts:
        return None
    busy = sum(dur for name, dur, grid in st["kernels"]
               if is_k3(name, grid, ctx.shapes.experts))
    if busy <= 0:
        return None
    need = sum(ctx.work.expert_gemm_bound_s(ctx.shapes, t) for t in forwards(ctx))
    return 100.0 * need / busy
