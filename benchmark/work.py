"""The yardstick's arithmetic: the H100's peaks, the roofline bound, and
each configuration's operations and bytes, counted from its published
shapes.

Frozen copies, so that a change to the program cannot move them:
``HBM_BYTES_PER_S``, ``BF16_OPS_PER_S``, ``FP8_OPS_PER_S`` and
``INT8_OPS_PER_S`` from ``deepgemm_ascend_tpu_torch/tiling/platform.py``
(NVIDIA's data sheet for one H100 SXM, dense, 700 W); :func:`bound_s` from
``deepgemm_ascend_tpu_torch/bench/roofline.py:bound_ms``; :func:`kernel_rows`
from ``deepgemm_ascend_tpu_torch/bench/prefill_profile.py:kernel_rows``.

Work is always what the tokens need, whatever a kernel does: a token is
counted once, at its own context length; padding rows, inactive slots and
tokens served from a cached prefix add nothing. Each weight byte is read
once a forward, each activation byte read once and each output byte
written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from benchmark.weights import Shapes

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP8_OPS_PER_S = 1979e12
INT8_OPS_PER_S = 1979e12

FP8_BLOCK = 128
SCALE_BYTES = 4       # one f32 scale
OUT_BYTES = 2         # bf16 outputs


def bound_s(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """(s, what bounds it): the least time for ``nbytes`` of device memory
    traffic and ``ops`` operations at ``peak`` operations per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_rows(prof):
    """(name, device ms, launches) of every kernel in a finished profile,
    most device time first (kernel events only)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    return rows


def _blocks(n: int) -> int:
    return -(-n // FP8_BLOCK)


def fp8_gemm(t: float, n: int, k: int, weights: float = 1.0) -> Tuple[float, float]:
    """(operations, bytes) of ``t`` token rows through an fp8 (n, k) weight
    with 1 x 128 activation scales and bf16 out; ``weights`` copies of the
    weight (experts) are read."""
    ops = 2.0 * t * n * k
    w = weights * (n * k + _blocks(n) * _blocks(k) * SCALE_BYTES)
    a = t * (k + _blocks(k) * SCALE_BYTES) + t * n * OUT_BYTES
    return ops, w + a


def dense_linears(s: Shapes, layer: int) -> Dict[str, Tuple[int, int]]:
    """The fp8 projections a token passes through in ``layer`` outside the
    routed experts: attention, and the dense FFN or the shared experts."""
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    out = {"q": (q, s.hidden), "k": (kv, s.hidden), "v": (kv, s.hidden),
           "o": (s.hidden, q)}
    inter = s.inter if not s.is_moe(layer) else s.moe_inter * s.shared
    if inter:
        out["gate_up"] = (2 * inter, s.hidden)
        out["down"] = (s.hidden, inter)
    return out


def dense_gemm_bound_s(s: Shapes, tokens: float) -> float:
    """Least time of every dense fp8 projection of one forward over
    ``tokens`` useful tokens (each weight read once)."""
    total = 0.0
    for layer in range(s.layers):
        for n, k in dense_linears(s, layer).values():
            ops, nbytes = fp8_gemm(tokens, n, k)
            total += bound_s(nbytes, ops, FP8_OPS_PER_S)[0]
    return total


def expert_gemm_bound_s(s: Shapes, tokens: float) -> float:
    """Least time of the routed experts' two grouped GEMMs in every MoE
    layer of one forward over ``tokens`` useful tokens: T·top_k rows, and
    the weights of the min(E, T·top_k) experts they can reach."""
    if not s.experts or tokens <= 0:
        return 0.0
    rows = tokens * s.top_k
    reach = min(s.experts, rows)
    layers = sum(1 for i in range(s.layers) if s.is_moe(i))
    t = 0.0
    for n, k in ((2 * s.moe_inter, s.hidden), (s.hidden, s.moe_inter)):
        ops, nbytes = fp8_gemm(rows, n, k, weights=reach)
        t += bound_s(nbytes, ops, FP8_OPS_PER_S)[0]
    return t * layers


def linear_ops_per_token(s: Shapes) -> float:
    """Operations of one token through every weight it uses: projections,
    dense FFN, router, the top-k routed and the shared experts, and the
    head (2 per multiply-add)."""
    total = 0
    for layer in range(s.layers):
        total += sum(n * k for n, k in dense_linears(s, layer).values())
        if s.is_moe(layer):
            total += s.hidden * s.experts + s.top_k * 3 * s.hidden * s.moe_inter
    total += s.hidden * s.vocab
    return 2.0 * total


def attention_ops(s: Shapes, context: int) -> float:
    """Operations of one token's attention over ``context`` keys (itself
    included) in every layer: scores and the weighted sum of values."""
    return 4.0 * s.layers * s.heads * s.head_dim * context


def token_ops(s: Shapes, positions: Iterable[int]) -> float:
    """Model operations of the tokens computed at ``positions``."""
    per = linear_ops_per_token(s)
    total = 0.0
    for p in positions:
        total += per + attention_ops(s, p + 1)
    return total


def model_ops(s: Shapes, prefill_spans: Iterable[Tuple[int, int]],
              decode_positions: Iterable[int]) -> float:
    """Operations of the useful work: prompts computed over [start, end)
    (a cached prefix excluded) and decoded tokens at their positions. The
    head counts once a prompt, for the position that is sampled."""
    per = linear_ops_per_token(s)
    head = 2.0 * s.hidden * s.vocab
    total = 0.0
    for a, b in prefill_spans:
        n = b - a
        if n <= 0:
            continue
        total += n * (per - head) + head
        total += 4.0 * s.layers * s.heads * s.head_dim * (a + 1 + b) * n / 2
    total += token_ops(s, decode_positions)
    return total
