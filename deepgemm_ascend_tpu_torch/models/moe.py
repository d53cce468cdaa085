"""MoE block: top-k routing + masked grouped GEMM experts, FP8 or W8A8 int8.

Port of ``deepgemm_ascend_tpu/models/moe.py``: an expert-parallel shard's
compute is ``moe_block(local_experts=, expert_offset=, group=)``, its routed
output summed over the "expert" axis's group before the shared expert.
DeepSeek-style: routed experts plus
always-on shared expert(s), SwiGLU in each expert. The routed experts hold
FP8 blockwise weights (:class:`ExpertWeights`, kernel K3) or W8A8 int8
per-channel weights (:class:`Int8ExpertWeights`, kernel K6;
:func:`int8_experts_from_fp8` converts the former); ``_moe_routed``
dispatches on the type, and the shared experts stay FP8 (K1) either way.
Dispatch uses the fixed-shape masked grouped kernel for prefill and decode
alike: capacity per expert = T·top_k, and ``masked_m`` says how many rows
are real. An explicit ``capacity`` below an expert's load keeps JAX's
out-of-range semantics: the assignments past it are dropped from the
buffer, and their gather reads row ``capacity - 1`` (JAX clamps a gather
index and drops a scatter's).

Numerics kept from the JAX package: the router gives bf16 logits from an
f32 accumulation; ``route_topk`` keeps the lower expert index on tied
scores (``lax.top_k``; here a stable descending sort); ``_swiglu`` works in
f32 and casts to bf16.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple, Union

import torch

from ..config import GemmConfig
from ..ops import grouped_gemm as gg
from ..ops import int8_gemm as i8
from ..ops import quant
from ..utils.common import resolve_device
from .config import ModelConfig
from .layers import BF16Linear, Fp8Linear


def _env_token_chunk() -> int:
    return int(os.environ.get("DGA_MOE_TOKEN_CHUNK", "2048"))


@dataclasses.dataclass
class ExpertWeights:
    """Per-expert SwiGLU weights, fp8 blockwise, K-major (NT):

    w1_q (E, 2·inter, hidden) gate∥up fused, w1_s (E, 2·inter/128,
    hidden/128); w2_q (E, hidden, inter), w2_s (E, hidden/128, inter/128).
    """

    w1_q: torch.Tensor
    w1_s: torch.Tensor
    w2_q: torch.Tensor
    w2_s: torch.Tensor

    @classmethod
    def create(cls, generator: torch.Generator, e: int, hidden: int,
               inter: int, *, device) -> "ExpertWeights":
        w1 = torch.randn((e, 2 * inter, hidden), generator=generator,
                         device=device) / (hidden ** 0.5)
        w1_q, w1_s = quant.quantize_fp8_weight(w1)
        del w1
        w2 = torch.randn((e, hidden, inter), generator=generator,
                         device=device) / (inter ** 0.5)
        w2_q, w2_s = quant.quantize_fp8_weight(w2)
        return cls(w1_q=w1_q, w1_s=w1_s, w2_q=w2_q, w2_s=w2_s)


def _int8_per_channel(w_nk: torch.Tensor):
    """(E, N, K) float → K-major int8 (E, N, K) and scales (E, 1, N): one
    symmetric scale per output channel, over K."""
    w_q, w_s = quant.quantize_int8(w_nk, axis=-1)
    return w_q.contiguous(), w_s.transpose(1, 2).contiguous()


@dataclasses.dataclass
class Int8ExpertWeights:
    """Per-expert SwiGLU weights, W8A8 int8 per output channel, K-major:

    w1_q (E, 2·inter, hidden) int8 with w1_s (E, 1, 2·inter) f32;
    w2_q (E, hidden, inter) int8 with w2_s (E, 1, hidden) f32.
    The JAX package stores the weights (E, in, out) with the same scales.
    Per-token activation × per-channel weight scales factor out of the K
    sum (ops/int8_gemm.py). Drop-in for :class:`ExpertWeights` in
    ``MoEParams.experts``.
    """

    w1_q: torch.Tensor
    w1_s: torch.Tensor
    w2_q: torch.Tensor
    w2_s: torch.Tensor

    @classmethod
    def create(cls, generator: torch.Generator, e: int, hidden: int,
               inter: int, *, device="cuda") -> "Int8ExpertWeights":
        dev = resolve_device(device)
        w1 = torch.randn((e, hidden, 2 * inter), generator=generator,
                         device=dev) / (hidden ** 0.5)
        w2 = torch.randn((e, inter, hidden), generator=generator,
                         device=dev) / (inter ** 0.5)
        return cls.from_weights(w1, w2)

    @classmethod
    def from_weights(cls, w1: torch.Tensor,
                     w2: torch.Tensor) -> "Int8ExpertWeights":
        """Quantize float expert weights given in the JAX package's layout,
        w1 (E, hidden, 2·inter) and w2 (E, inter, hidden), per output
        channel."""
        w1_q, w1_s = _int8_per_channel(w1.transpose(1, 2))
        w2_q, w2_s = _int8_per_channel(w2.transpose(1, 2))
        return cls(w1_q=w1_q, w1_s=w1_s, w2_q=w2_q, w2_s=w2_s)


def int8_experts_from_fp8(exp: ExpertWeights) -> Int8ExpertWeights:
    """Re-quantize fp8 expert weights to W8A8 int8, the fp8-checkpoint →
    int8 conversion: dequantize the blockwise fp8 weights to f32 (exact:
    one rounding of value × scale, as in the JAX package), then quantize
    per output channel. One matrix at a time, so the f32 copy of w1 is
    freed before w2's is made."""
    w1_q, w1_s = _int8_per_channel(
        quant.dequantize_fp8_weight(exp.w1_q, exp.w1_s))
    w2_q, w2_s = _int8_per_channel(
        quant.dequantize_fp8_weight(exp.w2_q, exp.w2_s))
    return Int8ExpertWeights(w1_q=w1_q, w1_s=w1_s, w2_q=w2_q, w2_s=w2_s)


@dataclasses.dataclass
class MoEParams:
    router: BF16Linear                 # (hidden, E)
    experts: Union[ExpertWeights, Int8ExpertWeights]
    shared_w1: Optional[Fp8Linear]     # hidden → 2·shared_inter
    shared_w2: Optional[Fp8Linear]
    # Token chunk of moe_block, read from DGA_MOE_TOKEN_CHUNK once, when the
    # parameters are built (the JAX package reads it on every trace).
    token_chunk: int = dataclasses.field(default_factory=_env_token_chunk)

    @classmethod
    def create(cls, generator: torch.Generator, cfg: ModelConfig, *,
               device) -> "MoEParams":
        shared_inter = cfg.moe_intermediate * cfg.num_shared_experts
        has_shared = cfg.num_shared_experts > 0
        return cls(
            router=BF16Linear.create(generator, cfg.hidden_size,
                                     cfg.num_experts, init_scale=0.02,
                                     device=device),
            experts=ExpertWeights.create(generator, cfg.num_experts,
                                         cfg.hidden_size,
                                         cfg.moe_intermediate, device=device),
            shared_w1=(Fp8Linear.create(generator, cfg.hidden_size,
                                        2 * shared_inter, device=device)
                       if has_shared else None),
            shared_w2=(Fp8Linear.create(generator, shared_inter,
                                        cfg.hidden_size, device=device)
                       if has_shared else None),
        )


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    gate, up = torch.chunk(h, 2, dim=-1)
    return (torch.nn.functional.silu(gate.to(torch.float32))
            * up.to(torch.float32)).to(torch.bfloat16)


def route_topk(logits: torch.Tensor,
               top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) → (weights (T, K) f32 normalized, indices (T, K) int32).
    Ties keep the lower index, like ``lax.top_k``."""
    scores = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, idx.to(torch.int32)


def dispatch_masked(
    topk_idx: torch.Tensor,    # (T, K) int
    num_experts: int,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plan the fixed-shape dispatch.

    Returns (slot (T, K) int32 — rank of (t, k) within its expert, in
    token-major order; masked_m (E,) int32; capacity T·K).
    """
    t, k = topk_idx.shape
    flat = topk_idx.reshape(-1).to(torch.int64)
    onehot = torch.nn.functional.one_hot(flat, num_experts).to(torch.int32)
    ranks_all = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(ranks_all, 1, flat[:, None])[:, 0]
    masked_m = onehot.sum(dim=0, dtype=torch.int32)
    return slot.reshape(t, k), masked_m, t * k


def moe_block(
    params: MoEParams,
    x: torch.Tensor,            # (T, hidden) bf16
    cfg: ModelConfig,
    *,
    capacity: Optional[int] = None,
    gemm_config: Optional[GemmConfig] = None,
    local_experts: Optional[int] = None,
    expert_offset: int = 0,
    group=None,
    token_chunk: Optional[int] = None,
) -> torch.Tensor:
    """One MoE FFN over a flat token batch.

    Under expert parallelism, ``params.experts`` holds this shard's
    ``local_experts`` experts, global ids [expert_offset, expert_offset +
    local_experts): routing runs over all ``cfg.num_experts`` as on every
    shard, only the assignments to local experts are computed (the others
    contribute zero), and ``group`` (the "expert" axis's process group)
    sums the shards' routed outputs.

    ``capacity``: rows an expert's buffer holds (default T·top_k, the
    worst case); ``gemm_config`` goes to the grouped GEMMs as their
    ``config``. Large token batches run in chunks of ``token_chunk`` tokens
    (default: ``params.token_chunk``): the dispatch buffer is (E, T·K,
    hidden) at worst-case capacity, so chunking bounds it at (E, chunk·K,
    hidden) with identical results — every routed quantity is per token.
    T is padded with zero rows up to a chunk multiple; their outputs are
    dropped. An explicit ``capacity`` disables chunking (the caller owns
    the shape).
    """
    t, hidden = x.shape
    tc = token_chunk if token_chunk is not None else params.token_chunk
    kw = dict(capacity=capacity, gemm_config=gemm_config,
              local_experts=local_experts, expert_offset=expert_offset)
    if capacity is None and tc and t > tc:
        nc = -(-t // tc)
        pad = nc * tc - t
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
        out = torch.cat([_moe_routed(params, xp[i * tc:(i + 1) * tc], cfg,
                                     **kw)
                         for i in range(nc)])[:t]
    else:
        out = _moe_routed(params, x, cfg, **kw)

    if group is not None:
        from ..parallel.mesh import psum
        out = psum(out, group)

    if params.shared_w1 is not None:
        sh = _swiglu(params.shared_w1(x))
        out = out + params.shared_w2(sh).to(torch.float32)
    return out.to(torch.bfloat16)


def _moe_routed(params: MoEParams, x: torch.Tensor, cfg: ModelConfig, *,
                capacity: Optional[int] = None,
                gemm_config: Optional[GemmConfig] = None,
                local_experts: Optional[int] = None,
                expert_offset: int = 0) -> torch.Tensor:
    """The routed-expert computation for one token block → (t, hidden) f32."""
    t, hidden = x.shape
    e_total = cfg.num_experts
    e_local = local_experts or e_total
    logits = params.router(x)
    weights, topk_idx = route_topk(logits, cfg.top_k)
    slot, masked_m, cap_default = dispatch_masked(topk_idx, e_total)
    cap = capacity or cap_default

    # Scatter tokens into the fixed (E_local, cap, hidden) buffer: row
    # t·K + k of the flat assignment list goes to (expert, slot). On a
    # shard, assignments to other shards' experts read back from
    # (0, cap-1) and are masked out of the combine, as in the JAX package.
    # Each token's row top_k times (repeat_interleave's values, with no
    # count read back to the host: the decode step is graph-captured).
    rows = x.to(torch.bfloat16)[:, None].expand(
        t, cfg.top_k, hidden).reshape(t * cfg.top_k, hidden)
    in_shard = None
    if e_local != e_total or expert_offset:
        local = topk_idx - expert_offset
        in_shard = ((local >= 0) & (local < e_local)).reshape(-1)
        topk_idx = torch.where(in_shard.reshape(t, -1), local, 0)
        slot = torch.where(in_shard.reshape(t, -1), slot, cap - 1)
        masked_m = masked_m[expert_offset:expert_offset + e_local]
    e_flat = topk_idx.reshape(-1).to(torch.int64)
    s_flat = slot.reshape(-1).to(torch.int64)
    # Past the capacity, JAX's scatter drops a row and its gather clamps to
    # the last row. Dropped rows and off-shard assignments go to one spare
    # row past the buffer, so that no two writes share a real row (CUDA
    # picks no winner among duplicate indices).
    keep = s_flat < cap
    if in_shard is not None:
        keep &= in_shard
    flat = torch.where(keep, e_flat * cap + s_flat, e_local * cap)
    buf = torch.zeros((e_local * cap + 1, hidden), dtype=torch.bfloat16,
                      device=x.device)
    buf[flat] = rows
    buf = buf[:-1].view(e_local, cap, hidden)
    s_flat = s_flat.clamp(max=cap - 1)
    masked_m = masked_m.clamp(max=cap)
    del rows

    # Expert SwiGLU through the masked grouped GEMM of the experts' type:
    # fp8 blockwise (K3) or W8A8 int8 with per-token scales (K6).
    # The rows an expert holds on average picks K3's tile and K6's route.
    exp = params.experts
    if isinstance(exp, Int8ExpertWeights):
        quantize = lambda t: quant.quantize_int8(t, axis=-1)  # (E, cap, 1)
        gemm = i8.m_grouped_int8_gemm_masked
    else:
        quantize = quant.quantize_fp8_act
        gemm = gg.m_grouped_gemm_masked
    gemm = functools.partial(gemm, expected_m=-(-t * cfg.top_k // e_total),
                             config=gemm_config)
    a_q, a_s = quantize(buf)
    del buf
    h = gemm(a_q, a_s, exp.w1_q, exp.w1_s, masked_m, b_layout="t")
    del a_q, a_s
    h = _swiglu(h)
    h_q, h_s = quantize(h)
    del h
    y = gemm(h_q, h_s, exp.w2_q, exp.w2_s, masked_m,
             b_layout="t")                                 # (E, cap, hidden)

    # Gather back + weighted combine.
    gathered = y[e_flat, s_flat]
    if in_shard is not None:
        gathered = torch.where(in_shard[:, None], gathered, 0)
    gathered = gathered.reshape(t, cfg.top_k, hidden)
    return torch.sum(gathered.to(torch.float32) * weights[:, :, None], dim=1)
