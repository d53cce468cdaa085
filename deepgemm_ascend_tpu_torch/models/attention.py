"""GQA attention with an INT8-quantized KV cache.

Port of ``deepgemm_ascend_tpu/models/attention.py``. Three branches,
chosen by the same gates as in the JAX package so that the same inputs take
the same branch in both:

* decode (s == 1): the fused in-place flash decode kernel (K2) attends the
  cache and writes the new token's row;
* prefill (s % 16 == 0 with ``prefill_start``): the cache is updated, then
  the flash prefill kernel (K4) attends it;
* otherwise (``use_flash_decode=False``, ragged s, or no ``prefill_start``):
  the fallback, plain PyTorch in f32 — the JAX package's XLA
  dequantize-in-contraction path.

Tensor parallelism (``parallel/sharded.py``): ``tp_heads`` local q heads
starting at global head ``head_offset``, the row-sharded o-projection's f32
partials summed over ``group`` and cast to bf16. The kv regime follows the
cache's local kv-head count, as in JAX: *congruent* (the cache holds this
shard's kv heads, a GQA problem of its own, so the flash kernels run on
it) or *replicated kv* (every kv head on every shard; each local q head
reads its kv head by global index, on the fallback path — JAX's XLA path).

The cache tensors are updated in place (the JAX package returns new arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import quant
from ..ops.flash_common import NEG_INF
from ..utils.logging import metrics
from .config import ModelConfig
from .layers import Fp8Linear, apply_rope


@dataclasses.dataclass
class KVCache:
    """Per-layer int8 KV cache: values (batch, kv_heads, max_seq, head_dim)
    int8, scales (batch, kv_heads, max_seq) f32 — the layout of the JAX
    package and of the flash kernels."""

    k_q: torch.Tensor
    k_s: torch.Tensor
    v_q: torch.Tensor
    v_s: torch.Tensor

    @classmethod
    def create(cls, batch: int, max_seq: int, kv_heads: int, head_dim: int,
               *, device) -> "KVCache":
        def z8():
            return torch.zeros((batch, kv_heads, max_seq, head_dim),
                               dtype=torch.int8, device=device)

        def zs():
            return torch.zeros((batch, kv_heads, max_seq),
                               dtype=torch.float32, device=device)
        return cls(k_q=z8(), k_s=zs(), v_q=z8(), v_s=zs())

    @property
    def max_seq(self) -> int:
        return self.k_q.shape[2]

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               positions: torch.Tensor) -> "KVCache":
        """Write new tokens. k_new/v_new: (batch, s_new, kv_heads, hd);
        positions: (batch, s_new) absolute slots."""
        k_q, k_s = quant.quantize_int8(k_new, axis=-1)   # (b,s,kvh,hd)/(…,1)
        v_q, v_s = quant.quantize_int8(v_new, axis=-1)
        return self.write_quantized(k_q, k_s, v_q, v_s, positions)

    def write_quantized(self, k_q, k_s, v_q, v_s,
                        positions: torch.Tensor) -> "KVCache":
        """Scatter already-quantized rows (k_q (b,s,kvh,hd) int8, k_s
        (b,s,kvh,1) f32) at ``positions``, in place. Positions outside
        [0, max_seq) are dropped, as the JAX package's scatter drops them (a
        freed slot whose length already equals the cache extent). On the
        CPU the rows in range are picked by ``nonzero``; elsewhere by
        :meth:`write_quantized_no_sync`, which reads nothing back to the
        host, so that a CUDA graph can hold it."""
        pos = positions.to(device=self.k_q.device, dtype=torch.int64)
        if pos.device.type != "cpu":
            return self.write_quantized_no_sync(k_q, k_s, v_q, v_s, pos)
        bi, si = torch.nonzero((pos >= 0) & (pos < self.max_seq),
                               as_tuple=True)
        p = pos[bi, si]
        self.k_q[bi, :, p] = k_q[bi, si]
        self.k_s[bi, :, p] = k_s[bi, si, :, 0]
        self.v_q[bi, :, p] = v_q[bi, si]
        self.v_s[bi, :, p] = v_s[bi, si, :, 0]
        return self

    def write_quantized_no_sync(self, k_q, k_s, v_q, v_s,
                                positions: torch.Tensor) -> "KVCache":
        """:meth:`write_quantized` in a fixed number of writes, with no
        count read back: every one of the b·s rows is written. A row out
        of range takes the place and the bytes of the first row in range,
        so the same bytes land there twice; where no row is in range, each
        writes back the bytes already at (batch 0, its position clamped
        into the cache). No two writes to one place differ."""
        pos = positions.to(device=self.k_q.device,
                           dtype=torch.int64).reshape(-1)
        s = k_q.shape[1]
        ok = (pos >= 0) & (pos < self.max_seq)
        first = torch.argmax(ok.to(torch.int32))   # first in range, or 0
        row = torch.where(ok, torch.arange(pos.numel(), device=pos.device),
                          first)
        bi, si = row // s, row % s
        p = pos[row].clamp(0, self.max_seq - 1)
        any_ok = ok.any()
        for dst, new in ((self.k_q, k_q[bi, si]),
                         (self.k_s, k_s[bi, si, :, 0]),
                         (self.v_q, v_q[bi, si]),
                         (self.v_s, v_s[bi, si, :, 0])):
            dst[bi, :, p] = torch.where(any_ok, new, dst[bi, :, p])
        return self


@dataclasses.dataclass
class AttentionParams:
    wq: Fp8Linear        # (hidden → heads·hd)
    wk: Fp8Linear        # (hidden → kv_heads·hd)
    wv: Fp8Linear
    wo: Fp8Linear        # (heads·hd → hidden)

    @classmethod
    def create(cls, generator: torch.Generator, cfg: ModelConfig, *,
               device) -> "AttentionParams":
        return cls(
            wq=Fp8Linear.create(generator, cfg.hidden_size, cfg.q_dim,
                                device=device),
            wk=Fp8Linear.create(generator, cfg.hidden_size, cfg.kv_dim,
                                device=device),
            wv=Fp8Linear.create(generator, cfg.hidden_size, cfg.kv_dim,
                                device=device),
            wo=Fp8Linear.create(generator, cfg.q_dim, cfg.hidden_size,
                                device=device),
        )


def _fallback(q, cache: KVCache, positions, seq_lens, heads, g, hd,
              head_offset=0):
    """Dequantize-in-contraction attention in f32 (the XLA path); local q
    head i reads the kv head of global head ``head_offset + i``."""
    kf = cache.k_q.to(torch.float32) * cache.k_s[..., None]
    vf = cache.v_q.to(torch.float32) * cache.v_s[..., None]
    kv_map = (head_offset + torch.arange(heads, device=q.device)) // g
    kf_h = kf[:, kv_map]                                   # (b, heads, S, hd)
    vf_h = vf[:, kv_map]
    qf = q.to(torch.float32)
    logits = torch.einsum("bshd,bhTd->bshT", qf, kf_h) / (hd ** 0.5)
    t_idx = torch.arange(cache.max_seq, device=q.device)
    causal = t_idx[None, None, :] <= positions[:, :, None]          # (b,s,S)
    valid = t_idx[None, None, :] < seq_lens.to(q.device)[:, None, None]
    mask = (causal & valid)[:, :, None, :]                          # (b,s,1,S)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bshT,bhTd->bshd", probs, vf_h)


def attention(
    params: AttentionParams,
    x: torch.Tensor,                 # (batch, s, hidden) bf16
    cache: KVCache,
    positions: torch.Tensor,         # (batch, s) absolute positions
    seq_lens: torch.Tensor,          # (batch,) valid cache length AFTER update
    cfg: ModelConfig,
    *,
    tp_heads: Optional[int] = None,
    head_offset: int = 0,
    group=None,
    prefill_start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Causal GQA over the int8 cache, for prefill (s = prompt) and decode
    (s = 1) alike. Under tensor parallelism ``params`` holds this shard's
    ``tp_heads`` q heads (and its kv heads in the congruent regime) and
    ``group`` is the "model" axis's process group."""
    b, s, _ = x.shape
    heads = tp_heads if tp_heads is not None else cfg.num_heads
    kv_heads = cache.k_q.shape[1]        # LOCAL kv heads (may be sharded)
    hd = cfg.head_dim
    g = cfg.num_heads // cfg.num_kv_heads   # invariant under sharding
    # Congruent ⇔ this shard's q heads attend exactly its kv heads.
    congruent = heads == kv_heads * g
    if kv_heads != cfg.num_kv_heads and not congruent:
        raise ValueError(
            f"kv cache sharded to {kv_heads} heads but {heads} local q "
            f"heads / group {g} — shard q and kv heads congruently")

    q = params.wq(x).reshape(b, s, heads, hd)
    k = params.wk(x).reshape(b, s, kv_heads, hd)
    v = params.wv(x).reshape(b, s, kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    use_flash = (s == 1 and congruent
                 and cfg.use_flash_decode and cache.max_seq % 8 == 0)
    use_flash_prefill = (s > 1 and s % 16 == 0 and congruent
                         and cfg.use_flash_decode
                         and prefill_start is not None
                         and cache.max_seq % 8 == 0)
    if use_flash:
        metrics.inc("attention.flash_decode_trace")
    elif use_flash_prefill:
        metrics.inc("attention.flash_prefill_trace")
    else:
        metrics.inc("attention.xla_fallback_trace")
    if use_flash:
        from ..ops.flash_decode import flash_decode_gqa_inplace
        k_q8, k_s8 = quant.quantize_int8(k.to(torch.float32), axis=-1)
        v_q8, v_s8 = quant.quantize_int8(v.to(torch.float32), axis=-1)
        out, kq2, vq2, ks2, vs2 = flash_decode_gqa_inplace(
            q[:, 0], cache.k_q, cache.k_s, cache.v_q, cache.v_s,
            k_q8[:, 0], v_q8[:, 0], k_s8[:, 0, :, 0], v_s8[:, 0, :, 0],
            seq_lens)
        cache = KVCache(k_q=kq2, k_s=ks2, v_q=vq2, v_s=vs2)
        out = out.reshape(b, 1, heads * hd).to(torch.bfloat16)
        return _o_proj(params, out, group), cache

    cache = cache.update(k.to(torch.float32), v.to(torch.float32), positions)
    if use_flash_prefill:
        from ..ops.flash_prefill import flash_prefill_gqa
        out = flash_prefill_gqa(q, cache.k_q, cache.k_s, cache.v_q,
                                cache.v_s, prefill_start, seq_lens)
    else:
        out = _fallback(q, cache, positions.to(q.device), seq_lens, heads,
                        g, hd, head_offset)
    out = out.reshape(b, s, heads * hd).to(torch.bfloat16)
    return _o_proj(params, out, group), cache


def _o_proj(params: AttentionParams, out: torch.Tensor, group):
    """The o-projection; under tensor parallelism this shard's partial in
    f32, summed over ``group``, then cast to bf16."""
    if group is None:
        return params.wo(out)
    from ..parallel.mesh import psum
    return psum(params.wo(out, out_dtype=torch.float32),
                group).to(torch.bfloat16)
