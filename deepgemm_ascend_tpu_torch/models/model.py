"""DeepSeek-V2-Lite-style MoE decoder model (the flagship serving model).

Port of ``deepgemm_ascend_tpu/models/model.py``. ``init_params`` builds the
quantized parameters on the device from a ``torch.Generator``;
``params_with_int8_experts`` re-quantizes the MoE experts to W8A8 int8;
``forward`` runs prefill or decode over an int8 KV cache, updating it in
place. The first ``first_dense_layers`` layers use a dense SwiGLU FFN, the
rest MoE. Under a running ``torch.profiler`` each layer's attention and FFN
are the spans ``model.attention`` and ``model.ffn``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from ..utils.common import resolve_device
from ..utils.logging import span
from .attention import AttentionParams, KVCache, attention
from .config import ModelConfig
from .layers import Fp8Linear, rms_norm
from .moe import (ExpertWeights, MoEParams, _swiglu,
                  int8_experts_from_fp8, moe_block)


@dataclasses.dataclass
class DenseFFN:
    w1: Fp8Linear     # hidden → 2·inter
    w2: Fp8Linear     # inter → hidden

    @classmethod
    def create(cls, generator: torch.Generator, hidden: int, inter: int, *,
               device) -> "DenseFFN":
        return cls(w1=Fp8Linear.create(generator, hidden, 2 * inter,
                                       device=device),
                   w2=Fp8Linear.create(generator, inter, hidden,
                                       device=device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(_swiglu(self.w1(x)))


@dataclasses.dataclass
class LayerParams:
    attn_norm: torch.Tensor
    attn: AttentionParams
    ffn_norm: torch.Tensor
    ffn: Union[DenseFFN, MoEParams]


@dataclasses.dataclass
class ModelParams:
    embed: torch.Tensor       # (vocab, hidden) bf16
    layers: List[LayerParams]
    final_norm: torch.Tensor
    lm_head: torch.Tensor     # (hidden, vocab) bf16

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
                device="cuda") -> ModelParams:
    """Random quantized parameters, built on ``device`` from ``seed`` (an int
    or a ``torch.Generator`` on that device)."""
    dev = resolve_device(device)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(seed)))
    ones = lambda: torch.ones((cfg.hidden_size,), dtype=torch.bfloat16,
                              device=dev)
    layers = []
    for i in range(cfg.num_layers):
        attn = AttentionParams.create(gen, cfg, device=dev)
        if i < cfg.first_dense_layers:
            ffn = DenseFFN.create(gen, cfg.hidden_size,
                                  cfg.dense_intermediate, device=dev)
        else:
            ffn = MoEParams.create(gen, cfg, device=dev)
        layers.append(LayerParams(attn_norm=ones(), attn=attn,
                                  ffn_norm=ones(), ffn=ffn))

    def table(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
    return ModelParams(embed=table((cfg.vocab_size, cfg.hidden_size)),
                       layers=layers, final_norm=ones(),
                       lm_head=table((cfg.hidden_size, cfg.vocab_size)))


def params_with_int8_experts(params: ModelParams) -> ModelParams:
    """Re-quantize every MoE layer's fp8 experts to W8A8 int8
    (:func:`moe.int8_experts_from_fp8`), layer by layer on the parameters'
    device. Dense-FFN layers, the shared experts and experts that are
    already int8 pass through unchanged (the same tensors)."""

    def conv(layer: LayerParams) -> LayerParams:
        ffn = layer.ffn
        if isinstance(ffn, MoEParams) and isinstance(ffn.experts,
                                                     ExpertWeights):
            ffn = dataclasses.replace(
                ffn, experts=int8_experts_from_fp8(ffn.experts))
        return dataclasses.replace(layer, ffn=ffn)

    return dataclasses.replace(params,
                               layers=[conv(l) for l in params.layers])


def init_cache(cfg: ModelConfig, batch: int, max_seq: Optional[int] = None,
               *, device="cuda") -> List[KVCache]:
    dev = resolve_device(device)
    max_seq = max_seq or cfg.max_seq_len
    return [KVCache.create(batch, max_seq, cfg.num_kv_heads, cfg.head_dim,
                           device=dev)
            for _ in range(cfg.num_layers)]


def forward(
    params: ModelParams,
    tokens: torch.Tensor,          # (batch, s) int
    caches: List[KVCache],
    positions: torch.Tensor,       # (batch, s) int
    seq_lens: torch.Tensor,        # (batch,) valid length AFTER this step
    cfg: ModelConfig,
    prefill_start: Optional[torch.Tensor] = None,
    *,
    attn_kw: Optional[dict] = None,
    moe_kw: Optional[dict] = None,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """Returns (logits (batch, s, vocab) f32, caches updated in place).

    ``prefill_start`` (batch,) asserts positions are consecutive from it
    (row i at prefill_start + i) — enables the flash prefill kernel.
    ``attn_kw`` / ``moe_kw``: a mesh shard's arguments of every layer's
    :func:`attention` and :func:`moe_block` (``parallel/sharded.py``); its
    logits are then those of its ``lm_head`` columns.
    """
    b, s = tokens.shape
    x = params.embed[tokens.to(torch.int64)]          # (b, s, hidden) bf16
    new_caches = []
    for layer, cache in zip(params.layers, caches):
        h = rms_norm(x, layer.attn_norm, cfg.rms_eps)
        with span("model.attention"):
            attn_out, cache = attention(layer.attn, h, cache, positions,
                                        seq_lens, cfg,
                                        prefill_start=prefill_start,
                                        **(attn_kw or {}))
        new_caches.append(cache)
        x = x + attn_out
        h = rms_norm(x, layer.ffn_norm, cfg.rms_eps)
        with span("model.ffn"):
            if isinstance(layer.ffn, MoEParams):
                flat = h.reshape(b * s, cfg.hidden_size)
                ffn_out = moe_block(layer.ffn, flat, cfg,
                                    **(moe_kw or {})).reshape(b, s, -1)
            else:
                ffn_out = layer.ffn(h)
        x = x + ffn_out
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    logits = torch.matmul(x.to(torch.float32),
                          params.lm_head.to(torch.float32))
    return logits, new_caches


def decode_step(
    params: ModelParams,
    tokens: torch.Tensor,          # (batch,) int — one token per sequence
    caches: List[KVCache],
    seq_lens: torch.Tensor,        # (batch,) length BEFORE this step
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """One decode step: returns (next-token logits (batch, vocab), caches)."""
    positions = seq_lens[:, None]                      # write slot
    logits, caches = forward(params, tokens[:, None], caches, positions,
                             seq_lens + 1, cfg)
    return logits[:, 0], caches


def generate_greedy_scan(
    params: ModelParams,
    tokens: torch.Tensor,          # (batch,) int current tokens
    caches: List[KVCache],
    seq_lens: torch.Tensor,
    cfg: ModelConfig,
    steps: int,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """Greedy decode of ``steps`` tokens (a Python loop over
    :func:`decode_step`; the JAX package scans on the device).
    Returns (tokens (batch, steps) int32, caches)."""
    out = []
    toks, lens = tokens, seq_lens
    for _ in range(steps):
        logits, caches = decode_step(params, toks, caches, lens, cfg)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        lens = lens + 1
        out.append(toks)
    return torch.stack(out, dim=1), caches
