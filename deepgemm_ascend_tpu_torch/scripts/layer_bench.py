"""Measure ONE full-size MoE decoder layer on the card.

Port of ``scripts/layer_bench.py``. One MoE decoder layer at real geometry
— ``v2_lite_full`` (all 64 experts resident, one card) and ``v3_style``
sliced to one expert-parallel shard (256/ep experts) — runs one decode
step (RMSNorm, GQA attention over the int8 cache through the in-place
flash decode, RMSNorm, the MoE block) per call, timed warm and back to
back (``bench.timing.time_fn``: CUDA events around the calls, then a
synchronize). It prints ms/layer and the naive full-model projection
tokens/s = batch / (num_layers × t_layer).

The shard computes its local experts' tokens only (``moe_block(
local_experts=, expert_offset=0)``, no sum across shards); attention and
the router run in full, as on one shard of a sharded decode step. The
layer's pieces come from one ``torch.Generator`` seeded 0, as
``AttentionParams.create`` and ``ExpertWeights.create`` take it.
``--expert-quant int8`` builds the experts as W8A8 int8.

    python -m deepgemm_ascend_tpu_torch.scripts.layer_bench \\
        --configs v2_lite_full:1 v3_style:32 --batch 64 --cache-len 2048
"""

from __future__ import annotations

import argparse

import torch

from ..bench import timing
from ..models.attention import AttentionParams, KVCache, attention
from ..models.config import TINY, V2_LITE_FULL, V3_STYLE
from ..models.layers import BF16Linear, rms_norm
from ..models.moe import ExpertWeights, Int8ExpertWeights, MoEParams, moe_block
from ..utils.common import resolve_device

CONFIGS = {"v2_lite_full": V2_LITE_FULL, "v3_style": V3_STYLE, "tiny": TINY}


def layer_bench(cfg, ep: int, batch: int, cache_len: int, expert_quant: str,
                dev, t_kw) -> dict:
    """Build one layer of ``cfg`` (the ep-shard's experts) and time its
    decode step; returns ms/layer and the projected tokens/s."""
    e_local = cfg.num_experts // ep
    s_len = min(cache_len, cfg.max_seq_len)
    gen = torch.Generator(device=dev).manual_seed(0)
    attn = AttentionParams.create(gen, cfg, device=dev)
    router = BF16Linear.create(gen, cfg.hidden_size, cfg.num_experts,
                               init_scale=0.02, device=dev)
    expert_cls = Int8ExpertWeights if expert_quant == "int8" else ExpertWeights
    experts = expert_cls.create(gen, e_local, cfg.hidden_size,
                                cfg.moe_intermediate, device=dev)
    moe = MoEParams(router=router, experts=experts, shared_w1=None,
                    shared_w2=None)
    norm = torch.ones((cfg.hidden_size,), dtype=torch.bfloat16, device=dev)
    cache = KVCache.create(batch, s_len, cfg.num_kv_heads, cfg.head_dim,
                           device=dev)
    x = (torch.randn((batch, 1, cfg.hidden_size), generator=gen, device=dev)
         * 0.1).to(torch.bfloat16)
    seq_lens = torch.full((batch,), s_len - 2, dtype=torch.int32, device=dev)
    positions = seq_lens[:, None]

    def layer_step(x):
        h = rms_norm(x, norm, cfg.rms_eps)
        attn_out, _ = attention(attn, h, cache, positions, seq_lens + 1, cfg)
        x1 = x + attn_out
        h2 = rms_norm(x1, norm, cfg.rms_eps)
        ffn = moe_block(moe, h2.reshape(batch, cfg.hidden_size), cfg,
                        local_experts=e_local, expert_offset=0)
        return x1 + ffn[:, None, :]

    t = timing.time_fn(layer_step, (x,), **t_kw)
    return {"e_local": e_local, "cache": s_len, "ms": t.seconds * 1e3,
            "tok_s": batch / (cfg.num_layers * t.seconds)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--cache-len", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--min-chain", type=float, default=0.25)
    ap.add_argument("--configs", nargs="*",
                    default=["v2_lite_full:1", "v3_style:32"],
                    help="name:ep pairs")
    ap.add_argument("--expert-quant", choices=["fp8", "int8"], default="fp8",
                    help="expert weight quantization: fp8 blockwise or W8A8 "
                         "int8 (models/moe.Int8ExpertWeights)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_kw = dict(iters=args.iters, repeats=2,
                min_chain_seconds=args.min_chain)
    for spec in args.configs:
        name, ep_s = spec.split(":")
        cfg = CONFIGS[name]
        r = layer_bench(cfg, int(ep_s), args.batch, args.cache_len,
                        args.expert_quant, dev, t_kw)
        print(f"[layer_bench] {name} ep={ep_s} (E_local={r['e_local']}) "
              f"experts={args.expert_quant} "
              f"batch={args.batch} cache={r['cache']}: {r['ms']:.3f} ms/layer "
              f"| projected full-model ({cfg.num_layers}L, this shard's "
              f"compute replicated): {r['tok_s']:.0f} tok/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
