"""Plain reference of the configurations' decoders, in float32.

The published architecture of a Hugging Face config (DeepSeekMoE and
Mistral, both Llama-style decoders): RMSNorm, rotary attention with grouped
KV heads, a SwiGLU FFN that is dense or a softmax-routed mixture of experts
with shared experts. It runs whole sequences with no cache, no kernels and
no batching of requests, a layer at a time over all of them, each layer's
weights made again from the seed (:mod:`benchmark.weights`). TF32 is off.

The configuration's precision is applied where it states it, by
:mod:`benchmark.reference.quant`: every projection's and expert's weight in
blocks and its input in groups (``prec.weight``, ``prec.act``), and the keys
and values per token and head as a cache holds them (``prec.kv``). Router,
embedding, norms and head stay at their bfloat16 weights. Activations are
bfloat16 between operations, as a bfloat16 checkpoint is served: each
operation computes in float32 and rounds its result once (:func:`_bf`).

Nothing here imports ``jax``, the JAX package or the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from benchmark.reference import quant
from benchmark.weights import SeededState, Shapes


@dataclasses.dataclass(frozen=True)
class Precision:
    weight: str
    act: str
    kv: str


STATED = Precision("fp8", "fp8", "int8")
CONTROL = Precision("int4", "int4", "int4")


def _bf(x: torch.Tensor) -> torch.Tensor:
    """A float32 result rounded to the bfloat16 it is passed on in."""
    return x.to(torch.bfloat16).to(torch.float32)


class _Linear:
    def __init__(self, w: torch.Tensor, prec: Precision):
        self.w = quant.weight(w, prec.weight)
        self.prec = prec

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _bf(quant.act(x, self.prec.act) @ self.w.t())


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalized in float32 and rounded, then scaled by the weight."""
    return _bf(_bf(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)) * w.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (s, heads, d), positions 0..s-1; halves rotated (rotate_half)."""
    s, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mlp(group: dict, prefix: str, prec: Precision):
    gate = _Linear(group[prefix + "gate_proj.weight"], prec)
    up = _Linear(group[prefix + "up_proj.weight"], prec)
    down = _Linear(group[prefix + "down_proj.weight"], prec)
    return lambda h: down(_bf(torch.nn.functional.silu(gate(h)) * up(h)))


class Reference:
    def __init__(self, hf: dict, seed: int, device, prec: Precision = STATED):
        self.hf = hf
        self.s = Shapes(hf)
        self.state = SeededState(hf, seed, device)
        self.prec = prec
        self.device = torch.device(device)

    def _prepare(self, layer: int) -> dict:
        """The layer's weights as the precision leaves them, made once."""
        s, prec, st = self.s, self.prec, self.state
        g = st.group(layer, "attn")
        w = {n: _Linear(g[f"self_attn.{n}_proj.weight"], prec) for n in "qkvo"}
        w["norms"] = st.group(layer, "norms")
        if not s.is_moe(layer):
            w["dense"] = _mlp(st.group(layer, "dense"), "mlp.", prec)
            return w
        w["router"] = st.group(layer, "router")["mlp.gate.weight"].float()
        ex = st.group(layer, "experts")
        w["experts"] = [_mlp(ex, f"mlp.experts.{e}.", prec) for e in range(s.experts)]
        if s.shared:
            w["shared"] = _mlp(st.group(layer, "shared"), "mlp.shared_experts.", prec)
        st.release()
        return w

    def _attention(self, w: dict, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        s, prec, hf = self.s, self.prec, self.hf
        norm = w["norms"]["input_layernorm.weight"]
        wq, wk, wv, wo = w["q"], w["k"], w["v"], w["o"]
        rep = s.heads // s.kv_heads
        out = []
        for x in xs:
            n = x.shape[0]
            h = _rms(x, norm, hf["rms_norm_eps"])
            q = _bf(_rope(wq(h).view(n, s.heads, s.head_dim), hf["rope_theta"]))
            k = _bf(_rope(wk(h).view(n, s.kv_heads, s.head_dim), hf["rope_theta"]))
            v = wv(h).view(n, s.kv_heads, s.head_dim)
            k, v = quant.per_row(k, prec.kv), quant.per_row(v, prec.kv)
            k = k.repeat_interleave(rep, dim=1).transpose(0, 1)    # (H, n, d)
            v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
            a = torch.empty((s.heads, n, s.head_dim), device=x.device)
            causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
            for h0 in range(0, s.heads, 4):
                qh = q[:, h0:h0 + 4].transpose(0, 1)
                sc = (qh @ k[h0:h0 + 4].transpose(1, 2)) / s.head_dim ** 0.5
                sc = sc.masked_fill(~causal, float("-inf"))
                a[h0:h0 + 4] = torch.softmax(sc, dim=-1) @ v[h0:h0 + 4]
            out.append(_bf(x + wo(_bf(a.transpose(0, 1).reshape(n, -1)))))
        return out

    def _ffn(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        s = self.s
        h = _rms(x, w["norms"]["post_attention_layernorm.weight"], self.hf["rms_norm_eps"])
        if "dense" in w:
            return _bf(x + w["dense"](h))
        scores = torch.softmax(_bf(h @ w["router"].t()), dim=-1)
        wt, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        wt, idx = wt[:, :s.top_k], idx[:, :s.top_k]
        if self.hf.get("norm_topk_prob", False):
            wt = wt / wt.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        for e, expert in enumerate(w["experts"]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                out.index_add_(0, tok, expert(h[tok]) * wt[tok, slot, None])
        if "shared" in w:
            out += w["shared"](h)
        return _bf(x + _bf(out))

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               wanted: Sequence[Sequence[int]], *, rows: int = 4096) -> List[torch.Tensor]:
        """Next-token logits (len(wanted[i]), vocab) of each sequence at the
        positions ``wanted[i]``; the FFN runs in blocks of ``rows`` tokens."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            embed = self.state.group(-1, "embed")["model.embed_tokens.weight"]
            xs = [embed[torch.as_tensor(list(t), device=self.device)].float()
                  for t in seqs]
            self.state.release()
            for layer in range(self.s.layers):
                w = self._prepare(layer)
                xs = self._attention(w, xs)
                flat = torch.cat(xs)
                flat = torch.cat([self._ffn(w, flat[i:i + rows])
                                  for i in range(0, flat.shape[0], rows)])
                xs = list(torch.split(flat, [x.shape[0] for x in xs]))
                del w
                self.state.release()
            norm = self.state.group(-1, "norms")["model.norm.weight"]
            head = self.state.group(-1, "head")["lm_head.weight"].float()
            out = []
            for x, pos in zip(xs, wanted):
                h = _rms(x[torch.as_tensor(list(pos), device=self.device)], norm,
                         self.hf["rms_norm_eps"])
                out.append(h @ head.t())
            self.state.release()
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
