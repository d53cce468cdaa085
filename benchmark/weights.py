"""A configuration's weights in the Hugging Face layout, made from the seed.

:class:`SeededState` is a lazy mapping from checkpoint names to tensors,
as a safetensors checkpoint would give them: bfloat16, torch ``(out, in)``
Linear layout. Each layer's tensors of one kind (attention, dense FFN,
routed experts, shared experts, router) come from one ``torch.randn``
call on the device, seeded from (seed, layer, kind), so any layer can be
made again alone and in any order: the program's loader takes them one
layer after another, and the reference makes each layer again after the
program's state is freed. Only the current layer's tensors are held.

``pad_dense_to`` hands the dense FFN over at a wider intermediate size,
with zero rows of gate and up and zero columns of down: the configuration
file says why.
"""

from __future__ import annotations

import hashlib
import re
from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import torch


def derive_seed(*parts) -> int:
    """A 63-bit generator seed from any whole numbers and strings."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


class Shapes:
    """The published shapes of a Hugging Face config (a dict)."""

    def __init__(self, hf: dict):
        self.hidden = hf["hidden_size"]
        self.layers = hf["num_hidden_layers"]
        self.heads = hf["num_attention_heads"]
        self.kv_heads = hf.get("num_key_value_heads", self.heads)
        self.head_dim = hf.get("head_dim") or self.hidden // self.heads
        self.vocab = hf["vocab_size"]
        self.inter = hf["intermediate_size"]
        self.experts = hf.get("n_routed_experts") or 0
        self.top_k = hf.get("num_experts_per_tok") or 0
        self.moe_inter = hf.get("moe_intermediate_size") or 0
        self.shared = hf.get("n_shared_experts") or 0
        self.first_dense = (hf.get("first_k_dense_replace", 0)
                            if self.experts else self.layers)
        self.std = hf.get("initializer_range", 0.02)

    def is_moe(self, layer: int) -> bool:
        return bool(self.experts) and layer >= self.first_dense

    def attn_shapes(self) -> Dict[str, Tuple[int, int]]:
        q, kv = self.heads * self.head_dim, self.kv_heads * self.head_dim
        return {"q_proj": (q, self.hidden), "k_proj": (kv, self.hidden),
                "v_proj": (kv, self.hidden), "o_proj": (self.hidden, q)}

    def mlp_shapes(self, inter: int) -> Dict[str, Tuple[int, int]]:
        return {"gate_proj": (inter, self.hidden), "up_proj": (inter, self.hidden),
                "down_proj": (self.hidden, inter)}


def _split(flat: torch.Tensor, shapes: Dict[str, Tuple[int, ...]]):
    out, i = {}, 0
    for name, shape in shapes.items():
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[i:i + n].view(shape)
        i += n
    return out


_LAYER = re.compile(r"model\.layers\.(\d+)\.(.*)")


class SeededState(Mapping):
    def __init__(self, hf: dict, seed: int, device, *,
                 pad_dense_to: Optional[int] = None):
        self.s = Shapes(hf)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.pad_dense_to = pad_dense_to
        self._held: Dict[Tuple[int, str], Dict[str, torch.Tensor]] = {}
        self._layer_held = None

    # -- generation -----------------------------------------------------------
    def _randn(self, n: int, layer, kind: str) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(derive_seed(self.seed, layer, kind))
        x = torch.randn((n,), generator=g, device=self.device,
                        dtype=torch.bfloat16)
        return x.mul_(self.s.std)

    def group(self, layer: int, kind: str) -> Dict[str, torch.Tensor]:
        """Every tensor of one kind in one layer (layer -1: the globals),
        keyed by its name inside the layer."""
        key = (layer, kind)
        if key in self._held:
            return self._held[key]
        if layer != self._layer_held:
            self._held.clear()
            self._layer_held = layer
        self._held[key] = out = self._make(layer, kind)
        return out

    def _make(self, layer: int, kind: str) -> Dict[str, torch.Tensor]:
        s, dev = self.s, self.device
        if kind == "norms":
            ones = lambda: torch.ones((s.hidden,), dtype=torch.bfloat16, device=dev)
            if layer < 0:
                return {"model.norm.weight": ones()}
            return {"input_layernorm.weight": ones(),
                    "post_attention_layernorm.weight": ones()}
        if kind == "embed":
            return {"model.embed_tokens.weight": self._randn(
                s.vocab * s.hidden, layer, kind).view(s.vocab, s.hidden)}
        if kind == "head":
            return {"lm_head.weight": self._randn(
                s.vocab * s.hidden, layer, kind).view(s.vocab, s.hidden)}
        if kind == "attn":
            shapes = {f"self_attn.{k}.weight": v for k, v in s.attn_shapes().items()}
        elif kind == "dense":
            shapes = {f"mlp.{k}.weight": v for k, v in s.mlp_shapes(s.inter).items()}
        elif kind == "shared":
            shapes = {f"mlp.shared_experts.{k}.weight": v
                      for k, v in s.mlp_shapes(s.moe_inter * s.shared).items()}
        elif kind == "router":
            shapes = {"mlp.gate.weight": (s.experts, s.hidden)}
        elif kind == "experts":
            shapes = {}
            for part, shape in s.mlp_shapes(s.moe_inter).items():
                shapes[part] = (s.experts, *shape)
            flat = _split(self._randn(sum(a * b * c for a, b, c in shapes.values()),
                                      layer, kind), shapes)
            return {f"mlp.experts.{e}.{part}.weight": flat[part][e]
                    for e in range(s.experts) for part in shapes}
        else:
            raise KeyError(kind)
        total = sum(a * b for a, b in shapes.values())
        out = _split(self._randn(total, layer, kind), shapes)
        if kind == "dense" and self.pad_dense_to and self.pad_dense_to != s.inter:
            extra = self.pad_dense_to - s.inter
            pad = torch.nn.functional.pad
            for k in ("mlp.gate_proj.weight", "mlp.up_proj.weight"):
                out[k] = pad(out[k], (0, 0, 0, extra))
            out["mlp.down_proj.weight"] = pad(out["mlp.down_proj.weight"], (0, extra))
        return out

    # -- the mapping ------------------------------------------------------------
    @staticmethod
    def _kind_of(rest: str) -> str:
        if rest.startswith("self_attn."):
            return "attn"
        if rest.endswith("layernorm.weight"):
            return "norms"
        if rest.startswith("mlp.experts."):
            return "experts"
        if rest.startswith("mlp.shared_experts."):
            return "shared"
        if rest == "mlp.gate.weight":
            return "router"
        return "dense"

    def __getitem__(self, name: str) -> torch.Tensor:
        m = _LAYER.fullmatch(name)
        if m is None:
            kind = {"model.embed_tokens.weight": "embed", "lm_head.weight": "head",
                    "model.norm.weight": "norms"}.get(name)
            if kind is None:
                raise KeyError(name)
            return self.group(-1, kind)[name]
        layer, rest = int(m.group(1)), m.group(2)
        if layer >= self.s.layers:
            raise KeyError(name)
        got = self.group(layer, self._kind_of(rest))
        if rest not in got:
            raise KeyError(name)
        return got[rest]

    def names(self) -> List[str]:
        s = self.s
        out = ["model.embed_tokens.weight", "model.norm.weight", "lm_head.weight"]
        for i in range(s.layers):
            p = f"model.layers.{i}."
            out += [p + "input_layernorm.weight", p + "post_attention_layernorm.weight"]
            out += [p + f"self_attn.{k}.weight" for k in s.attn_shapes()]
            if s.is_moe(i):
                out.append(p + "mlp.gate.weight")
                out += [p + f"mlp.experts.{e}.{k}.weight" for e in range(s.experts)
                        for k in s.mlp_shapes(1)]
                if s.shared:
                    out += [p + f"mlp.shared_experts.{k}.weight" for k in s.mlp_shapes(1)]
            else:
                out += [p + f"mlp.{k}.weight" for k in s.mlp_shapes(1)]
        return out

    def __iter__(self):
        return iter(self.names())

    def __len__(self) -> int:
        return len(self.names())

    def release(self) -> None:
        self._held.clear()
        self._layer_held = None
