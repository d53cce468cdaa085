"""Checkpoint loading: HF-style state dict → quantized ModelParams.

Port of ``deepgemm_ascend_tpu/models/loader.py``. A user switching from a
torch serving stack brings DeepSeek-V2-Lite-style weights (HF naming, torch
``(out, in)`` Linear layout) and gets the FP8-quantized parameters this
package serves. Quantization happens at load time, on the device given:
every large matmul weight is blockwise-FP8-quantized (128×128 scales,
``ops/quant.py``); routers, norms and embeddings stay bf16.

The HF ``(out, in)`` layout is already the port's weight layout (K-major,
``models/layers.py``), so the weights are quantized as they come: the
128×128 blocks are square, so the bytes and scales are the transpose of
what the JAX package's loader makes from ``Wᵀ``, and equal, byte for byte,
to its parameters carried over by ``models/convert.params_from_numpy``.

Name map (HF → ModelParams):
  model.embed_tokens.weight                      → embed
  model.norm.weight                              → final_norm
  lm_head.weight                                 → lm_head (transposed)
  model.layers.{i}.input_layernorm.weight        → layers[i].attn_norm
  model.layers.{i}.post_attention_layernorm.weight → layers[i].ffn_norm
  model.layers.{i}.self_attn.{q,k,v,o}_proj.weight → layers[i].attn.w{q,k,v,o}
  dense FFN:  .mlp.{gate,up,down}_proj.weight    → DenseFFN (gate∥up fused)
  MoE:        .mlp.gate.weight                   → router
              .mlp.experts.{e}.{gate,up,down}_proj.weight → ExpertWeights
              .mlp.shared_experts.{gate,up,down}_proj.weight → shared_w{1,2}

Quantized parameters persist with ``torch.save`` as nested dicts of
tensors (:func:`save_quantized`) and load back with ``torch.load(...,
weights_only=True)`` (:func:`load_quantized`) where the JAX package uses
orbax.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from ..ops import quant
from ..utils.common import resolve_device
from ..utils.logging import metrics
from .attention import AttentionParams
from .config import ModelConfig
from .layers import BF16Linear, Fp8Linear
from .model import DenseFFN, LayerParams, ModelParams
from .moe import ExpertWeights, Int8ExpertWeights, MoEParams

__all__ = ["load_params", "load_safetensors", "save_quantized",
           "load_quantized"]


def _fp8_linear(w_out_in: torch.Tensor) -> Fp8Linear:
    """torch Linear weight (out, in) f32 → Fp8Linear computing x @ Wᵀ."""
    w_q, w_s = quant.quantize_fp8_weight(w_out_in)
    return Fp8Linear(w_q=w_q, scales=w_s)


def _fused_w1(gate: torch.Tensor, up: torch.Tensor) -> Fp8Linear:
    """gate_proj (inter, hidden) + up_proj → fused (2·inter, hidden), gate
    first (the split order of ``moe._swiglu``)."""
    return _fp8_linear(torch.cat([gate, up], dim=0))


def load_params(state: Mapping[str, Any], cfg: ModelConfig, *,
                device="cuda") -> ModelParams:
    """Build quantized ModelParams on ``device`` from an HF-style state dict
    (numpy arrays or tensors of any float type). Its host seconds are
    added to the counter ``setup.load_params_s``."""
    with metrics.timer("setup.load_params_s"):
        return _load_params(state, cfg, resolve_device(device))


def _load_params(state: Mapping[str, Any], cfg: ModelConfig,
                 dev: torch.device) -> ModelParams:

    def get(name: str) -> torch.Tensor:
        if name not in state:
            raise KeyError(f"checkpoint missing tensor {name!r}")
        x = state[name]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(device=dev, dtype=torch.float32)

    def bf16(name: str) -> torch.Tensor:
        return get(name).to(torch.bfloat16)

    layers: List[LayerParams] = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        attn = AttentionParams(
            wq=_fp8_linear(get(p + "self_attn.q_proj.weight")),
            wk=_fp8_linear(get(p + "self_attn.k_proj.weight")),
            wv=_fp8_linear(get(p + "self_attn.v_proj.weight")),
            wo=_fp8_linear(get(p + "self_attn.o_proj.weight")),
        )
        if i < cfg.first_dense_layers:
            ffn: object = DenseFFN(
                w1=_fused_w1(get(p + "mlp.gate_proj.weight"),
                             get(p + "mlp.up_proj.weight")),
                w2=_fp8_linear(get(p + "mlp.down_proj.weight")),
            )
        else:
            def experts(part: str) -> torch.Tensor:
                return torch.stack([
                    get(p + f"mlp.experts.{j}.{part}_proj.weight")
                    for j in range(cfg.num_experts)])
            # (E, 2·inter, hidden) and (E, hidden, inter): K-major.
            w1_q, w1_s = quant.quantize_fp8_weight(
                torch.cat([experts("gate"), experts("up")], dim=1))
            w2_q, w2_s = quant.quantize_fp8_weight(experts("down"))
            shared_w1 = shared_w2 = None
            if cfg.num_shared_experts:
                shared_w1 = _fused_w1(
                    get(p + "mlp.shared_experts.gate_proj.weight"),
                    get(p + "mlp.shared_experts.up_proj.weight"))
                shared_w2 = _fp8_linear(
                    get(p + "mlp.shared_experts.down_proj.weight"))
            ffn = MoEParams(
                router=BF16Linear(w=bf16(p + "mlp.gate.weight").t()
                                  .contiguous()),
                experts=ExpertWeights(w1_q=w1_q, w1_s=w1_s, w2_q=w2_q,
                                      w2_s=w2_s),
                shared_w1=shared_w1, shared_w2=shared_w2)
        layers.append(LayerParams(
            attn_norm=bf16(p + "input_layernorm.weight"), attn=attn,
            ffn_norm=bf16(p + "post_attention_layernorm.weight"), ffn=ffn))

    return ModelParams(
        embed=bf16("model.embed_tokens.weight"), layers=layers,
        final_norm=bf16("model.norm.weight"),
        lm_head=bf16("lm_head.weight").t().contiguous())


def load_safetensors(paths: Union[Sequence[str], str], cfg: ModelConfig, *,
                     device="cuda") -> ModelParams:
    """Load from one or more .safetensors shards (HF checkpoint layout).
    The tensors are read as torch tensors, so bf16 checkpoints load too."""
    from safetensors import safe_open

    if isinstance(paths, (str, bytes)):
        paths = [paths]
    state: dict = {}
    for path in paths:
        with safe_open(path, framework="pt") as f:
            for name in f.keys():
                state[name] = f.get_tensor(name)
    return load_params(state, cfg, device=device)


# ---- quantized-checkpoint persistence -------------------------------------
# Quantize once, serve many times: converting an HF checkpoint re-runs the
# fp8 quantizer over every weight; the quantized parameters make a cold
# start a read.

_KINDS = {cls.__name__: cls for cls in (
    ModelParams, LayerParams, AttentionParams, DenseFFN, MoEParams,
    ExpertWeights, Int8ExpertWeights, Fp8Linear, BF16Linear)}


def _to_tree(obj):
    """Parameters → nested dicts of tensors (each dataclass tagged with its
    class name; fields that are not tensors or parameters, such as
    ``MoEParams.token_chunk``, are left to their defaults)."""
    if isinstance(obj, torch.Tensor) or obj is None:
        return obj
    if isinstance(obj, list):
        return [_to_tree(o) for o in obj]
    tree: Dict[str, Any] = {"kind": type(obj).__name__}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (torch.Tensor, list)) or v is None or \
                dataclasses.is_dataclass(v):
            tree[f.name] = _to_tree(v)
    return tree


def _from_tree(tree):
    if isinstance(tree, torch.Tensor) or tree is None:
        return tree
    if isinstance(tree, list):
        return [_from_tree(t) for t in tree]
    fields = {k: _from_tree(v) for k, v in tree.items() if k != "kind"}
    return _KINDS[tree["kind"]](**fields)


def save_quantized(params: ModelParams, path: str) -> None:
    """Write the quantized parameters to ``path`` (one ``torch.save`` file;
    every tensor keeps its dtype and bytes)."""
    torch.save(_to_tree(params), path)


def load_quantized(path: str, cfg: ModelConfig, *,
                   device="cuda") -> ModelParams:
    """Restore parameters written by :func:`save_quantized` onto
    ``device``, bit for bit, and check their depth against ``cfg``."""
    dev = resolve_device(device)
    params = _from_tree(torch.load(path, map_location=dev,
                                   weights_only=True))
    if len(params.layers) != cfg.num_layers:
        raise ValueError(f"checkpoint has {len(params.layers)} layers, "
                         f"config {cfg.num_layers}")
    return params
