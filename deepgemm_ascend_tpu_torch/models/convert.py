"""Parameters of the JAX package, carried into the port without a lost bit.

No JAX twin. :func:`params_from_numpy` takes the JAX package's
``ModelParams`` as nested dicts of numpy arrays — one dict per dataclass,
keyed by field name, a list for ``layers``, ``None`` for an absent shared
expert — with fp8 arrays as ``uint8`` views and bf16 arrays as ``uint16``
views, so no value is rounded on the way. The port never sees a JAX
object: whoever holds the JAX parameters (the tests) builds the tree.

The layouts differ, and are mapped here:

* ``Fp8Linear``: JAX (in, out) weights with a lane-expanded (in/128, out)
  scale panel → K-major (out, in) weights with compact (out/128, in/128)
  scales (the panel's columns are constant over each 128 block; taking
  every 128th column compacts it, and the check below refuses a panel that
  is not so);
* ``ExpertWeights``: (E, in, out) + (E, in/128, out) → (E, out, in) +
  (E, out/128, in/128), the same way per expert;
* ``Int8ExpertWeights`` (told apart by their int8 weights, which travel as
  they are): (E, in, out) → (E, out, in); the per-channel (E, 1, out)
  scales keep their layout;
* embeddings, norms, router and lm_head keep their layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.quant import BLOCK, FP8
from ..utils.common import resolve_device
from .attention import AttentionParams
from .config import ModelConfig
from .layers import BF16Linear, Fp8Linear
from .model import DenseFFN, LayerParams, ModelParams
from .moe import ExpertWeights, Int8ExpertWeights, MoEParams


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    if a.dtype != np.uint16:
        raise ValueError(f"bf16 arrays travel as uint16 views, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(
        torch.bfloat16).to(dev)


def _fp8(a: np.ndarray, dev) -> torch.Tensor:
    if a.dtype != np.uint8:
        raise ValueError(f"fp8 arrays travel as uint8 views, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).view(FP8).to(dev)


def _compact_panel(panel: np.ndarray) -> np.ndarray:
    """(…, kb, n) lane-expanded scales → (…, n/128, kb) compact, transposed."""
    panel = np.asarray(panel, np.float32)
    compact = panel[..., ::BLOCK]
    if not np.array_equal(np.repeat(compact, BLOCK, axis=-1)
                          [..., :panel.shape[-1]], panel):
        raise ValueError("scale panel is not constant over 128-column blocks")
    return np.ascontiguousarray(np.swapaxes(compact, -1, -2))


def _fp8_linear(d: Dict[str, Any], dev) -> Fp8Linear:
    w_q = np.swapaxes(d["w_q"], -1, -2)                     # (out, in)
    return Fp8Linear(w_q=_fp8(w_q, dev),
                     scales=torch.from_numpy(
                         _compact_panel(d["scales_exp"])).to(dev))


def _experts(d: Dict[str, Any], dev):
    if d["w1_q"].dtype == np.int8:
        def kmajor(w):
            return torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(w, -1, -2))).to(dev)

        def f32(s):
            return torch.from_numpy(np.array(s, np.float32)).to(dev)
        return Int8ExpertWeights(w1_q=kmajor(d["w1_q"]), w1_s=f32(d["w1_s"]),
                                 w2_q=kmajor(d["w2_q"]), w2_s=f32(d["w2_s"]))

    def scales(panel):
        return torch.from_numpy(_compact_panel(panel)).to(dev)
    return ExpertWeights(
        w1_q=_fp8(np.swapaxes(d["w1_q"], -1, -2), dev),
        w1_s=scales(d["w1_s"]),
        w2_q=_fp8(np.swapaxes(d["w2_q"], -1, -2), dev),
        w2_s=scales(d["w2_s"]))


def _ffn(d: Dict[str, Any], dev):
    if "router" in d:
        return MoEParams(
            router=BF16Linear(w=_bf16(d["router"]["w"], dev)),
            experts=_experts(d["experts"], dev),
            shared_w1=(_fp8_linear(d["shared_w1"], dev)
                       if d.get("shared_w1") is not None else None),
            shared_w2=(_fp8_linear(d["shared_w2"], dev)
                       if d.get("shared_w2") is not None else None))
    return DenseFFN(w1=_fp8_linear(d["w1"], dev),
                    w2=_fp8_linear(d["w2"], dev))


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cuda") -> ModelParams:
    """The port's ``ModelParams`` from the JAX package's parameters given as
    nested dicts of numpy arrays (see the module docstring)."""
    dev = resolve_device(device)
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"{cfg.num_layers}")
    layers = []
    for lt in tree["layers"]:
        a = lt["attn"]
        layers.append(LayerParams(
            attn_norm=_bf16(lt["attn_norm"], dev),
            attn=AttentionParams(wq=_fp8_linear(a["wq"], dev),
                                 wk=_fp8_linear(a["wk"], dev),
                                 wv=_fp8_linear(a["wv"], dev),
                                 wo=_fp8_linear(a["wo"], dev)),
            ffn_norm=_bf16(lt["ffn_norm"], dev),
            ffn=_ffn(lt["ffn"], dev)))
    return ModelParams(embed=_bf16(tree["embed"], dev), layers=layers,
                       final_norm=_bf16(tree["final_norm"], dev),
                       lm_head=_bf16(tree["lm_head"], dev))
