"""The system under test: the port's serving ``Engine`` over a configuration.

The only module of the benchmark that imports ``deepgemm_ascend_tpu_torch``.
It maps a configuration file's published keys onto the port's
``ModelConfig``, loads the seeded weights through the port's own
``models.loader.load_params`` (the path a checkpoint takes), re-quantizes
the routed experts where the configuration's precision asks for it, and
builds the ``Engine`` with the cell's settings.
"""

from __future__ import annotations

import dataclasses

import torch

from deepgemm_ascend_tpu_torch.models.config import ModelConfig
from deepgemm_ascend_tpu_torch.models.loader import load_params
from deepgemm_ascend_tpu_torch.models.model import params_with_int8_experts
from deepgemm_ascend_tpu_torch.serving.engine import Engine

from benchmark.weights import SeededState, Shapes

FP8_BLOCK = 128


def dense_width(hf: dict) -> int:
    """The dense FFN's width as the port is given it: the published width,
    rounded up to the fp8 block where it is not a multiple of it."""
    inter = hf["intermediate_size"]
    return -(-inter // FP8_BLOCK) * FP8_BLOCK


# Published keys that reach the port's ``ModelConfig`` as the field of the
# same name once it declares one. Until then a value that asks for what the
# port always does differently is refused, in these words.
PASSED_THROUGH = {
    "norm_topk_prob": (lambda v, s: bool(s.experts) and not v,
                       "the port's router renormalizes its top-k weights"),
    "scoring_func": (lambda v, s: v != "softmax",
                     "the port's router scores with a softmax"),
    "sliding_window": (lambda v, s: bool(v), "the port attends the whole context"),
}
ROUTED_EXPERTS = ("fp8", "int8")


def passed_through(hf: dict, s: Shapes) -> dict:
    """The ``PASSED_THROUGH`` keys that the configuration holds with a value
    and ``ModelConfig`` declares, as published; raises where one that it
    does not declare asks for something else than the port does."""
    declared = {f.name for f in dataclasses.fields(ModelConfig)}
    out = {}
    for key, (differs, refusal) in PASSED_THROUGH.items():
        value = hf.get(key)
        if value is None:
            continue
        if key in declared:
            out[key] = value
        elif differs(value, s):
            raise ValueError(refusal)
    return out


def routed_experts(hf: dict) -> str:
    """The routed experts' precision: ``precision.routed_experts``, fp8
    where the configuration does not say."""
    prec = hf.get("precision", {}).get("routed_experts", "fp8")
    if prec not in ROUTED_EXPERTS:
        raise ValueError(f"precision.routed_experts is {prec!r}; the port serves "
                         f"routed experts in {' or '.join(ROUTED_EXPERTS)}")
    return prec


def model_config(hf: dict) -> ModelConfig:
    s = Shapes(hf)
    return ModelConfig(
        vocab_size=s.vocab, hidden_size=s.hidden, num_layers=s.layers,
        num_heads=s.heads, num_kv_heads=s.kv_heads, head_dim=s.head_dim,
        num_experts=s.experts, num_shared_experts=s.shared, top_k=s.top_k,
        moe_intermediate=s.moe_inter, first_dense_layers=s.first_dense,
        dense_intermediate=dense_width(hf), rope_theta=float(hf["rope_theta"]),
        rms_eps=float(hf["rms_norm_eps"]),
        max_seq_len=int(hf["serving"]["max_seq_len"]), **passed_through(hf, s))


def build(hf: dict, cell: dict, seed: int, device) -> Engine:
    cfg = model_config(hf)
    experts = routed_experts(hf)
    state = SeededState(hf, seed, device, pad_dense_to=cfg.dense_intermediate)
    params = load_params(state, cfg, device=device)
    state.release()
    if experts == "int8":
        params = params_with_int8_experts(params)
    srv = hf["serving"]
    return Engine(params, cfg, max_slots=int(cell["max_slots"]),
                  max_seq_len=int(srv["max_seq_len"]), eos_id=srv.get("eos_id"),
                  temperature=float(srv.get("temperature", 0.0)),
                  decode_chunk=int(srv.get("decode_chunk", 1)), seed=seed,
                  prefix_cache_slots=int(cell.get("prefix_cache_slots", 0)),
                  device=device)


def engine_counters(engine: Engine) -> dict:
    """The program's own counts: ``Engine.stats`` and the metrics registry
    (``utils.logging.metrics``), in one flat dict."""
    from deepgemm_ascend_tpu_torch.utils.logging import metrics
    out = {f"stats.{k}": float(v) for k, v in engine.stats.items()}
    out.update({f"metrics.{k}": float(v) for k, v in metrics.snapshot().items()})
    return out


def free(engine: Engine) -> None:
    """Drop the engine's parameters, caches and captured graph."""
    engine._graph = None
    engine.params = None
    engine.caches = None
    if hasattr(engine, "_prefix_store"):
        engine._prefix_store = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
