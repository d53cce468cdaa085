"""The system under test: the port's serving ``Engine`` over a configuration.

The only module of the benchmark that imports ``deepgemm_ascend_tpu_torch``.
It maps a configuration file's published keys onto the port's
``ModelConfig``, loads the seeded weights through the port's own
``models.loader.load_params`` (the path a checkpoint takes) and builds the
``Engine`` with the cell's settings.
"""

from __future__ import annotations

import torch

from deepgemm_ascend_tpu_torch.models.config import ModelConfig
from deepgemm_ascend_tpu_torch.models.loader import load_params
from deepgemm_ascend_tpu_torch.serving.engine import Engine

from benchmark.weights import SeededState, Shapes

FP8_BLOCK = 128


def dense_width(hf: dict) -> int:
    """The dense FFN's width as the port is given it: the published width,
    rounded up to the fp8 block where it is not a multiple of it."""
    inter = hf["intermediate_size"]
    return -(-inter // FP8_BLOCK) * FP8_BLOCK


def model_config(hf: dict) -> ModelConfig:
    s = Shapes(hf)
    if hf.get("scoring_func", "softmax") != "softmax":
        raise ValueError("the port's router scores with a softmax")
    if s.experts and not hf.get("norm_topk_prob", True):
        raise ValueError("the port's router renormalizes its top-k weights")
    if hf.get("sliding_window"):
        raise ValueError("the port attends the whole context")
    return ModelConfig(
        vocab_size=s.vocab, hidden_size=s.hidden, num_layers=s.layers,
        num_heads=s.heads, num_kv_heads=s.kv_heads, head_dim=s.head_dim,
        num_experts=s.experts, num_shared_experts=s.shared, top_k=s.top_k,
        moe_intermediate=s.moe_inter, first_dense_layers=s.first_dense,
        dense_intermediate=dense_width(hf), rope_theta=float(hf["rope_theta"]),
        rms_eps=float(hf["rms_norm_eps"]),
        max_seq_len=int(hf["serving"]["max_seq_len"]))


def build(hf: dict, cell: dict, seed: int, device) -> Engine:
    cfg = model_config(hf)
    state = SeededState(hf, seed, device, pad_dense_to=cfg.dense_intermediate)
    params = load_params(state, cfg, device=device)
    state.release()
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
