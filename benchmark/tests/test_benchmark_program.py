"""How a configuration file reaches the port: its published keys as the
port's ``ModelConfig`` and its routed experts' precision as the engine's
parameters (``benchmark/program.py``)."""

import dataclasses
import json
from pathlib import Path
from typing import Optional

import pytest

from deepgemm_ascend_tpu_torch.models.config import ModelConfig
from deepgemm_ascend_tpu_torch.models.moe import ExpertWeights, Int8ExpertWeights, MoEParams

from benchmark import program

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"


def _config(path: Path) -> dict:
    return json.loads(path.read_text())


def _stub(field: str, kind, default):
    """``ModelConfig`` with one more field, as a later port may declare it."""
    return dataclasses.make_dataclass(
        "ModelConfig", [(field, kind, dataclasses.field(default=default))],
        bases=(ModelConfig,), frozen=True)


@pytest.mark.parametrize("path, want", [
    (BENCH / "configs" / "mistral7b.json", ModelConfig(
        vocab_size=32768, hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, num_experts=0, num_shared_experts=0, top_k=0, moe_intermediate=0,
        first_dense_layers=32, dense_intermediate=14336, rope_theta=1000000.0,
        rms_eps=1e-05, max_seq_len=4096)),
    (DATA / "tiny_moe.json", ModelConfig(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
        head_dim=128, num_experts=8, num_shared_experts=1, top_k=2, moe_intermediate=128,
        first_dense_layers=1, dense_intermediate=384, rope_theta=10000.0, rms_eps=1e-06,
        max_seq_len=256)),
    (DATA / "tiny_dense.json", ModelConfig(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
        head_dim=128, num_experts=0, num_shared_experts=0, top_k=0, moe_intermediate=0,
        first_dense_layers=2, dense_intermediate=384, rope_theta=1000000.0, rms_eps=1e-05,
        max_seq_len=256)),
], ids=["mistral7b", "tiny_moe", "tiny_dense"])
def test_model_config_field_by_field(path, want):
    got = program.model_config(_config(path))
    assert type(got) is ModelConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_dsmoe16b_builds_once_the_port_declares_norm_topk_prob(monkeypatch):
    hf = _config(DATA / "dsmoe16b.json")
    monkeypatch.setattr(program, "ModelConfig", _stub("norm_topk_prob", bool, True))
    cfg = program.model_config(hf)
    assert cfg.norm_topk_prob is False
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == (2048, 28, 16, 16, 128)
    assert (cfg.num_experts, cfg.num_shared_experts, cfg.top_k, cfg.moe_intermediate,
            cfg.dense_intermediate, cfg.first_dense_layers,
            cfg.vocab_size) == (64, 2, 6, 1408, 11008, 1, 102400)
    if "norm_topk_prob" in {f.name for f in dataclasses.fields(ModelConfig)}:
        monkeypatch.setattr(program, "ModelConfig", ModelConfig)
        real = program.model_config(hf)
        assert type(real) is ModelConfig
        assert dataclasses.asdict(real) == dataclasses.asdict(cfg)


# Each key of ``program.PASSED_THROUGH``: the file it is tried on, the
# value published that the port does not follow without the field, one
# that it follows, the field as a port would declare it, and the refusal.
PUBLISHED = {
    "norm_topk_prob": ("tiny_moe", False, True, bool, True, "renormalizes"),
    "scoring_func": ("tiny_moe", "sigmoid", "softmax", str, "softmax", "softmax"),
    "sliding_window": ("tiny_dense", 4096, None, Optional[int], None, "whole context"),
}


def _without(field: str):
    """``ModelConfig`` as a port that does not declare ``field`` has it: the
    same fields and defaults, less that one."""
    kept = [(f.name, f.type, dataclasses.field(default=f.default,
                                               default_factory=f.default_factory))
            for f in dataclasses.fields(ModelConfig) if f.name != field]
    return dataclasses.make_dataclass("ModelConfig", kept, frozen=True)


def _declaring(field: str, kind, default):
    """The port's ``ModelConfig`` where it declares ``field``, else the stub."""
    if field in {f.name for f in dataclasses.fields(ModelConfig)}:
        return ModelConfig
    return _stub(field, kind, default)


@pytest.mark.parametrize("branch", ["undeclared", "declared"])
@pytest.mark.parametrize("key", list(PUBLISHED))
def test_a_published_key_passes_through_where_the_port_declares_it(monkeypatch, key, branch):
    base, published, followed, kind, default, refusal = PUBLISHED[key]
    hf = dict(_config(DATA / f"{base}.json"), **{key: published})
    plain = dict(hf)
    del plain[key]
    if branch == "undeclared":
        monkeypatch.setattr(program, "ModelConfig", _without(key))
        with pytest.raises(ValueError, match=refusal):
            program.model_config(hf)
        got = program.model_config(dict(hf, **{key: followed}))
        assert not hasattr(got, key)
        assert dataclasses.asdict(got) == dataclasses.asdict(program.model_config(plain))
    else:
        cls = _declaring(key, kind, default)
        monkeypatch.setattr(program, "ModelConfig", cls)
        got = program.model_config(hf)
        assert type(got) is cls and getattr(got, key) == published
        field = {f.name: f for f in dataclasses.fields(cls)}[key]
        assert getattr(program.model_config(plain), key) == field.default


@pytest.mark.parametrize("experts, kind", [(None, ExpertWeights), ("fp8", ExpertWeights),
                                           ("int8", Int8ExpertWeights)])
def test_routed_experts_precision_reaches_the_engine(experts, kind):
    hf = _config(DATA / "tiny_moe.json")
    if experts is not None:
        hf["precision"] = {"weights": "fp8 e4m3", "routed_experts": experts}
    engine = program.build(hf, {"max_slots": 2}, 3, "cpu")
    moe = [layer.ffn for layer in engine.params.layers if isinstance(layer.ffn, MoEParams)]
    assert len(moe) == 1 and all(isinstance(f.experts, kind) for f in moe)


def test_an_unknown_routed_experts_precision_raises(monkeypatch):
    hf = dict(_config(DATA / "tiny_moe.json"), precision={"routed_experts": "int4"})
    monkeypatch.setattr(program, "load_params", lambda *a, **k: pytest.fail("loaded"))
    with pytest.raises(ValueError, match="int4"):
        program.build(hf, {"max_slots": 2}, 3, "cpu")
