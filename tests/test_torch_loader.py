"""The port's checkpoint loader (``models/loader.py``) against the JAX
package's, on the CPU.

The same synthetic HF-style state dict (numpy, from a seed) goes through
JAX's ``load_params`` — carried into the port by ``params_from_numpy``,
bit for bit — and through the port's ``load_params``: every fp8 weight and
scale must be byte-equal, every bf16 tensor bit-equal (the port quantizes
the HF ``(out, in)`` layout directly; the 128×128 blocks are square). The
decode logits of the two are then held to ``test_torch_model.py``'s bounds
on the flash path: rel-L2 2e-2 after the prefill, 5e-2 on teacher-forced
decode steps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import to_numpy, tree_of

CONFIGS = {"tiny": jmodels.TINY, "tiny_dense": jmodels.TINY_DENSE}


def hf_state(cfg, seed=0):
    """A synthetic HF checkpoint of ``cfg``: torch ``(out, in)`` Linear
    weights (gaussian, scale 0.02), unit norms."""
    rng = np.random.default_rng(seed)
    s = {}

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.02

    ones = lambda: np.ones((cfg.hidden_size,), np.float32)
    s["model.embed_tokens.weight"] = w(cfg.vocab_size, cfg.hidden_size)
    s["model.norm.weight"] = ones()
    s["lm_head.weight"] = w(cfg.vocab_size, cfg.hidden_size)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        s[p + "input_layernorm.weight"] = ones()
        s[p + "post_attention_layernorm.weight"] = ones()
        s[p + "self_attn.q_proj.weight"] = w(cfg.q_dim, cfg.hidden_size)
        s[p + "self_attn.k_proj.weight"] = w(cfg.kv_dim, cfg.hidden_size)
        s[p + "self_attn.v_proj.weight"] = w(cfg.kv_dim, cfg.hidden_size)
        s[p + "self_attn.o_proj.weight"] = w(cfg.hidden_size, cfg.q_dim)
        if i < cfg.first_dense_layers:
            for name, shape in (("gate", (cfg.dense_intermediate,
                                          cfg.hidden_size)),
                                ("up", (cfg.dense_intermediate,
                                        cfg.hidden_size)),
                                ("down", (cfg.hidden_size,
                                          cfg.dense_intermediate))):
                s[p + f"mlp.{name}_proj.weight"] = w(*shape)
            continue
        s[p + "mlp.gate.weight"] = w(cfg.num_experts, cfg.hidden_size)
        si = cfg.moe_intermediate * cfg.num_shared_experts
        for q, inter in ([f"mlp.experts.{j}." for j in range(
                cfg.num_experts)], cfg.moe_intermediate), \
                (["mlp.shared_experts."], si):
            for pre in q:
                s[p + pre + "gate_proj.weight"] = w(inter, cfg.hidden_size)
                s[p + pre + "up_proj.weight"] = w(inter, cfg.hidden_size)
                s[p + pre + "down_proj.weight"] = w(cfg.hidden_size, inter)
    return s


@pytest.fixture(scope="module", params=list(CONFIGS))
def loaded(request):
    cfg = CONFIGS[request.param]
    state = hf_state(cfg)
    jp = jmodels.load_params(state, cfg)
    return (cfg, state, jp,
            tmodels.params_from_numpy(tree_of(jp), cfg, device="cpu"),
            tmodels.load_params(state, cfg, device="cpu"))


def _leaves(obj, path=""):
    """(path, tensor) of every tensor in a parameter tree."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, list):
        for i, o in enumerate(obj):
            yield from _leaves(o, f"{path}[{i}]")
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")


def _assert_same_bits(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for name, x in la.items():
        y = lb[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8)), name


def test_load_params_byte_equal_to_jax(loaded):
    _, _, _, via_jax, port = loaded
    assert port.layers[0].attn.wq.w_q.dtype == torch.float8_e4m3fn
    _assert_same_bits(port, via_jax)


def test_loaded_decode_logits_match_jax(loaded):
    cfg, _, jp, _, tp = loaded
    rng = np.random.default_rng(6)
    b, s, max_seq = 2, 32, 64
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    lens = np.full((b,), s, np.int32)
    st = np.zeros((b,), np.int32)
    jc = jmodels.init_cache(cfg, b, max_seq)
    tc = tmodels.init_cache(cfg, b, max_seq, device="cpu")
    jlog, jc = jmodels.forward(jp, jnp.asarray(toks), jc, jnp.asarray(pos),
                               jnp.asarray(lens), cfg,
                               prefill_start=jnp.asarray(st))
    tlog, tc = tmodels.forward(tp, torch.from_numpy(toks), tc,
                               torch.from_numpy(pos), torch.from_numpy(lens),
                               cfg, prefill_start=torch.from_numpy(st))
    assert verify.relative_l2_error(to_numpy(tlog), np.asarray(jlog)) < 2e-2
    for _ in range(2):
        nt = rng.integers(0, cfg.vocab_size, size=(b,)).astype(np.int32)
        jlog, jc = jmodels.decode_step(jp, jnp.asarray(nt), jc,
                                       jnp.asarray(lens), cfg)
        tlog, tc = tmodels.decode_step(tp, torch.from_numpy(nt), tc,
                                       torch.from_numpy(lens), cfg)
        err = verify.relative_l2_error(to_numpy(tlog), np.asarray(jlog))
        assert np.isfinite(to_numpy(tlog)).all() and err < 5e-2, err
        lens = lens + 1


def test_missing_tensor_raises_like_jax():
    with pytest.raises(KeyError):
        jmodels.load_params({}, jmodels.TINY)
    with pytest.raises(KeyError, match="model.layers.0.self_attn.q_proj"):
        tmodels.load_params({}, jmodels.TINY, device="cpu")


def test_torch_tensors_load_like_numpy(loaded):
    """A state dict of tensors (bf16 here, as HF ships) loads as the same
    values given as numpy arrays."""
    cfg, state, _, _, _ = loaded
    as_bf16 = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in state.items()}
    rounded = {k: v.to(torch.float32).numpy() for k, v in as_bf16.items()}
    _assert_same_bits(tmodels.load_params(as_bf16, cfg, device="cpu"),
                      tmodels.load_params(rounded, cfg, device="cpu"))


def test_safetensors_roundtrip(loaded, tmp_path):
    safetensors = pytest.importorskip("safetensors.numpy")
    cfg, state, _, _, port = loaded
    names = sorted(state)
    half = len(names) // 2
    paths = [str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")]
    safetensors.save_file({k: state[k] for k in names[:half]}, paths[0])
    safetensors.save_file({k: state[k] for k in names[half:]}, paths[1])
    _assert_same_bits(tmodels.load_safetensors(paths, cfg, device="cpu"),
                      port)


@pytest.mark.parametrize("experts", ["fp8", "int8"])
def test_quantized_roundtrip_bit_for_bit(loaded, tmp_path, experts):
    cfg, _, _, _, port = loaded
    params = (tmodels.params_with_int8_experts(port) if experts == "int8"
              else port)
    path = str(tmp_path / "q.pt")
    tmodels.save_quantized(params, path)
    back = tmodels.load_quantized(path, cfg, device="cpu")
    _assert_same_bits(back, params)
    assert [type(l.ffn.experts if hasattr(l.ffn, "experts") else l.ffn)
            for l in back.layers] == \
        [type(l.ffn.experts if hasattr(l.ffn, "experts") else l.ffn)
         for l in params.layers]
    with pytest.raises(ValueError, match="layers"):
        tmodels.load_quantized(
            path, dataclasses.replace(cfg, num_layers=cfg.num_layers + 1),
            device="cpu")
