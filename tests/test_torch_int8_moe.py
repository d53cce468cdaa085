"""Port W8A8 int8 experts and layers vs the JAX package's, on the CPU.

Weight conversion has no rounding the two packages could take differently
(an exact fp8 dequantization, an exact amax, one f32 divide, round half to
even), so int8 weights must be byte-equal and scales equal. ``moe_block``
with int8 experts is held to ``test_torch_model.py``'s moe tolerance; the
engine to the JAX engine's greedy tokens, under ``jax.disable_jit()`` on
the fallback attention path, with the JAX top-1 margins checked first (as
in ``test_torch_serving.py``).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu.serving import Engine as JEngine
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.serving import Engine
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import to_numpy, to_torch, tree_of

jl = importlib.import_module("deepgemm_ascend_tpu.models.layers")
jm = importlib.import_module("deepgemm_ascend_tpu.models.moe")
jmodel = importlib.import_module("deepgemm_ascend_tpu.models.model")
tm = importlib.import_module("deepgemm_ascend_tpu_torch.models.moe")

TINY = jmodels.TINY
MARGIN = 1e-3


@pytest.fixture(scope="module")
def int8_pair():
    """TINY parameters with int8 experts, converted in each package from
    the same fp8 parameters."""
    jp = jmodels.init_params(jax.random.PRNGKey(0), TINY)
    tp = tmodels.params_from_numpy(tree_of(jp), TINY, device="cpu")
    return (jmodel.params_with_int8_experts(jp),
            tmodels.params_with_int8_experts(tp))


def assert_int8_experts_equal(je, te):
    """JAX (E, in, out) int8 weights vs the port's K-major (E, out, in),
    and the (E, 1, out) scales."""
    assert isinstance(te, tm.Int8ExpertWeights)
    for name in ("w1", "w2"):
        jw = np.asarray(getattr(je, f"{name}_q"))
        tw = getattr(te, f"{name}_q")
        assert tw.dtype == torch.int8 and tw.is_contiguous()
        np.testing.assert_array_equal(np.swapaxes(jw, 1, 2), tw.numpy())
        np.testing.assert_array_equal(np.asarray(getattr(je, f"{name}_s")),
                                      getattr(te, f"{name}_s").numpy())


def test_int8_expert_weights_from_weights_match_jax():
    rng = np.random.default_rng(0)
    w1 = (rng.normal(size=(4, 128, 384)) / 128 ** 0.5).astype(np.float32)
    w2 = (rng.standard_t(df=4, size=(4, 192, 128)) / 192 ** 0.5).astype(
        np.float32)
    je = jm.Int8ExpertWeights.from_weights(jnp.asarray(w1), jnp.asarray(w2))
    te = tm.Int8ExpertWeights.from_weights(torch.from_numpy(w1),
                                           torch.from_numpy(w2))
    assert_int8_experts_equal(je, te)
    assert te.w1_s.shape == (4, 1, 384) and te.w2_q.shape == (4, 128, 192)


def test_int8_experts_from_fp8_match_jax(int8_pair):
    jp, tp = int8_pair
    assert_int8_experts_equal(jp.layers[1].ffn.experts,
                              tp.layers[1].ffn.experts)


def test_params_with_int8_experts_passes_the_rest_through():
    tp = tmodels.init_params(0, TINY, device="cpu")
    conv = tmodels.params_with_int8_experts(tp)
    dense, moe = conv.layers
    assert dense.ffn is tp.layers[0].ffn            # dense FFN untouched
    assert moe.ffn.shared_w1 is tp.layers[1].ffn.shared_w1
    assert moe.attn is tp.layers[1].attn
    assert isinstance(moe.ffn.experts, tm.Int8ExpertWeights)
    assert isinstance(tp.layers[1].ffn.experts, tm.ExpertWeights)
    again = tmodels.params_with_int8_experts(conv)  # already int8: as is
    assert again.layers[1].ffn.experts is moe.ffn.experts


def test_params_from_numpy_carries_int8_experts(int8_pair):
    jp, tp = int8_pair
    carried = tmodels.params_from_numpy(tree_of(jp), TINY, device="cpu")
    je = jp.layers[1].ffn.experts
    assert_int8_experts_equal(je, carried.layers[1].ffn.experts)
    assert torch.equal(carried.layers[1].ffn.experts.w1_q,
                       tp.layers[1].ffn.experts.w1_q)


@pytest.mark.parametrize("source", ["create", "from_weights"])
def test_int8_linear_matches_jax(source):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 7, 256)) * 2, jnp.bfloat16)
    if source == "from_weights":
        w = (rng.normal(size=(256, 200)) / 16).astype(np.float32)
        jlin = jl.Int8Linear.from_weights(jnp.asarray(w))
        tlin = tmodels.Int8Linear.from_weights(torch.from_numpy(w))
        np.testing.assert_array_equal(np.asarray(jlin.w_q).T,
                                      tlin.w_q.numpy())
        np.testing.assert_array_equal(np.asarray(jlin.scales),
                                      tlin.scales.numpy())
    else:
        tlin = tmodels.Int8Linear.create(torch.Generator().manual_seed(0),
                                         256, 200, device="cpu")
        jlin = jl.Int8Linear(w_q=jnp.asarray(tlin.w_q.numpy().T),
                             scales=jnp.asarray(tlin.scales.numpy()))
        assert tlin.w_q.shape == (200, 256) and tlin.scales.shape == (1, 200)
    want = np.asarray(jlin(x), np.float32)
    got = tlin(to_torch(x))
    assert got.shape == (2, 7, 200) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("chunk", [0, 16])
def test_moe_block_int8_matches_jax(int8_pair, chunk):
    jp, tp = int8_pair
    x = jnp.asarray(np.random.default_rng(4).normal(size=(40, 256)) * 0.5,
                    jnp.bfloat16)
    want = np.asarray(jm.moe_block(jp.layers[1].ffn, x, TINY,
                                   token_chunk=chunk), np.float32)
    _kernels.reset_counters()
    got = to_numpy(tm.moe_block(tp.layers[1].ffn, to_torch(x), TINY,
                                token_chunk=chunk))
    assert verify.relative_l2_error(got, want) < (1e-2 if chunk else 1e-3)
    # The routed experts went through K6's path only; the shared expert is
    # fp8 (K1), as in the JAX package.
    counts = {n: c.plain_calls for n, c in _kernels.COUNTERS.items()}
    assert counts["int8_grouped_masked"] > 0 and counts["fp8_gemm"] > 0
    assert counts["grouped_gemm"] == 0


def test_engine_int8_greedy_tokens_match_jax_engine(monkeypatch):
    """As test_torch_serving.py's token test, with int8 experts: four
    equal-length prompts through two slots, on the fallback attention
    path."""
    import deepgemm_ascend_tpu.serving.engine as jengine
    cfg = dataclasses.replace(TINY, use_flash_decode=False)
    jp8 = jmodels.init_params(jax.random.PRNGKey(0), cfg)
    jp = jmodel.params_with_int8_experts(jp8)
    tp = tmodels.params_with_int8_experts(
        tmodels.params_from_numpy(tree_of(jp8), cfg, device="cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=12).tolist()
               for _ in range(4)]
    margins = []
    real_sample = jengine.sample_logits

    def recording_sample(logits, key, **kw):
        top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
        margins.extend((top2[:, 1] - top2[:, 0]).tolist())
        return real_sample(logits, key, **kw)

    monkeypatch.setattr(jengine, "sample_logits", recording_sample)
    with jax.disable_jit():
        want = JEngine(jp, cfg, max_slots=2, max_seq_len=64).generate(
            prompts, max_new_tokens=4)
    assert len(margins) == 4 * 4 and min(margins) > MARGIN, min(margins)
    got = Engine(tp, cfg, max_slots=2, max_seq_len=64, device="cpu").generate(
        prompts, max_new_tokens=4)
    assert got == want


def test_int8_expert_weights_create_on_cpu():
    g = torch.Generator().manual_seed(0)
    w = tm.Int8ExpertWeights.create(g, 4, 256, 128, device="cpu")
    assert w.w1_q.shape == (4, 256, 256) and w.w1_q.dtype == torch.int8
    assert w.w2_q.shape == (4, 256, 128) and w.w2_s.shape == (4, 1, 256)
    assert bool((w.w1_q.abs() <= 127).all())
    assert bool((w.w1_q.abs().amax(dim=-1) == 127).all())
