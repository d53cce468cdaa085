"""An expert-parallel shard's MoE block (``moe_block(local_experts=,
expert_offset=)``) against the JAX package's, on the CPU at TINY.

TINY has 8 experts, top-2; with ep=2 each shard holds 4 (offsets 0 and 4),
so with 40 tokens some of every token's two assignments land on the other
shard. The shard's block is held to ``test_torch_model.py``'s moe
tolerance against JAX's eager ``moe_block`` on the same shard (rel-L2 <
1e-3: the same fp8 products, f32 sums in another order). The two shards'
routed parts must sum to the whole routed block: each assignment's
expert output is the same rows through the same GEMM either way, and a
token's K = 2 weighted terms are added in the same order, so to f32
rounding (rtol 1e-6).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import to_numpy, to_torch, tree_of

jm = importlib.import_module("deepgemm_ascend_tpu.models.moe")
tm = importlib.import_module("deepgemm_ascend_tpu_torch.models.moe")

TINY = jmodels.TINY
EP = 2
E_LOCAL = TINY.num_experts // EP


@pytest.fixture(scope="module")
def moe_pair():
    jp = jmodels.init_params(jax.random.PRNGKey(0), TINY)
    tp = tmodels.params_from_numpy(tree_of(jp), TINY, device="cpu")
    return jp.layers[1].ffn, tp.layers[1].ffn


def _shard(moe, offset: int):
    """The MoE parameters with only experts [offset, offset + E_LOCAL): the
    expert weights of both packages lead with the expert dim."""
    ex = moe.experts
    return dataclasses.replace(moe, experts=dataclasses.replace(ex, **{
        f.name: getattr(ex, f.name)[offset:offset + E_LOCAL]
        for f in dataclasses.fields(ex)}))


def _tokens(n=40):
    return jnp.asarray(np.random.default_rng(5).normal(size=(n, 256)) * 0.5,
                       jnp.bfloat16)


@pytest.mark.parametrize("offset", [0, E_LOCAL])
def test_moe_block_shard_matches_jax(moe_pair, offset):
    jmoe, tmoe = moe_pair
    x = _tokens()
    want = np.asarray(jm.moe_block(_shard(jmoe, offset), x, TINY,
                                   local_experts=E_LOCAL,
                                   expert_offset=offset), np.float32)
    got = to_numpy(tm.moe_block(_shard(tmoe, offset), to_torch(x), TINY,
                                local_experts=E_LOCAL, expert_offset=offset))
    assert verify.relative_l2_error(got, want) < 1e-3


def test_some_tokens_route_off_each_shard(moe_pair):
    _, tmoe = moe_pair
    _, idx = tm.route_topk(tmoe.router(to_torch(_tokens())), TINY.top_k)
    local = (idx < E_LOCAL)
    assert bool(local.any()) and bool((~local).any())
    assert bool((local.sum(dim=1) == 1).any())       # split tokens


@pytest.mark.parametrize("chunk", [0, 16])
def test_shards_routed_parts_sum_to_the_whole(moe_pair, chunk):
    _, tmoe = moe_pair
    x = to_torch(_tokens())
    whole = tm._moe_routed(tmoe, x, TINY)
    parts = [tm._moe_routed(_shard(tmoe, off), x, TINY,
                            local_experts=E_LOCAL, expert_offset=off)
             for off in (0, E_LOCAL)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-7)
    # ... and through moe_block's token chunks (the shared expert removed,
    # so that it is not counted twice), to bf16 rounding of each part.
    routed_only = dataclasses.replace(tmoe, shared_w1=None, shared_w2=None)
    blocks = [tm.moe_block(_shard(routed_only, off), x, TINY,
                           local_experts=E_LOCAL, expert_offset=off,
                           token_chunk=chunk).float() for off in (0, E_LOCAL)]
    full = tm.moe_block(routed_only, x, TINY, token_chunk=chunk).float()
    assert verify.relative_l2_error((blocks[0] + blocks[1]).numpy(),
                                    full.numpy()) < 1e-2


def test_shard_buffer_indices_stay_in_range(moe_pair):
    """Off-shard assignments never index the (E_local, cap, hidden) buffer
    out of range: a shard whose window holds the last experts only."""
    _, tmoe = moe_pair
    x = to_torch(_tokens(7))
    out = tm.moe_block(_shard(tmoe, TINY.num_experts - 1), x, TINY,
                       local_experts=1, expert_offset=TINY.num_experts - 1)
    assert out.shape == (7, 256) and bool(torch.isfinite(out.float()).all())
