"""Port flash decode / prefill (K2/K4 CPU paths) vs the JAX package's.

The JAX side runs its Pallas kernels in interpret mode on the CPU. At these
sizes its kernels see one S block, so their online softmax is the port's
one-block softmax and the outputs agree within 1e-3 (the remaining gap is
the order of f32 sums). After the in-place decode write all four cache
arrays must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu.ops import flash_decode as jd
from deepgemm_ascend_tpu.ops import flash_prefill as jp
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import flash_decode as td
from deepgemm_ascend_tpu_torch.ops import flash_prefill as tp
from torch_bridge import (PREFILL_BUCKET_IDS, PREFILL_BUCKETS, to_numpy,
                          to_torch)


def _cache(b, kvh, s_max, hd, seed):
    rng = np.random.default_rng(seed)
    k_q = rng.integers(-127, 128, size=(b, kvh, s_max, hd), dtype=np.int8)
    v_q = rng.integers(-127, 128, size=(b, kvh, s_max, hd), dtype=np.int8)
    k_s = (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32)
    v_s = (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32)
    return k_q, k_s, v_q, v_s


@pytest.mark.parametrize("kvh,g", [(2, 2), (1, 4), (4, 1)])
def test_flash_decode_inplace_matches_jax(kvh, g):
    b, s_max, hd = 4, 256, 128
    k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, hd, seed=kvh * 10 + g)
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(size=(b, kvh * g, hd)), jnp.bfloat16)
    k_new = rng.integers(-127, 128, size=(b, kvh, hd), dtype=np.int8)
    v_new = rng.integers(-127, 128, size=(b, kvh, hd), dtype=np.int8)
    ks_new = (rng.random((b, kvh)) * 0.02).astype(np.float32)
    vs_new = (rng.random((b, kvh)) * 0.02).astype(np.float32)
    # one token, ragged, a full cache, and a freed slot at S (clamped).
    lens = np.asarray([1, 77, s_max - 1, s_max], np.int32)
    j_out, *j_caches = jd.flash_decode_gqa_inplace(
        q, jnp.asarray(k_q), jnp.asarray(k_s), jnp.asarray(v_q),
        jnp.asarray(v_s), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(ks_new), jnp.asarray(vs_new), jnp.asarray(lens))
    t_caches = [torch.from_numpy(x.copy()) for x in (k_q, k_s, v_q, v_s)]
    t_out, kq2, vq2, ks2, vs2 = td.flash_decode_gqa_inplace(
        to_torch(q), t_caches[0], t_caches[1], t_caches[2], t_caches[3],
        torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(ks_new), torch.from_numpy(vs_new),
        torch.from_numpy(lens))
    np.testing.assert_allclose(to_numpy(t_out), np.asarray(j_out),
                               atol=1e-3, rtol=0)
    # in place: the returned caches are the tensors passed in
    assert kq2 is t_caches[0] and vs2 is t_caches[3]
    for j, t in zip(j_caches, (kq2, vq2, ks2, vs2)):
        assert np.array_equal(np.asarray(j), t.numpy())


def test_flash_decode_empty_sequence_gives_zeros():
    b, kvh, s_max, hd = 2, 2, 64, 128
    k_q, k_s, v_q, v_s = (torch.from_numpy(x) for x in
                          _cache(b, kvh, s_max, hd, seed=3))
    before = k_q.clone()
    q = torch.randn(b, kvh * 2, hd)
    zeros8 = torch.zeros(b, kvh, hd, dtype=torch.int8)
    ones = torch.ones(b, kvh)
    out, *_ = td.flash_decode_gqa_inplace(
        q, k_q, k_s, v_q, v_s, zeros8, zeros8, ones, ones,
        torch.tensor([0, 0], dtype=torch.int32))
    assert not out.any()
    assert torch.equal(k_q, before)


@pytest.mark.parametrize("start", [[0, 0], [40, 7], [-24, 5]])
@pytest.mark.parametrize("kvh,g", [(2, 2), (1, 4), (4, 1), (1, 8), (1, 16)])
def test_flash_prefill_matches_jax(start, kvh, g):
    b, s, s_max, hd = 2, 32, 128, 128
    k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, hd, seed=5)
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.normal(size=(b, s, kvh * g, hd)), jnp.bfloat16)
    st = np.asarray(start, np.int32)
    lens = np.maximum(st, 0) + s
    want = np.asarray(jp.flash_prefill_gqa(
        q, jnp.asarray(k_q), jnp.asarray(k_s), jnp.asarray(v_q),
        jnp.asarray(v_s), jnp.asarray(st), jnp.asarray(lens)))
    got = to_numpy(tp.flash_prefill_gqa(
        to_torch(q), *(torch.from_numpy(x) for x in (k_q, k_s, v_q, v_s)),
        torch.from_numpy(st), torch.from_numpy(lens)))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("kvh,g,s,s_max,start,lens", PREFILL_BUCKETS,
                         ids=PREFILL_BUCKET_IDS)
def test_flash_prefill_bucket_geometry_matches_jax(kvh, g, s, s_max, start,
                                                  lens):
    """Buckets whose q block is wider than s (s = 16, 48 at group 1 or 2),
    ragged lengths with a serving padding row (length 1) and an empty one,
    a start at or past the cache, and a cache that is not a multiple of 64:
    K4 (plain) against JAX in interpret mode, within 1e-3 absolute."""
    b, hd = len(start), 128
    cache = _cache(b, kvh, s_max, hd, seed=s + g)
    q = jnp.asarray(np.random.default_rng(9).normal(size=(b, s, kvh * g, hd)),
                    jnp.bfloat16)
    st, ln = np.asarray(start, np.int32), np.asarray(lens, np.int32)
    want = np.asarray(jp.flash_prefill_gqa(
        q, *map(jnp.asarray, cache), jnp.asarray(st), jnp.asarray(ln)))
    got = to_numpy(tp.flash_prefill_gqa(
        to_torch(q), *(torch.from_numpy(x) for x in cache),
        torch.from_numpy(st), torch.from_numpy(ln)))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _block_keys(qb, start, seq_len, s, s_max, g, rows=tp.ROWS):
    """The keys q block ``qb`` of a sequence loads: [0, min(len, last
    position + 1)), none where its rows see no key."""
    last = start + min((qb + 1) * (rows // g), s) - 1
    return max(0, min(seq_len, s_max, last + 1))


def test_flash_prefill_block_order_is_heaviest_first():
    """The CUDA kernel's launch order (its Python mirror): every (batch, kv
    head, q block) exactly once, and at equal starts and lengths the keys
    each block loads never increase along it; the q order is its reverse
    in q blocks."""
    for b, kvh, s, g, start, s_max in ((2, 4, 512, 4, 0, 4096),
                                       (1, 4, 4096, 4, 8192, 16384),
                                       (3, 2, 48, 1, 0, 64),
                                       (2, 1, 16, 16, -8, 32)):
        order = tp.block_order(b, kvh, s, g)
        nq = -(-s // (tp.ROWS // g))
        assert sorted(order) == [(i, h, q) for i in range(b)
                                 for h in range(kvh) for q in range(nq)]
        keys = [_block_keys(q, start, start + s, s, s_max, g)
                for _, _, q in order]
        assert keys == sorted(keys, reverse=True)
        assert keys[0] == _block_keys(nq - 1, start, start + s, s, s_max,
                                        g)
        plain = tp.block_order(b, kvh, s, g, heavy_first=False)
        assert [q for _, _, q in plain] == [nq - 1 - q for _, _, q in order]
    # 64-row blocks double the q blocks of every group.
    assert len(tp.block_order(1, 4, 1024, 4, rows=64)) == 4 * 64
    assert _block_keys(0, -300, 16, 64, 4096, 4, rows=64) == 0
    assert _block_keys(3, 100, 612, 512, 4096, 4, rows=64) == 164


def test_flash_prefill_ragged_s_raises_like_jax():
    q = torch.zeros(1, 24, 4, 128)
    cache = [torch.zeros(1, 2, 64, 128, dtype=torch.int8),
             torch.zeros(1, 2, 64)] * 2
    with pytest.raises(ValueError):
        tp.flash_prefill_gqa(q, *cache, torch.zeros(1, dtype=torch.int32),
                             torch.full((1,), 24, dtype=torch.int32))


def test_flash_cpu_paths_count_plain_calls():
    c_d = _kernels.COUNTERS["flash_decode"]
    c_p = _kernels.COUNTERS["flash_prefill"]
    before = (c_d.launches, c_d.plain_calls, c_p.launches, c_p.plain_calls)
    test_flash_decode_empty_sequence_gives_zeros()
    q = torch.zeros(1, 16, 2, 128)
    k_q, k_s, v_q, v_s = (torch.from_numpy(x) for x in
                          _cache(1, 1, 32, 128, seed=9))
    tp.flash_prefill_gqa(q, k_q, k_s, v_q, v_s,
                         torch.zeros(1, dtype=torch.int32),
                         torch.full((1,), 16, dtype=torch.int32))
    assert (c_d.launches, c_d.plain_calls, c_p.launches, c_p.plain_calls) \
        == (before[0], before[1] + 1, before[2], before[3] + 1)
