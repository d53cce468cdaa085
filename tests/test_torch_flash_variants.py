"""Port flash decode K5a/K5b and flash prefill K4-stats (CPU paths) vs the
JAX package's.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the kernels' plain versions. At these sizes the JAX kernels see one
S block, so their online softmax is the port's one-block softmax. Outputs
agree within 1e-3 absolute (as in ``test_torch_flash.py``: the order of
f32 sums); the unnormalized acc within 1e-3 of l; m and l within 1e-5
relative; empty rows exactly (0, -1e30, 0) in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu.ops import flash_decode as jd
from deepgemm_ascend_tpu.ops import flash_prefill as jp
from deepgemm_ascend_tpu_torch import (flash_decode_gqa,
                                       flash_decode_gqa_state)
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import flash_decode as td
from deepgemm_ascend_tpu_torch.ops import flash_prefill as tp
from deepgemm_ascend_tpu_torch.ops.flash_decode import merge_current_token
from torch_bridge import (PREFILL_BUCKET_IDS, PREFILL_BUCKETS, to_numpy,
                          to_torch)


def _cache(b, kvh, s_max, hd, seed):
    rng = np.random.default_rng(seed)
    k_q = rng.integers(-127, 128, size=(b, kvh, s_max, hd), dtype=np.int8)
    v_q = rng.integers(-127, 128, size=(b, kvh, s_max, hd), dtype=np.int8)
    k_s = (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32)
    v_s = (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32)
    return k_q, k_s, v_q, v_s


def _torch(*arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


def assert_state_matches(got, want):
    """got/want: (acc, m, l) as numpy f32."""
    acc, m, l = got
    acc_w, m_w, l_w = want
    np.testing.assert_allclose(m, m_w, rtol=1e-5, atol=0)
    np.testing.assert_allclose(l, l_w, rtol=1e-5, atol=0)
    assert np.all(np.abs(acc - acc_w) <= 1e-3 * np.maximum(l_w, 1.0)[..., None])
    empty = l_w == 0
    assert np.all(m[empty] == np.float32(-1e30)) and np.all(l[empty] == 0)
    assert np.all(acc[empty] == 0)


DECODE_LENS = [0, 1, 77, 255, 256, 300]      # empty, …, S, past S (clamped)


@pytest.mark.parametrize("kvh,g", [(2, 2), (1, 4), (4, 1), (1, 16)])
def test_flash_decode_gqa_matches_jax(kvh, g):
    b, s_max, hd = len(DECODE_LENS), 256, 128
    cache = _cache(b, kvh, s_max, hd, seed=kvh * 10 + g)
    q = jnp.asarray(np.random.default_rng(3).normal(size=(b, kvh * g, hd)),
                    jnp.bfloat16)
    lens = np.asarray(DECODE_LENS, np.int32)
    want = np.asarray(jd.flash_decode_gqa(q, *map(jnp.asarray, cache),
                                          jnp.asarray(lens)))
    got = to_numpy(flash_decode_gqa(to_torch(q), *_torch(*cache),
                                    torch.from_numpy(lens)))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert not got[0].any()


@pytest.mark.parametrize("kvh,g", [(2, 2), (1, 4), (4, 1), (1, 16)])
def test_flash_decode_gqa_state_matches_jax(kvh, g):
    b, s_max, hd = len(DECODE_LENS), 256, 128
    cache = _cache(b, kvh, s_max, hd, seed=kvh * 10 + g + 1)
    q = jnp.asarray(np.random.default_rng(4).normal(size=(b, kvh * g, hd)),
                    jnp.bfloat16)
    lens = np.asarray(DECODE_LENS, np.int32)
    want = [np.asarray(x) for x in jd.flash_decode_gqa_state(
        q, *map(jnp.asarray, cache), jnp.asarray(lens))]
    got = [to_numpy(x) for x in flash_decode_gqa_state(
        to_torch(q), *_torch(*cache), torch.from_numpy(lens))]
    assert [x.shape for x in got] == [x.shape for x in want]
    assert_state_matches(got, want)
    assert got[1][0, 0] == np.float32(-1e30) and got[2][0, 0] == 0


def test_state_plus_current_token_equals_inplace():
    """The JAX docstring's exact merge of K5b's state with the current token
    gives K2's output for the same cache, as in the JAX package."""
    b, kvh, g, s_max, hd = 4, 2, 2, 128, 128
    k_q, k_s, v_q, v_s = _cache(b, kvh, s_max, hd, seed=30)
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.normal(size=(b, kvh * g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k_new = torch.from_numpy(rng.integers(-127, 128, (b, kvh, hd),
                                          dtype=np.int8))
    v_new = torch.from_numpy(rng.integers(-127, 128, (b, kvh, hd),
                                          dtype=np.int8))
    ks_new = torch.from_numpy((rng.random((b, kvh)) * 0.02 + 1e-3).astype(
        np.float32))
    vs_new = torch.from_numpy((rng.random((b, kvh)) * 0.02 + 1e-3).astype(
        np.float32))
    lens = torch.tensor([1, 40, 100, s_max], dtype=torch.int32)
    acc, m, l = flash_decode_gqa_state(q, *_torch(k_q, k_s, v_q, v_s),
                                       lens - 1)
    caches = _torch(k_q, k_s, v_q, v_s)
    want, *_ = td.flash_decode_gqa_inplace(q, *caches, k_new, v_new, ks_new,
                                           vs_new, lens)
    merged = merge_current_token((acc, m, l), q, k_new, ks_new, v_new,
                                 vs_new)
    np.testing.assert_allclose(merged.numpy(), want.numpy(), atol=1e-3,
                               rtol=0)
    # ... and K5a over the written cache is K2 too.
    read = flash_decode_gqa(q, *caches, lens)
    np.testing.assert_allclose(read.numpy(), want.numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("start", [-48, -16, 0, 40, 128, 500])
@pytest.mark.parametrize("kvh,g", [(2, 2), (1, 4), (4, 1), (1, 8), (1, 16)])
def test_flash_prefill_stats_matches_jax(start, kvh, g):
    """Rows before position 0 (start < 0), a q block straddling 0, and a
    start at or past the cache length (a fully visible ring hop)."""
    b, s, s_max, hd = 2, 32, 128, 128
    cache = _cache(b, kvh, s_max, hd, seed=5)
    q = jnp.asarray(np.random.default_rng(8).normal(size=(b, s, kvh * g, hd)),
                    jnp.bfloat16)
    st = np.asarray([start, start + 8], np.int32)
    lens = np.full(b, s_max, np.int32)
    want = [np.asarray(x) for x in jp.flash_prefill_gqa(
        q, *map(jnp.asarray, cache), jnp.asarray(st), jnp.asarray(lens),
        return_stats=True)]
    got = [to_numpy(x) for x in tp.flash_prefill_gqa(
        to_torch(q), *_torch(*cache), torch.from_numpy(st),
        torch.from_numpy(lens), return_stats=True)]
    assert [x.shape for x in got] == [x.shape for x in want]
    assert_state_matches(got, want)
    if start < 0:
        assert np.all(got[1][0, :-start] == np.float32(-1e30))
    normalized = to_numpy(tp.flash_prefill_gqa(
        to_torch(q), *_torch(*cache), torch.from_numpy(st),
        torch.from_numpy(lens)))
    safe = np.where(got[2] > 0, got[2], 1.0)[..., None]
    np.testing.assert_allclose(got[0] / safe, normalized, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kvh,g,s,s_max,start,lens", PREFILL_BUCKETS,
                         ids=PREFILL_BUCKET_IDS)
def test_flash_prefill_stats_bucket_geometry_matches_jax(kvh, g, s, s_max,
                                                        start, lens):
    """K4-stats (plain) against JAX in interpret mode at K4's bucket
    geometries (``torch_bridge.PREFILL_BUCKETS``): m and l within 1e-5
    relative, acc within 1e-3 of l, empty rows exactly (0, -1e30, 0)."""
    b, hd = len(start), 128
    cache = _cache(b, kvh, s_max, hd, seed=s + g + 1)
    q = jnp.asarray(np.random.default_rng(10).normal(
        size=(b, s, kvh * g, hd)), jnp.bfloat16)
    st, ln = np.asarray(start, np.int32), np.asarray(lens, np.int32)
    want = [np.asarray(x) for x in jp.flash_prefill_gqa(
        q, *map(jnp.asarray, cache), jnp.asarray(st), jnp.asarray(ln),
        return_stats=True)]
    got = [to_numpy(x) for x in tp.flash_prefill_gqa(
        to_torch(q), *_torch(*cache), torch.from_numpy(st),
        torch.from_numpy(ln), return_stats=True)]
    assert [x.shape for x in got] == [x.shape for x in want]
    assert_state_matches(got, want)


def test_new_cpu_paths_count_plain_calls():
    names = ("flash_decode_read", "flash_decode_state", "flash_prefill_stats")
    before = {n: (_kernels.COUNTERS[n].launches,
                  _kernels.COUNTERS[n].plain_calls) for n in names}
    cache = _torch(*_cache(1, 1, 32, 128, seed=9))
    q = torch.zeros(1, 2, 128)
    lens = torch.tensor([5], dtype=torch.int32)
    flash_decode_gqa(q, *cache, lens)
    flash_decode_gqa_state(q, *cache, lens)
    tp.flash_prefill_gqa(torch.zeros(1, 16, 2, 128), *cache,
                         torch.zeros(1, dtype=torch.int32), lens,
                         return_stats=True)
    for n in names:
        launches, calls = before[n]
        assert (_kernels.COUNTERS[n].launches,
                _kernels.COUNTERS[n].plain_calls) == (launches, calls + 1)


@pytest.mark.parametrize("what", ["state", "output"])
def test_closeness_checks_hold_the_rounding_bound(what):
    """``state_close`` / ``output_close`` (the kernels' accuracy contract)
    accept a state whose acc moves by most of its per-element bound
    2^-7·Σ w·|v| and reject one that moves past it, or an empty row that is
    not exactly (0, -1e30, 0)."""
    from deepgemm_ascend_tpu_torch.ops.flash_common import (PV_ROUNDING,
                                                            output_close,
                                                            state_close)
    b, kvh, g, s, s_max, hd = 1, 2, 2, 32, 96, 128
    k_q, k_s, v_q, v_s = _torch(*_cache(b, kvh, s_max, hd, seed=31))
    qg = torch.from_numpy(np.random.default_rng(32).normal(
        size=(b, kvh, g, s, hd)).astype(np.float32))
    st = torch.tensor([-8], dtype=torch.int32)
    lens = torch.tensor([s_max], dtype=torch.int32)
    abs_v = v_q.float().abs()
    if what == "state":
        ref = tp.flash_prefill_stats_plain(qg, k_q, k_s, v_q, v_s, st, lens)
        pv = tp.flash_prefill_stats_plain(qg, k_q, k_s, abs_v, v_s, st,
                                          lens)[0]
        close = lambda acc: state_close((acc, *ref[1:]), ref, pv)
        assert not state_close((ref[0], ref[1].clone().fill_(0), ref[2]),
                               ref, pv)
    else:
        ref = (tp.flash_prefill_plain(qg, k_q, k_s, v_q, v_s, st, lens),)
        pv = tp.flash_prefill_plain(qg, k_q, k_s, abs_v, v_s, st, lens)
        close = lambda acc: output_close(acc, ref[0], pv)
    assert close(ref[0])
    assert close(ref[0] + 0.9 * PV_ROUNDING * pv)
    assert not close(ref[0] + 1.1 * PV_ROUNDING * pv
                     + 1e-4 * ref[0].abs())
    row = ref[0].clone()
    row[0, 0, 0, 0, 0] += 1e-6                 # row 0 is before position 0
    assert not close(row)
