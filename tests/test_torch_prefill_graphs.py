"""The pieces of the engine's prefill graphs that run on the CPU: the cache
write that reads nothing back, the fixed-length write-back plan, the
capture rule, the static inputs, and a CPU engine that keeps no graph.
The graphs themselves run on the card (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu_torch.models import TINY, TINY_DENSE, init_params
from deepgemm_ascend_tpu_torch.models.attention import KVCache
from deepgemm_ascend_tpu_torch.ops import quant
from deepgemm_ascend_tpu_torch.serving import engine as engine_mod
from deepgemm_ascend_tpu_torch.serving.engine import (
    _CACHE_FIELDS, Engine, _prefill, _prefill_forward, _PrefillGraph,
    _write_back_plan, prefill_graph_key)


def _random_cache(b, max_seq, kvh=2, hd=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return KVCache(
        k_q=torch.randint(-127, 128, (b, kvh, max_seq, hd), generator=g,
                          dtype=torch.int8),
        k_s=torch.rand((b, kvh, max_seq), generator=g),
        v_q=torch.randint(-127, 128, (b, kvh, max_seq, hd), generator=g,
                          dtype=torch.int8),
        v_s=torch.rand((b, kvh, max_seq), generator=g))


def _clone(cache):
    return KVCache(**{n: getattr(cache, n).clone() for n in _CACHE_FIELDS})


def _equal(a, b):
    return all(torch.equal(getattr(a, n), getattr(b, n))
               for n in _CACHE_FIELDS)


MAX_SEQ = 32


@pytest.mark.parametrize("positions", [
    [[0, 1, 2, 3], [8, 9, 10, 11]],                      # in range
    [[28, 29, 30, 31], [30, 31, 32, 33]],                # straddling the end
    [[32, 33, 34, 35], [40, 41, 42, 43]],                # all past it
    [[-2, -1, 0, 1], [-4, -3, -2, -1]],                  # negative
    [[32, 33, 34, 35], [29, 30, 31, 32]],                # first row out, second straddles
    [[31], [32]],                                        # one token: a freed slot at the end
], ids=["in_range", "straddle", "all_past", "negative", "mixed", "decode"])
def test_write_quantized_no_sync_equals_the_nonzero_scatter(positions):
    """The write that reads nothing back leaves the cache byte for byte as
    the ``nonzero`` scatter does: rows in range written, the others
    dropped, every other byte untouched."""
    pos = torch.tensor(positions, dtype=torch.int32)
    b, s = pos.shape
    g = torch.Generator().manual_seed(1)
    k = torch.randn((b, s, 2, 8), generator=g)
    v = torch.randn((b, s, 2, 8), generator=g)
    k_q, k_s = quant.quantize_int8(k, axis=-1)
    v_q, v_s = quant.quantize_int8(v, axis=-1)
    base = _random_cache(b, MAX_SEQ)
    want = _clone(base).write_quantized(k_q, k_s, v_q, v_s, pos)
    got = _clone(base).write_quantized_no_sync(k_q, k_s, v_q, v_s, pos)
    assert _equal(got, want)
    written = ((pos >= 0) & (pos < MAX_SEQ)).any()
    assert _equal(got, base) != bool(written)


@pytest.mark.parametrize("slots", [
    [3, -1, -1, -1],          # all padding but one
    [2, 0, 3, 1],             # no padding
    [1, 2, 0, -1],
    [5],
    [4, 7, -1, -1, -1, -1, -1, -1],
])
def test_write_back_plan_equals_the_nonzero_write_back(slots):
    """The fixed-length plan (one pair a row, padding rows repeating the
    first row's) writes the slot caches as ``np.nonzero(slots >= 0)``'s
    pairs do, and nothing else."""
    slots = np.array(slots, np.int32)
    src, dst = _write_back_plan(slots)
    assert src.shape == dst.shape == slots.shape
    assert src.dtype == dst.dtype == np.int64
    rows = np.nonzero(slots >= 0)[0]
    assert set(zip(src.tolist(), dst.tolist())) == set(
        zip(rows.tolist(), slots[rows].tolist()))
    sub = _random_cache(len(slots), 16, seed=2)
    base = _random_cache(8, 16, seed=3)
    want, got = _clone(base), _clone(base)
    for name in _CACHE_FIELDS:
        getattr(want, name)[torch.from_numpy(slots[rows].astype(np.int64))] = \
            getattr(sub, name)[torch.from_numpy(rows)]
        getattr(got, name)[torch.from_numpy(dst)] = \
            getattr(sub, name)[torch.from_numpy(src)]
    assert _equal(got, want)


def test_write_back_plan_needs_a_row_with_a_slot():
    with pytest.raises(ValueError):
        _write_back_plan(np.full((4,), -1, np.int32))


@pytest.mark.parametrize("s_pad,bucket,key", [
    (1, 16, (1, 16)), (4, 512, (4, 512)), (1, 2048, (1, 2048)),
    (128, 16, (128, 16)), (2, 2048, None), (8, 512, None), (1, 4096, None),
])
def test_prefill_graph_key_caps_the_tokens(s_pad, bucket, key):
    """A forward is kept as a graph by its shape up to 2048 tokens (padded
    rows × bucket), and always runs eagerly above."""
    assert prefill_graph_key(s_pad, bucket) == key


def _group(bucket, rows, max_slots, seed, hit=0):
    """A group's prefill arrays: ``rows`` prompts (the first with a prefix
    hit of ``hit`` tokens) padded to a power of two rows."""
    rng = np.random.default_rng(seed)
    s_pad = 1
    while s_pad < rows:
        s_pad *= 2
    toks = np.zeros((s_pad, bucket), np.int32)
    total = np.ones((s_pad,), np.int32)
    last = np.zeros((s_pad,), np.int32)
    pstart = np.zeros((s_pad,), np.int32)
    slots = np.full((s_pad,), -1, np.int32)
    for i, slot in enumerate(rng.permutation(max_slots)[:rows]):
        n = int(rng.integers(1, bucket + 1))
        toks[i, :n] = rng.integers(1, TINY.vocab_size, size=n)
        start = hit if i == 0 else 0
        total[i], last[i], pstart[i], slots[i] = start + n, n - 1, start, slot
    return toks, total, last, pstart, slots


@pytest.mark.parametrize("cfg,bucket,rows,hit", [
    (TINY, 16, 1, 0), (TINY, 32, 3, 0), (TINY_DENSE, 16, 2, 16),
], ids=["moe_one_row", "moe_padded", "dense_prefix_hit"])
def test_staged_static_inputs_run_the_eager_prefill(cfg, bucket, rows, hit):
    """A prefill graph's static buffers, staged from a group's arrays, give
    :func:`_prefill_forward` the inputs :func:`_prefill` makes: the same
    logits and the same cache bytes."""
    params = init_params(0, cfg, device="cpu")
    max_slots = 4
    eng = Engine(params, cfg, max_slots=max_slots, max_seq_len=64,
                 device="cpu")
    for i, c in enumerate(eng.caches):
        rnd = _random_cache(max_slots, 64, cfg.num_kv_heads, cfg.head_dim,
                            seed=10 + i)
        for name in _CACHE_FIELDS:
            getattr(c, name).copy_(getattr(rnd, name))
    arrays = _group(bucket, rows, max_slots, seed=4, hit=hit)
    base = [_clone(c) for c in eng.caches]
    want = _prefill(params, base, cfg, *arrays)
    pg = _PrefillGraph(*arrays[0].shape, torch.device("cpu"))
    pg.stage(*arrays, max_slots)
    caches = [_clone(c) for c in eng.caches]
    got = _prefill_forward(params, caches, cfg, *pg.inputs())
    assert torch.equal(got, want)
    assert all(_equal(a, b) for a, b in zip(caches, base))
    assert not all(_equal(a, b) for a, b in zip(caches, eng.caches))


def _prefill_nonzero(params, caches, cfg, tokens, total_lens, last_idx,
                     pstart, slots):
    """The engine's prefill as it wrote its rows back before the
    fixed-length plan: the valid rows picked by ``np.nonzero``."""
    dev = params.device
    s_pad, bucket = tokens.shape
    idx_r = torch.from_numpy(np.clip(slots, 0, caches[0].k_q.shape[0] - 1)
                             ).to(dev, torch.int64)
    sub = [KVCache(k_q=c.k_q[idx_r], k_s=c.k_s[idx_r], v_q=c.v_q[idx_r],
                   v_s=c.v_s[idx_r]) for c in caches]
    pst = torch.from_numpy(pstart).to(dev)
    pos = pst[:, None] + torch.arange(bucket, dtype=torch.int32)[None]
    logits, sub = engine_mod.forward(
        params, torch.from_numpy(tokens), sub, pos,
        torch.from_numpy(total_lens), cfg, prefill_start=pst)
    rows = np.nonzero(slots >= 0)[0]
    src = torch.from_numpy(rows).to(dev, torch.int64)
    dst = torch.from_numpy(slots[rows]).to(dev, torch.int64)
    for c, s in zip(caches, sub):
        for name in _CACHE_FIELDS:
            getattr(c, name)[dst] = getattr(s, name)[src]
    return logits[torch.arange(s_pad),
                  torch.from_numpy(last_idx).to(torch.int64)]


@pytest.mark.parametrize("cfg", [TINY, TINY_DENSE], ids=["moe", "dense"])
def test_a_cpu_engine_keeps_its_tokens_and_takes_no_graph(cfg, monkeypatch):
    """On the CPU every prefill runs eagerly, shapes repeating or not: no
    graph is kept, captured or replayed, and the tokens and caches are
    those of the engine's earlier ``nonzero`` write-back."""
    params = init_params(1, cfg, device="cpu")
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3], list(range(20, 40)),
               [7, 7, 7], [2, 7, 1, 8], list(range(50, 70))]

    def serve():
        eng = Engine(params, cfg, max_slots=3, max_seq_len=64, device="cpu")
        return eng, eng.generate(prompts, max_new_tokens=3)

    eng, got = serve()
    assert eng._prefill_graphs == {}
    assert eng.stats["prefill_graph_replays"] == 0
    assert eng.stats["prefill_graph_captures"] == 0
    monkeypatch.setattr(engine_mod, "_prefill", _prefill_nonzero)
    old, want = serve()
    assert got == want
    assert all(_equal(a, b) for a, b in zip(eng.caches, old.caches))


def test_new_caches_drop_the_prefill_graphs():
    """Replacing the engine's caches (as freeing its state does) forgets
    every prefill graph and its pool."""
    eng = Engine(init_params(0, TINY_DENSE, device="cpu"), TINY_DENSE,
                 max_slots=2, max_seq_len=64, device="cpu")
    eng._prefill_graphs[(1, 16)] = None
    eng._prefill_pool = object()
    eng.caches = None
    assert eng._prefill_graphs == {} and eng._prefill_pool is None
