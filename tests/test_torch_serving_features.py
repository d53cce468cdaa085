"""Port serving features: chunked decode, the prefix cache and greedy
speculative decoding, on the CPU at TINY size, against the JAX package's
Engine where the result does not depend on the model's numbers, and
against the port's own plain engine where it does.

The prefix counters (hits, tokens reused, inserts) depend on the prompts
alone: the JAX engine computes them with its model stubbed out, while the
port's tokens are held to its own cold engine on the flash path (the
kernels' plain versions, K4 from ``prefill_start`` > 0 included). Token
and stat equality with JAX's chunked and speculative engines runs under
``jax.disable_jit()`` in test_torch_serving.py, beside the greedy test
whose eager JAX programs it shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu.serving import Engine as JEngine
from deepgemm_ascend_tpu.serving import engine as jengine
from deepgemm_ascend_tpu.utils.logging import metrics as jmetrics
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.serving import Engine
from deepgemm_ascend_tpu_torch.serving import engine as tengine
from deepgemm_ascend_tpu_torch.utils.logging import metrics as tmetrics

PREFIX_COUNTERS = ("engine.prefix_hits", "engine.prefix_tokens_reused",
                   "engine.prefix_inserts")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """TINY's ops are too small to share out: one intra-op thread a test
    worker, so that several workers do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flash_params():
    return tmodels.init_params(0, jmodels.TINY, device="cpu")


def _counters(snap) -> dict:
    return {name: int(snap.get(name, 0)) for name in PREFIX_COUNTERS}


# ---- chunked decode ----

def test_chunked_decode_flash_path_matches_single_steps(flash_params):
    """Main path on the CPU: decode_chunk 4 and 1 give the same greedy
    tokens through the kernels' plain versions, continuous batching and
    all, and the chunk runs only the fp8 path's kernels."""
    prompts = [[5, 17, 301, 2, 44], list(range(100, 120)), [7] * 17]
    want = Engine(flash_params, jmodels.TINY, max_slots=2, max_seq_len=64,
                  device="cpu").generate(prompts, max_new_tokens=7)
    _kernels.reset_counters()
    eng = Engine(flash_params, jmodels.TINY, max_slots=2, max_seq_len=64,
                 decode_chunk=4, device="cpu")
    assert eng.generate(prompts, max_new_tokens=7) == want
    used = {n for n, c in _kernels.COUNTERS.items() if c.plain_calls}
    assert used == {"fp8_gemm", "grouped_gemm", "flash_decode",
                    "flash_prefill"}
    assert eng.stats["decode_tokens"] == 3 * 6
    assert eng.stats["decode_slot_steps"] > eng.stats["decode_tokens"]


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, 0, 1.0), (0.8, 20, 0.9)])
def test_sampled_chunked_decode_draws_as_single_steps(flash_params,
                                                      temperature, top_k,
                                                      top_p):
    """Sampling happens inside the chunk, from the engine's generator, in
    the order single steps draw: with every request admitted at the first
    iteration, decode_chunk 4 and 1 give the same sampled tokens from the
    same seed (the chunk's wasted draws come after the last kept one)."""
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    kw = dict(max_slots=2, max_seq_len=64, temperature=temperature,
              top_k=top_k, top_p=top_p, seed=5, device="cpu")
    one = Engine(flash_params, jmodels.TINY, **kw).generate(prompts, 6)
    four = Engine(flash_params, jmodels.TINY, decode_chunk=4, **kw).generate(
        prompts, 6)
    assert four == one
    assert all(0 <= t < jmodels.TINY.vocab_size for o in four for t in o)


# ---- prefix cache ----

def _sys_prompt(n=20, mul=11, add=2):
    return [(i * mul + add) % jmodels.TINY.vocab_size for i in range(n)]


def _jax_prefix_counters(serve, monkeypatch, **kw):
    """The JAX engine's prefix counters after ``serve(engine)``. They
    depend on the prompts alone (the lookup, the LRU, the insert order),
    so the model is stubbed out: its forward returns zero logits and
    leaves the caches, and the engine's own bookkeeping runs."""
    cfg = jmodels.TINY

    def stub_forward(params, tokens, caches, *args, **kwargs):
        return jnp.zeros(tokens.shape + (cfg.vocab_size,)), caches

    def stub_decode(params, tokens, caches, lens):
        return jnp.zeros(tokens.shape + (cfg.vocab_size,)), caches

    monkeypatch.setattr(jengine, "forward", stub_forward)
    monkeypatch.setattr(jengine, "_jitted_decode_step",
                        lambda cfg: stub_decode)
    jmetrics.reset()
    with jax.disable_jit():
        serve(JEngine(None, cfg, max_seq_len=64, **kw))
    monkeypatch.undo()
    return _counters(jmetrics.snapshot())


def _check_prefix(flash_params, monkeypatch, serve, slots=1, store=2):
    """``serve`` on the port's prefix engine, on its cold engine and on
    JAX's prefix engine: the port's tokens equal its cold engine's, its
    prefix counters JAX's. Returns the counters."""
    want = _jax_prefix_counters(serve, monkeypatch, max_slots=slots,
                                prefix_cache_slots=store)
    kw = dict(max_slots=slots, max_seq_len=64, device="cpu")
    tmetrics.reset()
    got = serve(Engine(flash_params, jmodels.TINY, prefix_cache_slots=store,
                       **kw))
    counters = _counters(tmetrics.snapshot())
    assert got == serve(Engine(flash_params, jmodels.TINY, **kw))
    assert counters == want
    return counters


def _one_by_one(runs):
    """A serve function: each (prompt, max_new) of ``runs`` alone."""
    return lambda eng: [eng.generate([p], max_new_tokens=n)[0]
                        for p, n in runs]


def test_prefix_cache_exact_repeat_and_shared_prefix(flash_params,
                                                     monkeypatch):
    sysp = _sys_prompt()
    got = _check_prefix(flash_params, monkeypatch,
                        _one_by_one([(sysp + [7, 8], 4), (sysp + [7, 8], 4),
                                     (sysp + [9], 4)]))
    assert got == {"engine.prefix_hits": 2,
                   "engine.prefix_tokens_reused": 32,
                   "engine.prefix_inserts": 1}


def test_prefix_cache_lru_eviction(flash_params, monkeypatch):
    """One store slot: B evicts A, A misses and re-inserts, A then hits."""
    pa, pb = _sys_prompt(18, 3, 1), _sys_prompt(18, 5, 4)
    got = _check_prefix(flash_params, monkeypatch,
                        _one_by_one([(pa, 2), (pb, 2), (pa, 2), (pa, 2)]),
                        store=1)
    assert got == {"engine.prefix_hits": 1,
                   "engine.prefix_tokens_reused": 16,
                   "engine.prefix_inserts": 3}


def test_prefix_cache_same_step_eviction_cannot_clobber_hit(
        flash_params, monkeypatch):
    """One step admits a cold 33-token prompt (its own bucket) and a prompt
    that hits the full one-slot store: the cold admission's insert waits
    until the hit has copied its row out."""
    sysp = _sys_prompt()
    hit_prompt = sysp + [7]
    cold_prompt = [(i * 5 + 3) % jmodels.TINY.vocab_size for i in range(33)]

    def serve(eng):
        eng.generate([hit_prompt], max_new_tokens=1)
        ids = [eng.scheduler.submit(cold_prompt, 3),
               eng.scheduler.submit(hit_prompt, 3)]
        while eng.scheduler.has_work:
            eng.step()
        return [eng.scheduler.pop_result(i).output for i in ids]

    got = _check_prefix(flash_params, monkeypatch, serve,
                        slots=2, store=1)
    assert got["engine.prefix_hits"] == 1


def test_prefix_cache_batched_hits_resume_in_one_forward(
        flash_params, monkeypatch):
    """Three requests sharing a 32-token system prompt admitted in one
    step after a seeding request: their suffix windows prefill from start
    32 in one forward (three rows and a padding row), then decode."""
    sysp = _sys_prompt(32, 7, 1)
    prompts = [sysp + [(i * 13 + j) % jmodels.TINY.vocab_size
                       for j in range(4)] for i in range(3)]

    def serve(eng):
        first = eng.generate([prompts[0]], max_new_tokens=1)
        return first + eng.generate(prompts, max_new_tokens=3)

    got = _check_prefix(flash_params, monkeypatch, serve,
                        slots=4)
    assert got == {"engine.prefix_hits": 3,
                   "engine.prefix_tokens_reused": 96,
                   "engine.prefix_inserts": 1}


# ---- speculative decoding ----

SPEC_PROMPTS = [[5, 9, 2, 7], [3, 3, 8]]


def _spec_run(params, cfg, n_new=10, **kw):
    eng = Engine(params, cfg, max_slots=2, max_seq_len=64, device="cpu", **kw)
    return eng.generate(SPEC_PROMPTS, max_new_tokens=n_new), eng


def _junk_drafts(hist, k, n=3):
    return [(i * 7 + 1) % jmodels.TINY.vocab_size for i in range(k)]


def test_spec_lossless_vs_garbage_drafts(flash_params, monkeypatch):
    out_real, eng_real = _spec_run(flash_params, jmodels.TINY,
                                   speculative_k=3)
    monkeypatch.setattr(tengine, "_draft_prompt_lookup", _junk_drafts)
    out_junk, eng_junk = _spec_run(flash_params, jmodels.TINY,
                                   speculative_k=3)
    assert out_real == out_junk
    assert eng_junk.stats["decode_steps"] >= eng_real.stats["decode_steps"]


def test_spec_output_shape_and_accounting(flash_params):
    out_plain, _ = _spec_run(flash_params, jmodels.TINY)
    out_spec, eng = _spec_run(flash_params, jmodels.TINY, speculative_k=3)
    assert [len(o) for o in out_spec] == [len(o) for o in out_plain]
    assert (eng.stats["decode_tokens"]
            == sum(len(o) for o in out_spec) - eng.stats["prefills"])
    assert all(0 <= t < jmodels.TINY.vocab_size for o in out_spec for t in o)


def test_spec_respects_token_budget(flash_params):
    out, _ = _spec_run(flash_params, jmodels.TINY, n_new=2, speculative_k=3)
    assert [len(o) for o in out] == [2, 2]


def test_spec_falls_back_near_cache_end(flash_params):
    """A 16-token cache holds no verify window past length 0: every token
    after the prefill's comes from a plain step."""
    eng = Engine(flash_params, jmodels.TINY, max_slots=1, max_seq_len=16,
                 speculative_k=4, device="cpu")
    out = eng.generate([[1, 2, 3, 4, 5, 6, 7, 8]], max_new_tokens=8)[0]
    assert len(out) == 8
    plain = Engine(flash_params, jmodels.TINY, max_slots=1, max_seq_len=16,
                   device="cpu").generate([[1, 2, 3, 4, 5, 6, 7, 8]], 8)[0]
    assert out == plain
    assert eng.stats["decode_steps"] == 7


@pytest.mark.parametrize("kwargs,match", [
    ({"temperature": 0.7}, "greedy"), ({"top_k": 5}, "greedy"),
    ({"top_p": 0.9}, "greedy"), ({"decode_chunk": 4}, "decode_chunk"),
    ({"speculative_k": 16}, "verify window")])
def test_spec_refuses_what_jax_refuses(flash_params, kwargs, match):
    kw = {"speculative_k": 2, **kwargs}
    with pytest.raises(ValueError, match=match):
        Engine(flash_params, jmodels.TINY, max_slots=1, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        JEngine(None, jmodels.TINY, max_slots=1, **kw)


def test_spec_custom_draft_fn_oracle(flash_params):
    """Drafting the recorded greedy continuation lands k+1 tokens a verify
    and is still lossless."""
    out_ref, eng_ref = _spec_run(flash_params, jmodels.TINY, speculative_k=3)
    plen = [len(p) for p in SPEC_PROMPTS]

    def oracle(slot, hist, k):
        seq = out_ref[slot]
        pos = len(hist) - plen[slot]
        cont = list(seq[max(pos, 0):pos + k])
        pad = cont[-1] if cont else (hist[-1] if hist else 0)
        return (cont + [pad] * k)[:k]

    tmetrics.reset()
    out_oracle, eng = _spec_run(flash_params, jmodels.TINY, speculative_k=3,
                                draft_fn=oracle)
    snap = tmetrics.snapshot()
    assert out_oracle == out_ref
    assert eng.stats["decode_steps"] <= eng_ref.stats["decode_steps"]
    # Every verify but the budget's last accepts all three drafts.
    assert snap["engine.spec_accepted"] >= snap["engine.spec_proposed"] - 6


@pytest.mark.parametrize("seed", range(6))
def test_draft_prompt_lookup_matches_jax(seed):
    """The port's copy of the n-gram drafter against the JAX engine's over
    seeded random histories (short alphabets, so that n-grams repeat)."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        hist = rng.integers(0, 4, size=int(rng.integers(0, 24))).tolist()
        k, n = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        assert (tengine._draft_prompt_lookup(hist, k, n)
                == jengine._draft_prompt_lookup(hist, k, n)), (hist, k, n)


def test_draft_prompt_lookup_unit():
    d = tengine._draft_prompt_lookup
    assert d([7, 8, 9, 4, 5, 6, 7, 8, 9], 3) == [4, 5, 6]
    assert d([1, 2, 3, 4, 1, 2, 3], 3) == [4, 1, 2]
    assert d([9, 1, 2, 3, 9, 9, 1, 2, 3], 2) == [9, 9]
    assert d([1, 2, 3, 4, 5], 2) == [5, 5]
    assert d([], 2) == [0, 0]


def test_counter_on_card_counts_replays_not_captures():
    """A CUDA graph's capture goes through the wrappers but runs nothing;
    each replay launches what it captured: ``on_card`` leaves the first
    out and puts the second in, and ``reset`` clears both."""
    from deepgemm_ascend_tpu_torch.ops import _kernels
    c = _kernels.Counter("k")
    c.launches = 5          # 2 eager launches, 3 recorded by a capture
    c.captured = 3
    c.replayed = 3 * 4      # four replays
    assert c.on_card() == 2 + 12
    c.reset()
    assert (c.launches, c.captured, c.replayed, c.on_card()) == (0, 0, 0, 0)


# ---- the attention gates: kernel coverage on a CUDA cache ----

@pytest.mark.parametrize("hd,g,ok", [(128, 1, True), (128, 4, True),
                                     (128, 16, True), (64, 2, True),
                                     (128, 3, False), (96, 4, False)])
def test_cuda_geometry_predicate(hd, g, ok):
    """One rule for the CUDA attention kernels' coverage (head sizes 64
    and 128, GQA groups 1-16 by powers of two): the wrappers raise by
    it."""
    from deepgemm_ascend_tpu_torch.ops.flash_common import (
        check_cuda_geometry, cuda_geometry_ok)
    assert cuda_geometry_ok(hd, g) is ok
    if ok:
        check_cuda_geometry("k", hd, g)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            check_cuda_geometry("k", hd, g)


def test_tiny_dense_keeps_the_flash_gates_on_the_cpu():
    """The attention gates are the JAX package's: TINY_DENSE's head_dim
    64 takes the flash branches (on a CPU cache their plain versions)."""
    params = tmodels.init_params(0, jmodels.TINY_DENSE, device="cpu")
    tmetrics.reset()
    out = Engine(params, jmodels.TINY_DENSE, max_slots=2, max_seq_len=64,
                 device="cpu").generate([[1, 2, 3], [4, 5]], 3)
    snap = tmetrics.snapshot()
    assert [len(o) for o in out] == [3, 3]
    assert snap["attention.flash_decode_trace"] > 0
    assert snap["attention.flash_prefill_trace"] > 0
    assert "attention.xla_fallback_trace" not in snap
