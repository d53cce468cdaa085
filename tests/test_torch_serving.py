"""Port serving slice: the scheduler, sampling, and the Engine vs the JAX
package's Engine, on the CPU at TINY size.

Token equality against the JAX engine: the JAX engine runs under
``jax.disable_jit()``, so that both packages round at the same points (jit
lets XLA fuse bf16 round trips away, which moves TINY's logits by ~1e-1),
and on the fallback attention path (``use_flash_decode=False``), where the
two packages' logits then agree to ~1e-6. The test first checks that every
greedy step's JAX top-1 margin exceeds 1e-3, so a mismatch means a bug and
not a near-tie. On the flash path the logits agree only to a few 1e-2
(bf16/int8 rounding flips, see test_torch_model.py), below the margins of
a random TINY model, so there the port engine is held to its own unbatched
generation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu.serving import Engine as JEngine
from deepgemm_ascend_tpu.serving import engine as jengine
from deepgemm_ascend_tpu.serving import sample_logits as jsample_logits
from deepgemm_ascend_tpu.utils.logging import metrics as jmetrics
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.serving import Engine, Scheduler, sample_logits
from deepgemm_ascend_tpu_torch.serving import engine as engine_mod
from deepgemm_ascend_tpu_torch.utils.logging import metrics as tmetrics
from torch_bridge import tree_of

PROMPTS = [[5, 17, 301, 2, 44], list(range(100, 120)), [7] * 17]
MARGIN = 1e-3


# ---- scheduler (copied module: the JAX package's scheduler tests) ----

def test_scheduler_fifo_and_slots():
    s = Scheduler(max_slots=2, max_seq_len=64)
    r1 = s.submit([1, 2, 3], max_new_tokens=4)
    r2 = s.submit([4], max_new_tokens=4)
    r3 = s.submit([5, 6], max_new_tokens=4)
    adm = s.admissions()
    assert [a.req_id for a in adm] == [r1, r2]
    assert s.active_slots() == [0, 1]
    assert not s.admissions()
    for _ in range(4):
        s.record_tokens({0: 7})
    assert r1 in s.finished
    assert [a.req_id for a in s.admissions()] == [r3]
    assert s.result(r1).output == [7, 7, 7, 7]


def test_scheduler_eos_and_validation():
    s = Scheduler(max_slots=1, max_seq_len=16, eos_id=0)
    r = s.submit([1, 2], max_new_tokens=10)
    s.admissions()
    s.record_tokens({0: 5})
    s.record_tokens({0: 0})            # EOS
    assert s.result(r).output == [5, 0]
    with pytest.raises(ValueError):
        s.submit([], 1)
    with pytest.raises(ValueError):
        s.submit([1] * 10, 10)
    with pytest.raises(ValueError):
        s.submit([1, 2], max_new_tokens=0)


def test_scheduler_pop_result_releases():
    s = Scheduler(max_slots=1, max_seq_len=16)
    rid = s.submit([1], max_new_tokens=1)
    s.admissions()
    s.record_tokens({0: 3})
    assert s.pop_result(rid).output == [3]
    assert rid not in s.finished


# ---- sampling ----

def test_sample_logits_modes():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0], [9.0, 0.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    assert sample_logits(logits).tolist() == [1, 0]
    assert sample_logits(logits, gen, temperature=5.0, top_k=1).tolist() \
        == [1, 0]
    draws = {int(sample_logits(logits, gen, temperature=2.0, top_k=2)[0])
             for _ in range(24)}
    assert draws <= {1, 2}
    assert sample_logits(logits, gen, temperature=3.0,
                         top_p=1e-6).tolist() == [1, 0]
    assert sample_logits(logits, gen, temperature=2.0,
                         top_p=0.0).tolist() == [1, 0]
    s = sample_logits(logits, gen, temperature=1.0, top_k=99, top_p=0.9)
    assert s.shape == (2,) and s.dtype == torch.int32 and bool((s >= 0).all())


def test_sample_logits_seeded_draws_repeat():
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    a = sample_logits(logits, torch.Generator().manual_seed(7),
                      temperature=1.0, top_p=0.8)
    b = sample_logits(logits, torch.Generator().manual_seed(7),
                      temperature=1.0, top_p=0.8)
    assert torch.equal(a, b)


# Kept sets of top-k / top-p against JAX: each package's own draw is stubbed
# out (jax.random.categorical, the port's engine._categorical) to expose the
# logits it would sample from. Logits ~N(0, 3²), 16 × 32000 per seed, from numpy.
SAMPLING_MODES = [(0.7, 50, 1.0), (0.7, 0, 0.9), (1.3, 40, 0.95)]
# Tokens a row may differ by. f32: the one boundary token that cumsum order
# could flip (the port sums f32 with torch.cumsum, not in XLA's order).
# bf16: both packages truncate in bf16 with the same roundings
# (the temperature rounded to bf16 first, jax.nn.softmax's sum in f32, XLA's
# blocked prefix sum); this test measures 0 rows of 48 differing in every
# mode (truncating in f32 instead left 125 and 26 of 160 rows differing in
# the two top-p modes).
KEPT_ALLOWANCE = {"f32": 1, "bf16": 0}


def _kept_jax(x, dtype, monkeypatch, **kw):
    seen = {}

    def draw(key, logits, axis=-1):
        seen["kept"] = np.asarray(logits.astype(jnp.float32)) > -np.inf
        return jnp.argmax(logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", draw)
    jsample_logits(jnp.asarray(x, dtype), jax.random.PRNGKey(0), **kw)
    return seen["kept"]


def _kept_torch(x, dtype, monkeypatch, **kw):
    seen = {}

    def draw(probs, generator):
        seen["kept"] = (probs > 0).numpy()
        return torch.argmax(probs, dim=-1)

    monkeypatch.setattr(engine_mod, "_categorical", draw)
    sample_logits(torch.from_numpy(x).to(dtype), **kw)
    return seen["kept"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLING_MODES)
def test_sample_logits_kept_set_matches_jax(dtype, temperature, top_k, top_p,
                                            monkeypatch):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    for seed in range(3):
        x = (np.random.default_rng(seed).standard_normal((16, 32000))
             * 3).astype(np.float32)
        want = _kept_jax(x, jdt, monkeypatch, **kw)
        got = _kept_torch(x, tdt, monkeypatch, **kw)
        assert want.sum(-1).min() >= 1
        diff = (want != got).sum(-1)
        assert diff.max() <= KEPT_ALLOWANCE[dtype], (seed, diff.tolist())


# ---- engine ----

@pytest.fixture(scope="module")
def fallback_pair():
    cfg = dataclasses.replace(jmodels.TINY, use_flash_decode=False)
    jp = jmodels.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, tmodels.params_from_numpy(tree_of(jp), cfg, device="cpu")


def test_engine_greedy_tokens_match_jax_engine(fallback_pair, monkeypatch):
    """Four equal-length prompts through two slots: every prefill and decode
    row the JAX engine samples belongs to a live request (no padding rows,
    no idle slots), so the recorded margins are exactly the ones that
    decide the tokens."""
    import deepgemm_ascend_tpu.serving.engine as jengine
    cfg, jp, tp = fallback_pair
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


def test_engine_flash_path_batched_matches_unbatched():
    """Main path on the CPU: continuous batching (3 requests through 2
    slots, so a slot is reused) gives each request the tokens it gets when
    served alone, and only the plain versions of the fp8 path's kernels
    run (the int8 family's not at all)."""
    tp = tmodels.init_params(0, jmodels.TINY, device="cpu")
    _kernels.reset_counters()
    eng = Engine(tp, jmodels.TINY, max_slots=2, max_seq_len=64, device="cpu")
    got = eng.generate(PROMPTS, max_new_tokens=5)
    alone = [Engine(tp, jmodels.TINY, max_slots=1, max_seq_len=64,
                    device="cpu").generate([p], max_new_tokens=5)[0]
             for p in PROMPTS]
    assert got == alone
    assert all(len(t) == 5 for t in got)
    assert eng.stats["prefills"] == 3 and eng.tokens_per_second > 0
    counts = {n: (c.launches, c.plain_calls)
              for n, c in _kernels.COUNTERS.items()}
    fp8_path = ("fp8_gemm", "grouped_gemm", "flash_decode", "flash_prefill")
    assert all(launches == 0 and (calls > 0) == (name in fp8_path)
               for name, (launches, calls) in counts.items()), counts


def test_engine_padding_rows_write_no_cache_row():
    """Three same-bucket admissions pad the prefill to 4 rows; the padding
    row (slot -1) must not touch any slot's cache. (The decode step that
    follows runs every slot, and writes the idle slot 3 at position 0 —
    as in the JAX engine — so rows from 1 on are checked.)"""
    tp = tmodels.init_params(1, jmodels.TINY, device="cpu")
    eng = Engine(tp, jmodels.TINY, max_slots=4, max_seq_len=64, device="cpu")
    for c in eng.caches:
        c.k_q[3].fill_(9)
        c.k_s[3].fill_(0.5)
    for p in ([1, 2, 3], [4, 5], [6]):
        eng.scheduler.submit(p, max_new_tokens=2)
    eng.step()
    for c in eng.caches:
        assert bool((c.k_q[3, :, 1:] == 9).all())
        assert bool((c.k_s[3, :, 1:] == 0.5).all())


@pytest.mark.parametrize("kwargs", [{"mesh": "one rank"}])
def test_engine_refuses_later_slice_features(kwargs, tmp_path):
    """The mesh, which the engine refused before the sharded slice, now
    serves: on a mesh of one rank (a gloo group of this process alone) the
    engine gives the one-device engine's tokens, and the steps it runs are
    the sharded ones."""
    from torch_dist_worker import one_rank_mesh
    tp = tmodels.init_params(0, jmodels.TINY_DENSE, device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    with one_rank_mesh(tmp_path) as mesh:
        eng = Engine(tp, jmodels.TINY_DENSE, max_slots=2, max_seq_len=64,
                     device="cpu", mesh=mesh)
        assert eng._decode_sampled is not None
        got = eng.generate(prompts, max_new_tokens=4)
    assert got == Engine(
        tp, jmodels.TINY_DENSE, max_slots=2, max_seq_len=64,
        device="cpu").generate(prompts, max_new_tokens=4)


def test_engine_temperature_sampling_runs():
    tp = tmodels.init_params(0, jmodels.TINY_DENSE, device="cpu")
    out = Engine(tp, jmodels.TINY_DENSE, max_slots=2, max_seq_len=64,
                 temperature=1.0, top_k=20, top_p=0.9, seed=3,
                 device="cpu").generate([[1, 2, 3], [4]], max_new_tokens=4)
    assert [len(o) for o in out] == [4, 4]
    assert all(0 <= t < jmodels.TINY_DENSE.vocab_size for o in out for t in o)


# ---- the serving features against JAX's engine (same eager programs) ----

def _margins(logits) -> np.ndarray:
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _record_margins(monkeypatch):
    """Make the JAX engine record the top-1 margins of the rows that decide
    its emitted tokens: every prefill row (padding rows too), the active
    slots' rows of each decode step or chunk (wasted steps too), and rows
    0..accepted of each active slot's verify window. Returns a function
    that gives the margins recorded so far."""
    seen, verifies, decisive = [], [], []
    real_sample, real_forward = jengine.sample_logits, jengine.forward
    real_emit = JEngine._emit_tokens

    def sample(logits, key, **kw):
        seen.append(_margins(logits))
        return real_sample(logits, key, **kw)

    def forward(*args, **kw):
        logits, caches = real_forward(*args, **kw)
        verifies.append(_margins(logits))
        return logits, caches

    def emit(self, out_rows, active, sched, emitted, row_limit=None):
        if row_limit is None:
            steps = seen[len(seen) - out_rows.shape[0]:]
            del seen[len(seen) - out_rows.shape[0]:]
            decisive.extend(x for m in steps for x in m[active])
        else:
            decisive.extend(x for slot in active
                            for x in verifies[-1][slot, :row_limit[slot] + 1])
        decisive.extend(x for m in seen for x in np.ravel(m))
        seen.clear()
        return real_emit(self, out_rows, active, sched, emitted, row_limit)

    monkeypatch.setattr(jengine, "sample_logits", sample)
    monkeypatch.setattr(jengine, "forward", forward)
    monkeypatch.setattr(JEngine, "_emit_tokens", emit)
    return lambda: decisive + [x for m in seen for x in np.ravel(m)]


def test_chunked_decode_matches_jax_engine(fallback_pair, monkeypatch):
    """The port at decode_chunk=4 emits the JAX Engine(decode_chunk=4)'s
    greedy tokens with the same decode_steps and decode_slot_steps, and
    its own decode_chunk=1 engine's tokens. Two 12-token prompts in an
    18-token cache: the first chunk wastes three steps of the 2-token
    request; a second would pass the cache's end, so the last token
    decodes in a single step."""
    cfg, jp, tp = fallback_pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=12).tolist()
               for _ in range(2)]
    budgets = [6, 2]

    def serve(eng):
        ids = [eng.scheduler.submit(p, n) for p, n in zip(prompts, budgets)]
        while eng.scheduler.has_work:
            eng.step()
        return [eng.scheduler.pop_result(i).output for i in ids]

    margins = _record_margins(monkeypatch)
    with jax.disable_jit():
        jeng = JEngine(jp, cfg, max_slots=2, max_seq_len=18, decode_chunk=4)
        want = serve(jeng)
    assert min(margins()) > MARGIN, min(margins())
    eng = Engine(tp, cfg, max_slots=2, max_seq_len=18, decode_chunk=4,
                 device="cpu")
    got = serve(eng)
    assert got == want and [len(o) for o in got] == budgets
    assert (eng.stats["decode_steps"], eng.stats["decode_slot_steps"]) \
        == (jeng.stats["decode_steps"], jeng.stats["decode_slot_steps"]) \
        == (4 + 1, 4 * 2 + 1)
    assert eng.stats["decode_tokens"] == jeng.stats["decode_tokens"]
    assert eng.stats["graph_replays"] == 0 and eng.graph_launches is None
    assert serve(Engine(tp, cfg, max_slots=2, max_seq_len=18,
                        device="cpu")) == got


SPEC_PROMPTS = [[5, 9, 2, 7], [3, 3, 8]]


def test_spec_matches_jax_engine(fallback_pair, monkeypatch):
    """The same drafts through the port's and JAX's speculative engines
    give the same tokens, accepted and proposed counts and stats. The
    drafts are the port's plain greedy continuation with every third
    draft position wrong, so that verifies accept 0 to 3 drafts."""
    cfg, jp, tp = fallback_pair
    ref = Engine(tp, cfg, max_slots=2, max_seq_len=64, device="cpu").generate(
        SPEC_PROMPTS, max_new_tokens=9)
    plen = [len(p) for p in SPEC_PROMPTS]

    def drafts(slot, hist, k):
        pos = len(hist) - plen[slot]
        cont = (ref[slot] + [0] * k)[pos:pos + k]
        return [(t + 1) % cfg.vocab_size if (pos + i) % 3 == 2 else t
                for i, t in enumerate(cont)]

    margins = _record_margins(monkeypatch)
    jmetrics.reset()
    with jax.disable_jit():
        jeng = JEngine(jp, cfg, max_slots=2, max_seq_len=64, speculative_k=3,
                       draft_fn=drafts)
        want = jeng.generate(SPEC_PROMPTS, max_new_tokens=9)
    jsnap = jmetrics.snapshot()
    assert min(margins()) > MARGIN, min(margins())
    tmetrics.reset()
    eng = Engine(tp, cfg, max_slots=2, max_seq_len=64, speculative_k=3,
                 draft_fn=drafts, device="cpu")
    got = eng.generate(SPEC_PROMPTS, max_new_tokens=9)
    tsnap = tmetrics.snapshot()
    assert got == want == ref
    assert 0 < jsnap["engine.spec_accepted"] < jsnap["engine.spec_proposed"]
    for key in ("engine.spec_accepted", "engine.spec_proposed"):
        assert tsnap[key] == jsnap[key], key
    for key in ("decode_steps", "decode_slot_steps", "decode_tokens"):
        assert eng.stats[key] == jeng.stats[key], key
