"""The traffic kinds: the seed fixes the requests, the pool fixes the sizes."""

import json
import math
from pathlib import Path

import pytest

from benchmark.kinds import closed_loop, open_loop, sessions
from benchmark.kinds.common import Req, quantile_pool

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
DATA = Path(__file__).resolve().parent / "data"


def _mix(name):
    """A mix of BENCHMARK.json's, or one of the tests' data (``tiny_*``)."""
    return json.loads(((DATA if name.startswith("tiny_") else TRAFFIC) / f"{name}.json").read_text())


def _draw(kind, mix, seed, n=40):
    src = kind.Source(mix, seed=seed, vocab=32768, slots=16, max_seq_len=4096)
    src.start(100.0)
    reqs = list(src.setup_requests())
    reqs += src.poll(100.0 + 60.0)
    while len(reqs) < n:
        r = reqs[len(reqs) % max(1, len(reqs))]
        r.tokens = list(range(1, 1 + min(r.max_new, 8)))
        reqs += src.on_finish(r, 101.0)
    return [(r.prompt, r.max_new, r.due) for r in reqs[:n]]


@pytest.mark.parametrize("kind,mix", [(closed_loop, "decode"), (open_loop, "tiny_rag"),
                                      (sessions, "tiny_sessions")])
def test_the_seed_fixes_the_requests(kind, mix):
    m = _mix(mix)
    a = _draw(kind, m, 2 ** 33 + 5)
    assert a == _draw(kind, m, 2 ** 33 + 5)
    assert a != _draw(kind, m, 2 ** 33 + 6)


def test_every_seed_draws_the_same_pool_of_sizes():
    m = _mix("decode")
    one = closed_loop.Source(m, seed=7, vocab=100, slots=4, max_seq_len=4096)
    two = closed_loop.Source(m, seed=8, vocab=100, slots=4, max_seq_len=4096)
    n = len(one.prompt_len.values)
    a = sorted(one.prompt_len() for _ in range(n))
    b = sorted(two.prompt_len() for _ in range(n))
    assert a == b == sorted(quantile_pool(m["prompt"]).tolist())


def test_pools_keep_to_their_clips_and_median():
    for mix, key in (("tiny_rag", "prompt"), ("tiny_rag", "output")):
        d = _mix(mix)[key]
        pool = quantile_pool(d)
        assert pool.min() >= d["min"] and pool.max() <= d["max"]
        assert abs(sorted(pool)[len(pool) // 2] - d["median"]) <= 0.02 * d["median"] + 1


@pytest.mark.parametrize("key,mean", [("prompt", 161.31), ("output", 337.99)])
def test_the_decode_mix_keeps_its_sources_means(key, mean):
    """ShareGPT's published means (vLLM, arXiv:2309.06180, Fig. 11), drawn
    as exponentials: the pool's mean and median are the exponential's."""
    d = _mix("decode")[key]
    assert d["mean"] == mean
    pool = quantile_pool(d)
    assert pool.min() >= d["min"]
    assert abs(pool.mean() - mean) <= 0.005 * mean
    assert abs(sorted(pool)[len(pool) // 2] - mean * math.log(2)) <= 1


def test_open_loop_arrives_at_its_rate():
    m = _mix("tiny_rag")
    src = open_loop.Source(m, seed=3, vocab=100, slots=4, max_seq_len=4096)
    src.start(0.0)
    n = len(src.poll(512 / m["rate_per_s"]))
    assert abs(n - 512) <= 3


def test_sessions_grow_from_served_tokens_and_stay_in_the_cache():
    m = dict(_mix("tiny_sessions"), max_total=4096)
    src = sessions.Source(m, seed=4, vocab=100, slots=2, max_seq_len=4096)
    r = src.setup_requests()[0]
    for turn in range(12):
        r.tokens = list(range(1, r.max_new + 1))
        nxt = src.on_finish(r, 1.0)[0]
        assert len(nxt.prompt) + nxt.max_new <= 4096 - sessions.MARGIN
        if nxt.session["turn"] > 1:
            assert nxt.prompt[:len(r.prompt) + len(r.tokens)] == r.prompt + r.tokens
        r = nxt


def test_closed_loop_first_wave_has_residual_budgets():
    m = _mix("tiny_decode")
    src = closed_loop.Source(m, seed=5, vocab=100, slots=64, max_seq_len=4096)
    wave = src.setup_requests()
    assert len(wave) == 64 and all(isinstance(r, Req) for r in wave)
    assert min(r.max_new for r in wave) < m["output"]["min"]


@pytest.mark.parametrize("kind,mix", [(closed_loop, "decode"), (sessions, "tiny_sessions")])
def test_every_seed_starts_with_the_same_first_wave_sizes(kind, mix):
    m = _mix(mix)

    def sizes(seed):
        wave = kind.Source(m, seed=seed, vocab=100, slots=32, max_seq_len=4096).setup_requests()
        return sorted((len(r.prompt), r.max_new, (r.session or {}).get("turns")) for r in wave)
    assert sizes(2 ** 32 + 1) == sizes(2 ** 32 + 2)
