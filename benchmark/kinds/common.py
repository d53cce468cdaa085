"""What every traffic kind shares: the request record and seeded draws.

Lengths come from a fixed pool of a distribution's quantiles, dealt in an
order drawn from the seed: every seed serves the same set of sizes, so a
run's work does not change with its seed, only its order and its tokens.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional

import numpy as np

POOL = 512


@dataclasses.dataclass
class Req:
    """One request as the benchmark sees it. Times are ``perf_counter``
    seconds; ``due`` is when it was due (open loop) or submitted (closed
    loop), None for requests served during set-up; ``token_t`` holds each
    token's time and ``hit`` the prompt tokens a prefix cache served."""
    rid: int
    client: int
    prompt: List[int]
    max_new: int
    due: Optional[float] = None
    submit_t: Optional[float] = None
    engine_id: Optional[int] = None
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    done_t: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_t: List[float] = dataclasses.field(default_factory=list)
    hit: int = 0
    session: Optional[dict] = None


def quantile_pool(dist: dict, n: int = POOL) -> np.ndarray:
    """``n`` lengths at the mid-quantiles of a distribution, clipped to
    [``min``, ``max``] (either may be left out): an exponential of ``mean``
    where that is given (the spread that a published mean alone implies),
    else a lognormal with ``median`` and ``sigma``."""
    u = uniform_pool(n)
    if "mean" in dist:
        x = dist["mean"] * -np.log1p(-u)
    else:
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf(p) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist.get("min", 1), dist.get("max")).astype(np.int64)


class Dealer:
    """Deals a pool's values in seeded random order, reshuffled each pass."""

    def __init__(self, values: np.ndarray, rng: np.random.Generator):
        self.values = np.asarray(values)
        self.rng = rng
        self.order: List[int] = []

    def __call__(self) -> int:
        if not self.order:
            self.order = list(self.rng.permutation(len(self.values)))
        return self.values[self.order.pop()].item()


def uniform_pool(n: int = POOL) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def paired(rng: np.random.Generator, *pools) -> list:
    """Tuples of the pools' values joined in one fixed order (the same for
    every seed), dealt in seeded order."""
    fixed = np.random.default_rng(0)
    cols = [np.asarray(pools[0])] + [np.asarray(p)[fixed.permutation(len(p))]
                                     for p in pools[1:]]
    rows = [tuple(c[i].item() for c in cols) for i in range(len(cols[0]))]
    return [rows[i] for i in rng.permutation(len(rows))]


def residual_pool(dist: dict, n: int) -> np.ndarray:
    """``n`` mid-quantiles of the output still to come of requests found
    under way at a random instant: U·L with L length-biased (a slot is
    more often busy with a long request) and U uniform, at least 1."""
    lengths = quantile_pool(dist).astype(np.float64)
    r = (uniform_pool(64)[:, None] * lengths[None, :]).ravel()
    w = np.broadcast_to(lengths[None, :], (64, len(lengths))).ravel()
    order = np.argsort(r, kind="stable")
    cum = np.cumsum(w[order]) / w.sum()
    idx = np.searchsorted(cum, uniform_pool(n))
    return np.maximum(1, np.ceil(r[order][idx])).astype(np.int64)


class Tokens:
    """Prompt tokens from the seed, in [1, vocab)."""

    def __init__(self, vocab: int, rng: np.random.Generator):
        self.vocab = vocab
        self.rng = rng

    def __call__(self, n: int) -> List[int]:
        return self.rng.integers(1, self.vocab, size=n).tolist()


def pool_lengths(dist: dict) -> List[int]:
    """The distinct lengths a pool of ``dist`` holds."""
    return sorted(set(quantile_pool(dist).tolist()))
