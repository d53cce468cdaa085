"""Open loop: requests due on a Poisson schedule at a fixed rate, whether
or not earlier ones have finished; each is timed from its due time.

Mix keys: ``rate_per_s``, ``prompt`` and ``output`` (lengths as
:func:`benchmark.kinds.common.quantile_pool` reads them). The gaps between
arrivals are the exponential's mid-quantiles dealt in seeded order.
"""

from __future__ import annotations

import numpy as np

from benchmark.kinds.common import (Dealer, Req, Tokens, pool_lengths, quantile_pool,
                                    uniform_pool)


class Source:
    def __init__(self, mix: dict, *, seed: int, vocab: int, slots: int,
                 max_seq_len: int):
        rng = np.random.default_rng([seed, 2])
        self.mix = mix
        self.rate = float(mix["rate_per_s"])
        self.prompt_len = Dealer(quantile_pool(mix["prompt"]), rng)
        self.output_len = Dealer(quantile_pool(mix["output"]), rng)
        self.gap = Dealer(-np.log(1.0 - uniform_pool()) / self.rate, rng)
        self.tokens = Tokens(vocab, rng)
        self.rid = 0
        self.t_next = None

    def setup_requests(self):
        return []

    def start(self, t0: float) -> None:
        self.t_next = t0 + self.gap()

    def next_due(self):
        return self.t_next

    def poll(self, now: float):
        out = []
        while self.t_next is not None and self.t_next <= now:
            p = self.prompt_len()
            out.append(Req(self.rid, self.rid, self.tokens(p), self.output_len(),
                           due=self.t_next))
            self.rid += 1
            self.t_next += self.gap()
        return out

    def on_finish(self, req: Req, now: float):
        return []

    def prompt_lengths(self):
        """Every prompt length this traffic can send."""
        return pool_lengths(self.mix["prompt"])
