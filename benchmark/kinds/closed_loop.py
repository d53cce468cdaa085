"""Closed loop: a fixed set of clients, each sending its next request as
soon as its last one finishes (no think time).

Mix keys: ``clients`` (a number, or "slots" for one a slot of the cell),
``prompt`` and ``output`` (lengths as
:func:`benchmark.kinds.common.quantile_pool` reads them), ``first_wave``
("residual": the first request of every client is served from set-up on,
with an output budget drawn as the rest of a lifetime already under way,
so slots turn over steadily from the window's start) and ``setup_admit_batch`` (first-wave requests admitted a
step during set-up). The first wave's prompts and budgets are one pool of
quantiles a client, the same for every seed: the window's turnover, which
they set, does not change with the seed.
"""

from __future__ import annotations

import numpy as np

from benchmark.kinds.common import (Dealer, Req, Tokens, paired, pool_lengths,
                                    quantile_pool, residual_pool)


class Source:
    def __init__(self, mix: dict, *, seed: int, vocab: int, slots: int,
                 max_seq_len: int):
        rng = np.random.default_rng([seed, 1])
        self.mix = mix
        self.clients = slots if mix["clients"] == "slots" else int(mix["clients"])
        self.prompt_len = Dealer(quantile_pool(mix["prompt"]), rng)
        self.output_len = Dealer(quantile_pool(mix["output"]), rng)
        self.rng = rng
        self.tokens = Tokens(vocab, rng)
        self.admit_batch = int(mix.get("setup_admit_batch", slots))
        self.rid = 0

    def _new(self, client: int, due, max_new=None) -> Req:
        p = self.prompt_len()
        o = self.output_len() if max_new is None else max_new
        self.rid += 1
        return Req(self.rid - 1, client, self.tokens(p), o, due=due)

    def setup_requests(self):
        """The first wave, one request a client."""
        n = self.clients
        residual = self.mix.get("first_wave") == "residual"
        sizes = paired(self.rng, quantile_pool(self.mix["prompt"], n),
                       (residual_pool if residual else quantile_pool)(self.mix["output"], n))
        out = []
        for c, (p, o) in enumerate(sizes):
            self.rid += 1
            out.append(Req(self.rid - 1, c, self.tokens(p), o, due=None))
        return out

    def start(self, t0: float) -> None:
        pass

    def poll(self, now: float):
        return []

    def next_due(self):
        return None

    def on_finish(self, req: Req, now: float):
        return [self._new(req.client, now)]

    def prompt_lengths(self):
        """Every prompt length this traffic can send."""
        return pool_lengths(self.mix["prompt"])
