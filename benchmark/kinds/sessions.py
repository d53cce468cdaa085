"""Multi-turn sessions in a closed loop: each client runs sessions of
``turns`` turns; a turn's prompt is the previous turn's prompt, the tokens
served for it and a new message, so a prefix cache can hold the history.

Mix keys: ``clients`` (a number, or "slots"), ``turns`` (uniform
``min``..``max``), ``first_prompt``, ``message`` and ``output`` (lengths as
:func:`benchmark.kinds.common.quantile_pool` reads them), ``max_total`` (a
session ends where its next turn, with the least output, would pass it;
an output budget is cut to fit) and ``setup_admit_batch``. The first
turns of the first sessions are served from set-up on; their prompt
lengths and turn counts are one pool of quantiles a client, the same for
every seed.
"""

from __future__ import annotations

import numpy as np

from benchmark.kinds.common import Dealer, Req, Tokens, paired, quantile_pool, uniform_pool

# Rows left free at the cache's end: a chunk of decode steps never reaches it.
MARGIN = 16


class Source:
    def __init__(self, mix: dict, *, seed: int, vocab: int, slots: int,
                 max_seq_len: int):
        rng = np.random.default_rng([seed, 3])
        self.mix = mix
        self.clients = slots if mix["clients"] == "slots" else int(mix["clients"])
        t = mix["turns"]
        self.turns = Dealer(np.arange(t["min"], t["max"] + 1), rng)
        self.first = Dealer(quantile_pool(mix["first_prompt"]), rng)
        self.message = Dealer(quantile_pool(mix["message"]), rng)
        self.output_len = Dealer(quantile_pool(mix["output"]), rng)
        self.tokens = Tokens(vocab, rng)
        self.rng = rng
        self.limit = min(int(mix["max_total"]), max_seq_len) - MARGIN
        self.admit_batch = int(mix.get("setup_admit_batch", slots))
        self.rid = 0

    def _req(self, client, prompt, session, due, out=None) -> Req:
        o = min(out or self.output_len(), self.limit - len(prompt))
        self.rid += 1
        return Req(self.rid - 1, client, prompt, o, due=due, session=session)

    def _first_turn(self, client, due, first=None, turns=None, out=None) -> Req:
        session = {"turn": 1, "turns": turns or self.turns()}
        return self._req(client, self.tokens(first or self.first()), session, due, out)

    def setup_requests(self):
        n, t = self.clients, self.mix["turns"]
        turns = np.floor(t["min"] + uniform_pool(n) * (t["max"] - t["min"] + 1))
        sizes = paired(self.rng, quantile_pool(self.mix["first_prompt"], n),
                       turns.astype(np.int64), quantile_pool(self.mix["output"], n))
        return [self._first_turn(c, None, *size) for c, size in enumerate(sizes)]

    def start(self, t0: float) -> None:
        pass

    def poll(self, now: float):
        return []

    def next_due(self):
        return None

    def on_finish(self, req: Req, now: float):
        s = req.session
        msg = self.message()
        prompt = req.prompt + req.tokens + self.tokens(msg)
        least = self.mix["output"]["min"]
        if s["turn"] >= s["turns"] or len(prompt) + least > self.limit:
            return [self._first_turn(req.client, now)]
        return [self._req(req.client, prompt,
                          {"turn": s["turn"] + 1, "turns": s["turns"]}, now)]

    def prompt_lengths(self):
        """Every prompt length this traffic can send: a history grows to
        any length up to the limit."""
        return range(1, self.limit + 1)
