"""What the served requests needed: the useful work of a window or stretch.

The engine's prefix store is followed by :class:`PrefixReplica`, from the
rules the engine documents (16-token grain, the longest stored prefix that
leaves a suffix token, LRU over ``prefix_cache_slots``, inserts after a
step's hits), so that each admitted prompt's cached prefix is known and
its attention counted from there. The run prints whether the replica's
reuse equals the engine's own counter.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

GRAIN = 16


def bucket(n: int, max_seq_len: int) -> int:
    b = GRAIN
    while b < n:
        b *= 2
    if b > max_seq_len:
        b = min(-(-n // GRAIN) * GRAIN, max_seq_len)
    return b


class PrefixReplica:
    def __init__(self, slots: int, max_seq_len: int):
        self.slots = slots
        self.max_seq_len = max_seq_len
        self.store: "OrderedDict[tuple, int]" = OrderedDict()
        self.free = list(range(slots))

    def _lookup(self, prompt: List[int]) -> int:
        if not self.slots:
            return 0
        n = ((len(prompt) - 1) // GRAIN) * GRAIN
        while n >= GRAIN:
            key = tuple(prompt[:n])
            if key in self.store:
                if n + -(-(len(prompt) - n) // GRAIN) * GRAIN <= self.max_seq_len:
                    self.store.move_to_end(key)
                    return n
                return 0
            n -= GRAIN
        return 0

    def admit(self, prompts: List[List[int]]) -> List[int]:
        """The hits of one step's admissions, in admission order."""
        hits = [self._lookup(p) for p in prompts]
        if not self.slots:
            return hits
        order: Dict[int, List[int]] = {}
        for i, (p, h) in enumerate(zip(prompts, hits)):
            b = bucket(len(p) - h, self.max_seq_len)
            if h and h + b > self.max_seq_len:
                b = -(-(len(p) - h) // GRAIN) * GRAIN
            order.setdefault(b, []).append(i)
        for idx in order.values():
            for i in idx:
                p = prompts[i]
                n = ((len(p) - 1) // GRAIN) * GRAIN
                key = tuple(p[:n])
                if n < GRAIN or key in self.store:
                    continue
                if self.free:
                    slot = self.free.pop()
                else:
                    _, slot = self.store.popitem(last=False)
                self.store[key] = slot
        return hits


def useful_work(requests, t0: float, t1: float) -> Tuple[List[Tuple[int, int]], List[int]]:
    """(prefill spans [hit, prompt), decode positions) of the tokens that
    ``requests`` were served in (t0, t1]: a request's first token stands
    for its prefill, token j > 0 for the decode at position prompt + j - 1."""
    spans, positions = [], []
    for r in requests:
        p = len(r.prompt)
        for j, t in enumerate(r.token_t):
            if not (t0 < t <= t1):
                continue
            if j == 0:
                spans.append((r.hit, p))
            else:
                positions.append(p + j - 1)
    return spans, positions
