"""Continuous-batching scheduler (host-side, pure Python, hermetically
testable).

Port of ``deepgemm_ascend_tpu/serving/scheduler.py``, copied, with a
request's clocks added (``submit_t``, ``admit_t``, ``first_token_t``:
``time.perf_counter()`` readings).

The reference has no serving layer (SURVEY.md §1); this realizes the
north-star "continuous batching" requirement: a fixed pool of batch slots,
requests admitted into free slots as others finish, decode stepping all
active slots together (shape-static — the device program never changes).

Design: the scheduler owns NO device state. It tracks request lifecycles
and slot assignment; the engine (engine.py) owns params/caches and asks the
scheduler what to do each iteration. This mirrors production TPU serving
loops where admission logic stays on host and the device step is a fixed
compiled program.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Deque, Dict, List, Optional, Sequence


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    # Stamped by submit, by admissions and by the engine once the request's
    # first token is on the host.
    submit_t: Optional[float] = None
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)


@dataclasses.dataclass(frozen=True)
class Admission:
    """One prefill to perform: request → slot."""
    req_id: int
    slot: int
    prompt: List[int]


class Scheduler:
    """FIFO continuous batching over ``max_slots`` sequences."""

    def __init__(self, max_slots: int, max_seq_len: int,
                 eos_id: Optional[int] = None):
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.eos_id = eos_id
        self._ids = itertools.count()
        self.waiting: Deque[Request] = collections.deque()
        self.running: Dict[int, Request] = {}          # slot → request
        self.finished: Dict[int, Request] = {}
        self._free_slots = list(range(max_slots))

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        req = Request(next(self._ids), list(prompt), max_new_tokens,
                      submit_t=time.perf_counter())
        self.waiting.append(req)
        return req.req_id

    # -- engine-facing API ----------------------------------------------------
    def admissions(self) -> List[Admission]:
        """Requests to prefill this iteration (as many as slots allow)."""
        out = []
        now = time.perf_counter()
        while self.waiting and self._free_slots:
            req = self.waiting.popleft()
            slot = self._free_slots.pop(0)
            req.slot = slot
            req.admit_t = now
            self.running[slot] = req
            out.append(Admission(req.req_id, slot, list(req.prompt)))
        return out

    def active_slots(self) -> List[int]:
        return sorted(self.running)

    def record_tokens(self, slot_tokens: Dict[int, int]) -> List[int]:
        """Feed back one decoded token per active slot; returns req_ids that
        finished this step."""
        done_ids = []
        for slot, tok in slot_tokens.items():
            req = self.running.get(slot)
            if req is None:
                continue
            req.output.append(int(tok))
            eos = self.eos_id is not None and int(tok) == self.eos_id
            full = len(req.output) >= req.max_new_tokens
            cap = req.total_len >= self.max_seq_len
            if eos or full or cap:
                req.done = True
                done_ids.append(req.req_id)
                self.finished[req.req_id] = req
                del self.running[slot]
                self._free_slots.append(slot)
                self._free_slots.sort()
        return done_ids

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def result(self, req_id: int) -> Request:
        return self.finished[req_id]

    def pop_result(self, req_id: int) -> Request:
        """Fetch AND release a finished request — long-running servers must
        use this (``finished`` grows without bound otherwise)."""
        return self.finished.pop(req_id)
