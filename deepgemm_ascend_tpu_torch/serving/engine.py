"""Decode engine: fixed-slot continuous batching over the FP8 MoE model.

Port of ``deepgemm_ascend_tpu/serving/engine.py`` for one device. The batch
dimension of every decode step is ``max_slots`` (freed slots ride along,
their lengths clamped by the decode kernel); prompts are padded to
power-of-two buckets from 16 and each step's admissions are prefilled in
one forward per bucket, on a copy of their slots' cache rows that is
merged back afterwards. Padding rows (slot −1) never write a cache row.

Left for later slices, and refused by the constructor: the device mesh,
chunked decode (``decode_chunk > 1``), the prefix cache and speculative
decoding. PyTorch runs eagerly, so the JAX package's per-shape program
memo has no counterpart here.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.attention import KVCache
from ..models.config import ModelConfig
from ..models.model import ModelParams, decode_step, forward, init_cache
from ..utils.common import resolve_device
from ..utils.logging import get_logger, metrics
from .scheduler import Scheduler


def _bucket(n: int, lo: int = 16) -> int:
    # lo = 16: flash prefill needs s % 16 == 0 (attention.py gate)
    b = lo
    while b < n:
        b *= 2
    return b


def _prefill(params: ModelParams, caches: List[KVCache], cfg: ModelConfig,
             tokens: np.ndarray, total_lens: np.ndarray, last_idx: np.ndarray,
             pstart: np.ndarray, slots: np.ndarray) -> torch.Tensor:
    """Run up to S padded prompts (tokens (S, bucket)) through the model in
    one forward on a copy of their slots' cache rows, write the valid rows
    back, and return each row's next-token logits (S, vocab) at its last
    real token. Rows with slot < 0 are padding and write nothing."""
    dev = params.device
    s_pad, bucket = tokens.shape
    max_slots = caches[0].k_q.shape[0]
    idx_r = torch.from_numpy(np.clip(slots, 0, max_slots - 1)).to(
        dev, torch.int64)
    sub = [KVCache(k_q=c.k_q[idx_r], k_s=c.k_s[idx_r], v_q=c.v_q[idx_r],
                   v_s=c.v_s[idx_r]) for c in caches]
    pst = torch.from_numpy(pstart).to(dev)
    pos = pst[:, None] + torch.arange(bucket, device=dev,
                                      dtype=torch.int32)[None]
    logits, sub = forward(params, torch.from_numpy(tokens).to(dev), sub, pos,
                          torch.from_numpy(total_lens).to(dev), cfg,
                          prefill_start=pst)
    rows = np.nonzero(slots >= 0)[0]
    src = torch.from_numpy(rows).to(dev, torch.int64)
    dst = torch.from_numpy(slots[rows]).to(dev, torch.int64)
    for c, s in zip(caches, sub):
        for name in ("k_q", "k_s", "v_q", "v_s"):
            getattr(c, name)[dst] = getattr(s, name)[src]
    return logits[torch.arange(s_pad, device=dev),
                  torch.from_numpy(last_idx).to(dev, torch.int64)]


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s roundings: exp in ``x``'s dtype, the sum in f32
    rounded back to it, one division in it."""
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)


_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last dim in ``x``'s dtype, each addition
    rounded to it, in the order XLA's CPU backend evaluates ``jnp.cumsum``:
    blocks of 16 scanned in sequence, the block totals scanned the same way
    (recursively), then each block offset by the sum before it. In bf16 the
    order decides which tokens the nucleus keeps (a sum near 0.9 drops
    addends below its ulp, 2⁻⁸), so a 16-bit sum follows JAX's; an f32 sum
    is ``torch.cumsum``, whose order can flip only the boundary token."""
    n = x.shape[-1]
    nb = -(-n // _SCAN_BLOCK)
    q = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    q = q.reshape(*x.shape[:-1], nb, _SCAN_BLOCK).clone()
    for j in range(1, _SCAN_BLOCK):
        q[..., j] = q[..., j - 1] + q[..., j]
    if nb > 1:
        before = torch.nn.functional.pad(_cumsum(q[..., -1]), (1, 0))[..., :-1]
        q = q + before[..., None]
    return q.reshape(*x.shape[:-1], -1)[..., :n]


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling with optional top-k /
    nucleus (top-p) truncation. logits: (..., vocab) → (...,) int32.
    Temperature, top-k and top-p are computed in the logits' own dtype, as
    the JAX package does (JAX ``engine.py:172-192``), so a bf16 caller keeps
    the same tokens. The draw takes f32 probabilities of the kept logits
    from ``generator`` (the JAX package draws from its key: same
    distribution, other bits)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # JAX divides by the temperature as a weak-typed scalar: rounded to the
    # logits' dtype first.
    logits = logits / torch.tensor(temperature, dtype=logits.dtype)
    top_k = min(top_k, logits.shape[-1])   # top_k > vocab would crash
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = _softmax(sorted_l)
        cum = (torch.cumsum(probs, dim=-1) if probs.dtype == torch.float32
               else _cumsum(probs))
        # Smallest prefix with cumulative prob ≥ top_p stays; rank 0 always
        # survives (even for top_p <= 0).
        keep = cum - probs < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_l,
                             torch.full_like(sorted_l, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


class Engine:
    """Single-device serving engine."""

    def __init__(
        self,
        params: ModelParams,
        cfg: ModelConfig,
        *,
        max_slots: int = 8,
        max_seq_len: Optional[int] = None,
        eos_id: Optional[int] = None,
        mesh=None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        decode_chunk: int = 1,
        seed: int = 0,
        prefix_cache_slots: int = 0,
        speculative_k: int = 0,
        draft_fn=None,
        device="cuda",
    ):
        """Serve ``params`` on ``device`` (where the parameters must be).
        Sampling parameters are fixed at construction."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving arrives with the port's parallel slice")
        if int(decode_chunk) > 1:
            raise NotImplementedError(
                "decode_chunk > 1 arrives with the port's serving-features "
                "slice")
        if prefix_cache_slots:
            raise NotImplementedError(
                "prefix_cache_slots arrives with the port's serving-features "
                "slice")
        if speculative_k or draft_fn is not None:
            raise NotImplementedError(
                "speculative decoding arrives with the port's "
                "serving-features slice")
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, engine device "
                             f"is {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.scheduler = Scheduler(max_slots, self.max_seq_len, eos_id)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = init_cache(cfg, max_slots, self.max_seq_len,
                                 device=self.device)
        self.seq_lens = torch.zeros((max_slots,), dtype=torch.int32,
                                    device=self.device)
        self.last_tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                       device=self.device)
        self.stats = {"decode_steps": 0, "prefills": 0, "tokens_out": 0,
                      "decode_tokens": 0, "decode_time_s": 0.0,
                      "decode_slot_steps": 0, "prefill_time_s": 0.0,
                      "prefill_tokens": 0}

    def _prompt_bucket(self, prompt_len: int) -> int:
        bucket = _bucket(prompt_len)
        if bucket > self.max_seq_len:
            # pow2 bucket overshoots the cache: round to the flash-prefill
            # granularity, clamped to the cache extent.
            bucket = min(-(-prompt_len // 16) * 16, self.max_seq_len)
        return bucket

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self._gen, temperature=self.temperature,
                             top_k=self.top_k, top_p=self.top_p)

    def _emit_tokens(self, out_rows, active, sched, emitted) -> None:
        """Per-step emission: out_rows (T, slots) tokens; slots that finish
        (EOS/budget) stop emitting via the scheduler."""
        for t in range(out_rows.shape[0]):
            slot_tokens = {}
            for slot in active:
                req = sched.running.get(slot)
                if req is None:        # finished earlier in this batch
                    continue
                tok = int(out_rows[t, slot])
                slot_tokens[slot] = tok
                emitted.setdefault(req.req_id, []).append(tok)
            if not slot_tokens:
                break
            self.stats["tokens_out"] += len(slot_tokens)
            self.stats["decode_tokens"] += len(slot_tokens)
            metrics.inc("engine.tokens_out", len(slot_tokens))
            for rid in sched.record_tokens(slot_tokens):
                get_logger().info("req %d finished", rid)

    def step(self) -> Dict[int, List[int]]:
        """One engine iteration: admit + prefill new requests, decode all
        active slots once. Returns {req_id: [tokens]} emitted this step."""
        sched = self.scheduler
        emitted: Dict[int, List[int]] = {}

        # Batched admission: one prefill forward per bucket, the row count
        # padded to a power of two.
        prefill_tokens: Dict[int, int] = {}
        groups: Dict[int, list] = {}
        for adm in sched.admissions():
            groups.setdefault(self._prompt_bucket(len(adm.prompt)),
                              []).append(adm)
        for bucket, group in groups.items():
            s_pad = 1
            while s_pad < len(group):
                s_pad *= 2
            toks = np.zeros((s_pad, bucket), np.int32)
            total = np.ones((s_pad,), np.int32)     # padding rows: len 1
            last_i = np.zeros((s_pad,), np.int32)
            pstart = np.zeros((s_pad,), np.int32)
            slots = np.full((s_pad,), -1, np.int32)
            for i, adm in enumerate(group):
                toks[i, :len(adm.prompt)] = adm.prompt
                total[i] = len(adm.prompt)
                last_i[i] = len(adm.prompt) - 1
                slots[i] = adm.slot
            t0 = time.perf_counter()
            last_logits = _prefill(self.params, self.caches, self.cfg, toks,
                                   total, last_i, pstart, slots)
            metrics.inc("engine.prefill_dispatches")
            firsts = self._sample(last_logits).cpu().numpy()   # (s_pad,)
            self.stats["prefill_time_s"] += time.perf_counter() - t0
            self.stats["prefill_tokens"] += int(total[:len(group)].sum())
            g = len(group)
            v_slots = torch.from_numpy(slots[:g]).to(self.device,
                                                     torch.int64)
            self.seq_lens[v_slots] = torch.from_numpy(total[:g]).to(
                self.device)
            self.last_tokens[v_slots] = torch.from_numpy(
                firsts[:g].astype(np.int32)).to(self.device)
            for i, adm in enumerate(group):
                first_tok = int(firsts[i])
                self.stats["prefills"] += 1
                self.stats["tokens_out"] += 1
                metrics.inc("engine.prefills")
                get_logger().info("admitted req %d → slot %d (prompt %d)",
                                  adm.req_id, adm.slot, len(adm.prompt))
                prefill_tokens[adm.slot] = first_tok
                emitted.setdefault(adm.req_id, []).append(first_tok)
        if prefill_tokens:
            sched.record_tokens(prefill_tokens)

        active = sched.active_slots()
        if active:
            mask = np.zeros((self.max_slots,), bool)
            mask[active] = True
            jmask = torch.from_numpy(mask).to(self.device)
            t0 = time.perf_counter()
            logits, self.caches = decode_step(self.params, self.last_tokens,
                                              self.caches, self.seq_lens,
                                              self.cfg)
            nxt = self._sample(logits)
            self.seq_lens = torch.where(jmask, self.seq_lens + 1,
                                        self.seq_lens)
            self.last_tokens = torch.where(jmask, nxt, self.last_tokens)
            out_np = nxt.cpu().numpy()[None]           # (1, slots)
            self.stats["decode_time_s"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
            self.stats["decode_slot_steps"] += len(active)
            self._emit_tokens(out_np, active, sched, emitted)
            metrics.gauge("engine.active_slots", len(sched.running))
        return emitted

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 32,
    ) -> List[List[int]]:
        """Batch convenience: submit all, run to completion, return outputs."""
        ids = [self.scheduler.submit(p, max_new_tokens) for p in prompts]
        while self.scheduler.has_work:
            self.step()
        return [self.scheduler.pop_result(i).output for i in ids]

    @property
    def tokens_per_second(self) -> float:
        """Decode throughput: decode-emitted tokens over decode time
        (prefill-sampled tokens are excluded from both sides)."""
        t = self.stats["decode_time_s"]
        return self.stats["decode_tokens"] / t if t > 0 else 0.0
