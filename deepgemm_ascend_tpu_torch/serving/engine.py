"""Decode engine: fixed-slot continuous batching over the FP8 MoE model.

Port of ``deepgemm_ascend_tpu/serving/engine.py``. The batch
dimension of every decode step is ``max_slots`` (freed slots ride along,
their lengths clamped by the decode kernel); prompts are padded to
power-of-two buckets from 16 and each step's admissions are prefilled in
one forward per bucket, on a copy of their slots' cache rows that is
merged back afterwards. Padding rows (slot −1) never write a cache row.

The JAX engine's serving features, with its semantics:

* chunked decode (``decode_chunk`` = N > 1): N decode steps an iteration,
  sampled inside the chunk. JAX scans them in one device program. Here the
  chunk is a loop of eager steps on the CPU; on CUDA the first chunk runs
  eagerly on a side stream and is then captured there as one CUDA graph,
  which every later chunk replays (a failure to capture raises);
* the prefix cache (``prefix_cache_slots``): a store of prefilled 16-token
  grain prompt prefixes, LRU, copied into an admitted slot whose prompt
  extends one, the suffix prefilled from ``prefill_start`` = the hit;
* greedy speculative decoding (``speculative_k``, ``draft_fn``): every
  slot's current token and k drafts verified in one 16-token forward.

On CUDA without a mesh, a bucket group's prefill forward of at most
``_PREFILL_GRAPH_TOKENS`` tokens is a CUDA graph too, with its sampling:
kept by shape (padded rows, bucket), captured by the shape's second
forward after an eager first, replayed from then on with the group's
inputs copied into its static buffers; the read-back of the sampled
tokens is the group's only sync.

With ``mesh=`` (``parallel/sharded.py``) the engine runs the sharded dp/ep/tp
steps: every rank of the mesh runs one engine on its own shard of the
parameters and caches, with the same requests, and takes the same
scheduling and sampling decisions (the steps gather the next tokens and
the prefill logits to every rank; the generator is seeded alike
everywhere). Sampling runs inside the sharded decode step. As in JAX the
prefix cache is ignored with a warning and speculative decoding is
refused. A chunk of ``decode_chunk`` steps is captured as one CUDA graph
where the mesh's groups are NCCL or of one rank; over gloo groups it runs
as eager steps.

The engine's state (caches, lengths, last tokens) is updated in place, so
that a captured graph reads and writes one storage for each. PyTorch runs
eagerly, so the JAX package's per-shape program memo has no counterpart
here (the sharded steps keep a memo of their set-up).

Under a running ``torch.profiler`` the engine's phases are named spans
(``utils.logging.span``): ``engine.step`` around an iteration; inside it
``engine.admit``, one ``engine.prefill`` per bucket group,
``engine.prefix_insert``, ``engine.decode`` and ``engine.emit``;
``engine.readback`` around each blocking copy to the host
in them. A replayed chunk records no host span of its own: it sits under
``engine.decode``.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.attention import KVCache
from ..models.config import ModelConfig
from ..models.model import ModelParams, decode_step, forward, init_cache
from ..ops._kernels import COUNTERS
from ..utils.common import resolve_device
from ..utils.logging import get_logger, metrics, span
from .scheduler import Scheduler


def _bucket(n: int, lo: int = 16) -> int:
    # lo = 16: flash prefill needs s % 16 == 0 (attention.py gate)
    b = lo
    while b < n:
        b *= 2
    return b


_CACHE_FIELDS = ("k_q", "k_s", "v_q", "v_s")
# Verify-window width: the flash-prefill grain (s % 16 == 0, attention.py
# gate), so that the verification forward runs K4 over the int8 cache; the
# columns past k + 1 are padding, their cache rows invalid by length.
_VERIFY_WINDOW = 16
# Prefill forwards of at most this many tokens (padded rows × bucket) are
# captured as CUDA graphs. Below it an eager forward waits on the host's
# launches (Mistral-7B: ~4000 launches, ~100 ms of host, against ~28 ms of
# K1 at 512 tokens); above it the card's work covers the host (≥ ~110 ms
# of K1 at 2048 tokens), and a graph's memory pool would hold GBs.
_PREFILL_GRAPH_TOKENS = 2048


def prefill_graph_key(s_pad: int, bucket: int) -> Optional[tuple]:
    """The shape a prefill forward's CUDA graph is kept under, or None for
    a forward that always runs eagerly (over ``_PREFILL_GRAPH_TOKENS``)."""
    if s_pad * bucket > _PREFILL_GRAPH_TOKENS:
        return None
    return (s_pad, bucket)


def _draft_prompt_lookup(hist: List[int], k: int, n: int = 3) -> List[int]:
    """Prompt-lookup (n-gram) drafting, the JAX engine's: the k tokens that
    followed the most recent earlier occurrence of the last n-gram, padded
    with the last of them; with no match, the last token k times."""
    if len(hist) >= n + 1:
        tail = hist[-n:]
        for i in range(len(hist) - n - 1, -1, -1):
            if hist[i:i + n] == tail:
                cont = hist[i + n:i + n + k]
                if cont:
                    return (cont + [cont[-1]] * (k - len(cont)))[:k]
    last = hist[-1] if hist else 0
    return [last] * k


def _copy_cache_rows(dst: List[KVCache], src: List[KVCache],
                     dst_idx: torch.Tensor, src_idx: torch.Tensor) -> None:
    """Copy batch rows src[src_idx] → dst[dst_idx] of every layer's values
    and scales, in place (the destination rows are distinct). Used both
    ways between the slot caches and the prefix store."""
    for d, s in zip(dst, src):
        for name in _CACHE_FIELDS:
            getattr(d, name).index_copy_(
                0, dst_idx, getattr(s, name).index_select(0, src_idx))


def _write_back_plan(slots: np.ndarray):
    """The write-back of a prefill's rows into the slot caches as one
    (src, dst) pair a row, int64, of the rows' fixed count: a row with a
    slot writes into it; a padding row (slot < 0) repeats the first such
    row's pair, which writes the same bytes again and touches no other
    slot."""
    valid = slots >= 0
    if not valid.any():
        raise ValueError("a prefill needs a row with a slot")
    src = np.where(valid, np.arange(len(slots)), int(np.argmax(valid)))
    return src.astype(np.int64), slots[src].astype(np.int64)


def _prefill_forward(params: ModelParams, caches: List[KVCache],
                     cfg: ModelConfig, tokens: torch.Tensor,
                     total_lens: torch.Tensor, last_idx: torch.Tensor,
                     pstart: torch.Tensor, rows: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """:func:`_prefill` on device tensors (tokens, total_lens, pstart
    int32; last_idx, the gathered cache rows ``rows`` and the write-back
    plan ``src``/``dst`` int64), reading nothing back: what a prefill graph
    captures."""
    dev = tokens.device
    s_pad, bucket = tokens.shape
    sub = [KVCache(k_q=c.k_q[rows], k_s=c.k_s[rows], v_q=c.v_q[rows],
                   v_s=c.v_s[rows]) for c in caches]
    pos = pstart[:, None] + torch.arange(bucket, device=dev,
                                         dtype=torch.int32)[None]
    logits, sub = forward(params, tokens, sub, pos, total_lens, cfg,
                          prefill_start=pstart)
    for c, s in zip(caches, sub):
        for name in _CACHE_FIELDS:
            getattr(c, name)[dst] = getattr(s, name)[src]
    return logits[torch.arange(s_pad, device=dev), last_idx]


def _prefill_arrays(slots: np.ndarray, last_idx: np.ndarray,
                    max_slots: int) -> tuple:
    """The int64 inputs of :func:`_prefill_forward` made from the slots:
    last indices, gathered cache rows (a padding row reads slot 0's) and
    the write-back plan."""
    src, dst = _write_back_plan(slots)
    return (last_idx.astype(np.int64),
            np.clip(slots, 0, max_slots - 1).astype(np.int64), src, dst)


def _prefill(params: ModelParams, caches: List[KVCache], cfg: ModelConfig,
             tokens: np.ndarray, total_lens: np.ndarray, last_idx: np.ndarray,
             pstart: np.ndarray, slots: np.ndarray) -> torch.Tensor:
    """Run up to S padded prompts (tokens (S, bucket)) through the model in
    one forward on a copy of their slots' cache rows, write the valid rows
    back, and return each row's next-token logits (S, vocab) at its last
    real token. Rows with slot < 0 are padding and write nothing."""
    dev = params.device
    last, rows, src, dst = (torch.from_numpy(a).to(dev) for a in
                            _prefill_arrays(slots, last_idx,
                                            caches[0].k_q.shape[0]))
    return _prefill_forward(params, caches, cfg,
                            torch.from_numpy(tokens).to(dev),
                            torch.from_numpy(total_lens).to(dev), last,
                            torch.from_numpy(pstart).to(dev), rows, src, dst)


class _PrefillGraph:
    """One prefill forward of shape (s_pad, bucket) captured with its
    sampling as a CUDA graph: its inputs in static buffers on the card,
    filled from pinned host staging by asynchronous copies (int32: tokens,
    total lengths, prefill starts; int64: those of :func:`_prefill_arrays`),
    and the tokens it samples."""

    def __init__(self, s_pad: int, bucket: int, device):
        self.shape = (s_pad, bucket)
        n32, n64 = s_pad * (bucket + 2), 4 * s_pad
        self._dev32 = torch.empty(n32, dtype=torch.int32, device=device)
        self._dev64 = torch.empty(n64, dtype=torch.int64, device=device)
        pin = self._dev32.is_cuda
        self._host32 = torch.empty(n32, dtype=torch.int32, pin_memory=pin)
        self._host64 = torch.empty(n64, dtype=torch.int64, pin_memory=pin)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.sampled: Optional[torch.Tensor] = None
        # Launches and plain calls of each kernel in one replay.
        self.launches: Dict[str, tuple] = {}

    def stage(self, tokens, total_lens, last_idx, pstart, slots,
              max_slots) -> None:
        """Copy one group's inputs to the static buffers (queued on the
        current stream; the host buffers are free again once the group's
        tokens are read back)."""
        h32, h64 = self._host32.numpy(), self._host64.numpy()
        h32[:] = np.concatenate([tokens.reshape(-1), total_lens, pstart])
        h64[:] = np.concatenate(_prefill_arrays(slots, last_idx, max_slots))
        self._dev32.copy_(self._host32, non_blocking=True)
        self._dev64.copy_(self._host64, non_blocking=True)

    def inputs(self) -> tuple:
        """The static buffers as :func:`_prefill_forward`'s arguments from
        ``tokens`` on."""
        s_pad, bucket = self.shape
        tok, total, pst = self._dev32.split([s_pad * bucket, s_pad, s_pad])
        last, rows, src, dst = self._dev64.split(s_pad)
        return (tok.view(s_pad, bucket), total, last, pst, rows, src, dst)


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
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
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
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return _categorical(probs, generator).to(torch.int32)


def _categorical(probs: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw from each row of ``probs`` (..., n): argmax of p / q with q
    ~ Exp(1), the draw ``torch.multinomial`` makes for one sample, without
    its checks of the probabilities, which read them back to the host (a
    captured CUDA graph reads nothing back)."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


class Engine:
    """Serving engine on one device, or on this rank's shard of a mesh
    (``mesh=``)."""

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
        Sampling parameters are fixed at construction.

        ``decode_chunk``: decode N tokens an iteration (one graph replay on
        CUDA), at the cost of admission granularity and up to N−1 wasted
        steps a request after its EOS or budget (the scheduler drops
        them). ``prefix_cache_slots``: the number of stored prefixes.
        ``speculative_k``: drafts verified an iteration (greedy only);
        ``draft_fn(slot, hist, k) -> k tokens`` replaces prompt-lookup
        drafting. ``mesh``: a (data, expert, model) mesh
        (``parallel.make_mesh``) this rank serves its shard of; ``params``
        are the whole parameters, which the engine cuts to its shard, and
        ``max_slots`` must split over the "data" axis."""
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
        self.decode_chunk = max(int(decode_chunk), 1)
        # Greedy speculative decoding, lossless: the emitted tokens are the
        # verify forward's own argmaxes; drafts only decide how many land.
        self.spec_k = max(int(speculative_k), 0)
        if self.spec_k:
            if mesh is not None or self.decode_chunk > 1:
                raise ValueError("speculative_k requires single-device "
                                 "mode with decode_chunk=1")
            if temperature != 0.0 or top_k or (top_p and top_p < 1.0):
                raise ValueError("speculative_k requires greedy sampling "
                                 "(temperature 0, no top-k/top-p) — "
                                 "greedy verification is lossless")
            if self.spec_k >= _VERIFY_WINDOW:
                raise ValueError(f"speculative_k must be < the verify "
                                 f"window {_VERIFY_WINDOW}")
        self._draft_fn = (draft_fn if draft_fn is not None else
                          (lambda slot, hist, k:
                           _draft_prompt_lookup(hist, k)))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = init_cache(cfg, max_slots, self.max_seq_len,
                                 device=self.device)
        self._mesh = mesh
        self._eager_chunks = self.device.type != "cuda"
        # The mesh's sharded prefill steps run eagerly.
        self._prefill_graphs_on = self.device.type == "cuda" and mesh is None
        if mesh is not None:
            from ..parallel import mesh as meshmod
            from ..parallel import sharded
            dp = meshmod.axis_size(mesh, "data")
            if max_slots % dp:
                raise ValueError(f"max_slots {max_slots} does not split over "
                                 f"{dp} data shards")
            self.params = sharded.shard_params(mesh, params, cfg)
            self.caches = sharded.shard_caches(mesh, self.caches, cfg)
            self._decode_sampled = sharded.make_sharded_decode_step(
                mesh, cfg, params, sample={"temperature": temperature,
                                           "top_k": top_k, "top_p": top_p})
            # A gloo collective cannot be captured in a CUDA graph.
            self._eager_chunks |= any(
                meshmod.axis_size(mesh, ax) > 1 and torch.distributed
                .get_backend(mesh.get_group(ax)) == "gloo"
                for ax in meshmod.AXES)
            if prefix_cache_slots:
                get_logger().warning(
                    "prefix_cache_slots ignored in mesh mode (unsupported)")
                prefix_cache_slots = 0
        self.seq_lens = torch.zeros((max_slots,), dtype=torch.int32,
                                    device=self.device)
        self.last_tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                       device=self.device)
        # The decode steps' mask of active slots and their tokens (chunk,
        # slots): static buffers, which a captured chunk reads and writes.
        self._mask = torch.zeros((max_slots,), dtype=torch.bool,
                                 device=self.device)
        self._out = torch.zeros((self.decode_chunk, max_slots),
                                dtype=torch.int32, device=self.device)
        self._graph = None
        self._capture_stream = None
        # Launches and plain calls of each kernel in the captured chunk:
        # what every replay launches (the counters are bumped on the host,
        # once, while capturing).
        self.graph_launches: Optional[Dict[str, tuple]] = None
        self._prefix_slots = int(prefix_cache_slots)
        if self._prefix_slots:
            self._prefix_store = init_cache(cfg, self._prefix_slots,
                                            self.max_seq_len,
                                            device=self.device)
            self._prefix_map: "OrderedDict[tuple, int]" = OrderedDict()
            self._prefix_free = list(range(self._prefix_slots))
        self.stats = {"decode_steps": 0, "prefills": 0, "tokens_out": 0,
                      "decode_tokens": 0, "decode_time_s": 0.0,
                      # slot-steps the decode ran (chunk × active slots):
                      # decode_tokens / decode_slot_steps is the chunked
                      # decode's utilization.
                      "decode_slot_steps": 0, "prefill_time_s": 0.0,
                      "prefill_tokens": 0,
                      # tokens the prefill forwards ran (rows × bucket) and
                      # those of them that were padding (padded rows whole)
                      "prefill_tokens_run": 0, "prefill_tokens_padding": 0,
                      # requests admitted, and the sums over them of
                      # admit_t − submit_t and first_token_t − admit_t
                      "admitted": 0, "queue_wait_s": 0.0,
                      "first_token_wait_s": 0.0,
                      # host time of the CUDA graph capture, outside
                      # decode_time_s, and the graph's replays.
                      "graph_capture_s": 0.0, "graph_replays": 0,
                      # prefill forwards captured as CUDA graphs (their host
                      # time inside prefill_time_s) and replayed: every
                      # replayed forward, the capturing one included
                      "prefill_graph_captures": 0,
                      "prefill_graph_capture_s": 0.0,
                      "prefill_graph_replays": 0}

    @property
    def caches(self) -> List[KVCache]:
        return self._caches

    @caches.setter
    def caches(self, caches) -> None:
        # Prefill graphs by shape (prefill_graph_key): a shape seen once
        # maps to None (its next forward captures), then to its graph. All
        # share one memory pool: each graph's sampled tokens are read back
        # before another replays. A graph writes the caches' storage: new
        # caches (or none, when the engine's state is freed) drop the graphs
        # and their pool.
        self._caches = caches
        self._prefill_graphs: Dict[tuple, Optional[_PrefillGraph]] = {}
        self._prefill_pool = None

    def _prompt_bucket(self, prompt_len: int) -> int:
        bucket = _bucket(prompt_len)
        if bucket > self.max_seq_len:
            # pow2 bucket overshoots the cache: round to the flash-prefill
            # granularity, clamped to the cache extent.
            bucket = min(-(-prompt_len // 16) * 16, self.max_seq_len)
        return bucket

    # -- prefix cache --------------------------------------------------------
    def _prefix_lookup(self, prompt) -> tuple:
        """(hit_len, store_idx): the longest stored 16-grain prefix of
        ``prompt`` that still leaves ≥1 suffix token, or (0, None)."""
        if not self._prefix_slots:
            return 0, None
        L = ((len(prompt) - 1) // 16) * 16
        while L >= 16:
            key = tuple(prompt[:L])
            ent = self._prefix_map.get(key)
            if ent is not None:
                # The window must fit before the LRU promotion: a hit this
                # prompt cannot use must not displace reusable entries.
                if L + -(-(len(prompt) - L) // 16) * 16 <= self.max_seq_len:
                    self._prefix_map.move_to_end(key)
                    return L, ent
                return 0, None
            L -= 16
        return 0, None

    def _prefix_insert_batch(self, pending) -> None:
        """Store the freshly prefilled prefixes of ``pending`` (prompt,
        slot) pairs in one batched row copy. Called only after every hit
        of the step has copied its store row out, so that an LRU eviction
        here cannot overwrite a row a hit still needs."""
        dst, src = [], []
        for prompt, slot in pending:
            # The largest multiple of 16 that leaves ≥1 token, so that an
            # exact repeat hits too (a lookup needs a suffix).
            L = ((len(prompt) - 1) // 16) * 16
            key = tuple(prompt[:L])
            if L < 16 or key in self._prefix_map:
                continue
            if self._prefix_free:
                idx = self._prefix_free.pop()
            else:
                _, idx = self._prefix_map.popitem(last=False)   # LRU
            self._prefix_map[key] = idx
            dst.append(idx)
            src.append(slot)
        if dst:
            _copy_cache_rows(self._prefix_store, self.caches,
                             self._index(dst), self._index(src))
            metrics.inc("engine.prefix_inserts", len(dst))

    def _index(self, rows) -> torch.Tensor:
        return torch.as_tensor(rows, dtype=torch.int64).to(self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self._gen, temperature=self.temperature,
                             top_k=self.top_k, top_p=self.top_p)

    # -- decode ----------------------------------------------------------------
    def _decode_chunk(self, mask: torch.Tensor, out: torch.Tensor) -> None:
        """``out.shape[0]`` decode steps of every slot, each sampled: the
        function that the CUDA graph captures. Slots where ``mask`` is
        False neither advance nor change their token; step t's tokens go
        to ``out[t]``. Every state tensor is updated in place."""
        for t in range(out.shape[0]):
            if self._mesh is not None:
                sampled, _ = self._decode_sampled(
                    self.params, self.last_tokens, self.caches,
                    self.seq_lens, self._gen)
            else:
                logits, _ = decode_step(self.params, self.last_tokens,
                                        self.caches, self.seq_lens, self.cfg)
                sampled = self._sample(logits)
            nxt = torch.where(mask, sampled, self.last_tokens)
            self.seq_lens.add_(mask.to(torch.int32))
            self.last_tokens.copy_(nxt)
            out[t].copy_(nxt)

    def _run_decode(self, chunk: int) -> np.ndarray:
        """``chunk`` decode steps of the slots in ``self._mask``; returns
        their tokens (chunk, slots). On CUDA a chunk of ``decode_chunk``
        replays the captured graph; the first one runs eagerly on the
        stream the graph is then captured on (:meth:`_capture`)."""
        out = self._out[:chunk]
        if chunk == 1 or self._eager_chunks:
            self._decode_chunk(self._mask, out)
        elif self._graph is not None:
            self._graph.replay()
            self.stats["graph_replays"] += 1
            for n, (launches, _) in self.graph_launches.items():
                COUNTERS[n].replayed += launches
        else:
            # Real work, on the capture stream: it also makes that stream's
            # K2 arrival counts (flash_decode._ARRIVALS) before the
            # capture, outside the graph's memory pool.
            self._capture_stream = torch.cuda.Stream(self.device)
            self._capture_stream.wait_stream(
                torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._capture_stream):
                self._decode_chunk(self._mask, out)
            torch.cuda.current_stream(self.device).wait_stream(
                self._capture_stream)
        with span("engine.readback"):
            return out.cpu().numpy()

    def _capture(self) -> None:
        """Capture one chunk of ``decode_chunk`` steps as a CUDA graph on
        the stream its eager run used. Capturing runs nothing on the card:
        the launches its wrappers count are one replay's
        (``graph_launches``), kept apart under each counter's ``captured``
        (each replay adds them to ``replayed``). A failure raises: no chunk
        falls back to eager steps."""
        t0 = time.perf_counter()
        before = {n: (c.launches, c.plain_calls) for n, c in COUNTERS.items()}
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0.0:
            # Each replay then draws from the generator's next offset.
            graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph, stream=self._capture_stream):
            self._decode_chunk(self._mask, self._out)
        self._graph = graph
        self.graph_launches = {
            n: (c.launches - before[n][0], c.plain_calls - before[n][1])
            for n, c in COUNTERS.items()}
        for n, (launches, _) in self.graph_launches.items():
            COUNTERS[n].captured += launches
        self.stats["graph_capture_s"] += time.perf_counter() - t0

    def _prefill_sampled(self, tokens: np.ndarray, total: np.ndarray,
                         last_i: np.ndarray, pstart: np.ndarray,
                         slots: np.ndarray) -> torch.Tensor:
        """A bucket group's prefill forward and its sampled tokens (s_pad,)
        on the device. On CUDA without a mesh, a shape under the graph cap
        (:func:`prefill_graph_key`) runs eagerly the first time, is
        captured by its second forward and replayed from then on; other
        forwards run eagerly (:func:`_prefill`)."""
        key = (prefill_graph_key(*tokens.shape)
               if self._prefill_graphs_on else None)
        if key is None or key not in self._prefill_graphs:
            if key is not None:
                self._prefill_graphs[key] = None
            return self._sample(_prefill(self.params, self.caches, self.cfg,
                                         tokens, total, last_i, pstart,
                                         slots))
        pg = self._prefill_graphs[key]
        fresh = pg is None
        if fresh:
            pg = self._prefill_graphs[key] = _PrefillGraph(*key, self.device)
        pg.stage(tokens, total, last_i, pstart, slots, self.max_slots)
        if fresh:
            self._capture_prefill(pg)
        pg.graph.replay()
        self.stats["prefill_graph_replays"] += 1
        for n, (launches, _) in pg.launches.items():
            COUNTERS[n].replayed += launches
        return pg.sampled

    def _capture_prefill(self, pg: _PrefillGraph) -> None:
        """Capture ``pg``'s forward and sampling into the engine's prefill
        pool, on its static inputs; the launches are counted as in
        :meth:`_capture`. Capturing runs nothing on the card, and a host
        sync inside the forward makes it raise: no forward falls back to
        eager."""
        t0 = time.perf_counter()
        before = {n: (c.launches, c.plain_calls) for n, c in COUNTERS.items()}
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0.0:
            graph.register_generator_state(self._gen)
        if self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=self._prefill_pool):
            pg.sampled = self._sample(_prefill_forward(
                self.params, self.caches, self.cfg, *pg.inputs()))
        pg.graph = graph
        pg.launches = {
            n: (c.launches - before[n][0], c.plain_calls - before[n][1])
            for n, c in COUNTERS.items()}
        for n, (launches, _) in pg.launches.items():
            COUNTERS[n].captured += launches
        self.stats["prefill_graph_captures"] += 1
        self.stats["prefill_graph_capture_s"] += time.perf_counter() - t0

    def _verify(self, toks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """Every slot's window ``toks`` (slots, W) through the model at
        positions lens..lens+W-1 (K4 from ``prefill_start`` = lens; the
        window's cache rows written in place) → the greedy next token at
        each position (slots, W). Rows past a slot's accepted prefix are
        invalid by length and rewritten before they are attended."""
        w = toks.shape[1]
        pos = lens[:, None] + torch.arange(w, device=self.device,
                                           dtype=torch.int32)[None]
        logits, _ = forward(self.params, toks, self.caches, pos, lens + w,
                            self.cfg, prefill_start=lens)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _spec_decode(self, active, sched, emitted) -> bool:
        """One speculative iteration: k drafts a slot, all slots verified in
        one (max_slots, W) forward, each slot's accepted drafts plus the
        verify's next token emitted (1..k+1 tokens a slot). Returns False
        when an active slot is within W rows of the cache's end (the
        caller then takes a plain step)."""
        k = self.spec_k
        w = _VERIFY_WINDOW
        with span("engine.readback"):
            lens_np = self.seq_lens.cpu().numpy()
        if int(lens_np[active].max()) + w > self.max_seq_len:
            return False
        with span("engine.readback"):
            last_np = self.last_tokens.cpu().numpy()
        mask = np.zeros((self.max_slots,), bool)
        mask[active] = True
        toks = np.zeros((self.max_slots, w), np.int32)
        for slot in active:
            req = sched.running[slot]
            hist = list(req.prompt) + list(req.output)
            toks[slot, 0] = last_np[slot]
            toks[slot, 1:k + 1] = self._draft_fn(slot, hist, k)

        t0 = time.perf_counter()
        # Inactive slots run at length 0: their rows 0..k are scribbled but
        # invalid (rewritten by their next prefill).
        greedy = self._verify(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(np.where(mask, lens_np, 0).astype(
                np.int32)).to(self.device))
        with span("engine.readback"):
            g_np = greedy.cpu().numpy()                # (slots, w)
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += w * len(active)

        acc = {}
        for slot in active:
            a = 0
            while a < k and toks[slot, a + 1] == g_np[slot, a]:
                a += 1
            acc[slot] = a
            metrics.inc("engine.spec_proposed", k)
            metrics.inc("engine.spec_accepted", a)
        with span("engine.emit"):
            counts = self._emit_tokens(g_np[:, :k + 1].T, active, sched,
                                       emitted, row_limit=acc)
        new_lens, new_last = lens_np.copy(), last_np.copy()
        for slot in active:
            n_em = counts[slot]
            if n_em:
                new_lens[slot] = lens_np[slot] + n_em
                new_last[slot] = g_np[slot, n_em - 1]
        self.seq_lens.copy_(torch.from_numpy(new_lens))
        self.last_tokens.copy_(torch.from_numpy(new_last))
        return True

    def _emit_tokens(self, out_rows, active, sched, emitted,
                     row_limit=None) -> Dict[int, int]:
        """Emission of out_rows (T, slots) tokens; slots that finish
        (EOS/budget) stop emitting via the scheduler; ``row_limit[slot]``
        (inclusive) caps a slot's rows (speculative acceptance). Returns
        the tokens emitted a slot."""
        counts = {s: 0 for s in active}
        for t in range(out_rows.shape[0]):
            slot_tokens = {}
            for slot in active:
                if row_limit is not None and t > row_limit[slot]:
                    continue
                req = sched.running.get(slot)
                if req is None:        # finished earlier in this batch
                    continue
                tok = int(out_rows[t, slot])
                slot_tokens[slot] = tok
                emitted.setdefault(req.req_id, []).append(tok)
                counts[slot] += 1
            if not slot_tokens:
                break
            self.stats["tokens_out"] += len(slot_tokens)
            self.stats["decode_tokens"] += len(slot_tokens)
            for rid in sched.record_tokens(slot_tokens):
                get_logger().info("req %d finished", rid)
        return counts

    # -- main loop -------------------------------------------------------------
    def _admit(self) -> Dict[int, list]:
        """This step's admissions, grouped by the bucket of the suffix each
        prefills past its prefix-cache hit: {bucket: [(admission, hit_len,
        store_idx)]}."""
        groups: Dict[int, list] = {}
        for adm in self.scheduler.admissions():
            req = self.scheduler.running[adm.slot]
            self.stats["admitted"] += 1
            self.stats["queue_wait_s"] += req.admit_t - req.submit_t
            hit_len, store_idx = self._prefix_lookup(adm.prompt)
            sfx = len(adm.prompt) - hit_len
            bucket = self._prompt_bucket(sfx)
            if hit_len and hit_len + bucket > self.max_seq_len:
                # pow2 overshoot past the cache: the 16-grain window (the
                # lookup made sure it fits).
                bucket = -(-sfx // 16) * 16
            groups.setdefault(bucket, []).append((adm, hit_len, store_idx))
        return groups

    def _prefill_group(self, bucket: int, group: list,
                       emitted: Dict[int, List[int]],
                       prefill_tokens: Dict[int, int]) -> None:
        """One prefill forward of a bucket's admissions, the row count
        padded to a power of two; each row's first token sampled, read back
        and set as its slot's last token."""
        s_pad = 1
        while s_pad < len(group):
            s_pad *= 2
        toks = np.zeros((s_pad, bucket), np.int32)
        total = np.ones((s_pad,), np.int32)     # padding rows: len 1
        last_i = np.zeros((s_pad,), np.int32)
        pstart = np.zeros((s_pad,), np.int32)
        slots = np.full((s_pad,), -1, np.int32)
        hit_dst, hit_src = [], []
        for i, (adm, hit_len, store_idx) in enumerate(group):
            sfx_toks = adm.prompt[hit_len:]
            toks[i, :len(sfx_toks)] = sfx_toks
            total[i] = len(adm.prompt)
            last_i[i] = len(sfx_toks) - 1
            pstart[i] = hit_len
            slots[i] = adm.slot
            if hit_len:
                hit_dst.append(adm.slot)
                hit_src.append(store_idx)
                metrics.inc("engine.prefix_hits")
                metrics.inc("engine.prefix_tokens_reused", hit_len)
        t0 = time.perf_counter()
        if hit_dst:
            # The stored prefix rows into the slots (the suffix prefill
            # overwrites [hit, hit + bucket); later rows are rewritten by
            # decode before they are attended).
            _copy_cache_rows(self.caches, self._prefix_store,
                             self._index(hit_dst), self._index(hit_src))
        if self._mesh is not None:
            from ..parallel.sharded import make_sharded_prefill_step
            last_logits, _ = make_sharded_prefill_step(
                self._mesh, self.cfg, self.params, bucket, s_pad)(
                self.params, self.caches, toks, slots, total)
            sampled = self._sample(last_logits)
        else:
            sampled = self._prefill_sampled(toks, total, last_i, pstart,
                                            slots)
        metrics.inc("engine.prefill_dispatches")
        with span("engine.readback"):
            firsts = sampled.cpu().numpy()               # (s_pad,)
        now = time.perf_counter()
        g = len(group)
        self.stats["prefill_time_s"] += now - t0
        self.stats["prefill_tokens"] += int(total[:g].sum())
        self.stats["prefill_tokens_run"] += s_pad * bucket
        self.stats["prefill_tokens_padding"] += s_pad * bucket - int(
            (total[:g] - pstart[:g]).sum())
        v_slots = self._index(slots[:g])
        self.seq_lens[v_slots] = torch.from_numpy(total[:g]).to(self.device)
        self.last_tokens[v_slots] = torch.from_numpy(
            firsts[:g].astype(np.int32)).to(self.device)
        for i, (adm, hit_len, _) in enumerate(group):
            req = self.scheduler.running[adm.slot]
            req.first_token_t = now
            self.stats["first_token_wait_s"] += now - req.admit_t
            first_tok = int(firsts[i])
            self.stats["prefills"] += 1
            self.stats["tokens_out"] += 1
            get_logger().info("admitted req %d → slot %d (prompt %d, "
                              "prefix hit %d)", adm.req_id, adm.slot,
                              len(adm.prompt), hit_len)
            prefill_tokens[adm.slot] = first_tok
            emitted.setdefault(adm.req_id, []).append(first_tok)

    def step(self) -> Dict[int, List[int]]:
        """One engine iteration: admit + prefill new requests, then decode
        every active slot: one step, a chunk, or a speculative window.
        Returns {req_id: [tokens]} emitted this iteration."""
        with span("engine.step"):
            return self._step()

    def _step(self) -> Dict[int, List[int]]:
        sched = self.scheduler
        emitted: Dict[int, List[int]] = {}

        # Batched admission: one prefill forward per (suffix) bucket, the
        # row count padded to a power of two. Prefix-cache hits copy their
        # stored rows in first and prefill only the suffix window.
        with span("engine.admit"):
            groups = self._admit()
        prefill_tokens: Dict[int, int] = {}
        for bucket, group in groups.items():
            with span("engine.prefill"):
                self._prefill_group(bucket, group, emitted, prefill_tokens)
        if self._prefix_slots and groups:
            # After every group's hits copied their rows out.
            with span("engine.prefix_insert"):
                self._prefix_insert_batch([(adm.prompt, adm.slot)
                                           for group in groups.values()
                                           for adm, _, _ in group])
        if prefill_tokens:
            with span("engine.emit"):
                sched.record_tokens(prefill_tokens)

        active = sched.active_slots()
        if active and self.spec_k:
            with span("engine.decode"):
                done = self._spec_decode(active, sched, emitted)
            if done:
                return emitted
            # Too close to the cache's end for a window: a plain step.
        if active:
            with span("engine.decode"):
                chunk = self.decode_chunk
                if chunk > 1:
                    with span("engine.readback"):
                        longest = int(self.seq_lens.cpu()[active].max())
                    if longest + chunk > self.max_seq_len:
                        chunk = 1   # the tail of a long sequence: single steps
                mask = np.zeros((self.max_slots,), bool)
                mask[active] = True
                t0 = time.perf_counter()
                self._mask.copy_(torch.from_numpy(mask))
                out_np = self._run_decode(chunk)        # (chunk, slots)
                self.stats["decode_time_s"] += time.perf_counter() - t0
                self.stats["decode_steps"] += chunk
                self.stats["decode_slot_steps"] += chunk * len(active)
            if chunk > 1 and not self._eager_chunks and \
                    self._graph is None:
                self._capture()
            with span("engine.emit"):
                self._emit_tokens(out_np, active, sched, emitted)
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
