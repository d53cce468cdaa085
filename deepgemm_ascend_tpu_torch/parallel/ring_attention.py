"""Ring attention — context-parallel (CP) prefill over a KV ring.

Port of ``deepgemm_ascend_tpu/parallel/ring_attention.py`` onto
``torch.distributed``. Long-context prefill splits the SEQUENCE over a
ring of ranks: each holds S/cp query rows and S/cp KV rows. The KV shards
rotate around the ring (:func:`~.overlap.ring_shift`, the counterpart of
``lax.ppermute``) and each hop's partial attention merges into a running
online-softmax state, so no rank ever holds the full K/V.

* :func:`ring_attention_prefill` — bf16 q/k/v, f32 chunk attention in
  PyTorch; the contiguous schedule and the load-balanced zigzag schedule.
* :func:`ring_flash_prefill` — the production form over the INT8 KV cache:
  each hop runs the flash-prefill kernel with ``return_stats`` (K4-stats,
  ``ops/flash_prefill.py``) and the raw (acc, m, l) states merge across
  hops.
* :func:`zigzag_order` / :func:`zigzag_inverse` — zigzag layout helpers.

``group`` takes the place of JAX's ``axis_name`` (a ``ProcessGroup``, e.g.
``make_mesh(...).get_group("model")``; ``None``: the default group); a
rank's position in the sequence is its rank in the group. ``cp`` is the
static ring size and must equal the group's size; ``cp == 1`` needs no
group. Two empty-state conventions are kept exactly as in the JAX package:
:func:`_chunk_attn` marks a fully masked row with m = -inf and
:func:`_merge` guards with ``isfinite``, while the flash hops report
m = -1e30 (finite); the final division is ``acc / max(l, 1e-30)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.flash_prefill import flash_prefill_gqa
from .overlap import ring_rank, ring_shift

__all__ = ["ring_attention_prefill", "ring_flash_prefill",
           "zigzag_order", "zigzag_inverse"]


def zigzag_order(cp: int, s_total: int) -> np.ndarray:
    """Row permutation for the zigzag schedule: rank r owns sequence chunks
    r and 2cp-1-r (of 2cp equal chunks), so causal work balances. Apply to
    the sequence axis BEFORE sharding; invert the OUTPUT rows with
    :func:`zigzag_inverse`."""
    if s_total % (2 * cp):
        raise ValueError(f"s_total={s_total} must divide into 2*cp={2*cp} "
                         f"equal chunks")
    sc = s_total // (2 * cp)
    order = []
    for r in range(cp):
        order += list(range(r * sc, (r + 1) * sc))
        order += list(range((2 * cp - 1 - r) * sc, (2 * cp - r) * sc))
    return np.asarray(order)


def zigzag_inverse(cp: int, s_total: int) -> np.ndarray:
    inv = np.empty(s_total, np.int64)
    inv[zigzag_order(cp, s_total)] = np.arange(s_total)
    return inv


def _chunk_attn(q, k, v, mask, scale):
    """One (q-chunk × kv-chunk) attention partial in f32.

    q: (b, sq, h, d); k/v: (b, sk, h, d); mask: (sq, sk) bool (True = keep).
    Returns (acc (b, sq, h, d) — exp-weighted V sum, m (b, sq, h) row max,
    -inf for a fully masked row, l (b, sq, h) exp sum), all f32."""
    s = torch.einsum("bqhd,bkhd->bqhk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    keep = mask[None, :, None, :]
    s = torch.where(keep, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1)
    # fully masked rows (m = -inf): exp(-inf - -inf) = nan → guard to 0
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(keep, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bqhk,bkhd->bqhd", p, v.to(torch.float32))
    return acc, m, l


def _merge(state, new):
    """Online-softmax merge of two (acc, m, l) partial states."""
    acc0, m0, l0 = state
    acc1, m1, l1 = new
    m = torch.maximum(m0, m1)
    safe = lambda mm: torch.where(torch.isfinite(mm), mm, torch.zeros_like(mm))
    c0 = torch.where(torch.isfinite(m0), torch.exp(safe(m0) - safe(m)),
                     torch.zeros_like(m0))
    c1 = torch.where(torch.isfinite(m1), torch.exp(safe(m1) - safe(m)),
                     torch.zeros_like(m1))
    return (acc0 * c0[..., None] + acc1 * c1[..., None], m, l0 * c0 + l1 * c1)


def _finish(state, out_dtype):
    acc, _, l = state
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(out_dtype)


def _positions(r: int, cp: int, s_local: int, zigzag: bool, dev):
    """Global sequence positions of rank ``r``'s rows."""
    if zigzag:
        sc = s_local // 2
        ar = torch.arange(sc, device=dev)
        return torch.cat([r * sc + ar, (2 * cp - 1 - r) * sc + ar])
    return r * s_local + torch.arange(s_local, device=dev)


def _attn_hop(q, k, v, idx: int, owner: int, *, cp: int, causal: bool,
              zigzag: bool):
    """One hop of :func:`ring_attention_prefill` on rank ``idx``: its q rows
    against the KV shard of rank ``owner``. Returns the partial (acc, m, l).
    GQA: the small KV is expanded here, per hop. A causal zigzag hop off the
    diagonal computes exactly one unmasked (s_local × s_local/2) block."""
    b, s_local, h, d = q.shape
    hk = k.shape[2]
    if hk != h:
        k = torch.repeat_interleave(k, h // hk, dim=2)
        v = torch.repeat_interleave(v, h // hk, dim=2)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device=dev)
    if zigzag and causal and idx != owner:
        sc = s_local // 2
        if idx > owner:
            # Both local q chunks attend the owner's LOW chunk (global id
            # owner < idx): fully visible.
            return _chunk_attn(q, k[:, :sc], v[:, :sc], ones(s_local, sc),
                               scale)
        # Only the local HIGH chunk (global id 2cp-1-idx, above both owner
        # chunks) attends, to all of it; the low-chunk rows get the empty
        # softmax state.
        acc, m, l = _chunk_attn(q[:, sc:], k, v, ones(sc, s_local), scale)
        return (torch.cat([torch.zeros_like(acc), acc], dim=1),
                torch.cat([torch.full_like(m, float("-inf")), m], dim=1),
                torch.cat([torch.zeros_like(l), l], dim=1))
    if not causal:
        return _chunk_attn(q, k, v, ones(s_local, s_local), scale)
    mask = (_positions(idx, cp, s_local, zigzag, dev)[:, None]
            >= _positions(owner, cp, s_local, zigzag, dev)[None, :])
    return _chunk_attn(q, k, v, mask, scale)


def _ring(hop, kv, idx: int, cp: int, next_kv):
    """The hop loop of both rings on rank ``idx``: ``hop(kv, owner)`` over
    its own shard, then over the shard of rank (idx + s) % cp for s = 1 ..
    cp-1 (a reverse ring, as ``overlap.all_gather_gemm``), each partial
    merged into the running state. ``next_kv(kv, owner)`` returns the shard
    of rank ``owner`` given the one held now: :func:`~.overlap.ring_shift`
    for the public entries; a caller that runs every rank in one process
    passes a slice of the whole sequence. Returns the merged (acc, m, l)."""
    state = hop(kv, idx)
    for s in range(1, cp):
        owner = (idx + s) % cp
        kv = next_kv(kv, owner)
        state = _merge(state, hop(kv, owner))
    return state


def _shift(group):
    return lambda kv, owner: ring_shift(kv, group, reverse=True)


def _attn_ring(q, k, v, idx: int, cp: int, next_kv, *, causal: bool,
               zigzag: bool):
    """:func:`ring_attention_prefill`'s state on rank ``idx`` (:func:`_ring`
    over :func:`_attn_hop`)."""
    hop = lambda kv, owner: _attn_hop(q, *kv, idx, owner, cp=cp,
                                      causal=causal, zigzag=zigzag)
    return _ring(hop, (k, v), idx, cp, next_kv)


def ring_attention_prefill(q, k, v, *, group=None, cp: int,
                           causal: bool = True, schedule: str = "contiguous",
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Context-parallel attention over sequence-sharded q/k/v.

    Each rank passes its shards (b, s_local, heads, head_dim); the global
    row of local row r on rank i is ``i * s_local + r``. Returns the
    (b, s_local, heads, head_dim) attention output for the local query
    rows — the online-softmax math of flash attention, so it matches
    full-sequence attention to f32 rounding. GQA is native: k/v may carry
    fewer heads (h % hk == 0); the ring rotates the small KV and expands it
    locally per hop.

    ``schedule``: ``"contiguous"`` — rank i holds rows [i·s_local,
    (i+1)·s_local); ``"zigzag"`` — rank i holds chunks i and 2cp-1-i of 2cp
    chunks (permute the rows with :func:`zigzag_order` first, the output
    with :func:`zigzag_inverse` after), and every causal off-diagonal hop
    computes exactly one unmasked (s_local × s_local/2) block, chosen by
    the rank order (:func:`_attn_hop`)."""
    b, s_local, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k/v shards must match, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    hk = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s_local, d) or h % hk:
        raise ValueError(f"q/k/v shards must match, got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)} (q heads must "
                         f"be a multiple of kv heads)")
    if schedule not in ("contiguous", "zigzag"):
        raise ValueError(f"schedule must be contiguous|zigzag, "
                         f"got {schedule!r}")
    if cp == 1:
        return _finish(_attn_ring(q, k, v, 0, 1, None, causal=causal,
                                  zigzag=False), out_dtype)
    zig = schedule == "zigzag"
    if zig and s_local % 2:
        raise ValueError("zigzag needs an even local row count (two chunks)")
    return _finish(_attn_ring(q, k, v, ring_rank(group, cp), cp,
                              _shift(group), causal=causal, zigzag=zig),
                   out_dtype)


def _hop(q, k_q, k_s, v_q, v_s, owner_off: int):
    """One ring hop of :func:`ring_flash_prefill`: the local q rows against
    the KV shard of the rank ``owner_off`` positions before this one,
    presented to K4-stats at relative start ``owner_off · s_local``
    (negative: a future shard, fully masked; ≥ s_local: fully visible).
    Returns the raw (acc, m, l) state."""
    b, s_local = q.shape[:2]
    dev = q.device
    start = torch.full((b,), owner_off * s_local, dtype=torch.int32,
                       device=dev)
    seq = torch.full((b,), s_local, dtype=torch.int32, device=dev)
    return flash_prefill_gqa(q, k_q, k_s, v_q, v_s, start, seq,
                             return_stats=True)


def _flash_ring(q, kv, idx: int, cp: int, next_kv):
    """:func:`ring_flash_prefill`'s state on rank ``idx`` (:func:`_ring`
    over :func:`_hop`); ``kv`` is (k_q, k_s, v_q, v_s)."""
    return _ring(lambda kv, owner: _hop(q, *kv, idx - owner), tuple(kv),
                 idx, cp, next_kv)


def ring_flash_prefill(q, k_q, k_s, v_q, v_s, *, group=None, cp: int,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """CP prefill over the INT8 KV cache with flash chunks (contiguous
    schedule, causal).

    Per rank: q (b, s_local, heads, hd); k_q/v_q (b, kvh, s_local, hd) int8
    with (b, kvh, s_local) f32 per-token scales — the serving cache layout,
    sharded on the sequence dim. Each hop runs K4-stats (:func:`_hop`) and
    the states merge (:func:`_merge`). The TPU kernel's ``block_q`` /
    ``block_s`` knobs have no counterpart: the CUDA kernel's tiles are
    fixed."""
    kv = (k_q, k_s, v_q, v_s)
    if cp == 1:
        return _finish(_flash_ring(q, kv, 0, 1, None), out_dtype)
    return _finish(_flash_ring(q, kv, ring_rank(group, cp), cp,
                               _shift(group)), out_dtype)
