"""Flash prefill: causal GQA attention over the INT8 KV cache (K4, K4-stats).

Port of ``flash_prefill_gqa`` from ``deepgemm_ascend_tpu/ops/flash_prefill.py``.
Query row i of batch b sits at absolute position ``start[b] + i`` (start
may be negative) and attends cache positions t with ``t <= start[b] + i``
and ``t < seq_lens[b]``; the cache already holds the prompt's rows.
``return_stats=True`` returns the raw online-softmax state instead of the
normalized output, for merging across ring-attention hops
(``parallel/ring_attention.py``): a row before position 0, or with no
valid key, reports ``(acc 0, m NEG_INF, l 0)``.

On a CUDA tensor the wrapper launches ``csrc/flash_prefill.cu`` (the
``flash_prefill`` entry, or ``flash_prefill_stats`` for the state): blocks
of :data:`ROWS` query rows (the TPU kernel's VMEM-driven q-block search is
not needed) fed by a TMA ring, both products on the tensor cores, launched
heaviest first (:func:`block_order`); it reads q and writes its outputs in
the public layouts. At head size 64 the same entries run a kernel on the
CUDA cores instead, 16 query rows a block. On a CPU tensor it runs :func:`flash_prefill_plain` or
:func:`flash_prefill_stats_plain`, on the kernel layout of the JAX package.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .flash_common import (NEG_INF, check_cuda_geometry, softmax_pv,
                           softmax_state)

__all__ = ["block_order", "flash_prefill_gqa", "flash_prefill_plain",
           "flash_prefill_stats_plain"]

COUNTER = _kernels.COUNTERS["flash_prefill"]
STATS_COUNTER = _kernels.COUNTERS["flash_prefill_stats"]
# Query rows a block of the CUDA kernel: G heads x ROWS / G positions
# (csrc/flash_prefill.cu: kRows).
ROWS = 192


def block_order(b: int, kvh: int, s: int, g: int, rows: int = ROWS,
                heavy_first: bool = True):
    """The (batch, kv head, q block) of each grid block of the CUDA kernel,
    in launch order: the last q blocks (at equal starts, those with the
    most keys) first, each over every (batch, kv head); ``heavy_first=False``
    gives the q order. A q block is ``rows // g`` positions."""
    nq = -(-s // (rows // g))
    pairs = b * kvh
    order = []
    for blk in range(nq * pairs):
        rank, bh = divmod(blk, pairs)
        order.append((bh // kvh, bh % kvh, nq - 1 - rank if heavy_first
                      else rank))
    return order


def _masked_scores(qg, k_q, k_s, start, seq_lens):
    """(b, kvh, g, s, S) f32 scores with the kernel's masks."""
    b, kvh, g, s, hd = qg.shape
    s_max = k_q.shape[2]
    dev = qg.device
    qf = qg.to(torch.bfloat16).to(torch.float32)
    sc = qf @ k_q.to(torch.float32)[:, :, None].transpose(-1, -2)
    sc = sc * (k_s.to(torch.float32)
               * (1.0 / math.sqrt(hd)))[:, :, None, None, :]
    pos = (start.to(device=dev, dtype=torch.int64)[:, None]
           + torch.arange(s, device=dev)[None, :])                # (b, s)
    t = torch.arange(s_max, device=dev)
    mask = ((t[None, None, :] <= pos[:, :, None])
            & (t[None, None, :] < seq_lens.to(dev)[:, None, None]))  # (b,s,S)
    return torch.where(mask[:, None, None], sc, torch.full_like(sc, NEG_INF))


def flash_prefill_plain(qg, k_q, k_s, v_q, v_s, start, seq_lens):
    """Plain PyTorch version of K4 on the kernel layout: qg (b, kvh, g, s, hd)
    → (b, kvh, g, s, hd) f32, one-block softmax over the whole cache with
    the kernel's masks and bf16 points."""
    COUNTER.plain_calls += 1
    sc = _masked_scores(qg, k_q, k_s, start, seq_lens)
    return softmax_pv(sc, v_s.to(torch.float32)[:, :, None, None, :],
                      v_q.to(torch.float32)[:, :, None])


def flash_prefill_stats_plain(qg, k_q, k_s, v_q, v_s, start, seq_lens):
    """Plain PyTorch version of K4-stats: the one-block state of
    :func:`flash_prefill_plain` — acc (b, kvh, g, s, hd), m and l
    (b, kvh, g, s), f32."""
    STATS_COUNTER.plain_calls += 1
    sc = _masked_scores(qg, k_q, k_s, start, seq_lens)
    return softmax_state(sc, v_s.to(torch.float32)[:, :, None, None, :],
                         v_q.to(torch.float32)[:, :, None])


def flash_prefill_gqa(
    q: torch.Tensor,          # (b, s, heads, hd) bf16/f32
    k_q: torch.Tensor,        # (b, kvh, S, hd) int8
    k_s: torch.Tensor,        # (b, kvh, S) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    start: torch.Tensor,      # (b,) int32 — absolute position of q row 0
    seq_lens: torch.Tensor,   # (b,) int32 — valid cache length (incl. prompt)
    *,
    return_stats: bool = False,
):
    """Causal GQA prefill over the int8 cache → (b, s, heads, hd) f32, or
    with ``return_stats`` the state (acc (b, s, heads, hd) f32 unnormalized,
    m (b, s, heads) f32 row max with NEG_INF = empty, l (b, s, heads) f32
    exp-sum).

    Like the JAX package, ``s`` must be a multiple of 16 (``attention()``
    sends other lengths to the fallback path)."""
    b, s, heads, hd = q.shape
    _, kvh, s_max, _ = k_q.shape
    if heads % kvh:
        raise ValueError(f"heads={heads} not a multiple of kv_heads={kvh}")
    if s % 16:
        raise ValueError(
            f"flash_prefill_gqa needs a q-block that is a multiple of 16 "
            f"dividing s={s}; use the XLA attention path for ragged prompts")
    g = heads // kvh
    dev = q.device
    st = start.to(device=dev, dtype=torch.int32).contiguous()
    lens = seq_lens.to(device=dev, dtype=torch.int32).contiguous()
    if dev.type == "cpu":
        qg = q.to(torch.bfloat16).reshape(b, s, kvh, g, hd).permute(
            0, 2, 3, 1, 4)
        if return_stats:
            acc, m, l = flash_prefill_stats_plain(qg, k_q, k_s, v_q, v_s, st,
                                                  lens)
            return (acc.permute(0, 3, 1, 2, 4).reshape(b, s, heads, hd),
                    m.permute(0, 3, 1, 2).reshape(b, s, heads),
                    l.permute(0, 3, 1, 2).reshape(b, s, heads))
        out = flash_prefill_plain(qg, k_q, k_s, v_q, v_s, st, lens)
        return out.permute(0, 3, 1, 2, 4).reshape(b, s, heads, hd)
    if dev.type != "cuda":
        raise ValueError(f"flash_prefill_gqa: unsupported device {dev}")
    check_cuda_geometry("flash_prefill_gqa", hd, g)
    for label, t, dt in (("k_q", k_q, torch.int8), ("v_q", v_q, torch.int8),
                         ("k_s", k_s, torch.float32),
                         ("v_s", v_s, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"flash_prefill_gqa: {label} must be a "
                             f"contiguous {dt} tensor on {dev}")
    qb = q.to(torch.bfloat16).contiguous()
    # q is read in 16-byte words, the caches by TMA: an operand off 16
    # bytes would fault on the card (or be refused by the tensor map).
    for label, t in (("q", qb), ("k_q", k_q), ("v_q", v_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_prefill_gqa: {label} must start on a "
                             f"16-byte boundary (the kernel reads it by TMA "
                             f"or in 16-byte words)")
    out = torch.empty((b, s, heads, hd), dtype=torch.float32, device=dev)
    ins = (qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
           v_s.data_ptr(), st.data_ptr(), lens.data_ptr(), out.data_ptr())
    dims = (b, kvh, g, s, s_max, hd, 1.0 / math.sqrt(hd),
            _kernels.stream_ptr(dev))
    if return_stats:
        m = torch.empty((b, s, heads), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        rc = _kernels.entry("flash_prefill_stats")(
            *ins, m.data_ptr(), l.data_ptr(), *dims)
        _kernels.check(rc, "flash_prefill_stats")
        STATS_COUNTER.launches += 1
        return out, m, l
    rc = _kernels.entry("flash_prefill")(*ins, *dims)
    _kernels.check(rc, "flash_prefill")
    COUNTER.launches += 1
    return out
