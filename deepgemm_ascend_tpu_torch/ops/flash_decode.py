"""Flash decode over the INT8 KV cache (kernels K2, K5a, K5b).

Port of ``deepgemm_ascend_tpu/ops/flash_decode.py``. For one query token
per sequence each op attends cache rows [0, seq_len) of its kv head, with
``seq_len`` clamped to [0, S] first:

* :func:`flash_decode_gqa_inplace` (K2, the decode path's op): row
  seq_len-1 is the new token's K/V, which rides in as
  ``k_new``/``v_new``/``k_snew``/``v_snew``, and that row and its scales
  are written into all four cache arrays in place;
* :func:`flash_decode_gqa` (K5a): read only, returns the normalized output;
* :func:`flash_decode_gqa_state` (K5b): read only, returns the raw
  online-softmax state ``(acc, m, l)`` so that a caller can merge further
  terms exactly (an empty sequence gives m = NEG_INF, l = 0).

On a CUDA tensor the wrappers launch ``csrc/flash_decode.cu``; on a CPU
tensor they run the plain versions beside them. K5a and K5b take route
"span": one block per span of :data:`SPLIT_KEYS` keys of each (batch, kv
head), then a merge of the spans that normalizes, or for K5b writes the
merged state. K2 takes route "live" at head size 128 (:func:`route`; at
64 it takes route "span"): a grid of
:func:`live_blocks` blocks, fixed by the shapes, which read the lengths on
the card and share the live keys of all sequences out in proportion to
their lengths (:func:`live_plan`, :func:`live_block_range`), each through
a TMA ring and the tensor cores; the last block of each (batch, kv head)
to finish merges its blocks and writes the new row. Nothing is read back
to the host. K2 updates the caches passed in and returns them
(the JAX package returns new arrays through aliased outputs).
"""

from __future__ import annotations

import math

import torch

from ..tiling import platform
from . import _kernels
from .flash_common import (NEG_INF, check_cuda_geometry, softmax_pv,
                           softmax_state)

__all__ = ["flash_decode_gqa", "flash_decode_gqa_state",
           "flash_decode_gqa_inplace", "flash_decode_plain",
           "flash_decode_state_plain", "flash_decode_inplace_plain",
           "merge_current_token", "route", "live_blocks", "live_plan",
           "live_block_range"]

COUNTER = _kernels.COUNTERS["flash_decode"]
READ_COUNTER = _kernels.COUNTERS["flash_decode_read"]
STATE_COUNTER = _kernels.COUNTERS["flash_decode_state"]
# Keys per block of the CUDA kernel (a multiple of its 128-key chunk):
# 16 slots x 4 kv heads alone would give 64 blocks to 132 SMs, so longer
# caches are split into spans that run in parallel and are merged after.
SPLIT_KEYS = 512
# K2's routes, as the C entry numbers them.
ROUTES = ("span", "live")
# Route "live": keys a stage of its ring (a chunk), the blocks an SM its
# grid gives the live chunks beyond one per (batch, kv head)
# (scripts/decode_sweep.py times other counts), and the most blocks one
# (batch, kv head) takes (the kernel's bound: its merge's weights).
LIVE_CHUNK = 64
LIVE_HEAD_DIM = 128
LIVE_BLOCKS_PER_SM = 3
LIVE_MAX_SPLITS = 256


def route(k_q, v_q, k_new, v_new) -> str:
    """K2's route: ``"live"`` at head size LIVE_HEAD_DIM where TMA and
    16-byte loads can read the caches and the new rows (16-byte-aligned
    ``data_ptr``s; the wrapper makes them contiguous), else ``"span"``."""
    return ("live" if k_q.shape[-1] == LIVE_HEAD_DIM
            and all(t.data_ptr() % 16 == 0 for t in (k_q, v_q, k_new, v_new))
            else "span")


def live_blocks(b: int, kvh: int, s_max: int, sms: int) -> int:
    """The grid of route "live", fixed by the shapes so that no length is
    read back: one block per (batch, kv head) plus LIVE_BLOCKS_PER_SM on
    each of ``sms`` SMs for the live chunks, but no more than one block per
    chunk of a full cache."""
    heads = b * kvh
    return min(heads + LIVE_BLOCKS_PER_SM * sms,
               heads * (1 + -(-s_max // LIVE_CHUNK)))


def live_plan(lens, kvh: int, blocks: int):
    """What each of the ``blocks`` blocks of route "live" takes, as the
    kernel computes it on the card from the clamped lengths ``lens``: with
    C the live chunks of all (batch, kv head)s and A = blocks - b·kvh, each
    head of sequence i takes nb_i = min(LIVE_MAX_SPLITS,
    max(1, ceil(chunks_i / ceil(C / A)))) blocks, in the order (i, head,
    split). Returns one (sequence, head, split, nb) per block, None for a
    block past the plan."""
    chunks = [-(-int(n) // LIVE_CHUNK) for n in lens]
    avail = blocks - len(chunks) * kvh
    quota = max(1, -(-sum(chunks) * kvh // avail))
    plan = []
    for i, c in enumerate(chunks):
        nb = min(LIVE_MAX_SPLITS, max(1, -(-c // quota)))
        plan += [(i, h, split, nb) for h in range(kvh) for split in range(nb)]
    return plan + [None] * (blocks - len(plan))


# Route "live"'s arrival counts, one per (batch, kv head), by (device,
# stream): zero between launches (each launch's merging blocks reset
# theirs), so one buffer serves every launch of a stream, which runs them
# one after another; launches on two streams never share counts. A launch
# that fails drops its stream's buffer (it may have left counts behind).
_ARRIVALS = {}


def _arrivals(n: int, dev, stream: int) -> torch.Tensor:
    """At least ``n`` zeroed arrival counts for launches on ``stream`` (a
    ``cuda_stream`` handle) of ``dev``."""
    buf = _ARRIVALS.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[dev, stream] = torch.zeros(n, dtype=torch.int32,
                                                  device=dev)
    return buf


def live_block_range(length: int, split: int, splits: int):
    """Keys [t0, t1) that block ``split`` of ``splits`` takes of a sequence
    of ``length`` live keys, as the kernel computes them on the card: the
    ceil(length / LIVE_CHUNK) chunks dealt out so that blocks differ by at
    most one chunk; an empty range for a block with none."""
    chunks = -(-length // LIVE_CHUNK)
    base, rem = divmod(chunks, splits)
    c0 = split * base + min(split, rem)
    nc = base + (1 if split < rem else 0)
    return (min(length, c0 * LIVE_CHUNK),
            min(length, (c0 + nc) * LIVE_CHUNK))


def _write_new_rows(k_q, k_s, v_q, v_s, k_new, v_new, k_snew, v_snew, lens):
    """Write each sequence's new row at pos = len-1 (sequences with len 0
    write nothing)."""
    bi = torch.nonzero(lens > 0, as_tuple=True)[0]
    pos = (lens[bi] - 1).long()
    k_q[bi, :, pos] = k_new[bi]
    v_q[bi, :, pos] = v_new[bi]
    k_s[bi, :, pos] = k_snew[bi].to(k_s.dtype)
    v_s[bi, :, pos] = v_snew[bi].to(v_s.dtype)


def _scores(q, k_q, k_s, seq_lens):
    """(b, kvh, g, S) f32 scores of the valid rows [0, seq_lens), NEG_INF
    elsewhere. ``seq_lens`` is already clamped to [0, S]."""
    b, heads, hd = q.shape
    _, kvh, s_max, _ = k_q.shape
    qg = q.to(torch.bfloat16).to(torch.float32).reshape(b, kvh, heads // kvh,
                                                       hd)
    s = qg @ k_q.to(torch.float32).transpose(-1, -2)
    s = s * (k_s.to(torch.float32) * (1.0 / math.sqrt(hd)))[:, :, None, :]
    t = torch.arange(s_max, device=q.device)
    valid = t[None, :] < seq_lens.to(q.device)[:, None]      # (b, S)
    return torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))


def _pv_args(v_q, v_s):
    return v_s.to(torch.float32)[:, :, None, :], v_q.to(torch.float32)


def flash_decode_inplace_plain(q, k_q, k_s, v_q, v_s, k_new, v_new, k_snew,
                               v_snew, seq_lens):
    """Plain PyTorch version of K2: the same cache write, then a one-block
    softmax over the whole valid length with the kernel's bf16 points.
    ``seq_lens`` is already clamped to [0, S]. Returns (b, kvh, g, hd) f32."""
    COUNTER.plain_calls += 1
    _write_new_rows(k_q, k_s, v_q, v_s, k_new, v_new, k_snew, v_snew,
                    seq_lens)
    return softmax_pv(_scores(q, k_q, k_s, seq_lens), *_pv_args(v_q, v_s))


def flash_decode_plain(q, k_q, k_s, v_q, v_s, seq_lens):
    """Plain PyTorch version of K5a: K2's softmax without the cache write.
    Returns (b, kvh, g, hd) f32."""
    READ_COUNTER.plain_calls += 1
    return softmax_pv(_scores(q, k_q, k_s, seq_lens), *_pv_args(v_q, v_s))


def flash_decode_state_plain(q, k_q, k_s, v_q, v_s, seq_lens):
    """Plain PyTorch version of K5b: the one-block state — acc
    (b, kvh, g, hd), m and l (b, kvh, g), f32."""
    STATE_COUNTER.plain_calls += 1
    return softmax_state(_scores(q, k_q, k_s, seq_lens), *_pv_args(v_q, v_s))


def _prepare(name, q, k_q, k_s, v_q, v_s, seq_lens):
    """Shapes, the clamped lengths, and on CUDA the operand checks and the
    bf16 query. Returns (b, heads, hd, kvh, g, s_max, lens, q_for_kernel)."""
    b, heads, hd = q.shape
    _, kvh, s_max, _ = k_q.shape
    if heads % kvh:
        raise ValueError(f"heads={heads} not a multiple of kv_heads={kvh}")
    g = heads // kvh
    dev = q.device
    lens = torch.clamp(seq_lens.to(device=dev, dtype=torch.int32), 0, s_max)
    if dev.type == "cpu":
        return b, heads, hd, kvh, g, s_max, lens, q
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    check_cuda_geometry(name, hd, g)
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise ValueError(f"{name}: caches must be int8")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise ValueError(f"{name}: cache scales must be f32")
    for label, t in (("k_q", k_q), ("k_s", k_s), ("v_q", v_q), ("v_s", v_s)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous tensor "
                             f"on {dev}")
    return (b, heads, hd, kvh, g, s_max, lens,
            q.to(torch.bfloat16).contiguous())


def _span_scratch(b, kvh, g, s_max, hd, dev, split_keys=None):
    """Route "span"'s partial states: one per span of ``split_keys``
    (SPLIT_KEYS if None) keys of each (batch, kv head)."""
    n_split = -(-s_max // (split_keys or SPLIT_KEYS))
    return torch.empty((b * kvh * n_split * g * (hd + 2),),
                       dtype=torch.float32, device=dev)


def flash_decode_gqa_inplace(
    q: torch.Tensor,         # (b, heads, hd)
    k_q: torch.Tensor,       # (b, kvh, S, hd) int8 — rows [0, len-1) valid
    k_s: torch.Tensor,       # (b, kvh, S) f32 — rows [0, len-1) valid
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    k_new: torch.Tensor,     # (b, kvh, hd) int8 — the current token's row
    v_new: torch.Tensor,
    k_snew: torch.Tensor,    # (b, kvh) f32 — the current token's scales
    v_snew: torch.Tensor,
    seq_lens: torch.Tensor,  # (b,) int32 — length INCLUDING the current token
):
    """Fused decode attention + cache write.

    Returns ``(out (b, heads, hd) f32, k_q, v_q, k_s, v_s)``, the caches
    being the same tensors, updated in place. ``seq_lens`` is clamped to the
    cache extent first: the engine decodes every slot, freed ones included,
    and a freed slot's length may already equal S.
    """
    return _launch_inplace(q, k_q, k_s, v_q, v_s, k_new, v_new, k_snew,
                           v_snew, seq_lens)


def _launch_inplace(q, k_q, k_s, v_q, v_s, k_new, v_new, k_snew, v_snew,
                    seq_lens, plan=None):
    """K2 on ``q``'s device. ``plan``: (route, split) in place of
    :func:`route` and :func:`live_blocks`'s (for tests and sweeps): the
    span's keys for "span", the grid's blocks for "live"."""
    b, heads, hd, kvh, g, s_max, lens, qb = _prepare(
        "flash_decode_gqa_inplace", q, k_q, k_s, v_q, v_s, seq_lens)
    dev = q.device
    if dev.type == "cpu":
        out = flash_decode_inplace_plain(q, k_q, k_s, v_q, v_s, k_new, v_new,
                                         k_snew, v_snew, lens)
        return out.reshape(b, heads, hd), k_q, v_q, k_s, v_s
    kn = k_new.to(torch.int8).contiguous()
    vn = v_new.to(torch.int8).contiguous()
    ksn = k_snew.to(torch.float32).contiguous()
    vsn = v_snew.to(torch.float32).contiguous()
    for label, t in (("k_new", kn), ("v_new", vn), ("k_snew", ksn),
                     ("v_snew", vsn)):
        if t.device != dev:
            raise ValueError(f"flash_decode_gqa_inplace: {label} must be on "
                             f"{dev}")
    if plan is None:
        rt = route(k_q, v_q, kn, vn)
        plan = rt, (live_blocks(b, kvh, s_max, platform.detect(dev).num_cores)
                    if rt == "live" else SPLIT_KEYS)
    rt, split = plan
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    # Partial states: one per span, or one per block of the grid.
    part = (_span_scratch(b, kvh, g, s_max, hd, dev, split) if rt == "span"
            else torch.empty((split * g * (hd + 2),), dtype=torch.float32,
                             device=dev))
    stream = _kernels.stream_ptr(dev)
    rc = _kernels.entry("flash_decode")(
        qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), kn.data_ptr(), vn.data_ptr(), ksn.data_ptr(),
        vsn.data_ptr(), lens.data_ptr(), part.data_ptr(), out.data_ptr(),
        _arrivals(b * kvh, dev, stream).data_ptr(), b, kvh, g, s_max, hd,
        ROUTES.index(rt), split, 1.0 / math.sqrt(hd), stream)
    if rc:
        _ARRIVALS.pop((dev, stream), None)
    _kernels.check(rc, "flash_decode")
    COUNTER.launches += 1
    COUNTER.count_plan(f"{rt}/{split}")
    return out.reshape(b, heads, hd), k_q, v_q, k_s, v_s


def flash_decode_gqa(
    q: torch.Tensor,         # (b, heads, hd) bf16/f32
    k_q: torch.Tensor,       # (b, kvh, S, hd) int8
    k_s: torch.Tensor,       # (b, kvh, S) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    seq_lens: torch.Tensor,  # (b,) int32 — tokens [0, len) are attended
) -> torch.Tensor:
    """Single-token GQA attention over the int8 cache, read only. Returns
    (b, heads, hd) f32 (zeros for an empty sequence)."""
    b, heads, hd, kvh, g, s_max, lens, qb = _prepare(
        "flash_decode_gqa", q, k_q, k_s, v_q, v_s, seq_lens)
    dev = q.device
    if dev.type == "cpu":
        out = flash_decode_plain(q, k_q, k_s, v_q, v_s, lens)
        return out.reshape(b, heads, hd)
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    part = _span_scratch(b, kvh, g, s_max, hd, dev)
    rc = _kernels.entry("flash_decode_read")(
        qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), lens.data_ptr(), part.data_ptr(), out.data_ptr(),
        b, kvh, g, s_max, hd, SPLIT_KEYS, 1.0 / math.sqrt(hd),
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "flash_decode_read")
    READ_COUNTER.launches += 1
    return out.reshape(b, heads, hd)


def flash_decode_gqa_state(
    q: torch.Tensor,         # (b, heads, hd)
    k_q: torch.Tensor,       # (b, kvh, S, hd) int8
    k_s: torch.Tensor,       # (b, kvh, S) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    seq_lens: torch.Tensor,
):
    """Like :func:`flash_decode_gqa` but returns the raw online-softmax
    state ``(acc, m, l)`` — acc (b, heads, hd) UNNORMALIZED, m/l
    (b, heads) — so callers can merge additional attention terms exactly:

        M = max(m, s_extra); α = e^(m−M); β = e^(s_extra−M)
        out = (acc·α + β·v_extra) / (l·α + β)

    Empty sequences yield m = −1e30, l = 0 → the merge degenerates to the
    extra term alone (:func:`merge_current_token` writes it out for one
    token of the int8 cache)."""
    b, heads, hd, kvh, g, s_max, lens, qb = _prepare(
        "flash_decode_gqa_state", q, k_q, k_s, v_q, v_s, seq_lens)
    dev = q.device
    if dev.type == "cpu":
        acc, m, l = flash_decode_state_plain(q, k_q, k_s, v_q, v_s, lens)
    else:
        acc = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
        m = torch.empty((b, kvh, g), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        part = _span_scratch(b, kvh, g, s_max, hd, dev)
        rc = _kernels.entry("flash_decode_state")(
            qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), lens.data_ptr(), part.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, kvh, g, s_max, hd, SPLIT_KEYS,
            1.0 / math.sqrt(hd), _kernels.stream_ptr(dev))
        _kernels.check(rc, "flash_decode_state")
        STATE_COUNTER.launches += 1
    return (acc.reshape(b, heads, hd), m.reshape(b, heads),
            l.reshape(b, heads))


def merge_current_token(state, q, k_new, k_snew, v_new, v_snew):
    """Fold one more cache row (the current token) into the state of
    :func:`flash_decode_gqa_state`, exactly as its docstring writes the
    merge, with the kernels' score and their bf16 rounding of the
    probability times the row's v scale. state: acc (b, heads, hd), m/l
    (b, heads); q (b, heads, hd); k_new/v_new (b, kvh, hd) int8;
    k_snew/v_snew (b, kvh). Returns the normalized (b, heads, hd) f32 —
    what :func:`flash_decode_gqa_inplace` returns for that row."""
    acc, m, l = state
    b, heads, hd = q.shape
    kvh = k_new.shape[1]
    g = heads // kvh
    qf = q.to(torch.bfloat16).float().reshape(b, kvh, g, hd)
    s_new = ((qf * k_new.float()[:, :, None]).sum(-1)
             * (k_snew.float()[:, :, None] / math.sqrt(hd))).reshape(b, heads)
    big = torch.maximum(m, s_new)
    alpha, beta = torch.exp(m - big), torch.exp(s_new - big)
    w_new = (beta * v_snew.float().repeat_interleave(g, dim=1)).to(
        torch.bfloat16).float()
    v_row = v_new.float().repeat_interleave(g, dim=1)
    return ((acc * alpha[..., None] + w_new[..., None] * v_row)
            / (l * alpha + beta)[..., None])
