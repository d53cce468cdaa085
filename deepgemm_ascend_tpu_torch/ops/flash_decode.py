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
tensor they run the plain versions beside them. All three take route
"live" at head size 128 where TMA can read the caches (:func:`route` for
K2, which also needs its new rows aligned; :func:`read_route` for K5a and
K5b): a grid of :func:`live_blocks` blocks, fixed by the shapes, which
read the lengths on the card and share the live keys of all sequences
out in proportion to their lengths (:func:`live_plan`,
:func:`live_block_range`), each through a TMA ring and the tensor cores;
the last block of each (batch, kv head) to finish merges its blocks, and
K2's writes the new row. Elsewhere (head size 64, caches off 16 bytes)
they take route "span": one block per span of :data:`SPLIT_KEYS` keys of
each (batch, kv head), then a merge of the spans. A ``plan`` argument
forces either (for tests and measurements). Nothing is read back to the
host. K2 updates the caches passed in and returns them (the JAX package
returns new arrays through aliased outputs). Each launch is counted under
its plan too (``Counter.plans``: "live/<blocks>" or "span/<keys>").
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
           "merge_current_token", "route", "read_route", "live_blocks",
           "live_plan", "live_block_range"]

COUNTER = _kernels.COUNTERS["flash_decode"]
READ_COUNTER = _kernels.COUNTERS["flash_decode_read"]
STATE_COUNTER = _kernels.COUNTERS["flash_decode_state"]
# Keys per block of the CUDA kernel (a multiple of its 128-key chunk):
# 16 slots x 4 kv heads alone would give 64 blocks to 132 SMs, so longer
# caches are split into spans that run in parallel and are merged after.
SPLIT_KEYS = 512
# The routes, as the C entries number them.
ROUTES = ("span", "live")
# Route "live": keys a stage of its ring (a chunk), the blocks an SM its
# grid gives the live chunks beyond one per (batch, kv head)
# (scripts/decode_sweep.py times other counts), and the most blocks one
# (batch, kv head) takes (the kernel's bound: its merge's weights).
LIVE_CHUNK = 64
LIVE_HEAD_DIM = 128
LIVE_BLOCKS_PER_SM = 3
LIVE_MAX_SPLITS = 256


def read_route(k_q, v_q) -> str:
    """K5a's and K5b's route: ``"live"`` at head size LIVE_HEAD_DIM where
    TMA can read the caches (16-byte-aligned ``data_ptr``s; the caches are
    contiguous), else ``"span"``."""
    return ("live" if k_q.shape[-1] == LIVE_HEAD_DIM
            and all(t.data_ptr() % 16 == 0 for t in (k_q, v_q))
            else "span")


def route(k_q, v_q, k_new, v_new) -> str:
    """K2's route: :func:`read_route`'s, where 16-byte loads can read the
    new rows too (16-byte-aligned ``data_ptr``s; the wrapper makes them
    contiguous), else ``"span"``."""
    return ("live" if read_route(k_q, v_q) == "live"
            and all(t.data_ptr() % 16 == 0 for t in (k_new, v_new))
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


def _plan_scratch(rt, plan, b, kvh, g, s_max, hd, dev):
    """The plan (route, split) of a launch — ``plan``, or route ``rt`` with
    :func:`live_blocks`'s grid or SPLIT_KEYS keys a span — and its scratch
    of partial states: one per grid block (route "live"), or one per span
    of each (batch, kv head) (route "span")."""
    rt, split = plan or (rt, live_blocks(b, kvh, s_max,
                                         platform.detect(dev).num_cores)
                         if rt == "live" else SPLIT_KEYS)
    states = split if rt == "live" else b * kvh * -(-s_max // split)
    return rt, split, torch.empty((states * g * (hd + 2),),
                                  dtype=torch.float32, device=dev)


def _launched(counter, name, rc, dev, stream, rt, split):
    """Check a launch's return code (a failed one drops its stream's
    arrival counts, which it may have left non-zero) and count it."""
    if rc:
        _ARRIVALS.pop((dev, stream), None)
    _kernels.check(rc, name)
    counter.launches += 1
    counter.count_plan(f"{rt}/{split}")


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
    rt, split, part = _plan_scratch(route(k_q, v_q, kn, vn), plan, b, kvh, g,
                                    s_max, hd, dev)
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    stream = _kernels.stream_ptr(dev)
    rc = _kernels.entry("flash_decode")(
        qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), kn.data_ptr(), vn.data_ptr(), ksn.data_ptr(),
        vsn.data_ptr(), lens.data_ptr(), part.data_ptr(), out.data_ptr(),
        _arrivals(b * kvh, dev, stream).data_ptr(), b, kvh, g, s_max, hd,
        ROUTES.index(rt), split, 1.0 / math.sqrt(hd), stream)
    _launched(COUNTER, "flash_decode", rc, dev, stream, rt, split)
    return out.reshape(b, heads, hd), k_q, v_q, k_s, v_s


def flash_decode_gqa(
    q: torch.Tensor,         # (b, heads, hd) bf16/f32
    k_q: torch.Tensor,       # (b, kvh, S, hd) int8
    k_s: torch.Tensor,       # (b, kvh, S) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    seq_lens: torch.Tensor,  # (b,) int32 — tokens [0, len) are attended
    plan=None,
) -> torch.Tensor:
    """Single-token GQA attention over the int8 cache, read only. Returns
    (b, heads, hd) f32 (zeros for an empty sequence). ``plan``: (route,
    split) in place of :func:`read_route` and :func:`live_blocks`'s (for
    tests and measurements): the span's keys for "span", the grid's blocks
    for "live"."""
    return _launch_read(q, k_q, k_s, v_q, v_s, seq_lens, False, plan)


def flash_decode_gqa_state(
    q: torch.Tensor,         # (b, heads, hd)
    k_q: torch.Tensor,       # (b, kvh, S, hd) int8
    k_s: torch.Tensor,       # (b, kvh, S) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    seq_lens: torch.Tensor,
    plan=None,
):
    """Like :func:`flash_decode_gqa` but returns the raw online-softmax
    state ``(acc, m, l)`` — acc (b, heads, hd) UNNORMALIZED, m/l
    (b, heads) — so callers can merge additional attention terms exactly:

        M = max(m, s_extra); α = e^(m−M); β = e^(s_extra−M)
        out = (acc·α + β·v_extra) / (l·α + β)

    Empty sequences yield m = −1e30, l = 0 → the merge degenerates to the
    extra term alone (:func:`merge_current_token` writes it out for one
    token of the int8 cache). ``plan`` as for :func:`flash_decode_gqa`."""
    return _launch_read(q, k_q, k_s, v_q, v_s, seq_lens, True, plan)


def _launch_read(q, k_q, k_s, v_q, v_s, seq_lens, state: bool, plan):
    """K5a (``state`` False) or K5b on ``q``'s device."""
    name = "flash_decode_gqa_state" if state else "flash_decode_gqa"
    b, heads, hd, kvh, g, s_max, lens, qb = _prepare(
        name, q, k_q, k_s, v_q, v_s, seq_lens)
    dev = q.device
    if dev.type == "cpu":
        if not state:
            return flash_decode_plain(q, k_q, k_s, v_q, v_s, lens).reshape(
                b, heads, hd)
        acc, m, l = flash_decode_state_plain(q, k_q, k_s, v_q, v_s, lens)
        return (acc.reshape(b, heads, hd), m.reshape(b, heads),
                l.reshape(b, heads))
    rt, split, part = _plan_scratch(read_route(k_q, v_q), plan, b, kvh, g,
                                    s_max, hd, dev)
    acc = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    stream = _kernels.stream_ptr(dev)
    head = (qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), lens.data_ptr(), part.data_ptr(), acc.data_ptr())
    tail = (_arrivals(b * kvh, dev, stream).data_ptr(), b, kvh, g, s_max, hd,
            ROUTES.index(rt), split, 1.0 / math.sqrt(hd), stream)
    if not state:
        rc = _kernels.entry("flash_decode_read")(*head, *tail)
        _launched(READ_COUNTER, "flash_decode_read", rc, dev, stream, rt,
                  split)
        return acc.reshape(b, heads, hd)
    m = torch.empty((b, kvh, g), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    rc = _kernels.entry("flash_decode_state")(*head, m.data_ptr(),
                                              l.data_ptr(), *tail)
    _launched(STATE_COUNTER, "flash_decode_state", rc, dev, stream, rt,
              split)
    return acc.reshape(b, heads, hd), m.reshape(b, heads), l.reshape(b, heads)


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
