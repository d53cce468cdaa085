"""Decomposed collective GEMMs and the ring shift under them.

Port of ``deepgemm_ascend_tpu/parallel/overlap.py`` onto
``torch.distributed``. The JAX package decomposes a collective around a
sharded matmul into a ring of ``lax.ppermute`` steps interleaved with
per-chunk partial dots, so that XLA overlaps each step's transfer with the
next step's work. Here each step is :func:`ring_shift` — every rank posts
its send to one neighbour and its receive from the other together
(``dist.batch_isend_irecv``; a blocking send-then-receive would deadlock
the ring) — and each per-chunk product is a ``torch.matmul`` of f32-upcast
operands, as the JAX package's are plain ``lax.dot_general`` calls with
f32 accumulation. Run eagerly, the port's steps do not overlap; the
decomposition keeps the exchanged bytes at (tp-1)/tp of one buffer.

* :func:`gemm_reduce_scatter` — row-parallel linear (weights sharded on
  K): each rank ends with the fully summed M-chunk it owns.
* :func:`all_gather_gemm` — column-parallel linear over a K-sharded
  activation: the activation shard rotates and each arriving chunk
  multiplies the matching K rows.

``group`` takes the place of JAX's ``axis_name``: the ring's ranks, in
group-rank order (``None``: the default group). ``tp`` is the static ring
size and must equal the group's size; ``tp == 1`` needs no group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["gemm_reduce_scatter", "all_gather_gemm", "ring_shift"]


def _ring_perm(tp: int, reverse: bool = False):
    """Nearest-neighbour ring permutation as (source, destination) pairs."""
    if reverse:
        return [((i + 1) % tp, i) for i in range(tp)]
    return [(i, (i + 1) % tp) for i in range(tp)]


def ring_rank(group, size: int) -> int:
    """This process's rank in ``group``, checked against the static ring
    size."""
    n = dist.get_world_size(group)
    if n != size:
        raise ValueError(f"ring size {size} != the group's {n} ranks")
    return dist.get_rank(group)


def ring_shift(tensors: Sequence[torch.Tensor], group=None,
               reverse: bool = False) -> List[torch.Tensor]:
    """One hop of the ring: send each tensor to the next rank of ``group``
    and return the tensors received from the previous one (``reverse``: the
    other direction) — ``lax.ppermute(x, axis, _ring_perm(n, reverse))``
    for every tensor at once."""
    g = group if group is not None else dist.group.WORLD
    n, me = dist.get_world_size(g), dist.get_rank(g)
    perm = _ring_perm(n, reverse)
    dst = dist.get_global_rank(g, next(d for s, d in perm if s == me))
    src = dist.get_global_rank(g, next(s for s, d in perm if d == me))
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, g))
        ops.append(dist.P2POp(dist.irecv, o, src, g))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _dot(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(out_dtype)


def gemm_reduce_scatter(x_local: torch.Tensor, w_local: torch.Tensor, *,
                        group=None, tp: int,
                        preferred_element_type=torch.float32) -> torch.Tensor:
    """Row-parallel GEMM with a reduce-scatter ring epilogue.

    x_local: (m, k_local) activation shard (K sharded over the group);
    w_local: (k_local, n) weight shard; m % tp must be 0. Returns
    (m // tp, n): the fully summed output rows owned by this rank (row
    chunk = group rank), i.e. ``reduce_scatter(partials, dim=0)``. Ring
    schedule (tp-1 hops): start with the partial M-chunk owned by the rank
    tp-1 hops downstream, then alternate (shift the sum forward, add the
    next chunk's local partial)."""
    m, _ = x_local.shape
    if m % tp:
        raise ValueError(f"m={m} must be divisible by the ring size tp={tp}")
    if tp == 1:
        return _dot(x_local, w_local, preferred_element_type)
    mc = m // tp
    idx = ring_rank(group, tp)

    def chunk_partial(c):
        return _dot(x_local[c * mc:(c + 1) * mc], w_local,
                    preferred_element_type)

    # After s of the tp-1 hops the sum holds the chunk that is (tp-1-s)
    # hops downstream of this rank; it arrives home fully summed.
    acc = chunk_partial((idx + tp - 1) % tp)
    for s in range(1, tp):
        acc = ring_shift([acc], group)[0]
        acc = acc + chunk_partial((idx + tp - 1 - s) % tp)
    return acc


def all_gather_gemm(x_local: torch.Tensor, w_rows: torch.Tensor, *,
                    group=None, tp: int,
                    preferred_element_type=torch.float32) -> torch.Tensor:
    """Column-parallel GEMM over a K-sharded activation, gather decomposed.

    x_local: (m, k_local) activation shard; w_rows: (k_local·tp, n_local),
    this rank's weight columns with all K rows. Returns (m, n_local) =
    full_x @ w_rows without materializing full_x: the activation shard
    rotates around the (reverse) ring and each arriving chunk multiplies
    the matching K rows. Equal to ``all_gather(x) @ w_rows`` up to f32
    summation order."""
    m, k_local = x_local.shape
    if w_rows.shape[0] != k_local * tp:
        raise ValueError(f"w_rows must have {k_local * tp} rows "
                         f"(k_local={k_local} × tp={tp}), got "
                         f"{tuple(w_rows.shape)}")
    if tp == 1:
        return _dot(x_local, w_rows, preferred_element_type)
    idx = ring_rank(group, tp)

    def rows_dot(chunk_owner, xc):
        return _dot(xc, w_rows[chunk_owner * k_local:
                               (chunk_owner + 1) * k_local],
                    preferred_element_type)

    buf = x_local
    y = rows_dot(idx, buf)
    for s in range(1, tp):
        # Reverse ring: after s hops this rank holds the shard of rank
        # (idx + s) % tp.
        buf = ring_shift([buf], group, reverse=True)[0]
        y = y + rows_dot((idx + s) % tp, buf)
    return y
