"""Process-group initialization and the (data, expert, model) device mesh.

Port of ``deepgemm_ascend_tpu/parallel/mesh.py`` onto ``torch.distributed``.
Axis conventions, as in the JAX package:

  "data"   — batch / sequence-group parallelism (dp)
  "expert" — MoE expert parallelism (ep)
  "model"  — tensor parallelism over heads/vocab (tp); the ring of the
             context-parallel prefill (``ring_attention.py``) runs over
             ``mesh.get_group("model")``.

Where JAX builds a ``Mesh`` over the visible devices, the port builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group (one process per card, NCCL; or processes joined over gloo,
whose collectives take CPU and, in this torch, CUDA tensors). A gloo mesh
is built with ``device_type="cpu"`` whatever device its tensors live on.

JAX places an array on a mesh with a ``NamedSharding``; PyTorch runs one
process a rank, so :func:`shard` cuts a tensor to this rank's block along
the named axes and :func:`replicated` keeps the whole, each as a
contiguous copy of its own. The collectives over an axis's group —
:func:`psum`, :func:`pmax`, :func:`pmin`, :func:`all_gather` — are the
identity on a group of one rank (or ``None``), as a psum over a size-1
axis is a no-op in JAX.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["AXES", "init_distributed", "make_mesh",
           "mesh_shape", "axis_size", "replicated", "shard", "psum", "pmax",
           "pmin", "all_gather"]

AXES = ("data", "expert", "model")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def init_distributed() -> bool:
    """Join the default NCCL process group when launched by ``torchrun``
    (no-op otherwise, or when already joined), each process on the card
    ``LOCAL_RANK``; returns whether a group exists. Gated on the launcher's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), as the JAX
    package gates on ``JAX_COORDINATOR_ADDRESS``. CPU processes join gloo
    with ``torch.distributed.init_process_group`` themselves."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(v) for v in _TORCHRUN_ENV):
        return False
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl")
    return True


def mesh_shape(n: int, dp: Optional[int] = None, ep: Optional[int] = None,
               tp: Optional[int] = None) -> Tuple[int, int, int]:
    """(dp, ep, tp) for ``n`` devices. Unspecified axes default so that
    dp·ep·tp == n (greedy: fill tp, then ep, then dp) — the JAX package's
    rule, kept apart from the group so that it can be tested alone."""
    known = [a for a in (dp, ep, tp) if a]
    rem = n
    for a in known:
        if rem % a:
            raise ValueError(f"axis sizes {dp, ep, tp} do not divide {n}")
        rem //= a
    if tp is None:
        tp = rem
        rem = 1
    if ep is None:
        ep = rem
        rem = 1
    if dp is None:
        dp = rem
        rem = 1
    if dp * ep * tp != n:
        raise ValueError(f"dp*ep*tp = {dp*ep*tp} != {n} devices")
    return dp, ep, tp


def make_mesh(dp: Optional[int] = None, ep: Optional[int] = None,
              tp: Optional[int] = None, device_type: str = "cuda"):
    """Build a (data, expert, model) ``DeviceMesh`` over the default process
    group's ranks, axes sized by :func:`mesh_shape`. ``device_type="cpu"``
    for CPU processes (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = mesh_shape(dist.get_world_size(), dp, ep, tp)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def shard(x: torch.Tensor, mesh, *spec) -> torch.Tensor:
    """This rank's block of ``x``: dim i cut along mesh axis ``spec[i]``
    (``None``: kept whole) into equal blocks — JAX's ``shard(mesh, *spec)``
    placement, seen from one rank. A contiguous copy."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} {axis!r} shards")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.get_local_rank(axis) * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole of ``x`` on this rank, as a contiguous copy."""
    return shard(x, mesh)


def _ranks(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if _ranks(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, in place."""
    return _reduce(x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over the group's ranks, in place."""
    return _reduce(x, group, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum over the group's ranks, in place."""
    return _reduce(x, group, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order
    (``lax.all_gather(..., tiled=True)``)."""
    n = _ranks(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
