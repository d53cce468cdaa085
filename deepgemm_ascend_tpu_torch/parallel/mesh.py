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
process group (one process per card). The sharding helpers ``replicated``
and ``shard`` arrive with ``sharded.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["AXES", "init_distributed", "make_mesh", "mesh_shape"]

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
