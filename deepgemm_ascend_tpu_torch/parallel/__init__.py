"""Multi-device pieces of the port, over ``torch.distributed``.

Port of ``deepgemm_ascend_tpu/parallel/``, so far its context-parallel
primitives: the (data, expert, model) mesh (:mod:`.mesh`), the decomposed
collective GEMMs and the ring shift under them (:mod:`.overlap`), and ring
attention over bf16 q/k/v or the int8 KV cache (:mod:`.ring_attention`).
A ring runs over a process group (one process per card, NCCL; or CPU
processes with gloo) where the JAX package runs over a named mesh axis
inside ``shard_map``. ``sharded.py`` (the sharded serving steps) and
``Engine(mesh=...)`` are not ported yet.
"""

from .mesh import AXES, init_distributed, make_mesh, mesh_shape
from .overlap import all_gather_gemm, gemm_reduce_scatter, ring_shift
from .ring_attention import (ring_attention_prefill, ring_flash_prefill,
                             zigzag_inverse, zigzag_order)

__all__ = [
    "AXES", "init_distributed", "make_mesh", "mesh_shape",
    "all_gather_gemm", "gemm_reduce_scatter", "ring_shift",
    "ring_attention_prefill", "ring_flash_prefill", "zigzag_inverse",
    "zigzag_order",
]
