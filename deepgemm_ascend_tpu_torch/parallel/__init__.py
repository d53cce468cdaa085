"""Multi-device pieces of the port, over ``torch.distributed``.

Port of ``deepgemm_ascend_tpu/parallel/``: the (data, expert, model) mesh,
its sharding helpers and collectives (:mod:`.mesh`), the sharded serving
steps over dp/ep/tp (:mod:`.sharded`, which ``Engine(mesh=...)`` runs), the
decomposed collective GEMMs and the ring shift under them
(:mod:`.overlap`), and ring attention over bf16 q/k/v or the int8 KV cache
(:mod:`.ring_attention`). The port runs one process a rank (one a card over
NCCL, or processes joined over gloo) where the JAX package runs one
controller over named mesh axes inside ``shard_map``; a collective runs
over an axis's process group.
"""

from .mesh import (AXES, all_gather, init_distributed, make_mesh, mesh_shape,
                   pmax, pmin, psum, replicated, shard)
from .overlap import all_gather_gemm, gemm_reduce_scatter, ring_shift
from .ring_attention import (ring_attention_prefill, ring_flash_prefill,
                             zigzag_inverse, zigzag_order)
from .sharded import (clear_program_memo, make_sharded_decode_step,
                      make_sharded_prefill_step, shard_caches, shard_params,
                      tp_kv_sharding)

__all__ = [
    "AXES", "init_distributed", "make_mesh", "mesh_shape",
    "replicated", "shard", "psum", "pmax", "pmin", "all_gather",
    "all_gather_gemm", "gemm_reduce_scatter", "ring_shift",
    "ring_attention_prefill", "ring_flash_prefill", "zigzag_inverse",
    "zigzag_order",
    "clear_program_memo", "make_sharded_decode_step",
    "make_sharded_prefill_step", "shard_caches", "shard_params",
    "tp_kv_sharding",
]
