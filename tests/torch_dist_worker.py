"""Worker processes of ``test_torch_parallel.py`` (not a test module).

Imports torch and the port only, never JAX: the test module starts these
workers with the ``spawn`` context from a parent that has JAX loaded. Each
worker joins a gloo group through a ``file://`` store, builds the port's
(data, expert, model) mesh with every rank on the "model" axis, runs every
case it is given on its own shard of the case's inputs over that axis's
group, and writes its outputs to ``<out_dir>/<rank>.npz``.

A case is a dict: ``op`` (the port function to run), ``arrays`` mapping an
argument name to ``(array, shard_axis or None, dtype name)`` — bf16 values
travel as exact f32 — and ``kwargs``.
"""

import pathlib

import numpy as np
import torch
import torch.distributed as dist

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8}


def _inputs(case, rank, world):
    args = {}
    for name, (arr, axis, dtype) in case["arrays"].items():
        if axis is not None:
            arr = np.split(arr, world, axis=axis)[rank]
        args[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            _DTYPES[dtype])
    return args


def _run_case(case, rank, world, group):
    from deepgemm_ascend_tpu_torch import parallel
    op = case["op"]
    if op == "ring_shift":
        mine = torch.full((3,), float(rank))
        fwd, bwd = (parallel.ring_shift([mine], group, reverse=r)[0]
                    for r in (False, True))
        return np.stack([fwd.numpy(), bwd.numpy()])
    args = _inputs(case, rank, world)
    out = getattr(parallel, op)(**args, group=group, **case["kwargs"])
    return out.to(torch.float32).numpy()


def run(rank, world, init_file, cases, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from deepgemm_ascend_tpu_torch.parallel import make_mesh
        mesh = make_mesh(tp=world, device_type="cpu")
        group = mesh.get_group("model")
        out = {"mesh_shape": np.asarray(mesh.shape),
               "group_size": np.asarray(dist.get_world_size(group))}
        for name, case in cases.items():
            out[name] = _run_case(case, rank, world, group)
        np.savez(pathlib.Path(out_dir) / f"{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
