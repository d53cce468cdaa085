"""Worker processes of ``test_torch_parallel.py`` and
``test_torch_sharded.py`` (not a test module).

Imports torch and the port only, never JAX: the test module starts these
workers with the ``spawn`` context from a parent that has JAX loaded. Each
worker joins a gloo group through a ``file://`` store, builds the port's
(data, expert, model) mesh with every rank on the "model" axis, runs every
case it is given on its own shard of the case's inputs over that axis's
group, and writes its outputs to ``<out_dir>/<rank>.npz``.

A case is a dict: ``op`` (the port function to run), ``arrays`` mapping an
argument name to ``(array, shard_axis or None, dtype name)`` — bf16 values
travel as exact f32 — and ``kwargs``.

:func:`run_sharded` runs the sharded serving steps instead: for each mesh
shape of its world size, the port's parameters from the JAX package's (a
tree for ``params_from_numpy``), this rank's shard, a batched prefill, two
decode steps (logits gathered), the greedy and a sampled step on copies of
the same state, the sharded top-p threshold on given logits, and
``Engine(mesh=...)`` serving given prompts.

:func:`one_rank_mesh` gives a test process a (1, 1, 1) mesh of its own
over a one-rank gloo group.
"""

import contextlib
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


@contextlib.contextmanager
def one_rank_mesh(store_dir):
    """A (1, 1, 1) mesh over a gloo group of this process alone, joined
    through a ``file://`` store in ``store_dir``; on exit the sharded steps'
    memo is dropped and the group destroyed."""
    from deepgemm_ascend_tpu_torch.parallel import make_mesh, sharded
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, 1, device_type="cpu")
    finally:
        sharded.clear_program_memo()
        dist.destroy_process_group()


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


def _sharded_case(mesh, shape, spec, params):
    import copy

    from deepgemm_ascend_tpu_torch.models import TINY, init_cache
    from deepgemm_ascend_tpu_torch.parallel import sharded
    from deepgemm_ascend_tpu_torch.serving import Engine
    cfg = TINY
    out = {}
    p = sharded.shard_params(mesh, params, cfg)
    caches = sharded.shard_caches(
        mesh, init_cache(cfg, spec["slots_total"], spec["max_seq"],
                         device="cpu"), cfg)
    prefill = sharded.make_sharded_prefill_step(
        mesh, cfg, params, spec["bucket"], len(spec["slots"]))
    out["prefill"], caches = prefill(p, caches, spec["tokens"],
                                     spec["slots"], spec["true_lens"])
    for n in ("k_q", "k_s", "v_q", "v_s"):
        for li, c in enumerate(caches):
            out[f"cache{li}_{n}"] = getattr(c, n).clone()
    step = sharded.make_sharded_decode_step(mesh, cfg, params)
    lens = torch.from_numpy(spec["lens"])
    out["decode1"], caches = step(p, torch.from_numpy(spec["step1"]),
                                  caches, lens)
    saved = copy.deepcopy(caches)
    out["decode2"], _ = step(p, torch.from_numpy(spec["step2"]), caches,
                             lens + 1)
    greedy = sharded.make_sharded_decode_step(
        mesh, cfg, params, sample={"temperature": 0.0})
    out["greedy2"], _ = greedy(p, torch.from_numpy(spec["step2"]),
                               copy.deepcopy(saved), lens + 1)
    sampled = sharded.make_sharded_decode_step(
        mesh, cfg, params, sample=spec["sample"])
    out["sampled2"], _ = sampled(p, torch.from_numpy(spec["step2"]), saved,
                                 lens + 1, torch.Generator().manual_seed(7))
    model = mesh.get_group("model")
    tp = dist.get_world_size(model)
    t = mesh.get_local_rank("model")
    x = torch.from_numpy(np.split(spec["topp_logits"], tp, axis=1)[t])
    out["topp"] = sharded._topp_threshold_sharded(x, spec["topp_p"], model)
    for name, kw in spec["engines"].items():
        eng = Engine(params, cfg, max_slots=spec["slots_total"],
                     max_seq_len=spec["max_seq"], mesh=mesh, device="cpu",
                     **kw)
        outs = eng.generate(spec["prompts"], max_new_tokens=spec["new"])
        out[f"engine_{name}"] = np.asarray(outs)
    return {k: (v.to(torch.float32) if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else v) for k, v in out.items()}


def run_sharded(rank, world, init_file, shapes, tree, spec, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from deepgemm_ascend_tpu_torch.models import TINY, params_from_numpy
        from deepgemm_ascend_tpu_torch.parallel import make_mesh
        params = params_from_numpy(tree, TINY, device="cpu")
        out = {}
        for shape in shapes:
            mesh = make_mesh(*shape, device_type="cpu")
            tag = "x".join(map(str, shape))
            out[f"{tag}/coords"] = np.asarray(
                [mesh.get_local_rank(a) for a in ("data", "expert",
                                                  "model")])
            for k, v in _sharded_case(mesh, shape, spec, params).items():
                out[f"{tag}/{k}"] = (v.numpy() if isinstance(v, torch.Tensor)
                                     else v)
        np.savez(pathlib.Path(out_dir) / f"{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
