"""The port's sharded serving (``parallel/sharded.py``, ``Engine(mesh=...)``)
against the JAX package's ``shard_map`` steps and against its own
one-device path, on the CPU at TINY.

The port runs in real process groups: one group of 2 and one of 4
``spawn``-started workers (``torch_dist_worker.run_sharded``, no JAX) join
gloo through a ``file://`` store, each started once per module, and run
every mesh of their size: (1,1,2), (1,2,1), (2,1,1) and (1,4,1), (2,2,1),
(1,2,2), (1,1,4) — (dp, ep, tp). TINY has 4 q and 2 kv heads of 128, so
tp = 2 shards the kv heads congruently (the flash kernels per shard) and
tp = 4 replicates them (each shard's q heads read their kv head by global
index, the plain attention path). JAX runs its sharded steps on the
virtual CPU devices (``conftest.py``), its Pallas kernels in interpret
mode; the port's kernel wrappers run their plain versions. A worker that
does not finish within its join timeout is terminated and fails the tests.

Tolerances. JAX's sharded steps are jitted programs (eager ``shard_map``
takes 150-210 s a mesh here), and jit fuses bf16 round trips away, which
moves JAX's own logits 0.05-0.2 rel-L2 from its eager ones on these
inputs; the port computes as eager JAX (to ~1e-7). So every mesh is held
to eager JAX's one-device path (op by op, no jit around the model) —
which JAX's sharded steps equal, to 1e-6 with tp = 1
(``tests/test_parallel.py``) — within ``test_torch_model.py``'s bounds: rel-L2 2e-2 after the prefill and 5e-2 for decode steps where the
flash kernels run, 1e-3 on the replicated-kv (plain, f32) path, whose
reference runs with ``use_flash_decode=False`` as JAX's test does; and
four meshes also to JAX's jitted sharded step, within that bound plus
JAX's own distance between the two. Against the port's one-device path:
tp = 1 within 1e-6 rel-L2 (only the f32 order of an ep psum differs), tp
> 1 within 0.02 (the o-projection's partials psummed in f32: JAX's bound
for such meshes, ``tests/test_parallel.py``); the prefill's caches of a
tp = 1 mesh bit for bit, as JAX asserts.
"""

import copy
import dataclasses
import functools
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu.parallel import make_mesh as jmake_mesh
from deepgemm_ascend_tpu.parallel import sharded as jsh
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.parallel import make_mesh as tmake_mesh
from deepgemm_ascend_tpu_torch.parallel import sharded as tsh
from deepgemm_ascend_tpu_torch.serving import Engine
from deepgemm_ascend_tpu_torch.serving import engine as tengine
from deepgemm_ascend_tpu_torch.utils import verify
from torch_bridge import tree_of

P = jax.sharding.PartitionSpec
TINY = jmodels.TINY
JOIN_TIMEOUT_S = 120
MESHES = {2: [(1, 1, 2), (1, 2, 1), (2, 1, 1)],
          4: [(1, 4, 1), (2, 2, 1), (1, 2, 2), (1, 1, 4)]}
ALL = [m for ms in MESHES.values() for m in ms]
IDS = ["x".join(map(str, m)) for m in ALL]
# The meshes also run through JAX's jitted sharded steps: the two tp
# regimes, congruent and replicated kv.
JAX_MESHES = [(1, 1, 2), (1, 1, 4)]
FLASH_PREFILL, FLASH_DECODE, PLAIN_TOL = 2e-2, 5e-2, 1e-3
SELF_TP1, SELF_TP = 1e-6, 0.02
SAMPLE = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}


def _spec():
    """The inputs every mesh runs, from a numpy seed: a prefill of 3
    prompts (and a padding row) into slots 2, 0, 3 of 4, two decode steps
    with slot 1 idle, logits for the top-p search, and prompts to serve."""
    rng = np.random.default_rng(11)
    true_lens = np.asarray([20, 32, 9, 1], np.int32)
    tokens = np.zeros((4, 32), np.int32)
    for i, n in enumerate(true_lens[:3]):
        tokens[i, :n] = rng.integers(1, TINY.vocab_size, size=n)
    return dict(
        slots_total=4, max_seq=64, bucket=32, tokens=tokens,
        slots=np.asarray([2, 0, 3, -1], np.int32), true_lens=true_lens,
        lens=np.asarray([32, 0, 20, 9], np.int32),
        step1=rng.integers(0, TINY.vocab_size, size=4).astype(np.int32),
        step2=rng.integers(0, TINY.vocab_size, size=4).astype(np.int32),
        sample=SAMPLE,
        topp_logits=(rng.standard_normal((3, TINY.vocab_size)) * 3).astype(
            np.float32),
        topp_p=0.9,
        prompts=[rng.integers(1, TINY.vocab_size, size=n).tolist()
                 for n in (5, 17, 30, 3, 12, 40)],
        new=6, engines={"greedy": {}, "chunk2": {"decode_chunk": 2}})


SPEC = _spec()


@pytest.fixture(scope="module")
def jax_params():
    return jmodels.init_params(jax.random.PRNGKey(0), TINY)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return tmodels.params_from_numpy(tree_of(jax_params), TINY,
                                     device="cpu")


def _start(world, tree, out_dir):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run_sharded,
                         args=(r, world, str(out_dir / "store"),
                               MESHES[world], tree, SPEC, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(world, procs, out_dir):
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT_S)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    if hung:
        pytest.fail(f"world {world}: workers {hung} did not finish within "
                    f"{JOIN_TIMEOUT_S} s and were terminated")
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"world {world}: worker exit codes {codes}"
    return {r: dict(np.load(out_dir / f"{r}.npz")) for r in range(world)}


def _jax_run(jp, shape):
    """JAX's sharded prefill and two decode steps on ``shape``'s mesh."""
    n = int(np.prod(shape))
    mesh = jmake_mesh(*shape, devices=jax.devices()[:n])
    p = jsh.shard_params(mesh, jp, TINY)
    c = jsh.shard_caches(mesh, jmodels.init_cache(TINY, 4, 64), TINY)
    prefill = jsh.make_sharded_prefill_step(mesh, TINY, jp, 32, 4)
    lp, c = prefill(p, c, jnp.asarray(SPEC["tokens"]),
                    jnp.asarray(SPEC["slots"]), jnp.asarray(SPEC["true_lens"]))
    step = jsh.make_sharded_decode_step(mesh, TINY, jp)
    lens = jnp.asarray(SPEC["lens"])
    l1, c = step(p, jnp.asarray(SPEC["step1"]), c, lens)
    l2, _ = step(p, jnp.asarray(SPEC["step2"]), c, lens + 1)
    return [np.asarray(x, np.float32) for x in (lp, l1, l2)]


def _jax_eager(jp, flash):
    """Eager JAX's one-device path on the same inputs — op by op, with no
    jit around the model — with ``use_flash_decode=flash``: the engine's
    batched prefill (a forward on copies of the slots' cache rows, merged
    back by a dropping scatter) and the two decode steps."""
    cfg = dataclasses.replace(TINY, use_flash_decode=flash)
    caches = jmodels.init_cache(cfg, 4, 64)
    slots = jnp.asarray(SPEC["slots"])
    lens = jnp.asarray(SPEC["true_lens"])
    rows = jnp.clip(slots, 0, 3)
    sub = [jmodels.KVCache(k_q=c.k_q[rows], k_s=c.k_s[rows],
                           v_q=c.v_q[rows], v_s=c.v_s[rows]) for c in caches]
    pos = jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32)[None], (4, 32))
    logits, sub = jmodels.forward(jp, jnp.asarray(SPEC["tokens"]), sub, pos,
                                  lens, cfg,
                                  prefill_start=jnp.zeros(4, jnp.int32))
    lp = logits[jnp.arange(4), lens - 1]
    w = jnp.where(slots >= 0, slots, 4)
    caches = [jmodels.KVCache(**{
        n: getattr(c, n).at[w].set(getattr(s, n), mode="drop")
        for n in ("k_q", "k_s", "v_q", "v_s")}) for c, s in zip(caches, sub)]
    lens = jnp.asarray(SPEC["lens"])
    l1, caches = jmodels.decode_step(jp, jnp.asarray(SPEC["step1"]), caches,
                                     lens, cfg)
    l2, _ = jmodels.decode_step(jp, jnp.asarray(SPEC["step2"]), caches,
                                lens + 1, cfg)
    return [np.asarray(x, np.float32) for x in (lp, l1, l2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_params):
    """Both worker groups, run together, then JAX's references (not
    beside the workers: JAX's CPU threads would starve them). → (mesh tag
    → rank → outputs, JAX_MESHES tag → JAX's jitted sharded steps,
    use_flash_decode → eager JAX's one-device path)."""
    tree = tree_of(jax_params)
    dirs = {w: tmp_path_factory.mktemp(f"sharded{w}") for w in MESHES}
    procs = {w: _start(w, tree, dirs[w]) for w in MESHES}
    outs = {w: _join(w, procs[w], dirs[w]) for w in MESHES}
    ref = {"x".join(map(str, m)): _jax_run(jax_params, m)
           for m in JAX_MESHES}
    eager = {flash: _jax_eager(jax_params, flash) for flash in (True, False)}
    port = {}
    for w, by_rank in outs.items():
        for m in MESHES[w]:
            tag = "x".join(map(str, m))
            port[tag] = {r: {k.split("/", 1)[1]: v for k, v in o.items()
                             if k.startswith(tag + "/")}
                         for r, o in by_rank.items()}
    return port, ref, eager


@pytest.fixture(scope="module")
def one_device(port_params):
    """The port's one-device path on the same inputs, with the flash
    kernels and without (the replicated-kv meshes' attention path): the
    engine's batched prefill, the two decode steps, the caches after the
    prefill, and the engines' tokens."""
    out = {}
    for flash in (True, False):
        cfg = dataclasses.replace(TINY, use_flash_decode=flash)
        caches = tmodels.init_cache(cfg, 4, 64, device="cpu")
        lp = tengine._prefill(port_params, caches, cfg, SPEC["tokens"],
                              SPEC["true_lens"], SPEC["true_lens"] - 1,
                              np.zeros(4, np.int32), SPEC["slots"])
        after_prefill = copy.deepcopy(caches)
        lens = torch.from_numpy(SPEC["lens"])
        l1, caches = tmodels.decode_step(
            port_params, torch.from_numpy(SPEC["step1"]), caches, lens, cfg)
        l2, _ = tmodels.decode_step(port_params,
                                    torch.from_numpy(SPEC["step2"]), caches,
                                    lens + 1, cfg)
        engines = {name: Engine(port_params, cfg, max_slots=4,
                                max_seq_len=64, device="cpu",
                                **kw).generate(SPEC["prompts"], SPEC["new"])
                   for name, kw in SPEC["engines"].items()}
        out[flash] = ([x.numpy() for x in (lp, l1, l2)], after_prefill,
                      engines)
    return out


def _flash(shape):
    tp = shape[2]
    return tp == 1 or (TINY.num_kv_heads % tp == 0
                       and (TINY.kv_dim // tp) % 128 == 0)


@pytest.mark.parametrize("shape", ALL, ids=IDS)
def test_sharded_steps_match_jax(runs, shape):
    """Prefill and decode logits of every rank against eager JAX's
    one-device path and, on JAX_MESHES, JAX's jitted shard_map steps;
    every rank holds the same gathered logits."""
    port, ref, eager = runs
    tag = "x".join(map(str, shape))
    outs = port[tag]
    for r in outs:
        for k in ("prefill", "decode1", "decode2"):
            np.testing.assert_array_equal(outs[r][k], outs[0][k])
    flash = _flash(shape)
    bounds = ((FLASH_PREFILL, FLASH_DECODE, FLASH_DECODE) if flash
              else (PLAIN_TOL,) * 3)
    for i, (k, bound) in enumerate(zip(("prefill", "decode1", "decode2"),
                                       bounds)):
        got, want = outs[0][k], eager[flash][i]
        assert got.shape == want.shape and np.isfinite(got).all()
        err = verify.relative_l2_error(got, want)
        assert err < bound, (k, err)
        if tag in ref:
            jit_gap = verify.relative_l2_error(ref[tag][i], want)
            err = verify.relative_l2_error(got, ref[tag][i])
            assert err < bound + jit_gap, (k, err, jit_gap)


@pytest.mark.parametrize("shape", ALL, ids=IDS)
def test_sharded_steps_match_one_device(runs, one_device, shape):
    outs = runs[0]["x".join(map(str, shape))][0]
    bound = SELF_TP1 if shape[2] == 1 else SELF_TP
    for k, want in zip(("prefill", "decode1", "decode2"),
                       one_device[_flash(shape)][0]):
        err = verify.relative_l2_error(outs[k], want)
        assert err < bound, (k, err)


def _assembled_cache(outs, shape, layer, name):
    """The whole cache array from the ranks' blocks: batch over data,
    kv heads over model where sharded."""
    kv_sharded = shape[2] > 1 and _flash(shape)
    blocks = {}
    for o in outs.values():
        d, e, t = (int(x) for x in o["coords"])
        if e == 0 and (t == 0 or kv_sharded):
            blocks[(d, t)] = o[f"cache{layer}_{name}"]
    tps = shape[2] if kv_sharded else 1
    return np.concatenate([np.concatenate([blocks[(d, t)]
                                           for t in range(tps)], axis=1)
                           for d in range(shape[0])], axis=0)


@pytest.mark.parametrize("shape", [m for m in ALL if m[2] == 1],
                         ids=[i for m, i in zip(ALL, IDS) if m[2] == 1])
def test_tp1_prefill_caches_bit_equal_to_one_device(runs, one_device, shape):
    outs = runs[0]["x".join(map(str, shape))]
    for li, c in enumerate(one_device[True][1]):
        for name in ("k_q", "k_s", "v_q", "v_s"):
            np.testing.assert_array_equal(
                _assembled_cache(outs, shape, li, name),
                getattr(c, name).numpy(), err_msg=f"layer {li} {name}")


@pytest.mark.parametrize("shape", ALL, ids=IDS)
def test_sharded_sampling(runs, shape):
    """Greedy sampling inside the step is the argmax of the gathered
    logits, exactly; a sampled step gives every rank the same tokens, the
    tokens the one-device sampler draws from those logits with the same
    generator."""
    outs = runs[0]["x".join(map(str, shape))]
    logits = outs[0]["decode2"]
    for o in outs.values():
        np.testing.assert_array_equal(o["greedy2"], logits.argmax(-1))
        np.testing.assert_array_equal(o["sampled2"], outs[0]["sampled2"])
    want = tengine.sample_logits(torch.from_numpy(logits),
                                 torch.Generator().manual_seed(7), **SAMPLE)
    np.testing.assert_array_equal(outs[0]["sampled2"], want.numpy())


@functools.lru_cache(maxsize=None)
def _jax_topp(tp):
    mesh = jmake_mesh(1, 1, tp, devices=jax.devices()[:tp])
    f = jax.jit(jsh.shard_map(
        lambda x: jsh._topp_threshold_sharded(x, SPEC["topp_p"], "model"),
        mesh, in_specs=(P(None, "model"),), out_specs=P()))
    return np.asarray(f(jnp.asarray(SPEC["topp_logits"])))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_topp_threshold_matches_jax(runs, tp):
    """The threshold search over tp vocab shards against JAX's on the same
    logits: the same kept set, the cutoff within the search's final
    bracket (34·16⁻⁶ ≈ 2e-6) plus f32 rounding."""
    x = SPEC["topp_logits"]
    want = _jax_topp(tp)
    if tp == 1:
        got = tsh._topp_threshold_sharded(torch.from_numpy(x),
                                          SPEC["topp_p"], None).numpy()
    else:
        got = runs[0]["1x1x%d" % tp][0]["topp"]
        for o in runs[0]["1x1x%d" % tp].values():
            np.testing.assert_array_equal(o["topp"], got)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(x > got[:, None], x > want[:, None])
    kept = (x > got[:, None]).sum(1)
    assert (kept >= 1).all() and (kept < x.shape[1]).all()


@pytest.mark.parametrize("engine", list(SPEC["engines"]))
@pytest.mark.parametrize("shape", ALL, ids=IDS)
def test_mesh_engine_serves_the_one_device_tokens(runs, one_device, shape,
                                                  engine):
    """Engine(mesh=...) on every rank serves the one-device engine's
    greedy tokens (decode_chunk 2 runs its chunks as eager steps over
    gloo); a replicated-kv mesh those of the one-device engine on the same
    attention path."""
    outs = runs[0]["x".join(map(str, shape))]
    want = np.asarray(one_device[_flash(shape)][2][engine])
    for o in outs.values():
        np.testing.assert_array_equal(o[f"engine_{engine}"], want)


def test_engine_mesh_rules(port_params, caplog, tmp_path):
    """As in JAX: speculative decoding refuses a mesh, the prefix cache is
    ignored with a warning, and the slots must split over "data"."""
    with torch_dist_worker.one_rank_mesh(tmp_path) as mesh:
        with pytest.raises(ValueError, match="single-device"):
            Engine(port_params, TINY, max_slots=2, max_seq_len=64,
                   device="cpu", mesh=mesh, speculative_k=2)
        eng = Engine(port_params, TINY, max_slots=2, max_seq_len=64,
                     device="cpu", mesh=mesh, prefix_cache_slots=4)
        assert eng._prefix_slots == 0
        got = eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert got == Engine(
        port_params, TINY, max_slots=2, max_seq_len=64,
        device="cpu").generate([[1, 2, 3]], max_new_tokens=2)


def test_shard_helpers_cut_contiguous_blocks(tmp_path):
    """shard() takes this rank's block along each named axis as a
    contiguous copy; replicated() the whole; the collectives are the
    identity on a mesh of one rank."""
    from deepgemm_ascend_tpu_torch.parallel import (all_gather, pmax,
                                                    psum, replicated, shard)

    class Mesh:
        mesh_dim_names = ("data", "expert", "model")
        shape = (2, 1, 4)

        def get_local_rank(self, axis):
            return {"data": 1, "expert": 0, "model": 3}[axis]

    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    got = shard(x, Mesh(), "data", "model")
    assert torch.equal(got, x[2:4, 6:8]) and got.is_contiguous()
    got.add_(1)
    assert x[2, 6, 0] == 2 * 24 + 6 * 3
    r = replicated(x, Mesh())
    assert torch.equal(r, x) and r.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        shard(x, Mesh(), None, None, "model")
    with torch_dist_worker.one_rank_mesh(tmp_path) as mesh:
        for group in (None, mesh.get_group("model")):
            assert psum(x, group) is x and pmax(x, group) is x
            assert all_gather(x, group, dim=1) is x


def test_moe_capacity_keeps_jax_out_of_range_semantics(jax_params,
                                                       port_params):
    """An explicit capacity below the busiest expert's load: JAX drops the
    scatter of the assignments past it and its gather reads the last row
    (clamped); the port keeps both, within the moe tolerance (rel-L2 1e-3)
    of JAX's block run op by op — and stays finite and off the
    default-capacity result."""
    from deepgemm_ascend_tpu.models import moe as jmoe
    from deepgemm_ascend_tpu_torch.models import moe as tmoe
    x = np.random.default_rng(5).normal(size=(40, TINY.hidden_size)) * 0.5
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    tm = port_params.layers[1].ffn
    _, idx = tmoe.route_topk(tm.router(xt), TINY.top_k)
    load = int(torch.bincount(idx.reshape(-1).long()).max())
    cap = load - 3
    want = np.asarray(jmoe.moe_block(jax_params.layers[1].ffn, xj, TINY,
                                     capacity=cap), np.float32)
    got = tmoe.moe_block(tm, xt, TINY, capacity=cap).to(torch.float32)
    full = tmoe.moe_block(tm, xt, TINY).to(torch.float32)
    assert verify.relative_l2_error(got.numpy(), want) < 1e-3
    assert torch.isfinite(got).all() and not torch.equal(got, full)


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_capacity_on_expert_shards_keeps_every_real_row(port_params, ep):
    """On ep shards, with an explicit capacity below expert 0's load (so a
    real row sits in expert 0's last slot), the off-shard assignments write
    no row of the buffer: the shards' routed outputs sum to the unsharded
    block's at that capacity (top_k = 2: each f32 sum has one nonzero
    term a shard, so the sums are exact)."""
    from deepgemm_ascend_tpu_torch.models import moe as tmoe
    tm = port_params.layers[1].ffn
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(40, TINY.hidden_size)) * 0.5).to(torch.bfloat16)
    _, idx = tmoe.route_topk(tm.router(x), TINY.top_k)
    cap = int((idx == 0).sum()) - 2
    assert cap > 0 and TINY.top_k == 2
    want = tmoe._moe_routed(tm, x, TINY, capacity=cap)
    e = TINY.num_experts // ep
    got = sum(tmoe._moe_routed(
        dataclasses.replace(tm, experts=dataclasses.replace(tm.experts, **{
            f.name: getattr(tm.experts, f.name)[r * e:(r + 1) * e]
            for f in dataclasses.fields(tm.experts)})),
        x, TINY, capacity=cap, local_experts=e, expert_offset=r * e)
        for r in range(ep))
    assert torch.equal(got, want)


@pytest.mark.parametrize("experts", ["fp8", "int8"])
def test_moe_gemm_config_reaches_the_grouped_gemms(jax_params, port_params,
                                                   experts):
    """``moe_block(gemm_config=)`` is the grouped GEMMs' ``config``: with
    ``KernelType.XLA`` the block runs the XLA family (no call of the
    kernel's plain version) and stays within the moe tolerance of JAX's
    block with the same config."""
    from deepgemm_ascend_tpu.config import GemmConfig as JConfig
    from deepgemm_ascend_tpu.config import KernelType as JKind
    from deepgemm_ascend_tpu.models import moe as jmoe
    from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType
    from deepgemm_ascend_tpu_torch.models import moe as tmoe
    from deepgemm_ascend_tpu_torch.ops import _kernels
    jm = jax_params.layers[1].ffn
    tm = port_params.layers[1].ffn
    if experts == "int8":
        jm = dataclasses.replace(jm, experts=jmoe.int8_experts_from_fp8(
            jm.experts))
        tm = dataclasses.replace(tm, experts=tmoe.int8_experts_from_fp8(
            tm.experts))
    x = np.random.default_rng(7).normal(size=(24, TINY.hidden_size)) * 0.5
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    want = np.asarray(jmoe.moe_block(
        jm, xj, TINY, gemm_config=JConfig(kernel_type=JKind.XLA)),
        np.float32)
    _kernels.reset_counters()
    got = tmoe.moe_block(tm, xt, TINY, gemm_config=GemmConfig(
        kernel_type=KernelType.XLA)).to(torch.float32)
    kernel = "int8_grouped_masked" if experts == "int8" else "grouped_gemm"
    assert _kernels.COUNTERS[kernel].plain_calls == 0
    assert verify.relative_l2_error(got.numpy(), want) < 1e-3


def test_shard_params_cuts_every_expert_tensor(port_params):
    """shard_params gives a rank contiguous copies of its block: int8
    experts (weights and per-channel scales) on the expert dim, wq's rows
    and wo's columns with their 128-block scales, lm_head's vocab columns;
    the rest whole."""
    class Mesh:        # rank (0, 1, 1) of a (1, 2, 2) mesh
        mesh_dim_names = ("data", "expert", "model")
        shape = (1, 2, 2)

        def get_local_rank(self, axis):
            return {"data": 0, "expert": 1, "model": 1}[axis]

    params = tmodels.params_with_int8_experts(port_params)
    local = tsh.shard_params(Mesh(), params, TINY)
    ex, lex = params.layers[1].ffn.experts, local.layers[1].ffn.experts
    e = TINY.num_experts // 2
    for f in dataclasses.fields(ex):
        got = getattr(lex, f.name)
        assert got.is_contiguous() and torch.equal(got,
                                                   getattr(ex, f.name)[e:])
    a, la = params.layers[0].attn, local.layers[0].attn
    q = TINY.q_dim // 2
    assert torch.equal(la.wq.w_q.view(torch.uint8),
                       a.wq.w_q[q:].view(torch.uint8))
    assert torch.equal(la.wq.scales, a.wq.scales[q // 128:])
    assert la.wo.w_q.is_contiguous() and torch.equal(
        la.wo.w_q.view(torch.uint8), a.wo.w_q[:, q:].view(torch.uint8))
    assert torch.equal(la.wo.scales, a.wo.scales[:, q // 128:])
    # TINY's kv heads shard congruently at tp = 2.
    kv = TINY.kv_dim // 2
    assert torch.equal(la.wk.w_q.view(torch.uint8),
                       a.wk.w_q[kv:].view(torch.uint8))
    v = TINY.vocab_size // 2
    assert torch.equal(local.lm_head, params.lm_head[:, v:])
    assert torch.equal(local.embed, params.embed)
    assert local.embed.data_ptr() != params.embed.data_ptr()


def test_steps_are_memoized_per_mesh_object(tmp_path):
    """A step is memoized under its mesh object, never under another one
    that merely compares equal (a DeviceMesh's equality ignores its
    process groups, which a process may have joined again)."""
    with torch_dist_worker.one_rank_mesh(tmp_path) as a:
        b = tmake_mesh(1, 1, 1, device_type="cpu")
        assert a == b
        tsh.clear_program_memo()
        step = tsh.make_sharded_decode_step(a, TINY, None)
        assert tsh.make_sharded_decode_step(a, TINY, None) is step
        assert tsh.make_sharded_decode_step(b, TINY, None) is not step
        pre = tsh.make_sharded_prefill_step(a, TINY, None, 32, 4)
        assert tsh.make_sharded_prefill_step(a, TINY, None, 32, 4) is pre
        assert tsh.make_sharded_prefill_step(a, TINY, None, 16, 4) \
            is not pre
        tsh.clear_program_memo()
        assert tsh.make_sharded_decode_step(a, TINY, None) is not step
