"""The port's ``parallel/`` (mesh, ring shift, decomposed GEMMs, ring
attention) vs the JAX package's, on the CPU.

The JAX side runs under ``shard_map`` on the 8 virtual CPU devices
(``conftest.py``), its flash hops in Pallas interpret mode. The port runs
in real process groups: for each ring size (2 and 4) one group of
``spawn``-started workers (``torch_dist_worker.py``, no JAX) joins gloo
through a ``file://`` store once per module and runs every case of that
size; each rank's output shard is compared with the matching rows of JAX's
output. A worker that does not finish within its join timeout is
terminated and fails the test.

Tolerances: ring attention over bf16 inputs computes in f32 in both
packages, in the same hop order: 2e-5 (the order of f32 sums inside each
einsum). The int8-cache flash ring: 1e-3, as the flash parity tests (the
bf16 rounding of p·v_s against each package's running max). The
decomposed GEMMs sum exact products of bf16 inputs in f32: 1e-4 absolute
on outputs of magnitude ~10.
"""

import functools
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from deepgemm_ascend_tpu.parallel import make_mesh as jmake_mesh
from deepgemm_ascend_tpu.parallel import overlap as jov
from deepgemm_ascend_tpu.parallel import ring_attention as jra
from deepgemm_ascend_tpu.parallel.sharded import shard_map
from deepgemm_ascend_tpu_torch import parallel as tpar
from deepgemm_ascend_tpu_torch.parallel import ring_attention as tra

P = jax.sharding.PartitionSpec
JOIN_TIMEOUT_S = 120
RING_TOL = 2e-5
FLASH_TOL = 1e-3
GEMM_TOL = 1e-4


def _bf16(rng, shape, scale=0.5):
    """Values exact in bf16, as f32."""
    x = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return np.asarray(x, np.float32)


def _int8_cache(rng, b, kvh, s, d):
    k_q = rng.integers(-127, 128, size=(b, kvh, s, d), dtype=np.int8)
    v_q = rng.integers(-127, 128, size=(b, kvh, s, d), dtype=np.int8)
    k_s = (rng.random((b, kvh, s)) * 0.02 + 1e-3).astype(np.float32)
    v_s = (rng.random((b, kvh, s)) * 0.02 + 1e-3).astype(np.float32)
    return k_q, k_s, v_q, v_s


@functools.lru_cache(maxsize=None)
def _cases(cp):
    """Every case of ring size ``cp``: name → worker case. Inputs from a
    numpy seed; the JAX references read the same arrays."""
    rng = np.random.default_rng(100 + cp)
    cases = {}
    seq = lambda x: (x, 1, "bf16")
    for causal in (True, False):
        q, k, v = (_bf16(rng, (2, 16 * cp, 2, 32)) for _ in range(3))
        cases[f"ring_causal={causal}"] = dict(
            op="ring_attention_prefill",
            arrays={"q": seq(q), "k": seq(k), "v": seq(v)},
            kwargs=dict(cp=cp, causal=causal, out_dtype=torch.float32))
    s = 8 * 2 * cp
    q, k, v = (_bf16(rng, (2, s, 2, 32)) for _ in range(3))
    order = jra.zigzag_order(cp, s)
    cases["zigzag"] = dict(
        op="ring_attention_prefill",
        arrays={"q": seq(q[:, order]), "k": seq(k[:, order]),
                "v": seq(v[:, order])},
        kwargs=dict(cp=cp, schedule="zigzag", out_dtype=torch.float32),
        full=(q, k, v))
    q = _bf16(rng, (1, 8 * cp, 4, 16))
    k, v = (_bf16(rng, (1, 8 * cp, 2, 16)) for _ in range(2))
    cases["gqa"] = dict(
        op="ring_attention_prefill",
        arrays={"q": seq(q), "k": seq(k), "v": seq(v)},
        kwargs=dict(cp=cp, out_dtype=torch.float32))
    q = _bf16(rng, (2, 32 * cp, 4, 64))
    k_q, k_s, v_q, v_s = _int8_cache(rng, 2, 2, 32 * cp, 64)
    cases["flash"] = dict(
        op="ring_flash_prefill",
        arrays={"q": seq(q), "k_q": (k_q, 2, "i8"), "k_s": (k_s, 2, "f32"),
                "v_q": (v_q, 2, "i8"), "v_s": (v_s, 2, "f32")},
        kwargs=dict(cp=cp, out_dtype=torch.float32))
    x, w = _bf16(rng, (32, 64 * cp), 1.0), _bf16(rng, (64 * cp, 48), 1.0)
    cases["reduce_scatter"] = dict(
        op="gemm_reduce_scatter",
        arrays={"x_local": (x, 1, "bf16"), "w_local": (w, 0, "bf16")},
        kwargs=dict(tp=cp))
    x, w = _bf16(rng, (16, 32 * cp), 1.0), _bf16(rng, (32 * cp, 64), 1.0)
    cases["all_gather"] = dict(
        op="all_gather_gemm",
        arrays={"x_local": (x, 1, "bf16"), "w_rows": (w, 1, "bf16")},
        kwargs=dict(tp=cp))
    cases["ring_shift"] = dict(op="ring_shift")
    return cases


def _spawn(cp, out_dir):
    """One gloo group of ``cp`` workers running every case of that size;
    returns rank → {name: output}."""
    ctx = mp.get_context("spawn")
    cases = {n: {k: v for k, v in c.items() if k != "full"}
             for n, c in _cases(cp).items()}
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, cp, str(out_dir / "store"), cases,
                               str(out_dir)))
             for r in range(cp)]
    for p in procs:
        p.start()
    hung = []
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT_S)
        if p.is_alive():
            hung.append(p.pid)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    if hung:
        pytest.fail(f"cp={cp}: workers {hung} did not finish within "
                    f"{JOIN_TIMEOUT_S} s and were terminated")
    codes = [p.exitcode for p in procs]
    assert codes == [0] * cp, f"cp={cp}: worker exit codes {codes}"
    return {r: dict(np.load(out_dir / f"{r}.npz")) for r in range(cp)}


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """cp → the workers' outputs, each group started once per module."""
    runs = {}

    def get(cp):
        if cp not in runs:
            runs[cp] = _spawn(cp, tmp_path_factory.mktemp(f"ring{cp}"))
        return runs[cp]
    return get


def _gathered(outs, name, axis):
    return np.concatenate([outs[r][name] for r in sorted(outs)], axis=axis)


def _jax_ring(cp, fn, in_specs, out_spec):
    """JAX's function under shard_map over a tp=cp mesh, jitted."""
    return jax.jit(shard_map(fn, jmake_mesh(tp=cp), in_specs=in_specs,
                             out_specs=out_spec))


def _jax_arrays(case):
    out = []
    for arr, _, dt in case["arrays"].values():
        out.append(jnp.asarray(arr, {"bf16": jnp.bfloat16, "f32": jnp.float32,
                                     "i8": jnp.int8}[dt]))
    return out


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(ring_run, cp, causal):
    case = _cases(cp)[f"ring_causal={causal}"]
    f = _jax_ring(cp, lambda ql, kl, vl: jra.ring_attention_prefill(
        ql, kl, vl, axis_name="model", cp=cp, causal=causal,
        out_dtype=jnp.float32), (P(None, "model"),) * 3, P(None, "model"))
    want = np.asarray(f(*_jax_arrays(case)))
    got = _gathered(ring_run(cp), f"ring_causal={causal}", 1)
    np.testing.assert_allclose(got, want, atol=RING_TOL, rtol=0)


@pytest.mark.parametrize("cp", [2, 4])
def test_zigzag_ring_matches_jax(ring_run, cp):
    """The zigzag schedule, un-permuted, in both packages; and the port's
    permutation equals JAX's."""
    case = _cases(cp)["zigzag"]
    s = case["full"][0].shape[1]
    assert np.array_equal(tra.zigzag_order(cp, s), jra.zigzag_order(cp, s))
    assert np.array_equal(tra.zigzag_inverse(cp, s),
                          jra.zigzag_inverse(cp, s))
    f = _jax_ring(cp, lambda ql, kl, vl: jra.ring_attention_prefill(
        ql, kl, vl, axis_name="model", cp=cp, schedule="zigzag",
        out_dtype=jnp.float32), (P(None, "model"),) * 3, P(None, "model"))
    want = np.asarray(f(*_jax_arrays(case)))
    got = _gathered(ring_run(cp), "zigzag", 1)
    np.testing.assert_allclose(got, want, atol=RING_TOL, rtol=0)
    inv = jra.zigzag_inverse(cp, s)
    full = tra.ring_attention_prefill(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in case["full"]),
        cp=1, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got[:, inv], full, atol=RING_TOL, rtol=0)


@pytest.mark.parametrize("cp", [2, 4])
def test_ring_attention_gqa_matches_jax(ring_run, cp):
    case = _cases(cp)["gqa"]
    f = _jax_ring(cp, lambda ql, kl, vl: jra.ring_attention_prefill(
        ql, kl, vl, axis_name="model", cp=cp, out_dtype=jnp.float32),
        (P(None, "model"),) * 3, P(None, "model"))
    want = np.asarray(f(*_jax_arrays(case)))
    got = _gathered(ring_run(cp), "gqa", 1)
    np.testing.assert_allclose(got, want, atol=RING_TOL, rtol=0)


@pytest.mark.parametrize("cp", [2, 4])
def test_ring_flash_prefill_matches_jax(ring_run, cp):
    """K4-stats hops (the plain version on the CPU) merged across a real
    ring, against JAX's Pallas hops under shard_map."""
    case = _cases(cp)["flash"]
    cache_spec = P(None, None, "model")
    f = _jax_ring(cp, lambda ql, kq, ks, vq, vs: jra.ring_flash_prefill(
        ql, kq, ks, vq, vs, axis_name="model", cp=cp, block_q=16,
        block_s=128, out_dtype=jnp.float32),
        (P(None, "model"),) + (cache_spec,) * 4, P(None, "model"))
    want = np.asarray(f(*_jax_arrays(case)))
    got = _gathered(ring_run(cp), "flash", 1)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL, rtol=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_gemm_reduce_scatter_matches_jax(ring_run, tp):
    case = _cases(tp)["reduce_scatter"]
    f = _jax_ring(tp, lambda xl, wl: jov.gemm_reduce_scatter(
        xl, wl, axis_name="model", tp=tp),
        (P(None, "model"), P("model", None)), P("model", None))
    want = np.asarray(f(*_jax_arrays(case)))
    got = _gathered(ring_run(tp), "reduce_scatter", 0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=GEMM_TOL, rtol=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_all_gather_gemm_matches_jax(ring_run, tp):
    case = _cases(tp)["all_gather"]
    f = _jax_ring(tp, lambda xl, wl: jov.all_gather_gemm(
        xl, wl, axis_name="model", tp=tp),
        (P(None, "model"), P(None, "model")), P(None, "model"))
    want = np.asarray(f(*_jax_arrays(case)))
    got = _gathered(ring_run(tp), "all_gather", 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=GEMM_TOL, rtol=0)


@pytest.mark.parametrize("cp", [2, 4])
def test_ring_shift_and_mesh_group(ring_run, cp):
    """One hop forward brings the previous rank's tensor, one hop in
    reverse the next rank's; make_mesh(tp=cp) puts every rank on the
    model axis."""
    outs = ring_run(cp)
    for r, out in outs.items():
        assert out["mesh_shape"].tolist() == [1, 1, cp]
        assert int(out["group_size"]) == cp
        fwd, bwd = out["ring_shift"]
        assert (fwd == (r - 1) % cp).all() and (bwd == (r + 1) % cp).all()


# ---- one rank: no group needed, as in the JAX package


def test_single_rank_paths_match_jax():
    """cp == 1 / tp == 1 need no process group."""
    rng = np.random.default_rng(9)
    q, k, v = (_bf16(rng, (1, 32, 2, 16)) for _ in range(3))
    want = np.asarray(jra.ring_attention_prefill(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        axis_name="model", cp=1, out_dtype=jnp.float32))
    got = tpar.ring_attention_prefill(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        cp=1, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=RING_TOL, rtol=0)
    qf = _bf16(rng, (1, 32, 4, 64))
    cache = _int8_cache(rng, 1, 2, 32, 64)
    want = np.asarray(jra.ring_flash_prefill(
        jnp.asarray(qf, jnp.bfloat16), *map(jnp.asarray, cache),
        axis_name="model", cp=1, out_dtype=jnp.float32))
    got = tpar.ring_flash_prefill(
        torch.from_numpy(qf).to(torch.bfloat16),
        *(torch.from_numpy(x) for x in cache), cp=1,
        out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=FLASH_TOL, rtol=0)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((8, 16), (16, 24)))
    for jf, tf in ((jov.gemm_reduce_scatter, tpar.gemm_reduce_scatter),
                   (jov.all_gather_gemm, tpar.all_gather_gemm)):
        want = np.asarray(jf(jnp.asarray(x), jnp.asarray(w),
                             axis_name="model", tp=1))
        got = tf(torch.from_numpy(x), torch.from_numpy(w), tp=1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("axes", [{}, {"tp": 2}, {"tp": 4, "ep": 2},
                                  {"dp": 2, "ep": 2, "tp": 2}, {"dp": 2},
                                  {"ep": 4}, {"dp": 8}, {"dp": 2, "tp": 1}])
def test_mesh_axis_defaulting_matches_jax(axes):
    want = tuple(jmake_mesh(**axes).shape.values())
    assert tpar.mesh_shape(len(jax.devices()), **axes) == want


@pytest.mark.parametrize("axes", [{"dp": 3}, {"tp": 4, "ep": 4},
                                  {"dp": 2, "ep": 2, "tp": 1}])
def test_mesh_axis_errors_match_jax(axes):
    with pytest.raises(ValueError) as je:
        jmake_mesh(**axes)
    with pytest.raises(ValueError) as te:
        tpar.mesh_shape(len(jax.devices()), **axes)
    assert str(je.value) == str(te.value)


def test_init_distributed_is_gated_on_the_launcher_env(monkeypatch):
    """Without torchrun's environment no group is joined (as JAX's
    init_distributed without JAX_COORDINATOR_ADDRESS); make_mesh builds its
    mesh on the card unless told otherwise."""
    import inspect
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert inspect.signature(tpar.make_mesh).parameters[
        "device_type"].default == "cuda"


@pytest.mark.parametrize("bad", ["kv_shapes", "heads", "schedule", "ragged_m",
                                 "w_rows", "zigzag_chunks"])
def test_bad_arguments_raise_like_jax(bad):
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        if bad == "kv_shapes":
            tpar.ring_attention_prefill(z(1, 8, 2, 16), z(1, 8, 2, 8),
                                        z(1, 8, 2, 16), cp=1)
        elif bad == "heads":
            tpar.ring_attention_prefill(z(1, 8, 3, 16), z(1, 8, 2, 16),
                                        z(1, 8, 2, 16), cp=1)
        elif bad == "schedule":
            tpar.ring_attention_prefill(z(1, 8, 2, 16), z(1, 8, 2, 16),
                                        z(1, 8, 2, 16), cp=1,
                                        schedule="ring")
        elif bad == "ragged_m":
            tpar.gemm_reduce_scatter(z(10, 16), z(16, 8), tp=4)
        elif bad == "w_rows":
            tpar.all_gather_gemm(z(8, 16), z(16, 8), tp=4)
        else:
            tpar.zigzag_order(4, 36)
