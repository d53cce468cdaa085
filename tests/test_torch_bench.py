"""The port's measurement layer (``bench/``, ``utils/golden``, P0) against
the JAX package's, on the CPU.

Tolerances: the golden data must be byte-equal (the same numpy calls on
the same seeds); the shape suites equal; the roofline's operation and byte
counts equal (integers). The records screen's floors are held to 1e-12
relative against JAX's given one envelope with the H100's rates: the same
arithmetic in f64 on the same numbers. fp8 differs by design — the port
prices it at the fp8 rate, JAX at the bf16 rate — and is asserted so: the
port equals JAX given an envelope whose bf16 rate is the H100's fp8 rate.
P0's plain version is a copy and must equal the JAX Pallas copy kernel (in
interpret mode) bit for bit.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deepgemm_ascend_tpu.bench import records as jrecords
from deepgemm_ascend_tpu.bench import roofline as jroofline
from deepgemm_ascend_tpu.bench import shapes as jshapes
from deepgemm_ascend_tpu.tiling import platform as jplat
from deepgemm_ascend_tpu.utils import golden as jgolden
from deepgemm_ascend_tpu_torch.bench import records, roofline, shapes, timing
from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.ops import dispatch_probe as dp
from deepgemm_ascend_tpu_torch.tiling import platform as plat
from deepgemm_ascend_tpu_torch.utils import golden

# The H100's data-sheet rates as a JAX envelope (GB/s, TFLOP/s).
H100 = jplat.PlatformInfo("h100", 132, hbm_gbps=3350.0,
                          peak_bf16_tflops=989.0, peak_int8_tops=1979.0)
# ... and with fp8 priced as the port prices it (JAX prices fp8 at bf16).
H100_FP8_RATE = dataclasses.replace(H100, peak_bf16_tflops=1979.0)
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn,
                "float16": torch.float16}


@pytest.mark.parametrize("shape,seed", [((16, 32), 0), ((7, 13, 5), 3),
                                        ((256,), 11)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
def test_golden_generators_byte_equal(shape, seed, dtype):
    for name in ("gen_heavy_tail", "gen_uniform"):
        want = getattr(jgolden, name)(shape, dtype=dtype, seed=seed)
        got = getattr(golden, name)(shape, dtype=dtype, seed=seed)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("heavy_tail", [True, False])
@pytest.mark.parametrize("mnk,seed", [((8, 24, 16), 0), ((33, 5, 70), 7)])
def test_golden_gemm_byte_equal(mnk, seed, heavy_tail):
    want = jgolden.gen_golden_gemm(*mnk, seed=seed, heavy_tail=heavy_tail)
    got = golden.gen_golden_gemm(*mnk, seed=seed, heavy_tail=heavy_tail)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


def test_shape_suites_equal():
    names = [n for n in dir(jshapes) if n.isupper()]
    assert names == [n for n in dir(shapes) if n.isupper()]
    for n in names:
        assert getattr(shapes, n) == getattr(jshapes, n), n


@pytest.mark.parametrize("in_name,out_name", [
    ("bfloat16", "float32"), ("float32", "float32"), ("int8", "bfloat16"),
    ("float8_e4m3fn", "bfloat16"), ("float16", "float16")])
@pytest.mark.parametrize("mnk", [(4096, 4096, 4096), (1279, 5003, 7681),
                                 (8, 7168, 18432)])
def test_gemm_roofline_counts_equal_jax(mnk, in_name, out_name):
    want = jroofline.gemm_roofline(*mnk, jnp.dtype(in_name),
                                   jnp.dtype(out_name), H100)
    got = roofline.gemm_roofline(*mnk, TORCH_DTYPES[in_name],
                                 TORCH_DTYPES[out_name])
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert got.peak_bytes_per_s == want.peak_bytes_per_s == 3.35e12
    if in_name == "float8_e4m3fn":   # by design: the fp8 rate, not bf16's
        assert (got.peak_flops, want.peak_flops) == (1979e12, 989e12)
    elif in_name != "float32":       # f32: the CUDA cores vs a third of MXU
        assert got.peak_flops == want.peak_flops


def test_peak_ops_rates():
    assert plat.peak_ops(torch.float8_e4m3fn) == 1979e12
    assert plat.peak_ops(torch.float8_e5m2) == 1979e12
    assert plat.peak_ops(torch.int8) == 1979e12
    assert plat.peak_ops(torch.bfloat16) == plat.peak_ops(torch.float16) \
        == 989e12
    assert plat.peak_ops(torch.float32) == 67e12
    with pytest.raises(ValueError, match="no H100 peak"):
        plat.peak_ops(torch.int32)


def test_bound_ms():
    ms, by = roofline.bound_ms(3.35e9, 1.0, 989e12)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = roofline.bound_ms(1.0, 989e9, 989e12)
    assert by == "operations" and abs(ms - 1.0) < 1e-12


def test_op_dtypes_match_jax():
    assert set(records.OP_DTYPES) == set(jrecords.OP_DTYPES)
    for op, (i, o) in jrecords.OP_DTYPES.items():
        assert records.OP_DTYPES[op] == (TORCH_DTYPES[i], TORCH_DTYPES[o])


_OPS = sorted(jrecords.OP_DTYPES)


def _close(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("op", _OPS)
@pytest.mark.parametrize("mnk,scale", [((4096, 4096, 4096), 1.0),
                                       ((64, 18432, 7168), 1.0),
                                       ((128, 2048, 1408), 8.0),
                                       ((512, 1408, 2048), 24.0)])
def test_light_speed_floor_equals_jax(op, mnk, scale):
    i, o = jrecords.OP_DTYPES[op]
    got = records.light_speed_floor_s(op, *mnk, *records.OP_DTYPES[op],
                                      scale)
    fp8 = "float8" in i
    want = jrecords.light_speed_floor_s(op, *mnk, i, o, scale,
                                        H100_FP8_RATE if fp8 else H100)
    assert _close(got, want)
    if fp8 and mnk == (4096, 4096, 4096):    # compute-bound: fp8's rate
        jax_h100 = jrecords.light_speed_floor_s(op, *mnk, i, o, scale, H100)
        assert _close(got * 1979 / 989, jax_h100)


@pytest.mark.parametrize("op", ["gemm", "int8_gemm", "grouped_gemm_masked",
                                "int8_grouped_gemm", "fp8_gemm", "nosuch"])
@pytest.mark.parametrize("factor", [0.5, 0.97, 1.0, 1.2, 3.0])
def test_plausible_equals_jax(op, factor):
    m, n, k, e = 128, 2048, 1408, 8
    grouped = "grouped" in op
    known = op in records.OP_DTYPES
    dts = records.OP_DTYPES.get(op, (torch.bfloat16, torch.float32))
    floor = records.light_speed_floor_s(op, m, n, k, *dts,
                                        e if grouped else 1.0)
    t = floor * factor
    r = {"op": op, "m": m, "n": n, "k": k, "time_s": t,
         "tflops": 2.0 * m * n * k * (e if grouped else 1) / t / 1e12}
    info = H100_FP8_RATE if known and dts[0] == torch.float8_e4m3fn else H100
    assert records.flops_scale(r) == jrecords.flops_scale(r)
    assert records.plausible(r) == jrecords.plausible(r, info)
    if known:
        assert _close(records.roofline_fraction(r),
                      jrecords.roofline_fraction(r, info))
        assert records.plausible(r) == (factor >= 1 / records.DEFAULT_TOL)
    assert not records.plausible(dict(r, time_s=0.0))


def test_is_xla_equals_jax():
    for kt in (0, 1, 2, 3):
        cfg = {"kernel_type": kt}
        assert records.is_xla(cfg) == jrecords.is_xla(cfg)
    assert records.is_xla({}) == jrecords.is_xla({}) is False


def test_time_fn_grows_iters_to_min_chain():
    sleep = lambda: time.sleep(0.001)
    t = timing.time_fn(sleep, (), iters=2, repeats=2,
                       min_chain_seconds=0.02)
    assert t.iters >= 10
    assert t.total_seconds >= 0.01 and t.seconds >= 0.001
    assert t.rpc_floor_seconds == 0.0
    assert abs(t.seconds * t.iters - t.total_seconds) < 1e-9
    fixed = timing.time_fn(sleep, (), iters=3, repeats=1)
    assert fixed.iters == 3 and fixed.seconds > 0
    assert timing.time_fn(sleep, (), iters=4, repeats=1,
                          min_chain_seconds=0.02, max_iters=6).iters == 6


def test_time_gemm_like_on_cpu_tensors():
    a, b = torch.randn(32, 64), torch.randn(64, 16)
    t = timing.time_gemm_like(torch.matmul, a, b, iters=4, repeats=2)
    assert t.iters == 4 and t.seconds > 0
    assert t.tflops(2 * 32 * 64 * 16) > 0 and t.gbps(1e6) > 0


def _jax_copy(x):
    """The JAX probe's P0, as straggler_probe.py:75-84 builds it."""
    def _copy_kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:]
    return pl.pallas_call(_copy_kernel,
                          out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=True)(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_copy_probe_plain_equals_jax_pallas(seed):
    x = np.random.default_rng(seed).standard_normal(dp.PROBE_SHAPE).astype(
        np.float32)
    x[0, :4] = [np.inf, -0.0, np.nan, 1e-45]
    want = np.asarray(_jax_copy(jnp.asarray(x)))
    _kernels.reset_counters()
    got = dp.copy_probe(torch.from_numpy(x))
    assert got.numpy().tobytes() == want.tobytes() == x.tobytes()
    assert dp.COUNTER.plain_calls == 1 and dp.COUNTER.launches == 0


@pytest.mark.parametrize("bad", [torch.zeros(8, 129), torch.zeros(1024),
                                 torch.zeros(8, 128, dtype=torch.float64),
                                 torch.zeros(128, 8).t()])
def test_copy_probe_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError, match="copy_probe takes"):
        dp.copy_probe(bad)


def test_copy_probe_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        dp.copy_probe(torch.zeros(8, 128, device="meta"))
