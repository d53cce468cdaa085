"""Golden test-data generation.

Port of ``deepgemm_ascend_tpu/utils/golden.py`` (numpy only, copied so the
port never imports the JAX package; the same seed gives the same bytes).

Mirrors the reference's two generators:
* heavy-tail lognormal inputs for device tests, chosen to expose fp
  accumulation error (``framework/tests/test.py:23-38``);
* uniform [1, 10) inputs + fp32 numpy matmul for scripts
  (``deep_gemm_ascend/scripts/gen_golden.py:10-23``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gen_heavy_tail(shape, dtype=np.float32, seed: int = 0,
                   mean: float = 0.0, sigma: float = 1.0) -> np.ndarray:
    """Lognormal heavy-tail data with random signs (`test.py:23-31`)."""
    rng = np.random.default_rng(seed)
    mag = rng.lognormal(mean=mean, sigma=sigma, size=shape)
    sign = rng.choice([-1.0, 1.0], size=shape)
    return (mag * sign).astype(dtype)


def gen_uniform(shape, dtype=np.float32, seed: int = 0,
                low: float = 1.0, high: float = 10.0) -> np.ndarray:
    """Uniform [low, high) data (`gen_golden.py:14-16`)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, size=shape).astype(dtype)


def gen_golden_gemm(
    m: int, n: int, k: int,
    in_dtype=np.float32,
    seed: int = 0,
    heavy_tail: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, B, golden) with the golden computed in fp64 from the *rounded*
    inputs — ≙ ``gen_golden_data`` (`gen_golden.py:10-23`, `test.py:23-38`)
    which matmuls the cast inputs in fp32 numpy."""
    gen = gen_heavy_tail if heavy_tail else gen_uniform
    a = gen((m, k), dtype=in_dtype, seed=seed)
    b = gen((k, n), dtype=in_dtype, seed=seed + 1)
    golden = a.astype(np.float64) @ b.astype(np.float64)
    return a, b, golden.astype(np.float32)
