"""Benchmark shape suites.

Port of ``deepgemm_ascend_tpu/bench/shapes.py``, copied verbatim.

``REFERENCE_SUITE`` mirrors the reference's 18-shape list verbatim
(``framework/benchmark/benchmark.py:24-44`` — DeepSeek-like N/K pairs plus
adversarial primes). ``BASELINE_*`` realize the north-star configs from
BASELINE.json (dense sweep, grouped, decode).
"""

from __future__ import annotations

# (M, N, K) — `benchmark.py:24-44`
REFERENCE_SUITE = [
    (4096, 4096, 4096),
    (8, 7168, 18432),
    (8, 18432, 7168),
    (64, 4096, 7168),
    (64, 7168, 18432),
    (64, 18432, 7168),
    (64, 24576, 1536),
    (64, 32768, 512),
    (64, 7168, 16384),
    (128, 4096, 7168),
    (128, 7168, 18432),
    (128, 18432, 7168),
    (1024, 4096, 7168),
    (1024, 18432, 7168),
    (2048, 4096, 7168),
    (1279, 5003, 7681),
    (3511, 6151, 8191),
    (5119, 6997, 9901),
]

# BASELINE.json config 1: the headline chip metric.
HEADLINE = (4096, 4096, 4096)

# BASELINE.json config 2: dynamic-M sweep over DeepSeek N/K pairs.
DEEPSEEK_NK = [(7168, 18432), (18432, 7168), (4096, 7168), (7168, 16384)]
DYNAMIC_M = [64, 128, 256, 512, 1024, 2048, 4096, 8192]
DYNAMIC_SWEEP = [(m, n, k) for m in DYNAMIC_M for (n, k) in DEEPSEEK_NK]

# BASELINE configs 3-4: grouped shapes (E, M_per_expert-ish, N, K) —
# DeepSeek-V2-Lite MoE geometry: hidden 2048, moe_inter 1408, 64 experts.
GROUPED_PREFILL = [(8, 512, 1408, 2048), (8, 512, 2048, 1408)]
GROUPED_DECODE = [(8, 128, 1408, 2048), (8, 128, 2048, 1408)]
