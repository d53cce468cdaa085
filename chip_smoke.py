#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepgemm_ascend_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each of which raises on failure (exit code ≠ 0):

1. device: the card's name, count and power limit; build every CUDA kernel
   from ``deepgemm_ascend_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and report the build time;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes serving V2_LITE gives it (and V2_LITE_FULL's MoE-layer
   shapes for K2/K3/K6), with its time (CUDA events, warm-up, L2 flushed
   before every launch), the plain version's time, the bound
   max(bytes / 3.35 TB/s, operations / peak) of the H100 SXM data sheet
   and, where one PyTorch call computes the same function, that call's
   time (``torch._int_mm`` for K7's integer product; ``torch._scaled_mm``
   with blockwise scales for K1, where this torch accepts them). The int8
   kernels (K7, K9, K6) must equal their plain versions bit for bit;
3. model: V2_LITE at full width cut to 2 layers (1 dense + 1 MoE), with
   fp8 experts and again with int8 experts (``params_with_int8_experts``)
   — the kernel path on the card against the plain path on the CPU (the
   kernel wrappers take their plain versions only for CPU tensors), same
   parameters, a 256-token prompt and 8 teacher-forced decode steps;
4. serving, twice: V2_LITE at full width and depth, ``Engine(max_slots=16)``
   at ``max_seq_len=4096``, 24 greedy requests with 16..1024-token prompts
   and 32 new tokens each — first with fp8 experts, then with int8 experts.
   The kernel counters are zeroed just before each run and read just after:
   each run must have launched exactly its own kernel set (fp8: K1, K2,
   K3, K4; int8: K1, K2, K4, K6), and no plain version may have run.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches in phase 4 (both runs) and its phase-2 numbers; the last
line is ``{"ok": true, "device": {...}}``. ``--report PATH`` also writes the
full report there as JSON.
"""

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from deepgemm_ascend_tpu_torch.models import (V2_LITE, V2_LITE_FULL,
                                              decode_step, forward,
                                              init_cache, init_params,
                                              params_with_int8_experts)
from deepgemm_ascend_tpu_torch.models.layers import BF16Linear
from deepgemm_ascend_tpu_torch.models.moe import dispatch_masked, route_topk
from deepgemm_ascend_tpu_torch.ops import _kernels, quant
from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
from deepgemm_ascend_tpu_torch.ops import flash_prefill as fpmod
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as fp8mod
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as ggmod
from deepgemm_ascend_tpu_torch.ops import int8_gemm as i8mod
from deepgemm_ascend_tpu_torch.serving import Engine
from deepgemm_ascend_tpu_torch.utils.verify import relative_l2_error

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP8_OPS_PER_S = 1979e12            # dense fp8 tensor-core peak
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
ATTN_TOL = 2e-3                    # kernel vs plain, attention outputs
# Kernel path vs plain path, logits rel-L2. The random model is chaotic:
# one bf16 ulp moved in 1e-3..1e-2 of the GEMM outputs moves its logits by
# 0.05..0.1 (phase 3 measures this floor in every run), and the tensor
# cores' f32 accumulation rounds differently from the CPU's; a wrong mask,
# scale or layout moves them by O(1).
MODEL_REL_L2_TOL = 0.25
FLOOR_FLIP_RATE = 1e-2
DEV = torch.device("cuda")

KERNELS = {
    "fp8_gemm": ("deepgemm_ascend_tpu_torch/csrc/fp8_gemm.cu",
                 "deepgemm_ascend_tpu/ops/fp8_gemm.py:152"),
    "grouped_gemm": ("deepgemm_ascend_tpu_torch/csrc/grouped_gemm.cu",
                     "deepgemm_ascend_tpu/ops/grouped_gemm.py:282"),
    "flash_decode": ("deepgemm_ascend_tpu_torch/csrc/flash_decode.cu",
                     "deepgemm_ascend_tpu/ops/flash_decode.py:251"),
    "flash_prefill": ("deepgemm_ascend_tpu_torch/csrc/flash_prefill.cu",
                      "deepgemm_ascend_tpu/ops/flash_prefill.py:40"),
    "int8_gemm": ("deepgemm_ascend_tpu_torch/csrc/int8_gemm.cu",
                  "deepgemm_ascend_tpu/ops/int8_gemm.py:45"),
    "int8_grouped_contiguous": ("deepgemm_ascend_tpu_torch/csrc/int8_gemm.cu",
                                "deepgemm_ascend_tpu/ops/int8_gemm.py:217"),
    "int8_grouped_masked": ("deepgemm_ascend_tpu_torch/csrc/int8_gemm.cu",
                            "deepgemm_ascend_tpu/ops/int8_gemm.py:371"),
}
# The kernels each serving run must launch (and no other).
FP8_PATH = {"fp8_gemm", "grouped_gemm", "flash_decode", "flash_prefill"}
INT8_PATH = {"fp8_gemm", "int8_grouped_masked", "flash_decode",
             "flash_prefill"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, the L2 cache (50 MB) flushed by a
    256 MB write before every timed launch."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def within_one_bf16_ulp(got: torch.Tensor, ref: torch.Tensor) -> bool:
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    tiny = 1e-6 * float(ref.abs().max())
    return bool(((got - ref).abs() <= ulp + tiny).all())


# ---------------------------------------------------------------- phase 1

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script measures the port on a GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count})")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_dir = _kernels.build()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s into {build_dir}")
    for src, text in _kernels.build_log().items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  ptxas {src}: {regs[:2]}")
    return {"name": name, "count": count, "smi": smi, "build_s": build_s}


# ---------------------------------------------------------------- phase 2

def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


def check_fp8_gemm(m: int, n: int, k: int, seed: int) -> dict:
    g = _gen(seed)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m, k, generator=g, device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(n, k, generator=g, device=DEV) / math.sqrt(k))
    run = lambda: fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t")
    plain = lambda: fp8mod.fp8_gemm_plain(a_q, a_s, b_q, b_s.t(), b_t=True)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    ok = within_one_bf16_ulp(got, ref) and bool(torch.isfinite(got).all())
    kb = k // 128
    nbytes = m * k + m * kb * 4 + n * k + (n // 128) * kb * 4 + m * n * 2
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k, FP8_OPS_PER_S)
    return {"shape": f"m={m} n={n} k={k}", "ok": ok,
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by}


def _masked_m(e: int, tokens: int, top_k: int, seed: int) -> torch.Tensor:
    """Expert loads from routing random tokens through a random router."""
    g = _gen(seed)
    router = BF16Linear.create(g, 2048, e, init_scale=0.02, device=DEV)
    x = torch.randn(tokens, 2048, generator=g, device=DEV).to(torch.bfloat16)
    _, idx = route_topk(router(x), top_k)
    return dispatch_masked(idx, e)[1]


def check_grouped(e: int, tokens: int, n: int, k: int, seed: int) -> dict:
    cap = tokens * 6
    masked_m = _masked_m(e, tokens, 6, seed)
    g = _gen(seed + 1)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(e, cap, k, generator=g, device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=DEV) / math.sqrt(k))
    run = lambda: ggmod.m_grouped_gemm_masked(a_q, a_s, b_q, b_s, masked_m,
                                              b_layout="t")
    plain = lambda: ggmod.grouped_gemm_masked_plain(
        a_q, a_s, b_q, b_s.transpose(1, 2), masked_m, b_t=True)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    rows = masked_m.tolist()
    ok, err = True, 0.0
    for ei, r in enumerate(rows):
        if r:
            ok &= within_one_bf16_ulp(got[ei, :r], ref[ei, :r])
            err = max(err, float((got[ei, :r].float()
                                  - ref[ei, :r].float()).abs().max()))
    valid = sum(rows)
    active = sum(1 for r in rows if r)
    kb = k // 128
    nbytes = (valid * (k + kb * 4) + active * (n * k + (n // 128) * kb * 4)
              + valid * n * 2 + e * 4)
    b_ms, b_by = bound(nbytes, 2.0 * valid * n * k, FP8_OPS_PER_S)
    return {"shape": f"E={e} cap={cap} valid_rows={valid} n={n} k={k}",
            "ok": ok, "max_abs_err": err, "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by}


def scaled_mm_blockwise(m: int, n: int, k: int, seed: int) -> dict:
    """K1's library yardstick, if this torch has one: ``torch._scaled_mm``
    with DeepGEMM's 1×128 activation and 128×128 weight block scales. Each
    way of passing the scales that the call refuses is recorded with the
    first line of its error; the first that it accepts is checked against
    K1 and timed."""
    g = _gen(seed)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m, k, generator=g, device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(n, k, generator=g, device=DEV) / math.sqrt(k))
    outer_major = lambda t: t.t().contiguous().t()   # stride(0) == 1
    tries = {"_scaled_mm(scale_a (m,k/128), scale_b (k/128,n/128))":
             (a_s, b_s.t()),
             "_scaled_mm(scale_a outer-dim-major, scale_b (k/128,n/128))":
             (outer_major(a_s), b_s.t()),
             "_scaled_mm(scale_a outer-dim-major, scale_b contiguous)":
             (outer_major(a_s), b_s.t().contiguous())}
    refused = {}
    for label, (sa, sb) in tries.items():
        call = lambda: torch._scaled_mm(a_q, b_q.t(), scale_a=sa,
                                        scale_b=sb, out_dtype=torch.bfloat16)
        try:
            got = call()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError) as exc:
            refused[label] = str(exc).strip().splitlines()[0][:200]
            continue
        ref = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t")
        rel = float((got.float() - ref.float()).norm()
                    / ref.float().norm())
        return {"shape": f"m={m} n={n} k={k}", "accepted": label,
                "rel_l2_vs_k1": rel, "ms": time_ms(call), "refused": refused}
    return {"shape": f"m={m} n={n} k={k}", "accepted": None, "ms": None,
            "refused": refused}


def _int8_operands(a_shape, b_shape, seed):
    """Random int8 operands with per-row / per-column f32 scales. Row 0 of
    A and column 0 of B are all 127, so that one int32 sum (127²·k) is
    past 2^24 and its conversion to f32 rounds."""
    g = _gen(seed)
    a_q = torch.randint(-127, 128, a_shape, generator=g, device=DEV,
                        dtype=torch.int8)
    b_q = torch.randint(-127, 128, b_shape, generator=g, device=DEV,
                        dtype=torch.int8)
    a_q[..., 0, :] = 127
    b_q[..., 0, :] = 127              # column 0 of the K-major (…, n, k) B
    a_s = torch.rand(*a_shape[:-1], 1, generator=g, device=DEV) * 0.02 + 1e-3
    b_s = torch.rand(*b_shape[:-2], 1, b_shape[-2], generator=g,
                     device=DEV) * 0.02 + 1e-3
    return a_q, a_s, b_q, b_s


def _int_mm_yardstick(a_q, b_q) -> dict:
    """torch._int_mm: the int32 product alone (no epilogue), as a library
    time for K7. It refuses some shapes (m ≤ 16 on CUDA); the refusal is
    kept."""
    call = lambda: torch._int_mm(a_q, b_q.t())
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return {"library_ms": None,
                "library_note": "torch._int_mm refused: "
                + str(exc).strip().splitlines()[0][:160]}
    return {"library_ms": time_ms(call),
            "library_note": "torch._int_mm (int32 product only)"}


def check_int8_gemm(m: int, n: int, k: int, seed: int) -> dict:
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k), seed)
    run = lambda: i8mod.int8_gemm(a_q, a_s, b_q, b_s, b_layout="t")
    plain = lambda: i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s, b_t=True)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    ok = torch.equal(got, ref) and bool(torch.isfinite(got).all())
    nbytes = m * k + m * 4 + n * k + n * 4 + m * n * 2
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
    return {"shape": f"m={m} n={n} k={k}", "ok": ok,
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            **_int_mm_yardstick(a_q, b_q)}


def check_int8_masked(e: int, tokens: int, n: int, k: int,
                      seed: int) -> dict:
    cap = tokens * 6
    masked_m = _masked_m(e, tokens, 6, seed)
    a_q, a_s, b_q, b_s = _int8_operands((e, cap, k), (e, n, k), seed + 1)
    run = lambda: i8mod.m_grouped_int8_gemm_masked(a_q, a_s, b_q, b_s,
                                                   masked_m, b_layout="t")
    plain = lambda: i8mod.grouped_masked_plain(a_q, a_s, b_q, b_s, masked_m,
                                               b_t=True)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    rows = masked_m.tolist()
    ok, err = True, 0.0
    for ei, r in enumerate(rows):
        if r:
            ok &= torch.equal(got[ei, :r], ref[ei, :r])
            err = max(err, float((got[ei, :r].float()
                                  - ref[ei, :r].float()).abs().max()))
    valid = sum(rows)
    active = sum(1 for r in rows if r)
    nbytes = (valid * (k + 4) + active * (n * k + n * 4) + valid * n * 2
              + e * 4)
    b_ms, b_by = bound(nbytes, 2.0 * valid * n * k, INT8_OPS_PER_S)
    return {"shape": f"E={e} cap={cap} valid_rows={valid} n={n} k={k}",
            "ok": ok, "max_abs_err": err, "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "library_note": "none: no PyTorch call runs a masked grouped "
                            "int8 product"}


def check_int8_contiguous(e: int, tokens: int, n: int, k: int,
                          seed: int) -> dict:
    """Expert loads from routing ``tokens`` × top-6 through a random router,
    laid out by make_contiguous_layout at block_m = 128."""
    counts = _masked_m(e, tokens, 6, seed).tolist()
    m, gids, _ = ggmod.make_contiguous_layout(counts, 128)
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (e, n, k), seed + 1)
    ids = torch.from_numpy(gids)
    run = lambda: i8mod.m_grouped_int8_gemm_contiguous(a_q, a_s, b_q, b_s,
                                                       ids, b_layout="t")
    plain = lambda: i8mod.grouped_contiguous_plain(a_q, a_s, b_q, b_s, ids,
                                                   b_t=True)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    active = sum(1 for c in counts if c)
    nbytes = m * (k + 4) + active * (n * k + n * 4) + m * n * 2 + gids.size * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
    return {"shape": f"E={e} M_total={m} tokens={sum(counts)} n={n} k={k}",
            "ok": torch.equal(got, ref),
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "none: no PyTorch call runs a grouped int8 "
                            "product"}


def _int8_cache(b, kvh, s_max, seed):
    g = _gen(seed)
    kq = torch.randint(-127, 128, (b, kvh, s_max, 128), generator=g,
                       device=DEV, dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, kvh, s_max, 128), generator=g,
                       device=DEV, dtype=torch.int8)
    ks = torch.rand(b, kvh, s_max, generator=g, device=DEV) * 0.02 + 1e-3
    vs = torch.rand(b, kvh, s_max, generator=g, device=DEV) * 0.02 + 1e-3
    return kq, ks, vq, vs


def check_flash_decode(kvh: int, g: int, seed: int) -> dict:
    b, s_max, hd = 16, 4096, 128
    cache = _int8_cache(b, kvh, s_max, seed)
    gen = _gen(seed + 1)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=DEV).to(
        torch.bfloat16)
    k_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=DEV,
                          dtype=torch.int8)
    v_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=DEV,
                          dtype=torch.int8)
    ks_new = torch.rand(b, kvh, generator=gen, device=DEV) * 0.02
    vs_new = torch.rand(b, kvh, generator=gen, device=DEV) * 0.02
    lens_np = np.random.default_rng(seed).integers(1, s_max + 1, size=b)
    lens_np[:3] = [1, s_max, s_max]      # a fresh slot, a full and a freed one
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(DEV)
    kc = [t.clone() for t in cache]
    pc = [t.clone() for t in cache]
    run = lambda: fdmod.flash_decode_gqa_inplace(q, *kc, k_new, v_new,
                                                 ks_new, vs_new, lens)[0]
    plain = lambda: fdmod.flash_decode_inplace_plain(
        q, *pc, k_new, v_new, ks_new, vs_new, lens).reshape(b, kvh * g, hd)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    caches_equal = all(torch.equal(x, y) for x, y in zip(kc, pc))
    # The design question of this kernel: one block per (batch, kv head),
    # or spans of SPLIT_KEYS keys merged after. Time the former too.
    split_keys = fdmod.SPLIT_KEYS
    fdmod.SPLIT_KEYS = s_max
    try:
        one_block_ms = time_ms(run)
    finally:
        fdmod.SPLIT_KEYS = split_keys
    total = int(np.minimum(lens_np, s_max).sum())
    nbytes = (q.numel() * 2 + kvh * total * (2 * hd + 8)
              + b * kvh * 2 * (2 * hd + 8) + got.numel() * 4 + b * 4)
    b_ms, b_by = bound(nbytes, 4.0 * kvh * g * hd * total, BF16_OPS_PER_S)
    return {"shape": f"b={b} kvh={kvh} g={g} S={s_max} sum_len={total}",
            "ok": err < ATTN_TOL and caches_equal, "max_abs_err": err,
            "caches_equal": caches_equal, "ms": time_ms(run),
            "one_block_per_head_ms": one_block_ms,
            "plain_ms": time_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by}


def check_flash_prefill(start: int, seed: int) -> dict:
    b, kvh, g, s, s_max, hd = 4, 4, 4, 512, 4096, 128
    cache = _int8_cache(b, kvh, s_max, seed)
    q = torch.randn(b, s, kvh * g, hd, generator=_gen(seed + 1),
                    device=DEV).to(torch.bfloat16)
    st_np = np.full(b, start, np.int32)
    lens_np = st_np + s
    st = torch.from_numpy(st_np).to(DEV)
    lens = torch.from_numpy(lens_np).to(DEV)
    run = lambda: fpmod.flash_prefill_gqa(q, *cache, st, lens)
    qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
    plain = lambda: fpmod.flash_prefill_plain(qg, *cache, st, lens)
    got = run()
    ref = plain().permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    keys = sum(min(start + i + 1, int(lens_np[0])) for i in range(s)) * b
    rows_read = b * kvh * min(int(lens_np[0]), start + s)
    nbytes = q.numel() * 2 + rows_read * (2 * hd + 8) + got.numel() * 4
    b_ms, b_by = bound(nbytes, 4.0 * kvh * g * hd * keys, BF16_OPS_PER_S)
    return {"shape": f"b={b} s={s} start={start} kvh={kvh} g={g} S={s_max}",
            "ok": err < ATTN_TOL, "max_abs_err": err, "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by}


def phase_kernels() -> dict:
    results = {name: [] for name in KERNELS}
    lite_gemms = [(2048, 2048), (512, 2048), (22016, 2048), (2048, 11008),
                  (2816, 2048), (2048, 1408)]
    for i, (n, k) in enumerate(lite_gemms):
        for m in (16, 2048):
            results["fp8_gemm"].append(check_fp8_gemm(m, n, k, seed=i))
    # Decode (16 slots) and one prefill chunk (2048 tokens) for V2_LITE's
    # 32 experts and V2_LITE_FULL's 64; then both kv-head geometries.
    for e in (V2_LITE.num_experts, V2_LITE_FULL.num_experts):
        for tokens in (16, 2048):
            for n, k in ((2816, 2048), (2048, 1408)):
                results["grouped_gemm"].append(
                    check_grouped(e, tokens, n, k, seed=e + tokens + n))
    for i, cfg in enumerate((V2_LITE, V2_LITE_FULL)):
        results["flash_decode"].append(check_flash_decode(
            cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, seed=i + 1))
    for start in (0, 1000):
        results["flash_prefill"].append(check_flash_prefill(start, seed=3))
    for i, (n, k) in enumerate([(2048, 2048), (22016, 2048), (2048, 11008)]):
        for m in (16, 2048):
            results["int8_gemm"].append(check_int8_gemm(m, n, k, seed=20 + i))
    results["int8_gemm"].append(check_int8_gemm(33, 384, 1000, seed=23))
    for n, k in ((2816, 2048), (2048, 1408)):
        results["int8_grouped_contiguous"].append(
            check_int8_contiguous(V2_LITE.num_experts, 2048, n, k,
                                  seed=30 + n))
    for e, tokens in ((V2_LITE.num_experts, 16), (V2_LITE.num_experts, 2048),
                      (V2_LITE_FULL.num_experts, 16)):
        for n, k in ((2816, 2048), (2048, 1408)):
            results["int8_grouped_masked"].append(
                check_int8_masked(e, tokens, n, k, seed=e + tokens + n))
    k1_library = [scaled_mm_blockwise(m, 22016, 2048, seed=1)
                  for m in (16, 2048)]
    for name, rows in results.items():
        for r in rows:
            log(f"  {name:23s} {r['shape']:50s} ok={r['ok']} "
                f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']})"
                + (f" one-block-per-head ms={r['one_block_per_head_ms']:.4f}"
                   if "one_block_per_head_ms" in r else "")
                + (f" library_ms={r['library_ms']}" if "library_ms" in r
                   else ""))
    for r in k1_library:
        log(f"  K1 library yardstick {r['shape']}: accepted={r['accepted']} "
            f"ms={r['ms']} refused={r['refused']}"
            + (f" rel-L2 vs K1 {r['rel_l2_vs_k1']:.3g}" if r["accepted"]
               else ""))
    bad = [(n, r["shape"]) for n, rows in results.items() for r in rows
           if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    return {"checks": results, "k1_library": k1_library}


# ---------------------------------------------------------------- phase 3

def to_device(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, list):
        return [to_device(o, dev) for o in obj]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _model_logits(params, cfg, dev, prompt, steps):
    s = prompt.shape[1]
    caches = init_cache(cfg, 1, 4096, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    logits, caches = forward(
        params, torch.from_numpy(prompt).to(dev), caches, pos,
        torch.tensor([s], dtype=torch.int32, device=dev), cfg,
        prefill_start=torch.zeros(1, dtype=torch.int32, device=dev))
    out = [logits[0].float().cpu()]
    lens = s
    for tok in steps:
        lg, caches = decode_step(
            params, torch.tensor([int(tok)], dtype=torch.int32, device=dev),
            caches, torch.tensor([lens], dtype=torch.int32, device=dev), cfg)
        out.append(lg[0].float().cpu())
        lens += 1
    return out


def _flip_one_ulp(rate: float, seed: int):
    """Wraps a plain GEMM's last step (a function whose last argument is
    the output type) so that a fraction ``rate`` of its bf16 outputs moves
    by one ulp (seeded): the noise-floor probe of phase 3."""
    gen = torch.Generator().manual_seed(seed)

    def wrap(real):
        def plain(*args):
            bits = real(*args[:-1], torch.bfloat16).view(torch.int16)
            flip = torch.rand(bits.shape, generator=gen) < rate
            step = torch.where(torch.rand(bits.shape, generator=gen) < 0.5,
                               1, -1)
            bits = torch.where(flip, bits + step.to(torch.int16), bits)
            return bits.view(torch.bfloat16).to(args[-1])
        return plain
    return wrap


def phase_model(experts: str) -> dict:
    """``experts``: "fp8" (K3) or "int8" (K6, via params_with_int8_experts).
    The noise floor moves outputs of every plain GEMM of the path: K1 and
    K3's group sums, or K6's epilogue."""
    cfg = dataclasses.replace(V2_LITE, num_layers=2)   # 1 dense + 1 MoE
    params = init_params(0, cfg, device=DEV)
    if experts == "int8":
        params = params_with_int8_experts(params)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 256)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=8)
    _kernels.reset_counters()
    t0 = time.perf_counter()
    kern = _model_logits(params, cfg, DEV, prompt, steps)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    launched = {n: c.launches for n, c in _kernels.COUNTERS.items()}
    cpu_params = to_device(params, "cpu")
    t0 = time.perf_counter()
    plain = _model_logits(cpu_params, cfg, torch.device("cpu"), prompt, steps)
    t_plain = time.perf_counter() - t0
    errs = [relative_l2_error(a.numpy(), b.numpy())
            for a, b in zip(kern, plain)]
    wrap = _flip_one_ulp(FLOOR_FLIP_RATE, seed=3)
    real_gemm, real_epilogue = fp8mod._plain_gemm, i8mod._epilogue
    fp8mod._plain_gemm = ggmod._plain_gemm = wrap(real_gemm)
    i8mod._epilogue = wrap(real_epilogue)
    try:
        noisy = _model_logits(cpu_params, cfg, torch.device("cpu"), prompt,
                              steps)
    finally:
        fp8mod._plain_gemm = ggmod._plain_gemm = real_gemm
        i8mod._epilogue = real_epilogue
    floor = [relative_l2_error(a.numpy(), b.numpy())
             for a, b in zip(noisy, plain)]
    argmax_same = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                   for a, b in zip(kern, plain)]
    finite = all(bool(torch.isfinite(a).all()) for a in kern)
    log(f"model ({experts} experts): V2_LITE 2 layers, prompt 256 + 8 decode "
        f"steps; kernel path {t_kern:.2f} s (card), plain path "
        f"{t_plain:.2f} s (CPU)")
    log(f"  logits rel-L2 prefill {errs[0]:.3g}, decode max "
        f"{max(errs[1:]):.3g} (tolerance {MODEL_REL_L2_TOL}); top-1 "
        f"agreement {argmax_same}; launches {launched}")
    log(f"  noise floor: plain path with {FLOOR_FLIP_RATE:g} of GEMM outputs "
        f"moved one bf16 ulp, rel-L2 prefill {floor[0]:.3g}, decode max "
        f"{max(floor[1:]):.3g}")
    if not finite or max(errs) >= MODEL_REL_L2_TOL:
        raise RuntimeError(f"model ({experts}): kernel path vs plain path "
                           f"rel-L2 {errs} (finite={finite})")
    expected = FP8_PATH if experts == "fp8" else INT8_PATH
    if any(bool(launched[n]) != (n in expected) for n in launched):
        raise RuntimeError(f"model ({experts}): launches {launched}, "
                           f"expected exactly {sorted(expected)}")
    return {"rel_l2": errs, "top1_agreement": argmax_same,
            "noise_floor_rel_l2": floor, "launches": launched,
            "kernel_s": t_kern, "plain_s": t_plain}


# ---------------------------------------------------------------- phase 4

def _profile_decode_step(eng: Engine) -> dict:
    """One more decode step over all 16 slots (caches as serving left
    them) under torch.profiler: device kernel time against host wall time,
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = (eng.params, eng.last_tokens, eng.caches, eng.seq_lens, eng.cfg)
    decode_step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel events only: an operator's own row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    log(f"  one decode step under torch.profiler: wall {wall_ms:.2f} ms, "
        f"device kernels {device_ms:.2f} ms ({len(rows)} kernels), device "
        f"idle share {max(0.0, 1 - device_ms / wall_ms):.2f}")
    for key, ms, count in rows[:8]:
        log(f"    {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for k, ms, c in rows[:12]]}


def phase_serving(device: dict, experts: str) -> dict:
    """Serves the 24 requests with ``experts`` "fp8" or "int8"; the run must
    launch exactly FP8_PATH or INT8_PATH, and no plain version."""
    cfg = V2_LITE
    t0 = time.perf_counter()
    params = init_params(0, cfg, device=DEV)
    if experts == "int8":
        params = params_with_int8_experts(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng = Engine(params, cfg, max_slots=16, max_seq_len=4096, device=DEV)
    rng = np.random.default_rng(2)
    lengths = rng.integers(16, 1025, size=24)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in lengths]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counters()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: (c.launches, c.plain_calls)
              for n, c in _kernels.COUNTERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    st = eng.stats
    prefill_tps = st["prefill_tokens"] / st["prefill_time_s"]
    log(f"serving ({experts} experts): V2_LITE 8 layers, 16 slots, 24 "
        f"requests (prompts {int(lengths.min())}..{int(lengths.max())}), 32 "
        f"new tokens each, {wall:.2f} s wall (parameters built in "
        f"{setup_s:.2f} s)")
    log(f"  prefill {prefill_tps:.1f} tok/s ({st['prefill_tokens']} prompt "
        f"tokens), decode {eng.tokens_per_second:.1f} tok/s over "
        f"{st['decode_steps']} steps, peak memory {peak_gb:.2f} GiB; "
        f"{device['smi']}")
    log(f"  counters (launches, plain calls): {counts}")
    if len(outs) != 24 or any(len(o) != 32 for o in outs):
        raise RuntimeError(f"serving: lengths {[len(o) for o in outs]}")
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        raise RuntimeError("serving: token out of range")
    expected = FP8_PATH if experts == "fp8" else INT8_PATH
    if any(bool(launches) != (n in expected)
           for n, (launches, _) in counts.items()):
        raise RuntimeError(f"serving ({experts}): launches {counts}, "
                           f"expected exactly {sorted(expected)}")
    if any(calls for _, calls in counts.values()):
        raise RuntimeError(f"serving: a plain version ran: {counts}")
    profile = _profile_decode_step(eng)
    return {"experts": experts, "wall_s": wall, "setup_s": setup_s,
            "prefill_tok_s": prefill_tps, "profile": profile,
            "decode_tok_s": eng.tokens_per_second,
            "decode_steps": st["decode_steps"],
            "prefill_tokens": st["prefill_tokens"], "peak_gib": peak_gb,
            "counts": counts}


# ---------------------------------------------------------------- main

HEADLINE = {"fp8_gemm": "m=16 n=22016 k=2048",
            "grouped_gemm": "E=32 cap=96 ",
            "flash_decode": "kvh=4 g=4",
            "flash_prefill": "start=0",
            "int8_gemm": "m=16 n=22016 k=2048",
            "int8_grouped_contiguous": "n=2816",
            "int8_grouped_masked": "E=32 cap=96 "}
NO_LIBRARY = {
    "grouped_gemm": "none: no PyTorch call runs a masked grouped product "
                    "with blockwise fp8 scales",
    "flash_decode": "none: no PyTorch attention reads an int8 cache with "
                    "per-token scales and writes it in place",
    "flash_prefill": "none: no PyTorch attention reads an int8 cache with "
                     "per-token scales"}


def summarize(kernels: dict, runs: list) -> list:
    """One entry per kernel: launches in the serving runs, the headline
    shape's phase-2 numbers and its library yardstick."""
    summary = []
    for name, (source, replaces) in KERNELS.items():
        rows = kernels["checks"][name]
        head = next(r for r in rows if HEADLINE[name] in r["shape"])
        by_run = {run["experts"]: run["counts"][name][0] for run in runs}
        lib_ms, lib_note = head.get("library_ms"), head.get("library_note")
        if name == "fp8_gemm":
            lib = kernels["k1_library"][0]
            lib_ms = lib["ms"]
            lib_note = (f"torch.{lib['accepted']}" if lib["accepted"] else
                        "none: torch._scaled_mm refused the blockwise "
                        f"scales: {list(lib['refused'].values())[:1]}")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": lib_ms,
            "library_note": lib_note or NO_LIBRARY.get(name),
            "shape": head["shape"]})
    return summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", help="also write the full report here "
                        "(JSON)")
    report_path = parser.parse_args().report
    t_start = time.perf_counter()
    device = phase_device()
    log("phase 2: kernels against their plain versions")
    kernels = phase_kernels()
    log("phase 3: model, kernel path against plain path")
    model = {experts: phase_model(experts) for experts in ("fp8", "int8")}
    log("phase 4: serving, fp8 experts then int8 experts")
    runs = []
    for experts in ("fp8", "int8"):
        runs.append(phase_serving(device, experts))
        torch.cuda.empty_cache()      # the finished run's engine is gone
    summary = summarize(kernels, runs)
    log("kernels " + " | ".join(
        f"{k['name']}: launches={k['launches_by_run']} ok ms={k['ms']:.4f} "
        f"bound_ms={k['bound_ms']:.4f}" for k in summary))
    report = {"device": device, "kernels": kernels, "model": model,
              "serving": runs, "total_s": time.perf_counter() - t_start}
    if report_path:
        os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(f"total {report['total_s']:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
