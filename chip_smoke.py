#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepgemm_ascend_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each of which raises on failure (exit code ≠ 0):

1. device: the card's name, count and power limit; build every CUDA kernel
   from ``deepgemm_ascend_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and report the build time, and the registers and spills of
   every instance of the Hopper main loop (K10/K11, K12, K7);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes serving V2_LITE gives it (and V2_LITE_FULL's MoE-layer
   shapes for K2/K3/K6/K8), with its time (CUDA events, warm-up, L2
   flushed before every launch, the launches queued behind a spin kernel
   so that no host time is counted), the plain version's time, the bound
   max(bytes / 3.35 TB/s, operations / peak) of the H100 SXM data sheet
   and, where one PyTorch call computes the same function, that call's
   time (``torch._int_mm`` for K7's integer product; ``torch._scaled_mm``
   with blockwise scales for K1, where this torch accepts them;
   ``torch.matmul`` for the dense GEMMs K10 and K11). Every K10 and K11
   row shows the route its wrapper counted (``ops.gemm.route``: wgmma
   where TMA can describe 16-bit operands, ffma for f32 ones that 16-byte
   loads can read, else mma_tile); the f32 rows (2048³ in nn/nt/tn/tt,
   m=16 n=22016 k=2048, a batch of 4 at 2048³, K11 at m=16 n=2048
   k=11008 on the split gate's count, and 33×97×1000, which stays on
   mma_tile) time route mma_tile beside ffma in the same run
   (``old_route_ms``) and must equal it bit for bit (``equals_old_route``);
   every K7 row its own
   (``ops.int8_gemm.route``: wgmma for B stored K-major with k a multiple
   of 16, else int8_tile), every K1 and K3 row the plan its wrapper
   counted for the launch (``Counter.plans``: route ring for B stored
   K-major, else tile; the ring's tile; K1's group splits, ``ring_plan``;
   K3's tile from the MoE layer's ``expected_m``); K1 and K3 also on the
   same weights stored (k, n), the tile route, at a decode and a prefill
   shape, held bit for bit against the unsplit ring
   (``ring_equals_tile``); each of them, and every K12 row (always the
   new kernel), its time before the Hopper redesign (``prev_ms``: quoted
   from ``PREV_MS``, not measured in the run; in the log and the report
   only), and a line sums K1's and K3's rows over one V2_LITE decode
   step (``K1_PER_STEP``, ``K3_PER_STEP``); K10 rows with 16-bit inputs
   their time with bf16 output beside
   cuBLAS's 16-bit one (``bf16_out_ms``, also checked). The int8 kernels
   (K7, K9, K6) must equal their plain versions bit for bit. The dense
   GEMM's shapes that ``select_config`` sends to split-K (K11) are listed,
   and K11 is timed beside K10 there (``k10_ms``), as at the explicit
   split counts of the dense FFN's decode down projection. The folded-scale fp8 GEMM (K12) at
   K1's shapes, against its plain version (f32 sum order plus one bf16
   ulp) and within 5e-3 rel-L2 of K1, beside ``torch.matmul`` of the
   operands folded in PyTorch; the read-only decode attentions (K5a, K5b)
   at K2's shapes and at phase 4's lengths with an empty sequence, on
   their own route (``flash_decode.read_route``: "live" at head size 128)
   with route "span" timed beside it (``old_route_ms``), per element
   within 2⁻⁷·Σ w·|v| of their plain versions (``flash_common``) and
   within ATTN_TOL of route span; K5a over the cache K2 wrote equal to K2
   bit for bit (``equals_k2_live``), K5b's acc / l equal to K5a
   (``acc_over_l_equals_k5a``), and K5b merged exactly with the current
   token against K2; K4 and the prefill state (K4-stats)
   per element the same way (``output_close`` / ``state_close``) at phase
   2's shapes and phase 4's largest prefill bucket (b=8, s=1024 over a
   4096-key cache, ``BUCKET_1024_LENS``), K4-stats also at a start before
   0 and one past the cache, its acc / l equal to K4's output and its
   empty rows exactly (0, -1e30, 0); the rows from start 0 beside
   PyTorch's bf16 causal attention over the dequantized cache
   (``sdpa_bf16_ms``: a yardstick of another function, never
   ``library_ms``). K2 also at V3_STYLE's GQA group 8 (16 kv heads),
   which layer_bench runs, and at phase 4's lengths (16..1056 keys in a
   4096-key cache). Every K2 row shows its route (``route=live/<blocks>``:
   the grid of ``flash_decode.live_blocks``), its time on route "span"
   (the design before, same inputs, ``span_ms``), and ``prev_ms``; every
   K6 row its route and tile (``tiling.analytic.masked_plan`` from the MoE
   layer's ``expected_m``: ring 16x64 at decode, wgmma 64x64 at a
   128-token prefill forward, wgmma 128x256 at a 2048-token chunk) and
   ``prev_ms``; every K8 and K9 row its route (``contiguous_route``: K8
   wgmma16 128x128 for B stored K-major and a block_m that 64 divides, else
   tile — the block_m=96 row; K9 wgmma 128x256) and, at the 2048-token
   rows, the route before the redesign timed beside it in the same run
   (``old_route_ms``, bit-equal), K8's rows also bit-equal to K3 on the
   same rows (``equals_k3``) and its 16-bit bound beside the fp8 one; K6
   also on the same weights stored (E, k, n), route
   int8_tile, at V2_LITE's decode shape, held bit for bit against the
   route the hint picks for the K-major weights (``ring_equals_tile``).
   The dispatch probe P0 bit for bit against its
   plain version (a copy), beside ``Tensor.clone``, and the launch floor it
   measures (device and host µs per launch, through the wrapper and through
   the bare ctypes entry). Then every kernel of phase 7 at the shapes its
   scripts give it (``check_script_shapes``: the probe's rows, K1 at
   4096³, serve_bench's batch 64 and its engines' short caches,
   layer_bench's V2_LITE_FULL and V3_STYLE shard GEMMs, experts and
   decode attention), held the same way. Timing and bounds come from
   ``bench/`` (``timing.cold_ms``, ``roofline.bound_ms``);
3. model: V2_LITE at full width cut to 2 layers (1 dense + 1 MoE), with
   fp8 experts and again with int8 experts (``params_with_int8_experts``)
   — the kernel path on the card against the plain path on the CPU (the
   kernel wrappers take their plain versions only for CPU tensors), same
   parameters, a 256-token prompt and 8 teacher-forced decode steps; and
   the expert-parallel shard path of ``moe_block`` on the card: the
   routed outputs of V2_LITE_FULL's 64 experts in 8 shards must sum to
   the whole block's, and be zero for tokens routed elsewhere;
4. serving, twice: V2_LITE at full width and depth, ``Engine(max_slots=16)``
   at ``max_seq_len=4096``, 24 greedy requests with 16..1024-token prompts
   and 32 new tokens each — first with fp8 experts, then with int8 experts.
   The kernel counters are zeroed just before each run and read just after:
   each run must have launched exactly its own kernel set (fp8: K1, K2,
   K3, K4; int8: K1, K2, K4, K6), and no plain version may have run;
   K1 and K3 must have launched on ring plans only, K2 on route "live"
   only and K6 on its "ring" or "wgmma" routes only (their wrappers'
   ``Counter.plans``, printed by plan here and in phases 5-7).
   Then one more decode step of that state, five times unprofiled (host
   clock) and once under ``torch.profiler`` (device time, launches), and
   one prefill forward of the run's largest bucket (1024 rows a prompt:
   its first admissions' 1024-bucket prompts and a padding row;
   ``bench.prefill_profile``) the same way, with K4's device time in it.
   Then the serving features, each run with the counters zeroed just
   before and read just after: (b) the same requests at
   ``decode_chunk=8`` (a captured CUDA graph replayed a chunk): decode and
   prefill tok/s, utilization, peak memory, the capture's launches (one
   replay's: exactly K1, K3 or K6 and K2, K2 eight times a layer, no plain
   call); (a) on the state it leaves, the chunk eagerly and replayed from
   copies of that state, equal bit for bit (tokens, caches, lengths), and
   a step's wall ms each way (median of 5), device ms (profiled) and idle
   share; with fp8 experts (c) the prefix cache: 16 requests sharing a
   512-token system prompt, one batched admission on a cold engine and on
   a warm one, 16 hits, the warm first-token logits within the phase-3
   rel-L2 bound of the cold ones (the admissions' 16384- and 256-row
   GEMMs sum in other f32 orders), the first tokens that differ counted;
   and
   (d) speculative decoding (k=3) of 16 of the requests (one wave) with
   prompt-lookup and oracle drafts: the same tokens both ways; against
   plain greedy serving the first decode logits within the phase-3 bound,
   where the outputs leave it; accepted/proposed drafts and tok/s;
5. the reference-compatible API (``compat``) at V2_LITE's widths, as a
   caller of the reference library or of DeepGEMM drives it: ``run_mmad_*``
   into preallocated output buffers, the package's ``gemm`` through
   ``select_config`` and with an explicit split-K config,
   ``gemm_fp8_fp8_bf16_nt`` (V2_LITE_FULL's ragged dense w2 included), and
   one MoE prefill layer (2048 tokens, V2_LITE's experts) through the
   contiguous grouped alias, held bit for bit against the port's masked
   MoE path, the same layer with the experts re-quantized to W8A8
   (``params_with_int8_experts``) through ``m_grouped_int8_gemm_contiguous``
   (K9) held bit for bit against the masked int8 path (K6), plus the masked
   alias at decode. The counters are zeroed before and read after: exactly
   K10, K11, K8, K1, K3, K9 and K6 launched, no plain version; then every
   output is checked against the plain path;
6. context-parallel prefill at V2_LITE's attention width (16 q heads, 4 kv
   heads, head_dim 128) over a 16384-token prompt and its per-token int8
   cache: one K4 over the whole cache as the reference;
   ``ring_flash_prefill(cp=1)`` and ``ring_attention_prefill(cp=1)`` (the
   latter over the first 4096 rows: one unchunked f32 score tensor of the
   whole prompt would take 17 GB) through the public entry points; a cp=4
   ring whose ranks each run in turn on the one card through the public
   entry's own hop loop (``ring_attention._flash_ring``, 16 K4-stats
   launches), taking the next KV shard from the cache where the ring's
   transport would deliver it (the transport is the only part not run),
   and the f32 ring over the dequantized cache in the zigzag and
   contiguous schedules the same way (``_attn_ring``); then the decode of
   the last prompt token through ``flash_decode_gqa`` (K5a, equal to K2
   bit for bit: route "live" on K2's grid), ``flash_decode_gqa_state``
   (K5b) merged with that token, and K2, and
   the attention output's o-projection through
   ``fp8_gemm(scale_mode="folded")`` (K12) beside K1. Exactly K4,
   K4-stats, K5a, K5b, K2, K12 and K1 must launch, no plain version. Then
   every kernel is held against its plain version at these shapes: each of
   the 16 hops, K4 and the flash rings on 256 rows at each end of every
   shard, per element within 2⁻⁷·Σ w·|v| (``flash_common.state_close`` /
   ``output_close``: the bf16 rounding of w = p·v_s against two running
   maxima); the f32 rings against plain f32 attention within 2e-5 of
   softmax·|v|; K5a, K5b, K2, K12 and K1 at their phase-6 shapes; and the
   siblings over every row (flash rings vs K4 within 2e-3, zigzag vs
   contiguous within 1e-5, K5a and K5b + the token vs K2);
7. the measurement scripts (``deepgemm_ascend_tpu_torch/scripts``), each
   through its ``main(argv)`` in this process, at full width, iterations
   and chain lengths cut: ``straggler_probe`` (every row, its tile
   variants included; P0, K1, K12, K3, K8, K10, and K11 where
   ``select_config`` splits), ``profile_kernel --op
   fp8_gemm`` at 4096³ with ``--check`` (K1), ``headline`` (K1),
   ``serve_bench`` scan (V2_LITE, batch 64, 64 steps, cache 4096: K1, K3,
   K2), engine, mixed and chunksweep (16 slots: K1, K3, K2, K4), prefix
   (16 requests, one new token each: K1, K3, K4), engine with
   ``--speculative-k 3 --spec-oracle`` (K1, K3, K4, and K2 for the
   recording's tail), ``layer_bench`` at
   ``v2_lite_full:1 v3_style:32`` (batch 64, cache 2048) with fp8 experts
   (K1, K3, K2) and with int8 (K1, K6, K2). The counters are zeroed before
   and read after each run: exactly its kernel set, no plain version, rc 0;
   each script's lines are printed;
8. the tiling tiers (``tiling/``) and the compiled tile variants of K10/K11
   (wgmma 64x64, 128x128, 128x256; ffma 16x128, 64x64, 128x128), K7
   (wgmma 64x64, 128x128, 128x256) and K1 (ring 16x64, 64x64, unsplit and
   on the default plan's splits): each variant at phase 2's shapes against
   its plain version and bit for bit against the default tile where the K
   step is unchanged, with its cold ms (``check_variants``); a sweep
   (``scripts/autotune_sweep``, a child process a shape) of K10 bf16 at
   2048³ and at 1279×5003×7681 (the padded configs among its candidates),
   K7 and K1 at m=16 and m=2048 of n=22016 k=2048, every candidate through
   the gate (the XLA family timed beside, as a yardstick that never
   wins), each candidate's ms, the analytic default's and the winner's
   printed, the records in a temporary directory removed at the end; the
   sweep's cache reloaded as the card's, where
   ``select_config`` must hit (``tiling.cache_hit``) and the wrapper,
   called with no config, launch the winner's tile (``Counter.plans``);
   the counters zeroed before and read after those calls and one call of
   each variant through its public wrapper: exactly K10, K11, K7 and K1,
   every variant, no plain version; a predictor trained on the records
   (torch Adam) whose picks and declines must follow its decline policy,
   through the selector's tier 2 as well; the C++ host core
   (``native.py``, built with g++) equal to the Python tiling on a grid;
   and the host µs of K1's selection at the decode path's shapes, the
   tiers' and the wrapper's memoised one (``selection_host_cost``).
   The grouped GEMMs and K12 through the same tiers: (a) every compiled
   tile of K3 (ring 16x64, 64x64) and K6 (ring 16x64, wgmma 64x64,
   128x256) at V2_LITE's experts and phase 2's loads of a decode step, a
   128-token prefill forward and a 2048-token chunk (cap 96, 768, 12288;
   the MoE layer's expected_m), of K8 (wgmma16 64x128, 128x128) and K9
   (wgmma 64x64, 128x256) on phase 2's 2048-token layouts, and of K12
   (64x64, 128x128, 128x256) at m=16 and m=2048 of n=22016 k=2048, each
   against its plain version and the default tile's output (bit for bit;
   K12's equality is reported, not required), with its cold ms
   (``check_grouped_variants``); (b) the grouped sweep in process
   (GROUPED_SWEEPS: K3 and K6 at a decode and a prefill expected_m, K8
   and K9 on 128-row m-tiles, at V2_LITE's expert shapes, on routed
   top-6 loads, ``bench.loads``), each candidate's cold ms, the
   default's and the winner's; (c) with that
   cache as the card's, each swept shape through its public wrapper with
   no config hitting the cache and launching the winner's tile, then an
   entry naming another compiled tile moving the next launch to it
   (``serve_grouped_from_cache``); the driven run's counters then also
   show K3, K6, K8, K9 and K12 (K12 by tile from its launch count, its
   wrapper counting no plan), and the host µs of the grouped wrappers'
   selection, the tiers' and the memoised one
   (``grouped_selection_host_cost``);
9. the loader, the golden and quality scripts, and sharded serving: (a)
   ``models.load_params`` of a synthetic HF checkpoint (numpy, from a
   seed) at V2_LITE's widths, cut to 2 layers for time, on the card and
   byte-equal to the same loader on the CPU, its logits through the
   kernels within the phase-3 bound of the same parameters under
   ``exact_mode``, and the ``save_quantized`` / ``load_quantized`` round
   trip bit for bit; (b) ``scripts/gen_golden`` at 2048³ in fp16 and
   bf16, the inputs through K10 into a file that ``verify_output`` must
   pass against the golden, and the ``torch_matmul`` cross-check; (c)
   ``scripts/eval_quality --model v2_lite`` (24 steps, batch 4) with fp8
   and int8 experts, ``ok`` required; (d) a 1-rank NCCL group joined
   through a ``file://`` store in this process (destroyed at the end):
   phase 4's requests through ``Engine(mesh=make_mesh(1, 1, 1))``, fp8 at
   ``decode_chunk`` 1 and 8 and int8 at 1, tokens and final caches equal
   to phase 4's bit for bit, exactly phase 4's kernels on their routes and
   no plain call; then 16 of the requests (16 new tokens), the reference
   of (e), and those tokens fed back through the sharded prefill and
   decode steps (teacher-forced); (e) four ``spawn``ed processes joined
   over gloo, their tensors on the one card, serving the same 16 requests
   through the unmodified engine on the meshes (1,4,1), (1,1,4) (kv heads
   sharded congruently) and (2,2,1): rank 0's decode step from empty
   caches within 1e-6 rel-L2 of (d)'s (tp = dp = 1) or 0.02 (JAX's bounds
   for that step), every rank's tokens identical, each rank's launches
   (exactly the fp8 serving kernels, no plain call) and decode tok/s
   (gloo ranks sharing one card: a harness check, not a scaling figure);
   teacher-forced with (d)'s tokens, the prefill's logits and every decode
   step's (which read the caches merged over "data") within the phase-3
   bound of (d)'s, and rank 0's served tokens equal to (d)'s or parting
   where those logits' differences explain it.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches through its wrapper in phases 4 to 9 (``launches``; in
phase 9 (e) the four ranks' launches summed), the
launches of its bare C entry there (``bare_launches``: P0's dispatch
floor times ``raw_launch``'s entry, which no wrapper counts) and its
phase-2 numbers, then one entry per compiled tile variant (``"<kernel>
<route> <tile>"``: its launches in phase 8's driven run and its numbers
at its headline shape); the last line
is ``{"ok": true, "device": {...}}``. ``--report PATH`` also writes the full
report there as JSON.
"""

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from deepgemm_ascend_tpu_torch import compat, select_config
from deepgemm_ascend_tpu_torch.bench import loads as bench_loads
from deepgemm_ascend_tpu_torch.bench import prefill_profile
from deepgemm_ascend_tpu_torch.bench import shapes as bench_shapes
from deepgemm_ascend_tpu_torch.bench.roofline import bound_ms
from deepgemm_ascend_tpu_torch.bench.timing import cold_ms
from deepgemm_ascend_tpu_torch.compat import deep_gemm
from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType
from deepgemm_ascend_tpu_torch.models import (V2_LITE, V2_LITE_FULL,
                                              V3_STYLE, KVCache,
                                              decode_step, forward,
                                              init_cache, init_params,
                                              load_params, load_quantized,
                                              params_with_int8_experts,
                                              save_quantized)
from deepgemm_ascend_tpu_torch.models import moe as moemod
from deepgemm_ascend_tpu_torch.models.layers import BF16Linear
from deepgemm_ascend_tpu_torch.models.moe import dispatch_masked, route_topk
from deepgemm_ascend_tpu_torch.ops import _kernels, quant
from deepgemm_ascend_tpu_torch.ops import dispatch_probe as dpmod
from deepgemm_ascend_tpu_torch.ops import flash_decode as fdmod
from deepgemm_ascend_tpu_torch.ops import flash_prefill as fpmod
from deepgemm_ascend_tpu_torch.ops import fp8_gemm as fp8mod
from deepgemm_ascend_tpu_torch.ops import grouped_gemm as ggmod
from deepgemm_ascend_tpu_torch.ops.flash_common import (PV_ROUNDING,
                                                        output_close,
                                                        state_close)
from deepgemm_ascend_tpu_torch.ops import int8_gemm as i8mod
from deepgemm_ascend_tpu_torch.ops.gemm import plan_label as gemm_plan_label
from deepgemm_ascend_tpu_torch.ops.gemm import route as gemm_route
from deepgemm_ascend_tpu_torch.ops.gemm import (bgemm, gemm,
                                                gemm_ksplit_plain, gemm_plain,
                                                gemm_with_config)
from deepgemm_ascend_tpu_torch.parallel import (ring_attention_prefill,
                                                ring_flash_prefill,
                                                zigzag_inverse, zigzag_order)
from deepgemm_ascend_tpu_torch.parallel import ring_attention as ringmod
from deepgemm_ascend_tpu_torch.parallel import make_mesh
from deepgemm_ascend_tpu_torch.parallel import sharded as shardmod
from deepgemm_ascend_tpu_torch.scripts import (eval_quality, gen_golden,
                                               torch_matmul, verify_output)
from deepgemm_ascend_tpu_torch.scripts import (headline, layer_bench,
                                               prefill_sweep, profile_kernel,
                                               serve_bench, straggler_probe)
from deepgemm_ascend_tpu_torch.serving import Engine
from deepgemm_ascend_tpu_torch.serving import engine as engine_mod
from deepgemm_ascend_tpu_torch.tiling import analytic
from deepgemm_ascend_tpu_torch.tiling import padding as tiling_padding
from deepgemm_ascend_tpu_torch.tiling.autotune import \
    describe as autotune_describe
from deepgemm_ascend_tpu_torch.tiling.padding import pad_fp8_operands_nt
# H100 SXM data sheet: dense tensor-core peaks, f32 on the CUDA
# cores (not TF32).
from deepgemm_ascend_tpu_torch.tiling.platform import (BF16_OPS_PER_S,
                                                       F32_OPS_PER_S,
                                                       FP8_OPS_PER_S,
                                                       INT8_OPS_PER_S)
from deepgemm_ascend_tpu_torch.utils.common import round_up
from deepgemm_ascend_tpu_torch.utils.logging import metrics as engine_metrics
from deepgemm_ascend_tpu_torch.utils.verify import relative_l2_error

# K10/K11 vs their plain f32 matmul: each f32 output within this fraction
# of Σ|a·b| (two f32 sums of the same exact products in another order;
# random rounding grows as √K·2⁻²⁴ ≈ 6e-6 at K = 11008).
GEMM_REL_TOL = 1e-5
ATTN_TOL = 2e-3                    # K2/K4 vs plain; sibling attention kernels
FOLDED_REL_L2 = 5e-3               # K12 vs K1: JAX's contract for 'folded'
# The f32 rings against plain f32 attention: per element within this
# fraction of softmax·|v| (the same exact products, another f32 order and
# other running maxima); between two f32 rings over every row, absolute.
F32_ATTN_TOL = 2e-5
F32_SIBLING_TOL = 1e-5

# Kernel path vs plain path, logits rel-L2. The random model is chaotic:
# one bf16 ulp moved in 1e-3..1e-2 of the GEMM outputs moves its logits by
# 0.05..0.1 (phase 3 measures this floor in every run), and the tensor
# cores' f32 accumulation rounds differently from the CPU's; a wrong mask,
# scale or layout moves them by O(1).
MODEL_REL_L2_TOL = 0.25
# Phase 4's prefix cache, warm vs cold admission first-token logits: the
# same rows through K1 in other split plans (16384- and 256-row forwards),
# two card paths that round differently. About 1.5x the largest distance
# that scripts/prefix_spread.py measures on an H100 over system prompts
# from 24 seeds (0.1084, seed 18; phase 4's own prompt, seed 3, 0.083);
# the 0.05 this bound once was, 3x a single reading, is below that. A
# wrong suffix start or row copy moves them by O(1).
PREFIX_REL_L2_TOL = 0.16
FLOOR_FLIP_RATE = 1e-2
# Σ of an expert-parallel block's shards vs the whole block, f32 outputs:
# the same products, a token's ≤ top_k terms added in another order.
MOE_SHARD_REL_L2 = 1e-5
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
    "gemm": ("deepgemm_ascend_tpu_torch/csrc/gemm.cu",
             "deepgemm_ascend_tpu/ops/gemm.py:52"),
    "gemm_ksplit": ("deepgemm_ascend_tpu_torch/csrc/gemm.cu",
                    "deepgemm_ascend_tpu/ops/gemm.py:219"),
    "grouped_gemm_contiguous": (
        "deepgemm_ascend_tpu_torch/csrc/grouped_gemm.cu",
        "deepgemm_ascend_tpu/ops/grouped_gemm.py:70"),
    "fp8_gemm_folded": ("deepgemm_ascend_tpu_torch/csrc/fp8_gemm.cu",
                        "deepgemm_ascend_tpu/ops/fp8_gemm.py:90"),
    "flash_decode_read": ("deepgemm_ascend_tpu_torch/csrc/flash_decode.cu",
                          "deepgemm_ascend_tpu/ops/flash_decode.py:49"),
    "flash_decode_state": ("deepgemm_ascend_tpu_torch/csrc/flash_decode.cu",
                           "deepgemm_ascend_tpu/ops/flash_decode.py:60"),
    "flash_prefill_stats": ("deepgemm_ascend_tpu_torch/csrc/flash_prefill.cu",
                            "deepgemm_ascend_tpu/ops/flash_prefill.py:89"),
    "copy_probe": ("deepgemm_ascend_tpu_torch/csrc/dispatch_probe.cu",
                   "scripts/straggler_probe.py:75"),
}
# The kernels each serving run must launch (and no other).
FP8_PATH = {"fp8_gemm", "grouped_gemm", "flash_decode", "flash_prefill"}
INT8_PATH = {"fp8_gemm", "int8_grouped_masked", "flash_decode",
             "flash_prefill"}
# The routes serving must launch them on, by their wrappers' plan labels:
# K1 and K3 on the TMA ring, K2 on "live", K6 on "ring" or "wgmma".
SERVING_ROUTES = {"fp8_gemm": ("ring",), "grouped_gemm": ("ring",),
                  "flash_decode": ("live/",),
                  "int8_grouped_masked": ("ring", "wgmma")}
# Phase 4's serving features: the decode chunk a graph replay, the prefix
# cache's shared system prompt and its requests, the speculative drafts.
CHUNK = 8
PREFIX_SYSTEM = 512
PREFIX_REQUESTS = 16
SPEC_K = 3
# ... and of its admissions alone (the prefix cache's waves, one new token
# each) and of speculative serving (the verify windows run K4, never K2).
PREFILL_PATH = FP8_PATH - {"flash_decode"}
SPEC_PATH = PREFILL_PATH
# ... and the kernels of the compat API's run (phase 5).
COMPAT_PATH = {"gemm", "gemm_ksplit", "grouped_gemm_contiguous", "fp8_gemm",
               "grouped_gemm", "int8_grouped_contiguous",
               "int8_grouped_masked"}
# ... and of the context-parallel prefill and the direct ops (phase 6).
CP_PATH = {"flash_prefill", "flash_prefill_stats", "flash_decode_read",
           "flash_decode_state", "flash_decode", "fp8_gemm_folded",
           "fp8_gemm"}
# ... and of each measurement script (phase 7): the decode-only runs launch
# no prefill kernel; the probe adds K11 where select_config splits one of
# its dense shapes (script_runs).
DECODE_PATH = {"fp8_gemm", "grouped_gemm", "flash_decode"}
TILING_PATH = {"gemm", "gemm_ksplit", "int8_gemm", "fp8_gemm", "grouped_gemm",
               "int8_grouped_masked", "grouped_gemm_contiguous",
               "int8_grouped_contiguous", "fp8_gemm_folded"}
DECODE_INT8_PATH = {"fp8_gemm", "int8_grouped_masked", "flash_decode"}
PROBE_PATH = {"copy_probe", "fp8_gemm", "fp8_gemm_folded", "grouped_gemm",
              "grouped_gemm_contiguous", "gemm"}
# V2_LITE's projection GEMMs, (n, k): attention q/o, kv, the dense FFN's
# gate∥up and down, an expert's gate∥up and down.
LITE_GEMMS = [(2048, 2048), (512, 2048), (22016, 2048), (2048, 11008),
              (2816, 2048), (2048, 1408)]
# Rows of the dense GEMMs: a decode batch of 16 slots, a 2048-token prefill
# chunk; the MoE layer of phase 5 routes one such chunk.
DENSE_M = (16, 2048)
PREFILL_TOKENS = 2048
# Phase 6: the prompt, the ring size, and the rows of the unchunked
# ring_attention_prefill(cp=1) check.
CP_TOKENS = 16384
CP_RANKS = 4
CP_DENSE_ROWS = 4096
# Rows at each end of every rank's shard held against the plain versions.
CP_CHECK_ROWS = 256
# Phase 7's script arguments, which phase 2 checks the kernels at:
# serve_bench scan's and layer_bench's batch, their caches, the engine
# modes' slots, serve_bench's new tokens, layer_bench's name:ep shards.
SCRIPT_BATCH = 64
SCAN_CACHE = 4096
LAYER_CACHE = 2048
ENGINE_SLOTS = 16
SERVE_STEPS = 64
LAYER_CONFIGS = ("v2_lite_full:1", "v3_style:32")
# serve_bench --mode prefix's system prompt at its default --max-seq.
PREFIX_SCRIPT_SYSTEM = 480

# One V2_LITE decode step (16 slots, 8 layers): K1's launches at each
# (n, k) — every layer's wq, wo and wk, wv; layer 0's dense FFN; layers
# 1-7's shared expert — and K3's (E=32, cap=96: layers 1-7's routed
# experts, gate∥up and down). Phase 2 sums their m=16 rows with these
# weights.
K1_PER_STEP = {(2048, 2048): 16, (512, 2048): 16, (22016, 2048): 1,
               (2048, 11008): 1, (2816, 2048): 7, (2048, 1408): 7}
K3_PER_STEP = {(2816, 2048): 7, (2048, 1408): 7}

# Times before the Hopper redesign of K10, K12, K7 and K11. K10's and
# K12's are from the report of the last run of this script's phase 2 on
# the kernels of that time (the run that added the probe's and the 4096³
# rows; cold ms, NVIDIA H100 80GB HBM3, 700.00 W); K7's and K11's below.
# Each such row prints its earlier time beside the new one as prev_ms,
# labelled as quoted; it is not measured in the run, so the kernels line
# leaves it out.
PREV_MS = {
    "gemm": {
        "m=16 n=2048 k=2048 bf16 nn": 0.0459,
        "m=2048 n=2048 k=2048 bf16 nn": 0.1041,
        "m=16 n=512 k=2048 bf16 nn": 0.0451,
        "m=2048 n=512 k=2048 bf16 nn": 0.0464,
        "m=16 n=22016 k=2048 bf16 nn": 0.0631,
        "m=2048 n=22016 k=2048 bf16 nn": 1.1894,
        "m=16 n=2048 k=11008 bf16 nn": 0.2276,
        "m=2048 n=2048 k=11008 bf16 nn": 0.5061,
        "m=16 n=2816 k=2048 bf16 nn": 0.0464,
        "m=2048 n=2816 k=2048 bf16 nn": 0.1499,
        "m=16 n=2048 k=1408 bf16 nn": 0.0337,
        "m=2048 n=2048 k=1408 bf16 nn": 0.0757,
        "m=2048 n=2048 k=2048 fp16 nn": 0.1049,
        "m=2048 n=2048 k=2048 f32 nn": 1.0557,
        "m=2048 n=2048 k=2048 bf16 nt": 0.1244,
        "m=2048 n=2048 k=2048 bf16 tn": 0.1068,
        "m=2048 n=2048 k=2048 bf16 tt": 0.1058,
        "m=33 n=97 k=1000 bf16 nn": 0.08,
        "batch=4 m=2048 n=2048 k=2048 bf16 nn": 0.3822,
        "m=1279 n=5003 k=7681 bf16 nn": 2.9927,
        "m=1279 n=5120 k=7808 bf16 nn": 0.7383,
        "m=3511 n=6151 k=8191 bf16 nn": 11.4618,
        "m=3511 n=6272 k=8192 bf16 nn": 2.2072,
        "m=5119 n=6997 k=9901 bf16 nn": 21.609,
        "m=5119 n=7040 k=9984 bf16 nn": 4.18,
        "m=4096 n=4096 k=4096 bf16 nn": 0.8235,
    },
    # K7's (int8_tile route) and K11's (mma_tile route) before theirs:
    # measured, not quoted from a report — the mean of two runs of this
    # script's phase 2 on the tree before the redesign, alternated with
    # two on the redesign in one run on one card (cold ms, the reps
    # queued behind timing.cold_ms's spin; NVIDIA H100 80GB HBM3,
    # 700.00 W).
    "int8_gemm": {
        "m=16 n=2048 k=2048": 0.022,
        "m=2048 n=2048 k=2048": 0.0606,
        "m=16 n=22016 k=2048": 0.0364,
        "m=2048 n=22016 k=2048": 0.6352,
        "m=16 n=2048 k=11008": 0.0866,
        "m=2048 n=2048 k=11008": 0.2687,
    },
    "gemm_ksplit": {
        "m=16 n=2048 k=11008 bf16 k_split=4": 0.0737,
        "m=16 n=2048 k=11008 bf16 k_split=3": 0.0915,
    },
    # K1's and K3's before their ring route: the mean of two runs of
    # this script's phase 2 (scripts/phase2_ab.py) on the tree before the
    # redesign, all on the tile route (cold ms, the reps queued behind
    # timing.cold_ms's spin; NVIDIA H100 80GB HBM3, 700.00 W).
    "fp8_gemm": {
        "m=16 n=2048 k=2048": 0.0274,
        "m=2048 n=2048 k=2048": 0.0787,
        "m=16 n=512 k=2048": 0.0269,
        "m=2048 n=512 k=2048": 0.0312,
        "m=16 n=22016 k=2048": 0.0412,
        "m=2048 n=22016 k=2048": 0.7399,
        "m=16 n=2048 k=11008": 0.1312,
        "m=2048 n=2048 k=11008": 0.3827,
        "m=16 n=2816 k=2048": 0.0275,
        "m=2048 n=2816 k=2048": 0.1053,
        "m=16 n=2048 k=1408": 0.0211,
        "m=2048 n=2048 k=1408": 0.0576,
        "m=64 n=512 k=2048": 0.0281,
        "m=4096 n=4096 k=4096": 0.5569,
        "m=64 n=2048 k=2048": 0.0289,
        "m=64 n=22016 k=2048": 0.043,
        "m=64 n=2048 k=11008": 0.1431,
        "m=64 n=2816 k=2048": 0.0293,
        "m=64 n=2048 k=1408": 0.0222,
        "m=64 n=16384 k=7168": 0.1047,
        "m=64 n=2048 k=7168": 0.0903,
        "m=64 n=7168 k=16384": 0.1908,
    },
    "grouped_gemm": {
        "E=32 cap=96 valid_rows=96 n=2816 k=2048": 0.1188,
        "E=32 cap=96 valid_rows=96 n=2048 k=1408": 0.0686,
        "E=32 cap=12288 valid_rows=12288 n=2816 k=2048": 1.3181,
        "E=32 cap=12288 valid_rows=12288 n=2048 k=1408": 0.8447,
        "E=64 cap=96 valid_rows=96 n=2816 k=2048": 0.1954,
        "E=64 cap=96 valid_rows=96 n=2048 k=1408": 0.1029,
        "E=64 cap=12288 valid_rows=12288 n=2816 k=2048": 2.1355,
        "E=64 cap=12288 valid_rows=12288 n=2048 k=1408": 1.4152,
        "E=8 cap=128 valid_rows=1024 n=2048 k=512": 0.0179,
        "E=32 cap=384 valid_rows=384 n=2816 k=2048": 0.1457,
        "E=32 cap=384 valid_rows=384 n=2048 k=1408": 0.0883,
        "E=64 cap=384 valid_rows=384 n=2816 k=2048": 0.2671,
        "E=64 cap=384 valid_rows=384 n=2048 k=1408": 0.1552,
        "E=8 cap=512 valid_rows=19 n=4096 k=7168": 0.1579,
        "E=8 cap=512 valid_rows=19 n=7168 k=2048": 0.1055,
    },
    # K2's (route span) and K6's (int8_tile) before their redesign: the
    # mean of the two runs of this script's phase 2 on the tree before it
    # in one scripts/phase2_ab.py call beside two on the redesign (cold
    # ms; NVIDIA H100 80GB HBM3, 700.00 W); the serving-length K2 row,
    # which that tree lacks, from its span_ms in the redesign's two runs
    # (the same kernel on the same inputs).
    "flash_decode": {
        "b=16 kvh=4 g=4 S=4096 sum_len=34911": 0.0878,
        "b=16 kvh=16 g=1 S=4096 sum_len=35489": 0.1262,
        "b=16 kvh=16 g=8 S=4096 sum_len=29067": 0.1751,
        "b=16 kvh=4 g=4 S=4096 sum_len=8848 lengths=serving": 0.0706,
        "b=64 kvh=4 g=4 S=4096 sum_len=118269": 0.1251,
        "b=16 kvh=4 g=4 S=80 sum_len=663": 0.0233,
        "b=16 kvh=4 g=4 S=104 sum_len=859": 0.0252,
        "b=64 kvh=16 g=1 S=2048 sum_len=73752": 0.2128,
        "b=64 kvh=16 g=8 S=2048 sum_len=73752": 0.3754,
    },
    "int8_grouped_masked": {
        "E=32 cap=96 valid_rows=96 n=2816 k=2048": 0.1115,
        "E=32 cap=96 valid_rows=96 n=2048 k=1408": 0.0685,
        "E=32 cap=12288 valid_rows=12288 n=2816 k=2048": 1.3914,
        "E=32 cap=12288 valid_rows=12288 n=2048 k=1408": 0.9461,
        "E=64 cap=96 valid_rows=96 n=2816 k=2048": 0.1767,
        "E=64 cap=96 valid_rows=96 n=2048 k=1408": 0.0977,
        "E=64 cap=384 valid_rows=384 n=2816 k=2048": 0.2532,
        "E=64 cap=384 valid_rows=384 n=2048 k=1408": 0.1528,
        "E=8 cap=512 valid_rows=19 n=4096 k=7168": 0.1717,
        "E=8 cap=512 valid_rows=19 n=7168 k=2048": 0.0989,
    },
    "fp8_gemm_folded": {
        "m=64 n=512 k=2048 b_layout=t": 0.0377,
        "m=16 n=2048 k=2048 b_layout=t": 0.0376,
        "m=2048 n=2048 k=2048 b_layout=t": 0.1028,
        "m=16 n=512 k=2048 b_layout=t": 0.0382,
        "m=2048 n=512 k=2048 b_layout=t": 0.0393,
        "m=16 n=22016 k=2048 b_layout=t": 0.0525,
        "m=2048 n=22016 k=2048 b_layout=t": 1.0136,
        "m=16 n=2048 k=11008 b_layout=t": 0.1807,
        "m=2048 n=2048 k=11008 b_layout=t": 0.505,
        "m=16 n=2816 k=2048 b_layout=t": 0.0376,
        "m=2048 n=2816 k=2048 b_layout=t": 0.1384,
        "m=16 n=2048 k=1408 b_layout=t": 0.028,
        "m=2048 n=2048 k=1408 b_layout=t": 0.0732,
        "m=2048 n=2048 k=2048 b_layout=n": 0.2651,
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def within_one_bf16_ulp(got: torch.Tensor, ref: torch.Tensor) -> bool:
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    tiny = 1e-6 * float(ref.abs().max())
    return bool(((got - ref).abs() <= ulp + tiny).all())


def gemm_close(got: torch.Tensor, ref: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> bool:
    """K10/K11 against the plain f32 product of the logical a (…, m, k) and
    b (…, k, n): f32 outputs within GEMM_REL_TOL of Σ|a·b|; a 16-bit output
    (both sides rounded once from such f32 sums) within that plus one ulp
    of its type."""
    if not bool(torch.isfinite(got).all()):
        return False
    g, r = got.float(), ref.float()
    tol = GEMM_REL_TOL * torch.matmul(a.float().abs(), b.float().abs())
    if got.dtype != torch.float32:
        tol = tol + torch.finfo(got.dtype).eps * torch.maximum(g.abs(),
                                                               r.abs())
    return bool(((g - r).abs() <= tol).all())


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
    sm90 = sm90_instances(_kernels.build_log())
    for inst in sm90:
        log(f"  ptxas {inst}")
    return {"name": name, "count": count, "smi": smi, "build_s": build_s,
            "sm90_instances": sm90}


def sm90_instances(logs: dict) -> list:
    """Stack, spills and registers of every instance of the Hopper kernels
    (K10's and K11's wgmma and ffma routes, K12, K7's wgmma route, K1's and
    K3's ring, K6's ring and wgmma routes, K2's, K5a's and K5b's live
    route, K8's wgmma16 route and its probe, K9's wgmma route), from nvcc's
    -Xptxas -v, under
    their mangled names (the template arguments: tile, stages, layout
    flags, types)."""
    out = []
    for text in logs.values():
        lines = text.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(
                    kern in ln for kern in ("gemm_sm90", "folded_sm90",
                                            "int8_sm90", "ring_kernel",
                                            "masked_sm90", "live_kernel",
                                            "contiguous_sm90", "wgmma16",
                                            "gemm_ffma")):
                props = " ".join(x.strip() for x in lines[i + 2:i + 4])
                name = ln.split("'")[1]
                out.append(f"{name}: {props}")
    return out


# ---------------------------------------------------------------- phase 2

def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


def launch_plans() -> dict:
    """Each kernel's launches since the counters were zeroed, by the plan
    its wrapper counted (K1 and K3: route, ring tile, splits)."""
    return {n: dict(c.plans) for n, c in _kernels.COUNTERS.items()
            if c.plans}


def launched_plan(counter, run):
    """Runs ``run`` once: its output, and the route, ring tile and splits
    of the plan its wrapper counted for the launch (``Counter.plans``:
    "tile", "ring 16x64", "ring 16x64/4")."""
    counter.plans.clear()
    out = run()
    plans = list(counter.plans)
    if len(plans) != 1:
        raise RuntimeError(f"{counter.name}: one launch counted {plans}")
    if plans[0] == "tile":
        return out, {"route": "tile"}
    tile, _, splits = plans[0].split()[1].partition("/")
    return out, {"route": "ring", "ring_tile": tile,
                 "splits": int(splits or 1)}


def launched_route(counter, run):
    """Runs ``run`` once: its output and the plan its wrapper counted for
    the launch, as ``route`` (K2: "live/<blocks>" or "span/<keys>"; K6:
    "ring 16x64", "wgmma 128x256", "int8_tile")."""
    counter.plans.clear()
    out = run()
    plans = list(counter.plans)
    if len(plans) != 1:
        raise RuntimeError(f"{counter.name}: one launch counted {plans}")
    return out, {"route": plans[0]}


def launched_tile(counter, run):
    """``launched_route`` for K10, K11 and K7, whose wrappers count a
    launch as "<route> <rows>x<cols>": the route and the tile apart."""
    out, plan = launched_route(counter, run)
    rt, _, tile = plan["route"].partition(" ")
    return out, {"route": rt, "tile": tile}


def k10_config(a_in, b_in, layout, m, n, batch=1, splits=1, rt=None):
    """K10's config (K11's with ``splits`` > 1) on the tile the kernels
    pick for this grid on the route the operands take
    (``analytic.default_tile``; the analytic answer without its split
    gate)."""
    rt = rt or gemm_route(a_in, b_in, layout)
    bm, bn = analytic.default_tile("gemm", rt, m, n, max(batch, 1), splits)
    if splits > 1:
        return GemmConfig(bm, bn, 64, kernel_type=KernelType.KSPLIT,
                          k_split=splits)
    return GemmConfig(bm, bn, 64)


def check_fp8_gemm(m: int, n: int, k: int, seed: int,
                   b_layout: str = "t") -> dict:
    """K1 on weights stored as the port stores them ('t': the ring route),
    or on the same weights stored (k, n) ('n': the tile route), which is
    then also held bit for bit against the unsplit ring on the 't'
    weights."""
    g = _gen(seed)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m, k, generator=g, device=DEV))
    b_nk, bs_nk = quant.quantize_fp8_weight(
        torch.randn(n, k, generator=g, device=DEV) / math.sqrt(k))
    b_q, b_s = ((b_nk, bs_nk) if b_layout == "t"
                else (b_nk.t().contiguous(), bs_nk.t().contiguous()))
    run = lambda: fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout)
    plain = lambda: fp8mod.fp8_gemm_plain(a_q, a_s, b_nk, bs_nk.t(),
                                          b_t=True)
    got, plan = launched_plan(fp8mod.COUNTER, run)
    ref = plain()
    torch.cuda.synchronize()
    ok = within_one_bf16_ulp(got, ref) and bool(torch.isfinite(got).all())
    extra = {}
    if b_layout == "n":
        ring = fp8mod._launch(a_q, a_s, b_nk, bs_nk.t(), fp8mod._SHIFT, True,
                              torch.bfloat16,
                              plan=("ring", fp8mod.ring_tile(m), 1))
        torch.cuda.synchronize()
        extra["ring_equals_tile"] = bool(torch.equal(ring, got))
        ok &= extra["ring_equals_tile"]
    kb = k // 128
    nbytes = m * k + m * kb * 4 + n * k + (n // 128) * kb * 4 + m * n * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k, FP8_OPS_PER_S)
    shape = f"m={m} n={n} k={k}" + ("" if b_layout == "t" else " b=(k, n)")
    return {"shape": shape, "ok": ok,
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, **plan, **extra,
            "prev_ms": PREV_MS["fp8_gemm"].get(shape)}


def _masked_m(e: int, tokens: int, top_k: int, seed: int) -> torch.Tensor:
    """Expert loads from routing random tokens through a random router."""
    g = _gen(seed)
    router = BF16Linear.create(g, 2048, e, init_scale=0.02, device=DEV)
    x = torch.randn(tokens, 2048, generator=g, device=DEV).to(torch.bfloat16)
    _, idx = route_topk(router(x), top_k)
    return dispatch_masked(idx, e)[1]


def check_grouped(e: int, tokens: int, n: int, k: int, seed: int,
                  top_k: int = 6, loads=None, expected_m="mean",
                  b_layout: str = "t") -> dict:
    """K3 at capacity tokens·top_k; the loads are ``loads`` (one per local
    expert) or those of routing the tokens over ``e`` experts. The tile's
    hint ``expected_m`` is the MoE layer's (ceil(tokens·top_k / e)) unless
    given. 'n': the same weights stored (E, k, n), the tile route, held
    bit for bit against the ring on the 't' weights on the valid rows."""
    cap = tokens * top_k
    if expected_m == "mean":
        expected_m = -(-cap // e)
    masked_m = _masked_m(e, tokens, top_k, seed) if loads is None else loads
    e = masked_m.numel()
    g = _gen(seed + 1)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(e, cap, k, generator=g, device=DEV))
    b_nk, bs_nk = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=DEV) / math.sqrt(k))
    b_q, b_s = ((b_nk, bs_nk) if b_layout == "t"
                else (b_nk.transpose(1, 2).contiguous(),
                      bs_nk.transpose(1, 2).contiguous()))
    run = lambda: ggmod.m_grouped_gemm_masked(a_q, a_s, b_q, b_s, masked_m,
                                              b_layout=b_layout,
                                              expected_m=expected_m)
    plain = lambda: ggmod.grouped_gemm_masked_plain(
        a_q, a_s, b_nk, bs_nk.transpose(1, 2), masked_m, b_t=True)
    got, plan = launched_plan(ggmod.COUNTER, run)
    ref = plain()
    ring = (ggmod._launch(a_q, a_s, b_nk, bs_nk.transpose(1, 2),
                          fp8mod._SHIFT, masked_m, True, torch.bfloat16,
                          expected_m=expected_m)
            if b_layout == "n" else None)
    torch.cuda.synchronize()
    rows = masked_m.tolist()
    ok, err = True, 0.0
    for ei, r in enumerate(rows):
        if r:
            ok &= within_one_bf16_ulp(got[ei, :r], ref[ei, :r])
            err = max(err, float((got[ei, :r].float()
                                  - ref[ei, :r].float()).abs().max()))
    extra = {}
    if ring is not None:
        extra["ring_equals_tile"] = all(
            torch.equal(ring[ei, :r], got[ei, :r]) for ei, r in
            enumerate(rows))
        ok &= extra["ring_equals_tile"]
    valid = sum(rows)
    active = sum(1 for r in rows if r)
    kb = k // 128
    nbytes = (valid * (k + kb * 4) + active * (n * k + (n // 128) * kb * 4)
              + valid * n * 2 + e * 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * valid * n * k, FP8_OPS_PER_S)
    shape = (f"E={e} cap={cap} valid_rows={valid} n={n} k={k}"
             + ("" if b_layout == "t" else " b=(E, k, n)"))
    return {"shape": shape, "ok": ok, "max_abs_err": err, "ms": cold_ms(run),
            "plain_ms": cold_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by, **plan, "expected_m": expected_m,
            **extra, "prev_ms": PREV_MS["grouped_gemm"].get(shape)}


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
                "rel_l2_vs_k1": rel, "ms": cold_ms(call), "refused": refused}
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
    return {"library_ms": cold_ms(call),
            "library_note": "torch._int_mm (int32 product only)"}


def check_int8_gemm(m: int, n: int, k: int, seed: int) -> dict:
    """K7 with B stored (n, k), bit for bit against its plain version; its
    route (``ops.int8_gemm.route``: wgmma where k is a multiple of 16) and
    its time before the Hopper redesign (``PREV_MS``, quoted)."""
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k), seed)
    run = lambda: i8mod.int8_gemm(a_q, a_s, b_q, b_s, b_layout="t")
    plain = lambda: i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s, b_t=True)
    got, plan = launched_tile(i8mod.K7, run)
    ref = plain()
    torch.cuda.synchronize()
    ok = torch.equal(got, ref) and bool(torch.isfinite(got).all())
    nbytes = m * k + m * 4 + n * k + n * 4 + m * n * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
    shape = f"m={m} n={n} k={k}"
    return {"shape": shape, "ok": ok, **plan,
            "prev_ms": PREV_MS["int8_gemm"].get(shape),
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            **_int_mm_yardstick(a_q, b_q)}


def check_int8_masked(e: int, tokens: int, n: int, k: int, seed: int,
                      top_k: int = 6, loads=None, expected_m="mean",
                      b_layout: str = "t") -> dict:
    """K6, with the capacity, loads and route hint (the MoE layer's
    ``expected_m``) of :func:`check_grouped`; its route and tile as its
    wrapper counted them, and its time before the redesign (``PREV_MS``,
    quoted). 'n': the same weights stored (E, k, n), route int8_tile,
    also held bit for bit against the route the hint picks for the 't'
    weights on the valid rows."""
    cap = tokens * top_k
    if expected_m == "mean":
        expected_m = -(-cap // e)
    masked_m = _masked_m(e, tokens, top_k, seed) if loads is None else loads
    e = masked_m.numel()
    a_q, a_s, b_nk, b_s = _int8_operands((e, cap, k), (e, n, k), seed + 1)
    b_q = b_nk if b_layout == "t" else b_nk.transpose(1, 2).contiguous()
    run = lambda: i8mod.m_grouped_int8_gemm_masked(a_q, a_s, b_q, b_s,
                                                   masked_m,
                                                   b_layout=b_layout,
                                                   expected_m=expected_m)
    plain = lambda: i8mod.grouped_masked_plain(a_q, a_s, b_nk, b_s, masked_m,
                                               b_t=True)
    got, plan = launched_route(i8mod.K6, run)
    ref = plain()
    hinted = (i8mod._launch_masked(a_q, a_s, b_nk, b_s, masked_m, True,
                                   torch.bfloat16, expected_m=expected_m)
              if b_layout == "n" else None)
    torch.cuda.synchronize()
    rows = masked_m.tolist()
    ok, err = True, 0.0
    for ei, r in enumerate(rows):
        if r:
            ok &= torch.equal(got[ei, :r], ref[ei, :r])
            err = max(err, float((got[ei, :r].float()
                                  - ref[ei, :r].float()).abs().max()))
    extra = {}
    if hinted is not None:
        extra["ring_equals_tile"] = all(
            torch.equal(hinted[ei, :r], got[ei, :r])
            for ei, r in enumerate(rows))
        ok &= extra["ring_equals_tile"]
    valid = sum(rows)
    active = sum(1 for r in rows if r)
    nbytes = (valid * (k + 4) + active * (n * k + n * 4) + valid * n * 2
              + e * 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * valid * n * k, INT8_OPS_PER_S)
    shape = (f"E={e} cap={cap} valid_rows={valid} n={n} k={k}"
             + ("" if b_layout == "t" else " b=(E, k, n)"))
    return {"shape": shape, "ok": ok, "max_abs_err": err, "ms": cold_ms(run),
            "plain_ms": cold_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by, **plan, "expected_m": expected_m, **extra,
            "prev_ms": PREV_MS["int8_grouped_masked"].get(shape),
            "library_ms": None,
            "library_note": "none: no PyTorch call runs a masked grouped "
                            "int8 product"}


def check_int8_contiguous(e: int, tokens: int, n: int, k: int,
                          seed: int) -> dict:
    """K9 on expert loads from routing ``tokens`` × top-6 through a random
    router, laid out by make_contiguous_layout at block_m = 128: its route
    as its wrapper counted it (``contiguous_route``: wgmma for B stored
    K-major), bit for bit against its plain version and against the route
    before the redesign, int8_tile, timed beside it in the same run
    (``old_route_ms``)."""
    counts = _masked_m(e, tokens, 6, seed).tolist()
    m, gids, _ = ggmod.make_contiguous_layout(counts, 128)
    a_q, a_s, b_q, b_s = _int8_operands((m, k), (e, n, k), seed + 1)
    ids = torch.from_numpy(gids)
    run = lambda: i8mod.m_grouped_int8_gemm_contiguous(a_q, a_s, b_q, b_s,
                                                       ids, b_layout="t")
    plain = lambda: i8mod.grouped_contiguous_plain(a_q, a_s, b_q, b_s, ids,
                                                   b_t=True)
    old = lambda: i8mod._launch_contiguous(a_q, a_s, b_q, b_s, ids, 128,
                                           True, torch.bfloat16,
                                           plan=("int8_tile", 0))
    got, plan = launched_route(i8mod.K9, run)
    ref, before = plain(), old()
    torch.cuda.synchronize()
    equals_old = bool(torch.equal(got, before))
    active = sum(1 for c in counts if c)
    nbytes = m * (k + 4) + active * (n * k + n * 4) + m * n * 2 + gids.size * 4
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
    return {"shape": f"E={e} M_total={m} tokens={sum(counts)} n={n} k={k}",
            "ok": torch.equal(got, ref) and equals_old, **plan,
            "equals_old_route": equals_old,
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": cold_ms(run), "old_route_ms": cold_ms(old),
            "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "none: no PyTorch call runs a grouped int8 "
                            "product"}


def _int8_cache(b, kvh, s_max, seed, hd=128):
    g = _gen(seed)
    kq = torch.randint(-127, 128, (b, kvh, s_max, hd), generator=g,
                       device=DEV, dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, kvh, s_max, hd), generator=g,
                       device=DEV, dtype=torch.int8)
    ks = torch.rand(b, kvh, s_max, generator=g, device=DEV) * 0.02 + 1e-3
    vs = torch.rand(b, kvh, s_max, generator=g, device=DEV) * 0.02 + 1e-3
    return kq, ks, vq, vs


# Phase 4's decode lengths: prompts of 16..1024 tokens and up to 32 new
# ones (the serving-length K2 row).
SERVING_LENGTHS = (16, 1024 + 32)


def check_flash_decode(kvh: int, g: int, seed: int, b: int = 16,
                       s_max: int = 4096, lengths=None,
                       contract_only: bool = False, hd: int = 128) -> dict:
    """K2 on its own route (``flash_decode.route``: "live" on a grid of
    ``live_blocks``), against its plain version (output within ATTN_TOL
    and per element within ``flash_common.output_close``, caches bit for
    bit), beside route "span" (the design before, timed on the same
    inputs, held the same way). Lengths: from 1..S with a fresh, a full
    and a freed slot, or ``lengths="serving"``: phase 4's.
    ``contract_only``: the output is held to ``output_close`` alone (a
    cache of tens of keys, where the bf16 rounding of w against the
    running max, which the contract bounds, passes ATTN_TOL for some
    draws: 2.1-3.3e-3 in 6 of 30 seeds at S = 80..104 on the card).
    ``hd`` 64: K2's own route is "span" too."""
    cache = _int8_cache(b, kvh, s_max, seed, hd)
    gen = _gen(seed + 1)
    q = torch.randn(b, kvh * g, hd, generator=gen, device=DEV).to(
        torch.bfloat16)
    k_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=DEV,
                          dtype=torch.int8)
    v_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=DEV,
                          dtype=torch.int8)
    ks_new = torch.rand(b, kvh, generator=gen, device=DEV) * 0.02
    vs_new = torch.rand(b, kvh, generator=gen, device=DEV) * 0.02
    rng = np.random.default_rng(seed)
    if lengths == "serving":
        lens_np = rng.integers(*SERVING_LENGTHS, endpoint=True, size=b)
    else:
        lens_np = rng.integers(1, s_max + 1, size=b)
        lens_np[:3] = [1, s_max, s_max]  # a fresh slot, a full and a freed one
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(DEV)
    kc = [t.clone() for t in cache]
    pc = [t.clone() for t in cache]
    sc = [t.clone() for t in cache]
    new = (k_new, v_new, ks_new, vs_new)
    run = lambda: fdmod.flash_decode_gqa_inplace(q, *kc, *new, lens)[0]
    span = lambda: fdmod._launch_inplace(
        q, *sc, *new, lens, plan=("span", fdmod.SPLIT_KEYS))[0]
    plain = lambda: fdmod.flash_decode_inplace_plain(
        q, *pc, *new, lens).reshape(b, kvh * g, hd)
    got, plan = launched_route(fdmod.COUNTER, run)
    ref, by_span = plain(), span()
    k_q, k_s, v_abs, v_s = (t.clone() for t in abs_v(cache))
    pv = fdmod.flash_decode_inplace_plain(
        q, k_q, k_s, v_abs, v_s, k_new, v_new.float().abs(), ks_new, vs_new,
        lens).reshape(b, kvh * g, hd)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    caches_equal = all(torch.equal(x, y) and torch.equal(z, y)
                       for x, y, z in zip(kc, pc, sc))
    span_err = float((by_span - ref).abs().max())
    close = output_close(got, ref, pv) and output_close(by_span, ref, pv)
    within_tol = contract_only or (err < ATTN_TOL and span_err < ATTN_TOL)
    total = int(np.minimum(lens_np, s_max).sum())
    nbytes = (q.numel() * 2 + kvh * total * (2 * hd + 8)
              + b * kvh * 2 * (2 * hd + 8) + got.numel() * 4 + b * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * kvh * g * hd * total, BF16_OPS_PER_S)
    shape = (f"b={b} kvh={kvh} g={g} S={s_max} sum_len={total}"
             + (" lengths=serving" if lengths == "serving" else "")
             + (f" hd={hd}" if hd != 128 else ""))
    return {"shape": shape, "ok": within_tol and close and caches_equal,
            "max_abs_err": err, "caches_equal": caches_equal, **plan,
            "ms": cold_ms(run), "span_ms": cold_ms(span),
            "prev_ms": PREV_MS["flash_decode"].get(shape),
            "plain_ms": cold_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by}


# Phase 4's largest prefill bucket: the 1024-bucket prompts among the first
# 16 admitted requests of its default_rng(2) draw, and the padding row
# (length 1) that rounds the bucket's rows up to 8.
BUCKET_1024_LENS = (861, 837, 621, 836, 751, 1017, 904, 1)


def _prefill_inputs(b, s, s_max, start, lens, seed, hd=128):
    """The int8 cache, bf16 q, starts and lengths of a K4 row: every
    sequence from ``start``, of length start + s unless ``lens`` says."""
    kvh, g = 4, 4
    cache = _int8_cache(b, kvh, s_max, seed, hd)
    q = torch.randn(b, s, kvh * g, hd, generator=_gen(seed + 1),
                    device=DEV).to(torch.bfloat16)
    st_np = np.full(b, start, np.int32)
    lens_np = (np.asarray(lens, np.int32) if lens is not None
               else np.maximum(st_np + s, 1).astype(np.int32))
    return (cache, q, torch.from_numpy(st_np).to(DEV),
            torch.from_numpy(lens_np).to(DEV), st_np, lens_np)


def sdpa_bf16_ms(q, cache, s):
    """A yardstick, not the same function: PyTorch's causal GQA attention
    (``scaled_dot_product_attention``, ``is_causal``, ``enable_gqa``) on
    bf16 K/V dequantized beforehand, over the first s keys (at start 0
    they are every key a row sees)."""
    kq, ks, vq, vs = cache
    k = (kq[:, :, :s].float() * ks[:, :, :s, None]).to(torch.bfloat16)
    v = (vq[:, :, :s].float() * vs[:, :, :s, None]).to(torch.bfloat16)
    qt = q.transpose(1, 2)
    return cold_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, k, v, is_causal=True, enable_gqa=True))


def check_flash_prefill(start: int, seed: int, b: int = 4, s: int = 512,
                        s_max: int = 4096, lens=None, hd: int = 128) -> dict:
    """K4 against its plain version: within ATTN_TOL and per element
    within ``flash_common.output_close``. ``lens``: phase 4's bucket
    lengths (else start + s each). Rows from start 0 also time PyTorch's
    bf16 attention beside it (``sdpa_bf16_ms``). ``hd`` 64: the kernel on
    the CUDA cores."""
    cache, q, st, lens_t, st_np, lens_np = _prefill_inputs(
        b, s, s_max, start, lens, seed, hd)
    kvh = cache[0].shape[1]
    run = lambda: fpmod.flash_prefill_gqa(q, *cache, st, lens_t)
    qg = _kernel_layout(q, kvh)
    plain = lambda: fpmod.flash_prefill_plain(qg, *cache, st, lens_t)
    got = run()
    ref = _rows(plain())
    pv = _rows(fpmod.flash_prefill_plain(qg, *abs_v(cache), st, lens_t))
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    # The bucket row (32768 rows over up to 1017 keys) is held to the
    # per-element contract alone: the bf16 rounding of w against the
    # running max, which it bounds, reaches 2.03e-3 there (the kernel
    # before this one rounds at the same points), past the absolute
    # ATTN_TOL that the other rows keep.
    ok = output_close(got, ref, pv) and (lens is not None or err < ATTN_TOL)
    del ref, pv
    b_ms, b_by = prefill_sweep.k4_bound(b, kvh, 4, s, s_max, st_np.tolist(),
                                        lens_np.tolist(), hd=hd)
    shape = (f"b={b} s={s} start={start} kvh={kvh} g=4 S={s_max}"
             + (" lens=phase4" if lens is not None else "")
             + (f" hd={hd}" if hd != 128 else ""))
    return {"shape": shape, "ok": ok, "max_abs_err": err, "ms": cold_ms(run),
            "plain_ms": cold_ms(plain, reps=3), "bound_ms": b_ms,
            "bound_by": b_by,
            **({"sdpa_bf16_ms": sdpa_bf16_ms(q, cache, s)} if start == 0
               else {})}


_ITEMSIZE = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4}


def _dense_operands(lead, m, n, k, dtype, layout, seed):
    """Stored operands of a dense GEMM (A (…, k, m) for layout "t…", B
    (…, n, k) for "…t") and their logical (…, m, k) / (…, k, n) views."""
    g = _gen(seed)
    a = torch.randn(*lead, m, k, generator=g, device=DEV).to(dtype)
    b = (torch.randn(*lead, k, n, generator=g, device=DEV)
         / math.sqrt(k)).to(dtype)
    a_in = a.transpose(-1, -2).contiguous() if layout[0] == "t" else a
    b_in = b.transpose(-1, -2).contiguous() if layout[1] == "t" else b
    return a_in, b_in, a_in.transpose(-1, -2) if layout[0] == "t" else a_in, \
        b_in.transpose(-1, -2) if layout[1] == "t" else b_in


def _gemm_bound(batch, m, n, k, dtype):
    nbytes = batch * ((m * k + k * n) * _ITEMSIZE[dtype] + m * n * 4)
    peak = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    return bound_ms(nbytes, 2.0 * batch * m * n * k, peak)


def _picked(m, n, k, dtype) -> str:
    cfg = select_config(m, n, k, dtype, torch.float32, device=DEV)
    return cfg.kernel_type.name + (f"/{cfg.k_split}" if cfg.k_split > 1
                                   else "")


def check_gemm(m: int, n: int, k: int, seed: int, dtype=torch.bfloat16,
               layout: str = "nn", batch: int = 0) -> dict:
    """K10 (forced: COMMON on the tile the kernels pick there,
    ``k10_config``) against its plain version; ``batch`` > 0 runs
    ``bgemm`` over that many products in one launch. Its route and tile
    as its wrapper counted them (``ops.gemm.route``: wgmma where TMA can
    describe 16-bit operands, ffma for f32 ones that 16-byte loads can
    read, else mma_tile), its time before the Hopper redesign, and for
    16-bit inputs its time with bf16 output: the like-for-like yardstick of
    torch.matmul (cuBLAS), which stores 16-bit outputs, half of K10's f32
    store. On route ffma also the f32 route before it, mma_tile, timed in
    the same run and equal bit for bit (``equals_old_route``)."""
    lead = (batch,) if batch else ()
    a_in, b_in, a, b = _dense_operands(lead, m, n, k, dtype, layout, seed)
    a_t, b_t = layout[0] == "t", layout[1] == "t"
    cfg = k10_config(a_in, b_in, layout, m, n, batch)

    def run(out_dtype=torch.float32, plan=None):
        c = cfg if plan is None else k10_config(a_in, b_in, layout, m, n,
                                                batch, rt=plan)
        if batch:
            return bgemm(a_in, b_in, config=c, out_dtype=out_dtype,
                         plan=plan)
        return gemm_with_config(a_in, b_in, config=c, layout=layout,
                                out_dtype=out_dtype, plan=plan)

    plain = lambda: gemm_plain(a_in, b_in, a_t=a_t, b_t=b_t)
    got, plan = launched_tile(_kernels.COUNTERS["gemm"], run)
    ref = plain()
    extra = {}
    if plan["route"] == "ffma":
        old = lambda: run(plan="mma_tile")
        before = old()
        torch.cuda.synchronize()
        extra = {"equals_old_route": bool(torch.equal(got, before)),
                 "old_route_ms": cold_ms(old)}
    torch.cuda.synchronize()
    b_ms, b_by = _gemm_bound(max(batch, 1), m, n, k, dtype)
    name = {torch.bfloat16: "bf16", torch.float16: "fp16",
            torch.float32: "f32"}[dtype]
    shape = (f"batch={batch} " if batch else "") + \
        f"m={m} n={n} k={k} {name} {layout}"
    ok = gemm_close(got, ref, a, b) and extra.get("equals_old_route", True)
    bf16_ms = None
    if dtype != torch.float32:
        got16 = run(torch.bfloat16)
        ref16 = gemm_plain(a_in, b_in, a_t=a_t, b_t=b_t,
                           out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ok = ok and gemm_close(got16, ref16, a, b)
        bf16_ms = cold_ms(lambda: run(torch.bfloat16))
    return {"shape": shape, "dtype": dtype,
            "picked": _picked(m, n, k, dtype), **plan, **extra,
            "ok": ok,
            "max_abs_err": float((got - ref).abs().max()),
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "prev_ms": PREV_MS["gemm"].get(shape),
            "bf16_out_ms": bf16_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cold_ms(lambda: torch.matmul(a, b)),
            "library_note": "torch.matmul (cuBLAS) on the same operands; "
                            + ("f32 output" if dtype == torch.float32 else
                               "16-bit output (bf16_out_ms is K10's)")}


def check_ksplit(m: int, n: int, k: int, splits: int, seed: int,
                 why: str, dtype=torch.bfloat16) -> dict:
    """K11 with ``splits`` splits against its plain version, its route and
    tile as its wrapper counted them and its time before the Hopper
    redesign (``PREV_MS``, quoted), and K10 (``k10_config``) timed at the
    same shape. The bound counts the f32 partials K11 writes. On route ffma
    also route mma_tile timed in the same run, its output equal bit for
    bit (``equals_old_route``)."""
    a, b, _, _ = _dense_operands((), m, n, k, dtype, "nn", seed)
    cfg = k10_config(a, b, "nn", m, n, splits=splits)
    k10 = k10_config(a, b, "nn", m, n)
    run = lambda: gemm_with_config(a, b, config=cfg)
    plain = lambda: gemm_ksplit_plain(a, b, splits)
    got, plan = launched_tile(_kernels.COUNTERS["gemm_ksplit"], run)
    ref = plain()
    extra = {}
    if plan["route"] == "ffma":
        old_cfg = k10_config(a, b, "nn", m, n, splits=splits, rt="mma_tile")
        old = lambda: gemm_with_config(a, b, config=old_cfg, plan="mma_tile")
        before = old()
        torch.cuda.synchronize()
        extra = {"equals_old_route": bool(torch.equal(got, before)),
                 "old_route_ms": cold_ms(old)}
    torch.cuda.synchronize()
    item = _ITEMSIZE[dtype]
    b_ms, b_by = bound_ms((m * k + k * n) * item + splits * m * n * 4,
                          2.0 * m * n * k, F32_OPS_PER_S
                          if dtype == torch.float32 else BF16_OPS_PER_S)
    name = "f32" if dtype == torch.float32 else "bf16"
    shape = f"m={m} n={n} k={k} {name} k_split={splits}"
    return {"shape": shape, "why": why, **plan, **extra,
            "prev_ms": PREV_MS["gemm_ksplit"].get(shape),
            "ok": gemm_close(got, ref, a, b)
                  and extra.get("equals_old_route", True),
            "max_abs_err": float((got - ref).abs().max()),
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "k10_ms": cold_ms(lambda: gemm_with_config(a, b, config=k10)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cold_ms(lambda: torch.matmul(a, b)),
            "library_note": f"torch.matmul (cuBLAS) on the same {name} "
                            f"operands; {name} output"}


def _equals_masked_k3(a_q, a_s, b_q, b_s, counts, block_m, got) -> bool:
    """Whether K3 (its ring route, as serving runs it) gives the rows of
    each expert of a contiguous layout the same bits as K8 did (``got``):
    the layout's spans copied into a masked (E, max rows, k) buffer."""
    e, k = len(counts), a_q.shape[1]
    cap = max(counts)
    starts = np.cumsum([0] + [-(-c // block_m) * block_m for c in counts])
    a3 = torch.zeros((e, cap, k), dtype=a_q.dtype, device=DEV)
    as3 = torch.zeros((e, cap, k // 128), device=DEV)
    for ei, c in enumerate(counts):
        a3[ei, :c] = a_q[starts[ei]:starts[ei] + c]
        as3[ei, :c] = a_s[starts[ei]:starts[ei] + c]
    mm = torch.tensor(counts, dtype=torch.int32, device=DEV)
    masked = ggmod.m_grouped_gemm_masked(a3, as3, b_q, b_s, mm, b_layout="t",
                                         expected_m=-(-sum(counts) // e))
    torch.cuda.synchronize()
    return all(torch.equal(masked[ei, :c], got[starts[ei]:starts[ei] + c])
               for ei, c in enumerate(counts))


def check_contiguous(e: int, tokens: int, n: int, k: int, seed: int,
                     block_m: int = 128, counts=None,
                     old_route: bool = False) -> dict:
    """K8 on the layout of ``tokens`` × top-6 routed by a random router
    (the same loads as K3's check with the same seed) or of ``counts``
    rows per expert, laid out by make_contiguous_layout at ``block_m``,
    plus one padding tile (-1) at the end, which must come out exactly
    zero; its route as its wrapper counted it (``contiguous_route``:
    wgmma16 for B stored K-major and a block_m that 64 divides, else
    tile). ``old_route``: also bit-equal to the route before the redesign
    (tile) timed beside it in the same run (``old_route_ms``), and each
    expert's rows bit-equal to K3 on the same rows (``equals_k3``)."""
    if counts is None:
        counts = _masked_m(e, tokens, 6, seed).tolist()
    _, gids, _ = ggmod.make_contiguous_layout(counts, block_m)
    gids = np.append(gids, -1).astype(np.int32)
    m = gids.size * block_m
    g = _gen(seed + 1)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m, k, generator=g, device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=DEV) / math.sqrt(k))
    ids = torch.from_numpy(gids)         # host ids: one small copy a call
    run = lambda: ggmod.m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s, ids,
                                                  b_layout="t")
    plain = lambda: ggmod.grouped_gemm_contiguous_plain(
        a_q, a_s, b_q, b_s.transpose(1, 2), ids, b_t=True)
    got, plan = launched_route(ggmod.K8, run)
    ref = plain()
    torch.cuda.synchronize()
    pad_zero = bool((got[-block_m:] == 0).all())
    ok = within_one_bf16_ulp(got, ref) and pad_zero
    extra = {}
    if old_route:
        old = lambda: ggmod._launch_contiguous(
            a_q, a_s, b_q, b_s.transpose(1, 2), fp8mod._SHIFT, ids, block_m,
            True, torch.bfloat16, plan=("tile", 0))
        before = old()
        torch.cuda.synchronize()
        extra = {"equals_old_route": bool(torch.equal(got, before)),
                 "equals_k3": _equals_masked_k3(a_q, a_s, b_q, b_s, counts,
                                                block_m, got),
                 "old_route_ms": cold_ms(old)}
        ok &= extra["equals_old_route"] and extra["equals_k3"]
    rows = m - block_m                       # rows of expert tiles
    active = sum(1 for c in counts if c)
    kb = k // 128
    nbytes = (m * (k + kb * 4) + active * (n * k + (n // 128) * kb * 4)
              + m * n * 2 + gids.size * 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * rows * n * k, FP8_OPS_PER_S)
    # The least time of a 16-bit route (wgmma16 runs the f16 tensor cores).
    f16_ms, _ = bound_ms(nbytes, 2.0 * rows * n * k, BF16_OPS_PER_S)
    return {"shape": f"E={e} block_m={block_m} M_total={m} "
                     f"tokens={sum(counts)} n={n} k={k}",
            "ok": ok, "padding_tile_zero": pad_zero, **plan, **extra,
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "bound_16bit_ms": f16_ms,
            "library_ms": None,
            "library_note": "none: no PyTorch call runs a grouped product "
                            "with blockwise fp8 scales"}


def check_fp8_folded(m: int, n: int, k: int, seed: int,
                     b_layout: str = "t") -> dict:
    """K12 against its plain version (both fold the same bf16 operands, so
    f32 sum order plus one bf16 ulp) and within FOLDED_REL_L2 of K1.
    Library yardstick: ``torch.matmul`` of the operands folded in PyTorch,
    timed alone and with the fold."""
    g = _gen(seed)
    b_t = b_layout == "t"
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m, k, generator=g, device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn((n, k) if b_t else (k, n), generator=g, device=DEV)
        / math.sqrt(k))
    bs_view = b_s.t() if b_t else b_s
    run = lambda: fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                                  scale_mode="folded", allow_relaxed=True)
    plain = lambda: fp8mod.fp8_gemm_folded_plain(a_q, a_s, b_q, bs_view,
                                                 b_t=b_t)
    fold = lambda: fp8mod.fold_operands(a_q, a_s, b_q, bs_view, b_t=b_t)
    got, ref = run(), plain()
    k1 = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout=b_layout,
                         out_dtype=torch.float32)
    a_sc, b_sc = fold()
    torch.cuda.synchronize()
    rel = float((got.float() - k1).norm() / k1.norm())
    kb = k // 128
    nbytes = m * k + m * kb * 4 + n * k + (n // 128) * kb * 4 + m * n * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k, BF16_OPS_PER_S)
    shape = f"m={m} n={n} k={k} b_layout={b_layout}"
    return {"shape": shape, "route": "wgmma",
            "prev_ms": PREV_MS["fp8_gemm_folded"].get(shape),
            "ok": gemm_close(got, ref, a_sc, b_sc) and rel < FOLDED_REL_L2,
            "rel_l2_vs_k1": rel,
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cold_ms(lambda: torch.matmul(a_sc, b_sc)),
            "library_with_fold_ms": cold_ms(lambda: torch.matmul(*fold())),
            "library_note": "torch.matmul (cuBLAS) of the bf16 operands "
                            "folded beforehand in PyTorch; bf16 output"}


def abs_v(cache):
    """The cache with |v| for v: the plain versions run on it give the
    per-element rounding scale of ``state_close`` / ``output_close``."""
    k_q, k_s, v_q, v_s = cache
    return k_q, k_s, v_q.float().abs(), v_s


def check_flash_decode_variants(kvh: int, g: int, seed: int,
                                lengths=None):
    """K5a and K5b at K2's shapes (lengths 0, 1, S and random; or
    ``lengths="serving"``: phase 4's, with one empty sequence) on their
    own route (``flash_decode.read_route``: "live" on the grid of
    ``live_blocks``), against their plain versions, per element
    (``flash_common.output_close`` / ``state_close``), and against route
    "span" (the design before, timed on the same inputs: ``old_route_ms``)
    within ATTN_TOL. K5a over the cache K2 (route "live") wrote, at K2's
    lengths, must equal K2's output bit for bit (``equals_k2_live``: the
    same plan and arithmetic), and K5b's acc / l K5a's output where l > 0
    (``acc_over_l_equals_k5a``); on one cache, K5b over the rows before
    the new one merged with the new token must match K2 within ATTN_TOL.
    Returns the K5a and the K5b result."""
    b, s_max, hd = 16, 4096, 128
    heads = kvh * g
    cache = _int8_cache(b, kvh, s_max, seed)
    gen = _gen(seed + 1)
    q = torch.randn(b, heads, hd, generator=gen, device=DEV).to(
        torch.bfloat16)
    rng = np.random.default_rng(seed)
    if lengths == "serving":
        lens_np = rng.integers(*SERVING_LENGTHS, endpoint=True, size=b)
        lens_np[0] = 0                   # an empty slot
    else:
        lens_np = rng.integers(1, s_max + 1, size=b)
        lens_np[:3] = [0, 1, s_max]      # an empty, a fresh and a full slot
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(DEV)
    span = ("span", fdmod.SPLIT_KEYS)
    read = lambda: fdmod.flash_decode_gqa(q, *cache, lens)
    state = lambda: fdmod.flash_decode_gqa_state(q, *cache, lens)
    read_span = lambda: fdmod.flash_decode_gqa(q, *cache, lens, plan=span)
    state_span = lambda: fdmod.flash_decode_gqa_state(q, *cache, lens,
                                                      plan=span)
    read_plain = lambda: fdmod.flash_decode_plain(q, *cache, lens)
    state_plain = lambda: fdmod.flash_decode_state_plain(q, *cache, lens)
    got_r, plan_r = launched_route(fdmod.READ_COUNTER, read)
    got_s, plan_s = launched_route(fdmod.STATE_COUNTER, state)
    ref_r = read_plain().reshape(b, heads, hd)
    ref_s = [x.reshape(b, heads, *x.shape[3:]) for x in state_plain()]
    by_span, state_by_span = read_span(), state_span()
    pv_r = fdmod.flash_decode_plain(q, *abs_v(cache), lens).reshape(
        b, heads, hd)
    pv_s = fdmod.flash_decode_state_plain(q, *abs_v(cache), lens)[0].reshape(
        b, heads, hd)
    # The new token at len-1: K2 over a copy of the cache, then K5a over
    # the cache it wrote; K5b over the rows before it, merged exactly.
    k_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=DEV,
                          dtype=torch.int8)
    v_new = torch.randint(-127, 128, (b, kvh, hd), generator=gen, device=DEV,
                          dtype=torch.int8)
    ks_new = torch.rand(b, kvh, generator=gen, device=DEV) * 0.02 + 1e-3
    vs_new = torch.rand(b, kvh, generator=gen, device=DEV) * 0.02 + 1e-3
    new = (k_new, v_new, ks_new, vs_new)
    written = [t.clone() for t in cache]
    k2, k2_plan = launched_route(fdmod.COUNTER, lambda: (
        fdmod.flash_decode_gqa_inplace(q, *written, *new, lens)[0]))
    read_written = fdmod.flash_decode_gqa(q, *written, lens)
    lens1 = lens.clamp(min=1)
    before = fdmod.flash_decode_gqa_state(q, *cache, lens1 - 1)
    written1 = [t.clone() for t in cache]
    want = fdmod.flash_decode_gqa_inplace(q, *written1, *new, lens1)[0]
    merged = fdmod.merge_current_token(before, q, k_new, ks_new, v_new,
                                       vs_new)
    torch.cuda.synchronize()
    equals_k2 = (k2_plan["route"] == plan_r["route"]
                 and bool(torch.equal(read_written, k2)))
    acc, _, l = got_s
    live = l > 0
    normalized = acc / torch.where(live, l, torch.ones_like(l))[..., None]
    acc_over_l = bool(torch.equal(normalized[live], got_r[live]))
    span_l = state_by_span[2]
    span_out = state_by_span[0] / torch.where(
        span_l > 0, span_l, torch.ones_like(span_l))[..., None]
    err_span = {"read": float((got_r - by_span).abs().max()),
                "state": float((normalized - span_out).abs().max())}
    span_close = (output_close(by_span, ref_r, pv_r)
                  and state_close(state_by_span, ref_s, pv_s))
    err_merge_k2 = float((merged - want).abs().max())
    cross_ok = (err_merge_k2 < ATTN_TOL and span_close
                and max(err_span.values()) < ATTN_TOL)
    total = int(lens_np.sum())
    shape = (f"b={b} kvh={kvh} g={g} S={s_max} sum_len={total}"
             + (" lengths=serving" if lengths == "serving" else ""))
    in_bytes = q.numel() * 2 + kvh * total * (2 * hd + 8) + b * 4
    ops = 4.0 * kvh * g * hd * total
    results = []
    for name, run, old, plain, plan, out_bytes, ok, err, equal in (
            ("read", read, read_span, read_plain, plan_r,
             b * heads * hd * 4, output_close(got_r, ref_r, pv_r),
             float((got_r - ref_r).abs().max()),
             {"equals_k2_live": equals_k2}),
            ("state", state, state_span, state_plain, plan_s,
             b * heads * (hd + 2) * 4, state_close(got_s, ref_s, pv_s),
             float((got_s[0] - ref_s[0]).abs().max()),
             {"acc_over_l_equals_k5a": acc_over_l})):
        b_ms, b_by = bound_ms(in_bytes + out_bytes, ops, BF16_OPS_PER_S)
        results.append({
            "shape": shape, **plan, **equal,
            "ok": ok and cross_ok and all(equal.values()),
            "max_abs_err": err,
            "vs_k2": {"state_merged_with_token": err_merge_k2},
            "vs_span": err_span[name],
            "ms": cold_ms(run), "old_route_ms": cold_ms(old),
            "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by})
    return results


def check_flash_prefill_stats(start: int, seed: int, b: int = 4,
                              s: int = 512, s_max: int = 4096,
                              lens=None, hd: int = 128) -> dict:
    """K4-stats at K4's shapes: (acc, m, l) against the plain state per
    element (``flash_common.state_close``), acc / l against K4's output,
    rows before position 0 exactly (0, -1e30, 0)."""
    cache, q, st, lens_t, st_np, lens_np = _prefill_inputs(
        b, s, s_max, start, lens, seed, hd)
    kvh = cache[0].shape[1]
    run = lambda: fpmod.flash_prefill_gqa(q, *cache, st, lens_t,
                                          return_stats=True)
    qg = _kernel_layout(q, kvh)
    plain = lambda: fpmod.flash_prefill_stats_plain(qg, *cache, st, lens_t)
    acc, m, l = run()
    out = fpmod.flash_prefill_gqa(q, *cache, st, lens_t)
    ref = [_rows(x) for x in plain()]
    pv = _rows(fpmod.flash_prefill_stats_plain(qg, *abs_v(cache), st,
                                               lens_t)[0])
    torch.cuda.synchronize()
    norm_err = float((acc / torch.where(l > 0, l, torch.ones_like(l))[
        ..., None] - out).abs().max())
    empty_rows = max(0, min(-start, s))
    empty_ok = bool((m[:, :empty_rows] == -1e30).all()) and \
        bool((l[:, :empty_rows] == 0).all()) and \
        bool((acc[:, :empty_rows] == 0).all())
    ok = state_close((acc, m, l), ref, pv) and norm_err < ATTN_TOL \
        and empty_ok
    err = float((acc - ref[0]).abs().max())
    del ref, pv
    b_ms, b_by = prefill_sweep.k4_bound(b, kvh, 4, s, s_max, st_np.tolist(),
                                        lens_np.tolist(), hd=hd, stats=True)
    shape = (f"b={b} s={s} start={start} kvh={kvh} g=4 S={s_max}"
             + (" lens=phase4" if lens is not None else "")
             + (f" hd={hd}" if hd != 128 else ""))
    return {"shape": shape, "ok": ok, "max_abs_err": err,
            "acc_over_l_vs_k4": norm_err, "empty_rows": empty_rows,
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            **({"sdpa_bf16_ms": sdpa_bf16_ms(q, cache, s)} if start == 0
               else {})}


def check_copy_probe(seed: int) -> dict:
    """P0 against its plain version (a copy: bit for bit), cold like every
    kernel here, beside ``Tensor.clone``; then the launch floor as the
    straggler probe reads it: device and host µs per launch, through the
    wrapper and through the bare ctypes entry."""
    x = torch.randn(dpmod.PROBE_SHAPE, generator=_gen(seed), device=DEV)
    run = lambda: dpmod.copy_probe(x)
    plain = lambda: dpmod.copy_probe_plain(x)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    b_ms, b_by = bound_ms(2 * x.numel() * 4, 0.0, F32_OPS_PER_S)
    floor = straggler_probe.dispatch_floor(
        DEV, 1000, dict(iters=200, repeats=3, min_chain_seconds=0.01))
    return {"shape": "8x128 f32", "ok": torch.equal(got, ref),
            "max_abs_err": float((got - ref).abs().max()),
            "ms": cold_ms(run), "plain_ms": cold_ms(plain, reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cold_ms(lambda: x.clone()),
            "library_note": "Tensor.clone", "launch_floor_us": floor}


def check_script_shapes(results: dict) -> None:
    """Phase 7's kernels at the shapes its scripts give them, each against
    its plain version with the tolerances above, before phase 7 times
    them. K11 joins where ``select_config`` splits one of the dense shapes
    (with the rest of phase 2's dense shapes)."""
    sp = straggler_probe
    # straggler_probe: fp8small (K1, K12); masked (K3 with every row of
    # the E 128-row blocks valid, K8 on one 128-row tile per expert);
    # primes as given and with K and N padded to 128; bf16cube.
    m, n, k = sp.FP8SMALL
    results["fp8_gemm"].append(check_fp8_gemm(m, n, k, seed=100))
    results["fp8_gemm_folded"].append(check_fp8_folded(m, n, k, seed=101))
    e, rows, n, k = sp.MASKED
    full = torch.full((e,), rows, dtype=torch.int32, device=DEV)
    results["grouped_gemm"].append(
        check_grouped(e, rows, n, k, seed=102, top_k=1, loads=full,
                      expected_m=None))
    results["grouped_gemm_contiguous"].append(
        check_contiguous(e, rows, n, k, seed=103, counts=[rows] * e))
    for m, n, k in sp.PRIMES:
        results["gemm"].append(check_gemm(m, n, k, seed=104))
        results["gemm"].append(check_gemm(m, round_up(n, 128),
                                          round_up(k, 128), seed=105))
    results["gemm"].append(check_gemm(*(sp.BF16CUBE,) * 3, seed=106))
    # profile_kernel --op fp8_gemm and headline: K1 at 4096³.
    results["fp8_gemm"].append(check_fp8_gemm(*bench_shapes.HEADLINE,
                                              seed=107))
    # serve_bench scan: V2_LITE, SCRIPT_BATCH rows a step over SCAN_CACHE
    # keys: its projections (K1), experts (K3) and decode attention (K2).
    b = SCRIPT_BATCH
    group = V2_LITE.num_heads // V2_LITE.num_kv_heads
    for i, (n, k) in enumerate(LITE_GEMMS):
        results["fp8_gemm"].append(check_fp8_gemm(b, n, k, seed=110 + i))
    h, inter = V2_LITE.hidden_size, V2_LITE.moe_intermediate
    for n, k in ((2 * inter, h), (h, inter)):
        results["grouped_gemm"].append(check_grouped(
            V2_LITE.num_experts, b, n, k, seed=116 + n,
            top_k=V2_LITE.top_k))
    results["flash_decode"].append(check_flash_decode(
        V2_LITE.num_kv_heads, group, seed=117, b=b, s_max=SCAN_CACHE))
    # serve_bench engine / mixed (ENGINE_SLOTS slots, SERVE_STEPS new
    # tokens): caches of steps + 16 and steps + 40 keys, their prompts
    # prefilled in buckets of 16 and 32 rows.
    for s_max, s in ((SERVE_STEPS + 16, 16), (SERVE_STEPS + 40, 32)):
        results["flash_decode"].append(check_flash_decode(
            V2_LITE.num_kv_heads, group, seed=118, b=ENGINE_SLOTS,
            s_max=s_max))
        results["flash_prefill"].append(check_flash_prefill(
            0, seed=119, b=ENGINE_SLOTS, s=s, s_max=s_max))
    # serve_bench chunksweep: caches of steps + 24 keys, prompts in the
    # 16-row bucket. prefix: a PREFIX_SCRIPT_SYSTEM-token system prompt and
    # 4 tokens a request in a cache 64 longer, the cold wave in the
    # 512-row bucket, the warm one in 16-row windows from the system
    # prompt's end. --speculative-k: 16-row verify windows in the engine
    # mode's cache.
    results["flash_decode"].append(check_flash_decode(
        V2_LITE.num_kv_heads, group, seed=125, b=ENGINE_SLOTS,
        s_max=SERVE_STEPS + 24, contract_only=True))
    prefix_cache = PREFIX_SCRIPT_SYSTEM + 64
    for start, s, s_max in ((0, 16, SERVE_STEPS + 24),
                            (0, 512, prefix_cache),
                            (PREFIX_SCRIPT_SYSTEM, 16, prefix_cache),
                            (SERVE_STEPS // 2, 16, SERVE_STEPS + 16)):
        results["flash_prefill"].append(check_flash_prefill(
            start, seed=126, b=ENGINE_SLOTS, s=s, s_max=s_max))
    # layer_bench, SCRIPT_BATCH rows over LAYER_CACHE keys, each config's
    # expert-parallel shard (V3_STYLE: 8 of 256 experts, loads of routing
    # over all 256): the attention projections (K1), the experts fp8 (K3)
    # and int8 (K6), the decode attention (K2: GQA groups 1 and 8).
    for spec in LAYER_CONFIGS:
        name, ep = spec.split(":")
        cfg = layer_bench.CONFIGS[name]
        h, q, kv, inter = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                           cfg.moe_intermediate)
        for n, k in dict.fromkeys(((q, h), (kv, h), (h, q))):
            results["fp8_gemm"].append(check_fp8_gemm(b, n, k, seed=120))
        loads = _masked_m(cfg.num_experts, b, cfg.top_k,
                          seed=121)[:cfg.num_experts // int(ep)]
        for n, k in ((2 * inter, h), (h, inter)):
            results["grouped_gemm"].append(check_grouped(
                cfg.num_experts, b, n, k, seed=122, top_k=cfg.top_k,
                loads=loads, expected_m=-(-b * cfg.top_k // cfg.num_experts)))
            results["int8_grouped_masked"].append(check_int8_masked(
                cfg.num_experts, b, n, k, seed=123, top_k=cfg.top_k,
                loads=loads, expected_m=-(-b * cfg.top_k // cfg.num_experts)))
        results["flash_decode"].append(check_flash_decode(
            cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, seed=124,
            b=b, s_max=LAYER_CACHE))


def phase_kernels() -> dict:
    results = {name: [] for name in KERNELS}
    for i, (n, k) in enumerate(LITE_GEMMS):
        for m in (16, 2048):
            results["fp8_gemm"].append(check_fp8_gemm(m, n, k, seed=i))
    # The tile route (weights stored (k, n)), against the unsplit ring.
    for m, n, k in ((16, 2048, 2048), (2048, 22016, 2048)):
        results["fp8_gemm"].append(check_fp8_gemm(m, n, k, seed=8,
                                                  b_layout="n"))
    # Decode (16 slots) and one prefill chunk (2048 tokens) for V2_LITE's
    # 32 experts and V2_LITE_FULL's 64; then both kv-head geometries.
    for e in (V2_LITE.num_experts, V2_LITE_FULL.num_experts):
        for tokens in (16, 2048):
            for n, k in ((2816, 2048), (2048, 1408)):
                results["grouped_gemm"].append(
                    check_grouped(e, tokens, n, k, seed=e + tokens + n))
    for n, k in ((2816, 2048), (2048, 1408)):
        results["grouped_gemm"].append(check_grouped(
            V2_LITE.num_experts, 16, n, k, seed=9 + n, b_layout="n"))
    # V2_LITE's GQA group 4, V2_LITE_FULL's 1, V3_STYLE's 8 (layer_bench).
    for i, cfg in enumerate((V2_LITE, V2_LITE_FULL, V3_STYLE)):
        results["flash_decode"].append(check_flash_decode(
            cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, seed=i + 1))
    results["flash_decode"].append(check_flash_decode(
        V2_LITE.num_kv_heads, V2_LITE.num_heads // V2_LITE.num_kv_heads,
        seed=1, lengths="serving"))
    for start in (0, 1000):
        results["flash_prefill"].append(check_flash_prefill(start, seed=3))
    results["flash_prefill"].append(check_flash_prefill(
        0, seed=4, b=len(BUCKET_1024_LENS), s=1024, lens=BUCKET_1024_LENS))
    # Phase 4's serving features: the prefix cache's suffix windows (16
    # rows from start PREFIX_SYSTEM) and the speculative verify window (16
    # rows at each slot's length), 16 slots: K4 at s=16, and the window's
    # 256-row projections (K1) and experts (K3).
    for start in (PREFIX_SYSTEM, 1000):
        results["flash_prefill"].append(check_flash_prefill(
            start, seed=5, b=16, s=16))
    # Head size 64 (TINY_DENSE's): K2 on route "span", K4 and K4-stats on
    # the CUDA cores.
    results["flash_decode"].append(check_flash_decode(4, 4, seed=6, hd=64))
    for start in (0, 1000):
        results["flash_prefill"].append(check_flash_prefill(start, seed=7,
                                                            hd=64))
    for i, (n, k) in enumerate(LITE_GEMMS[:2]):
        results["fp8_gemm"].append(check_fp8_gemm(256, n, k, seed=30 + i))
    for n, k in ((2816, 2048), (2048, 1408)):
        results["grouped_gemm"].append(check_grouped(
            V2_LITE.num_experts, 256, n, k, seed=31 + n))
    for i, (n, k) in enumerate([(2048, 2048), (22016, 2048), (2048, 11008)]):
        for m in (16, 2048):
            results["int8_gemm"].append(check_int8_gemm(m, n, k, seed=20 + i))
    results["int8_gemm"].append(check_int8_gemm(33, 384, 1000, seed=23))
    for n, k in ((2816, 2048), (2048, 1408)):
        results["int8_grouped_contiguous"].append(
            check_int8_contiguous(V2_LITE.num_experts, 2048, n, k,
                                  seed=30 + n))
    # Decode (16 slots), a 128-token prefill forward of phase 4 (24 rows an
    # expert: the 64 x 64 wgmma tile) and one prefill chunk (2048 tokens)
    # for V2_LITE's 32 experts, and decode for V2_LITE_FULL's 64.
    for e, tokens in ((V2_LITE.num_experts, 16), (V2_LITE.num_experts, 128),
                      (V2_LITE.num_experts, 2048),
                      (V2_LITE_FULL.num_experts, 16)):
        for n, k in ((2816, 2048), (2048, 1408)):
            results["int8_grouped_masked"].append(
                check_int8_masked(e, tokens, n, k, seed=e + tokens + n))
    # The int8_tile route (weights stored (E, k, n)), against the ring.
    results["int8_grouped_masked"].append(check_int8_masked(
        V2_LITE.num_experts, 16, 2816, 2048, seed=10, b_layout="n"))
    # The dense GEMM: V2_LITE's projections at decode and prefill, then the
    # other input types, layouts, a ragged shape and a batch.
    for i, (n, k) in enumerate(LITE_GEMMS):
        for m in (16, 2048):
            results["gemm"].append(check_gemm(m, n, k, seed=40 + i))
    for dtype in (torch.float16, torch.float32):
        results["gemm"].append(check_gemm(2048, 2048, 2048, seed=47,
                                          dtype=dtype))
    for layout in ("nt", "tn", "tt"):
        results["gemm"].append(check_gemm(2048, 2048, 2048, seed=48,
                                          layout=layout))
    results["gemm"].append(check_gemm(33, 97, 1000, seed=49))
    results["gemm"].append(check_gemm(2048, 2048, 2048, seed=50, batch=4))
    # f32 (route ffma, each beside route mma_tile): the other layouts, a
    # decode row, a batch, and a ragged shape that stays on mma_tile.
    f32 = torch.float32
    for layout in ("nt", "tn", "tt"):
        results["gemm"].append(check_gemm(2048, 2048, 2048, seed=53,
                                          dtype=f32, layout=layout))
    results["gemm"].append(check_gemm(16, 22016, 2048, seed=54, dtype=f32))
    results["gemm"].append(check_gemm(2048, 2048, 2048, seed=55, dtype=f32,
                                      batch=4))
    results["gemm"].append(check_gemm(33, 97, 1000, seed=56, dtype=f32))
    check_script_shapes(results)
    # Split-K wherever select_config picks it among those shapes (in their
    # input type), and at the decode shape of the dense FFN's down
    # projection with 4 and 3 splits, and in f32 with the gate's.
    split = {}
    for r in results["gemm"]:
        if r["picked"].startswith("KSPLIT") and "batch" not in r["shape"]:
            m, n, k = (int(f.split("=")[1]) for f in r["shape"].split()[:3])
            split[m, n, k, int(r["picked"].split("/")[1]), r["dtype"]] = 1
    for m, n, k, splits, dtype in split:
        results["gemm_ksplit"].append(check_ksplit(
            m, n, k, splits, seed=51, why="select_config", dtype=dtype))
    for splits in (4, 3):
        results["gemm_ksplit"].append(check_ksplit(
            16, 2048, 11008, splits, seed=52, why="explicit config"))
    gate = select_config(16, 2048, 11008, f32, f32, device=DEV)
    if (16, 2048, 11008, gate.k_split, f32) not in split:
        results["gemm_ksplit"].append(check_ksplit(
            16, 2048, 11008, max(gate.k_split, 2), seed=57,
            why="the gate's splits, f32", dtype=f32))
    # K8 at K3's prefill loads (same seeds), V2_LITE's 32 experts and
    # V2_LITE_FULL's 64 (each bit-equal to K3 and to route tile, timed
    # beside it), and one layout tile that is not a multiple of 64.
    for e in (V2_LITE.num_experts, V2_LITE_FULL.num_experts):
        for n, k in ((2816, 2048), (2048, 1408)):
            results["grouped_gemm_contiguous"].append(
                check_contiguous(e, 2048, n, k, seed=e + 2048 + n,
                                 old_route=True))
    results["grouped_gemm_contiguous"].append(check_contiguous(
        V2_LITE.num_experts, 2048, 2816, 2048, seed=60, block_m=96))
    # K12 at K1's shapes (b_layout 't', the port's weights), and 'n' once;
    # K5a/K5b at K2's, K4-stats at K4's plus a start before 0 and past S.
    for i, (n, k) in enumerate(LITE_GEMMS):
        for m in DENSE_M:
            results["fp8_gemm_folded"].append(
                check_fp8_folded(m, n, k, seed=90 + i))
    results["fp8_gemm_folded"].append(
        check_fp8_folded(2048, 2048, 2048, seed=96, b_layout="n"))
    for i, cfg in enumerate((V2_LITE, V2_LITE_FULL)):
        read, state = check_flash_decode_variants(
            cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, seed=i + 11)
        results["flash_decode_read"].append(read)
        results["flash_decode_state"].append(state)
    read, state = check_flash_decode_variants(
        V2_LITE.num_kv_heads, V2_LITE.num_heads // V2_LITE.num_kv_heads,
        seed=1, lengths="serving")
    results["flash_decode_read"].append(read)
    results["flash_decode_state"].append(state)
    for start in (0, 1000, -256, 4096):
        results["flash_prefill_stats"].append(
            check_flash_prefill_stats(start, seed=13))
    results["flash_prefill_stats"].append(check_flash_prefill_stats(
        0, seed=4, b=len(BUCKET_1024_LENS), s=1024, lens=BUCKET_1024_LENS))
    for start in (0, -256):
        results["flash_prefill_stats"].append(
            check_flash_prefill_stats(start, seed=15, hd=64))
    results["copy_probe"].append(check_copy_probe(seed=14))
    k1_library = [scaled_mm_blockwise(m, 22016, 2048, seed=1)
                  for m in (16, 2048)]
    for name, rows in results.items():
        for r in rows:
            log(f"  {name:23s} {r['shape']:50s} ok={r['ok']} "
                f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']})"
                + (f" span_ms={r['span_ms']:.4f}" if "span_ms" in r
                   else "")
                + (f" sdpa_bf16_ms(yardstick, another function)="
                   f"{r['sdpa_bf16_ms']:.4f}" if "sdpa_bf16_ms" in r
                   else "")
                + (f" library_ms={r['library_ms']}" if "library_ms" in r
                   else "")
                + (f" select_config={r['picked']}" if "picked" in r else "")
                + (f" route={r['route']}" if "route" in r else "")
                + (f" tile={r['tile']}" if r.get("tile") else "")
                + (f" tile={r['ring_tile']}" if "ring_tile" in r else "")
                + (f" splits={r['splits']}" if "splits" in r else "")
                + (f" expected_m={r['expected_m']}" if "expected_m" in r
                   else "")
                + (f" ring_equals_tile={r['ring_equals_tile']}"
                   if "ring_equals_tile" in r else "")
                + (f" old_route_ms(same run)={r['old_route_ms']:.4f}"
                   if "old_route_ms" in r else "")
                + (f" equals_old_route={r['equals_old_route']}"
                   if "equals_old_route" in r else "")
                + (f" equals_k2_live={r['equals_k2_live']}"
                   if "equals_k2_live" in r else "")
                + (f" acc_over_l_equals_k5a={r['acc_over_l_equals_k5a']}"
                   if "acc_over_l_equals_k5a" in r else "")
                + (f" equals_k3={r['equals_k3']}" if "equals_k3" in r
                   else "")
                + (f" bound_16bit_ms={r['bound_16bit_ms']:.4f}"
                   if "bound_16bit_ms" in r else "")
                + (f" prev_ms(before the redesign, quoted)={r['prev_ms']}"
                   if r.get("prev_ms") else "")
                + (f" bf16_out_ms={r['bf16_out_ms']:.4f}"
                   if r.get("bf16_out_ms") else "")
                + (f" K10 ms={r['k10_ms']:.4f} ({r['why']})" if "k10_ms" in r
                   else "")
                + (f" with fold ms={r['library_with_fold_ms']:.4f} rel-L2 vs "
                   f"K1 {r['rel_l2_vs_k1']:.3g}" if "rel_l2_vs_k1" in r
                   else "")
                + (f" vs K2 {r['vs_k2']}" if "vs_k2" in r else "")
                + (f" acc/l vs K4 {r['acc_over_l_vs_k4']:.3g} empty rows "
                   f"{r['empty_rows']}" if "empty_rows" in r else "")
                + (f" launch floor us {r['launch_floor_us']}"
                   if "launch_floor_us" in r else ""))
    for r in k1_library:
        log(f"  K1 library yardstick {r['shape']}: accepted={r['accepted']} "
            f"ms={r['ms']} refused={r['refused']}"
            + (f" rel-L2 vs K1 {r['rel_l2_vs_k1']:.3g}" if r["accepted"]
               else ""))
    step = decode_step_sums(results)
    for name, sums in step.items():
        log(f"  decode step (V2_LITE, 16 slots), {name}: {sums['launches']} "
            f"launches, Σ ms={sums['ms']:.4f} bound_ms={sums['bound_ms']:.4f}"
            f" prev_ms(before the ring, quoted)={sums['prev_ms']:.4f}")
    bad = [(n, r["shape"]) for n, rows in results.items() for r in rows
           if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    return {"checks": results, "k1_library": k1_library,
            "decode_step": step}


def decode_step_sums(results: dict) -> dict:
    """K1's and K3's time in one V2_LITE decode step: their phase-2 rows
    at the step's shapes (K1 at m = 16, K3 at E=32 cap=96), weighted by
    the step's launches (K1_PER_STEP, K3_PER_STEP); the bound and the
    quoted time before the ring the same way."""
    out = {}
    for name, per_step, fmt in (
            ("fp8_gemm", K1_PER_STEP, "m=16 n={} k={}"),
            ("grouped_gemm", K3_PER_STEP, "E=32 cap=96 valid_rows=96 n={} "
                                          "k={}")):
        sums = {"launches": 0, "ms": 0.0, "bound_ms": 0.0, "prev_ms": 0.0}
        for (n, k), count in per_step.items():
            row = next(r for r in results[name]
                       if r["shape"] == fmt.format(n, k))
            sums["launches"] += count
            for key in ("ms", "bound_ms", "prev_ms"):
                sums[key] += count * (row[key] or 0.0)
        out[name] = sums
    return out


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


def _expert_shard(moe, offset: int, e_local: int):
    """The MoE parameters with only experts [offset, offset + e_local):
    every expert weight leads with the expert dim."""
    ex = moe.experts
    return dataclasses.replace(moe, experts=dataclasses.replace(ex, **{
        f.name: getattr(ex, f.name)[offset:offset + e_local]
        for f in dataclasses.fields(ex)}))


def check_moe_shards(experts: str, ep: int = 8, tokens: int = 64) -> dict:
    """The expert-parallel shard path of ``moe_block`` (``local_experts``,
    ``expert_offset``: its routed part), as layer_bench runs V3_STYLE's
    shard of 8 experts, on the card through K3 (or K6): V2_LITE_FULL's 64
    experts in ``ep`` shards of 8, a batch of 64 tokens. The shards' f32
    routed outputs must sum to the whole block's (each assignment is the
    same row through the same kernel either way; only the f32 order of a
    token's terms differs: rel-L2 < MOE_SHARD_REL_L2), and a shard's
    output must be exactly zero for the tokens with no expert on it."""
    cfg = V2_LITE_FULL
    e, h = cfg.num_experts, cfg.hidden_size
    e_local = e // ep
    gen = _gen(140)
    router = BF16Linear.create(gen, h, e, init_scale=0.02, device=DEV)
    cls = moemod.Int8ExpertWeights if experts == "int8" else \
        moemod.ExpertWeights
    moe = moemod.MoEParams(
        router=router, experts=cls.create(gen, e, h, cfg.moe_intermediate,
                                          device=DEV),
        shared_w1=None, shared_w2=None)
    x = (torch.randn(tokens, h, generator=gen, device=DEV) * 0.1).to(
        torch.bfloat16)
    whole = moemod._moe_routed(moe, x, cfg)
    _, idx = route_topk(router(x), cfg.top_k)
    parts, stray = [], 0.0
    for off in range(0, e, e_local):
        part = moemod._moe_routed(_expert_shard(moe, off, e_local), x, cfg,
                                  local_experts=e_local, expert_offset=off)
        off_shard = ~((idx >= off) & (idx < off + e_local)).any(dim=1)
        stray = max(stray, float(part[off_shard].abs().max())
                    if bool(off_shard.any()) else 0.0)
        parts.append(part)
    torch.cuda.synchronize()
    rel = float((sum(parts) - whole).norm() / whole.norm())
    log(f"moe shards ({experts} experts): V2_LITE_FULL {e} experts in {ep} "
        f"shards of {e_local}, {tokens} tokens: Σ shards vs whole rel-L2 "
        f"{rel:.3g} (limit {MOE_SHARD_REL_L2:g}), largest output of a shard "
        f"for tokens routed elsewhere {stray:g}")
    if not rel < MOE_SHARD_REL_L2 or stray != 0.0 or \
            not bool(torch.isfinite(whole).all()):
        raise RuntimeError(f"moe shards ({experts}): rel-L2 {rel}, "
                           f"off-shard output {stray}")
    return {"rel_l2_sum_vs_whole": rel, "off_shard_max_abs": stray}


# ---------------------------------------------------------------- phase 4

def _profiled_kernels(fn) -> tuple:
    """``fn`` once under torch.profiler, ended by a synchronize: its CUDA
    kernels as (name, device ms, launches), most time first, and the host
    wall ms around it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prefill_profile.kernel_rows(prof), wall_ms


def _profile_decode_step(eng: Engine) -> dict:
    """One more decode step over all 16 slots (caches as serving left
    them) under torch.profiler: device kernel time against host wall time,
    the step's kernel launches, and the kernels that take the most device
    time. Before it, the same step five times unprofiled (host clock
    around each, ended by a synchronize; the median), with the port's
    wrapper launches in it counted: the host time per launch and the idle
    share of an unprofiled step come from this one engine state."""
    args = (eng.params, eng.last_tokens, eng.caches, eng.seq_lens, eng.cfg)
    decode_step(*args)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        _kernels.reset_counters()
        t0 = time.perf_counter()
        decode_step(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wrapped = sum(c.launches for c in _kernels.COUNTERS.values())
    unprofiled_ms = sorted(walls)[2]
    rows, wall_ms = _profiled_kernels(lambda: decode_step(*args))
    device_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    log(f"  one decode step under torch.profiler: wall {wall_ms:.2f} ms, "
        f"device kernels {device_ms:.2f} ms ({len(rows)} kernels, {launches} "
        f"launches), device idle share {max(0.0, 1 - device_ms / wall_ms):.2f}")
    log(f"  the same step unprofiled: wall {unprofiled_ms:.2f} ms (median of "
        f"5: {[round(w, 2) for w in walls]}), {wrapped} of its launches "
        f"through the port's wrappers; host "
        f"{unprofiled_ms * 1e3 / max(launches, 1):.2f} us per launch, device idle "
        f"share {max(0.0, 1 - device_ms / unprofiled_ms):.2f}")
    for key, ms, count in rows[:8]:
        log(f"    {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "launches": launches,
            "unprofiled_wall_ms": unprofiled_ms, "unprofiled_walls_ms": walls,
            "wrapper_launches": wrapped,
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for k, ms, c in rows[:12]]}


def counts_now() -> dict:
    """Each kernel's (launches on the card, plain calls) since the
    counters were zeroed: a CUDA graph's capture runs nothing, and each
    of its replays launches every kernel it holds (``Counter.on_card``)."""
    return {n: (c.on_card(), c.plain_calls)
            for n, c in _kernels.COUNTERS.items()}


def check_path(label: str, counts: dict, expected: set,
               plans: dict = None) -> None:
    """Raise unless exactly the kernels ``expected`` launched, no plain
    version ran and (given ``plans``) every launch took its serving route
    (SERVING_ROUTES)."""
    if any(bool(launches) != (n in expected)
           for n, (launches, _) in counts.items()):
        raise RuntimeError(f"{label}: launches {counts}, expected exactly "
                           f"{sorted(expected)}")
    if any(calls for _, calls in counts.values()):
        raise RuntimeError(f"{label}: a plain version ran: {counts}")
    off_route = {n: p for n, p in (plans or {}).items()
                 if any(not label_.startswith(SERVING_ROUTES[n])
                        for label_ in p)}
    if off_route:
        raise RuntimeError(f"{label}: a kernel left its route "
                           f"{ {n: SERVING_ROUTES[n] for n in off_route} }: "
                           f"{off_route}")


def serving_prompts(cfg):
    """Phase 4's 24 requests: 16..1024-token prompts (default_rng(2))."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(16, 1025, size=24)
    return [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
            for n in lengths]


def serve(eng: Engine, prompts, max_new: int = 32):
    """Serve ``prompts`` on ``eng`` with the counters zeroed just before
    and read just after: (outputs, wall s, counts, plans, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counters()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (outs, wall, counts_now(), launch_plans(),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def serving_params(experts: str):
    """V2_LITE's parameters (seed 0) with fp8 experts, or re-quantized to
    int8, on the card."""
    params = init_params(0, V2_LITE, device=DEV)
    if experts == "int8":
        params = params_with_int8_experts(params)
    return params


def phase_serving(device: dict, experts: str) -> dict:
    """Serves the 24 requests with ``experts`` "fp8" or "int8"; the run must
    launch exactly FP8_PATH or INT8_PATH, and no plain version."""
    cfg = V2_LITE
    t0 = time.perf_counter()
    params = serving_params(experts)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng = Engine(params, cfg, max_slots=16, max_seq_len=4096, device=DEV)
    prompts = serving_prompts(cfg)
    lengths = [len(p) for p in prompts]
    outs, wall, counts, plans, peak_gb = serve(eng, prompts)
    st = eng.stats
    prefill_tps = st["prefill_tokens"] / st["prefill_time_s"]
    log(f"serving ({experts} experts): V2_LITE 8 layers, 16 slots, 24 "
        f"requests (prompts {min(lengths)}..{max(lengths)}), 32 "
        f"new tokens each, {wall:.2f} s wall (parameters built in "
        f"{setup_s:.2f} s)")
    log(f"  prefill {prefill_tps:.1f} tok/s ({st['prefill_tokens']} prompt "
        f"tokens), decode {eng.tokens_per_second:.1f} tok/s over "
        f"{st['decode_steps']} steps, peak memory {peak_gb:.2f} GiB; "
        f"{device['smi']}")
    log(f"  counters (launches, plain calls): {counts}")
    log(f"  launches by plan: {plans}")
    if len(outs) != 24 or any(len(o) != 32 for o in outs):
        raise RuntimeError(f"serving: lengths {[len(o) for o in outs]}")
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        raise RuntimeError("serving: token out of range")
    expected = FP8_PATH if experts == "fp8" else INT8_PATH
    check_path(f"serving ({experts})", counts, expected, plans)
    digest = cache_digest(eng)
    profile = _profile_decode_step(eng)
    prefill = _profile_prefill_forward(eng)
    return {"run": experts, "wall_s": wall, "setup_s": setup_s,
            "prefill_tok_s": prefill_tps, "profile": profile,
            "prefill_profile": prefill,
            "decode_tok_s": eng.tokens_per_second,
            "decode_steps": st["decode_steps"],
            "prefill_tokens": st["prefill_tokens"], "peak_gib": peak_gb,
            "counts": counts, "plans": plans, "outputs": outs,
            "cache_sha256": digest}


def phase_features(device: dict, experts: str, plain_outs) -> list:
    """The serving features on the same parameters and requests: the 24
    requests at decode_chunk=CHUNK (a captured CUDA graph a chunk) and the
    chunk on the state it leaves, eager against replayed; with fp8
    experts also the prefix cache and speculative decoding. ``plain_outs``:
    phase_serving's outputs. Returns one run a path (its counts read just
    after it)."""
    params = serving_params(experts)
    prompts = serving_prompts(V2_LITE)
    runs = [phase_chunked(device, experts, params, prompts, plain_outs)]
    if experts == "fp8":
        torch.cuda.empty_cache()
        runs.append(phase_prefix(device, params))
        torch.cuda.empty_cache()
        runs.append(phase_speculative(device, params, prompts))
    return runs


def engine_state(eng: Engine):
    """Clones of an engine's state: caches, lengths, last tokens."""
    return ([[getattr(c, n).clone() for n in engine_mod._CACHE_FIELDS]
             for c in eng.caches], eng.seq_lens.clone(),
            eng.last_tokens.clone())


def restore_state(eng: Engine, state) -> None:
    caches, lens, last = state
    for c, saved in zip(eng.caches, caches):
        for n, t in zip(engine_mod._CACHE_FIELDS, saved):
            getattr(c, n).copy_(t)
    eng.seq_lens.copy_(lens)
    eng.last_tokens.copy_(last)


def cache_digest(eng: Engine) -> str:
    """sha256 over every cache tensor's bytes of an engine, on the host."""
    h = hashlib.sha256()
    for c in eng.caches:
        for n in engine_mod._CACHE_FIELDS:
            h.update(getattr(c, n).contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


def _profiled_device_ms(fn) -> tuple:
    """(device kernel ms, kernel launches) of ``fn`` run once."""
    rows, _ = _profiled_kernels(fn)
    return sum(r[1] for r in rows), sum(r[2] for r in rows)


def check_chunk_replay(eng: Engine) -> dict:
    """(a) The chunk on the state serving left (every slot active): run
    once eagerly and once by graph replay from identical copies of that
    state, the tokens and every cache, length and last token must be
    equal bit for bit. Then each way five times from that state (host
    clock ended by a synchronize; the median over CHUNK steps), once under
    torch.profiler (device kernel ms), and the replay once between CUDA
    events (its span on the card)."""
    eng._mask.fill_(True)
    start = engine_state(eng)
    eng._decode_chunk(eng._mask, eng._out)
    eager_out, eager = eng._out.clone(), engine_state(eng)
    restore_state(eng, start)
    eng._graph.replay()
    torch.cuda.synchronize()
    replayed = engine_state(eng)
    differ = [f"layer {i} {n}" for i, (a, b) in
              enumerate(zip(eager[0], replayed[0]))
              for n, x, y in zip(engine_mod._CACHE_FIELDS, a, b)
              if not torch.equal(x, y)]
    differ += [n for n, x, y in (("seq_lens", eager[1], replayed[1]),
                                 ("last_tokens", eager[2], replayed[2]),
                                 ("tokens", eager_out, eng._out))
               if not torch.equal(x, y)]
    del eager, replayed

    def timed(fn):
        walls = []
        for _ in range(5):
            restore_state(eng, start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / CHUNK)
        return sorted(walls)[2], walls

    eager_chunk = lambda: eng._decode_chunk(eng._mask, eng._out)
    eager_ms, eager_walls = timed(eager_chunk)
    replay_ms, replay_walls = timed(eng._graph.replay)
    restore_state(eng, start)
    eager_dev, eager_launches = _profiled_device_ms(eager_chunk)
    restore_state(eng, start)
    replay_dev, replay_launches = _profiled_device_ms(eng._graph.replay)
    restore_state(eng, start)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    eng._graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    span_ms = ev[0].elapsed_time(ev[1]) / CHUNK
    out = {"bit_equal": not differ, "differ": differ,
           "eager_step_ms": eager_ms, "eager_walls_ms": eager_walls,
           "replay_step_ms": replay_ms, "replay_walls_ms": replay_walls,
           "eager_device_ms": eager_dev / CHUNK,
           "eager_launches": eager_launches / CHUNK,
           "replay_device_ms": replay_dev / CHUNK,
           "replay_launches": replay_launches / CHUNK,
           "replay_span_ms": span_ms,
           "eager_idle": max(0.0, 1 - eager_dev / CHUNK / eager_ms),
           "replay_idle": max(0.0, 1 - replay_dev / CHUNK / replay_ms)}
    log(f"  (a) one chunk of {CHUNK} on the state serving left, eager vs "
        f"replayed from copies of it: "
        + ("tokens, caches, lengths, last tokens bit-equal" if not differ
           else f"DIFFER in {differ}"))
    log(f"      a step: eager {eager_ms:.3f} ms wall (median of 5: "
        f"{[round(w, 3) for w in eager_walls]}), device kernels "
        f"{out['eager_device_ms']:.3f} ms ({out['eager_launches']:.0f} "
        f"launches), idle {out['eager_idle']:.2f}; replayed {replay_ms:.3f} "
        f"ms wall ({[round(w, 3) for w in replay_walls]}), device kernels "
        f"{out['replay_device_ms']:.3f} ms ({out['replay_launches']:.0f} "
        f"launches), span between events {span_ms:.3f} ms, idle "
        f"{out['replay_idle']:.2f}")
    if differ:
        raise RuntimeError(f"chunk: the replay differs from the eager "
                           f"chunk in {differ}")
    return out


def phase_chunked(device: dict, experts: str, params, prompts,
                  plain_outs) -> dict:
    """(b) The 24 requests at decode_chunk=CHUNK: decode and prefill tok/s,
    peak memory, utilization; the capture's launches (one replay's) hold
    the decode path: exactly DECODE_PATH / DECODE_INT8_PATH, K2 once a
    layer a step, every kernel a multiple of CHUNK, no plain call; the
    whole run holds the serving path. Then (a) on the state it left."""
    cfg = V2_LITE
    eng = Engine(params, cfg, max_slots=16, max_seq_len=4096,
                 decode_chunk=CHUNK, device=DEV)
    outs, wall, counts, plans, peak_gb = serve(eng, prompts)
    st = eng.stats
    prefill_tps = st["prefill_tokens"] / st["prefill_time_s"]
    util = st["decode_tokens"] / st["decode_slot_steps"]
    same = sum(a == b for a, b in zip(outs, plain_outs))
    graph = {n: c for n, c in eng.graph_launches.items() if any(c)}
    log(f"serving ({experts} experts) at decode_chunk={CHUNK}: {wall:.2f} s "
        f"wall; prefill {prefill_tps:.1f} tok/s, decode "
        f"{eng.tokens_per_second:.1f} tok/s over {st['decode_steps']} steps "
        f"({st['graph_replays']} replays, capture "
        f"{st['graph_capture_s']:.3f} s apart), utilization {util:.3f}, peak "
        f"memory {peak_gb:.2f} GiB; {same} of 24 outputs equal the "
        f"decode_chunk=1 run's; {device['smi']}")
    log(f"  the capture's launches (one replay's; launches, plain calls): "
        f"{graph}")
    log(f"  counters of the run (launches on the card: the capture's left "
        f"out, {st['graph_replays']} replays' put in; plain calls): "
        f"{counts}")
    if len(outs) != 24 or any(len(o) != 32 for o in outs) or \
            any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        raise RuntimeError(f"chunked serving: lengths "
                           f"{[len(o) for o in outs]} or tokens out of range")
    check_path(f"chunked serving ({experts})", counts,
               FP8_PATH if experts == "fp8" else INT8_PATH, plans)
    check_path(f"the captured chunk ({experts})", eng.graph_launches,
               DECODE_PATH if experts == "fp8" else DECODE_INT8_PATH)
    if graph["flash_decode"][0] != CHUNK * cfg.num_layers or \
            any(n % CHUNK for n, _ in graph.values()):
        raise RuntimeError(f"the captured chunk: launches {graph}, not "
                           f"each kernel's per-step launches x {CHUNK}")
    digest = cache_digest(eng)
    replay = check_chunk_replay(eng)
    return {"run": f"{experts} chunk {CHUNK}", "wall_s": wall,
            "prefill_tok_s": prefill_tps,
            "decode_tok_s": eng.tokens_per_second,
            "decode_steps": st["decode_steps"],
            "graph_replays": st["graph_replays"],
            "graph_capture_s": st["graph_capture_s"], "utilization": util,
            "peak_gib": peak_gb, "outputs_equal_chunk1": same,
            "graph_launches": graph, "counts": counts, "plans": plans,
            "replay": replay, "outputs": outs, "cache_sha256": digest}


def phase_prefix(device: dict, params) -> dict:
    """(c) PREFIX_REQUESTS requests that share a PREFIX_SYSTEM-token system
    prompt (4 tokens of their own), admitted in one step: on a cold engine,
    and on a warm one whose store holds the system prompt (seeded by one
    request). The admission's wall time each way (host clock ended by a
    synchronize), the hits and tokens reused. The two admissions compute
    the same rows in forwards of 16384 and 256 rows, which K1 sums in
    another f32 order (``fp8_gemm.ring_plan`` splits by m): each request's
    first-token logits must lie within PREFIX_REL_L2_TOL of the cold
    ones, and a first token may differ only where the cold top-1 margin
    over the warm token is below the largest difference of the two logit
    rows (a near-tie)."""
    cfg = V2_LITE
    rng = np.random.default_rng(3)
    system = rng.integers(1, cfg.vocab_size, size=PREFIX_SYSTEM).tolist()
    prompts = [system + rng.integers(1, cfg.vocab_size, size=4).tolist()
               for _ in range(PREFIX_REQUESTS)]

    def wave(prefix_slots):
        eng = Engine(params, cfg, max_slots=PREFIX_REQUESTS,
                     max_seq_len=4096, prefix_cache_slots=prefix_slots,
                     device=DEV)
        eng.generate([prompts[0]], max_new_tokens=1)     # seed (and warm)
        ids = [eng.scheduler.submit(p, 1) for p in prompts]
        logits = []
        real_prefill = engine_mod._prefill

        def recording_prefill(*args):
            logits.append(real_prefill(*args))
            return logits[-1]

        engine_metrics.reset()
        torch.cuda.synchronize()
        _kernels.reset_counters()
        engine_mod._prefill = recording_prefill
        try:
            t0 = time.perf_counter()
            eng.step()                   # one batched admission
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine_mod._prefill = real_prefill
        counts, snap = counts_now(), engine_metrics.snapshot()
        firsts = [eng.scheduler.pop_result(i).output[0] for i in ids]
        (rows,) = logits                 # one bucket: rows in request order
        return wall, firsts, counts, snap, rows[:PREFIX_REQUESTS].float()

    cold_wall, cold, cold_counts, _, cold_l = wave(0)
    warm_wall, warm, counts, snap, warm_l = wave(4)
    hits = int(snap.get("engine.prefix_hits", 0))
    reused = int(snap.get("engine.prefix_tokens_reused", 0))
    rel = ((warm_l - cold_l).norm(dim=-1) / cold_l.norm(dim=-1)).tolist()
    max_abs = (warm_l - cold_l).abs().amax(dim=-1)
    flips = [i for i, (a, b) in enumerate(zip(cold, warm)) if a != b]
    margins = {i: float(cold_l[i, cold[i]] - cold_l[i, warm[i]])
               for i in flips}
    log(f"prefix cache (fp8 experts): {PREFIX_REQUESTS} requests sharing a "
        f"{PREFIX_SYSTEM}-token system prompt, one batched admission: cold "
        f"{cold_wall * 1e3:.2f} ms, warm {warm_wall * 1e3:.2f} ms "
        f"({cold_wall / warm_wall:.2f}x); {hits} hits, {reused} tokens "
        f"reused; first-token logits warm vs cold rel-L2 max {max(rel):.3g} "
        f"(bound {PREFIX_REL_L2_TOL}), max abs {float(max_abs.max()):.3g}; "
        f"{PREFIX_REQUESTS - len(flips)} of {PREFIX_REQUESTS} first tokens "
        f"equal" + (f"; the others (request: the cold top-1 margin over the "
                    f"warm token, max |logit difference|): "
                    f"{ {i: (round(margins[i], 5), round(float(max_abs[i]), 5)) for i in flips} }"
                    if flips else "") + f"; {device['smi']}")
    log(f"  counters of the warm admission (launches, plain calls): {counts}")
    check_path("prefix cache (cold admission)", cold_counts, PREFILL_PATH)
    check_path("prefix cache (warm admission)", counts, PREFILL_PATH)
    if hits != PREFIX_REQUESTS or reused != PREFIX_REQUESTS * PREFIX_SYSTEM:
        raise RuntimeError(f"prefix cache: {hits} hits, {reused} reused")
    if not max(rel) < PREFIX_REL_L2_TOL or \
            not bool(torch.isfinite(warm_l).all()):
        raise RuntimeError(f"prefix cache: warm first-token logits vs cold "
                           f"rel-L2 {rel}")
    wide = {i: m for i, m in margins.items() if not m < float(max_abs[i])}
    if wide:
        raise RuntimeError(f"prefix cache: first tokens differ where the "
                           f"cold margin is not a near-tie: {wide}")
    return {"run": "prefix", "cold_admission_s": cold_wall,
            "warm_admission_s": warm_wall, "prefix_hits": hits,
            "tokens_reused": reused, "logits_rel_l2": rel,
            "first_tokens_equal": PREFIX_REQUESTS - len(flips),
            "flip_margins": margins, "counts": counts}


def _verify_witness(params, state, slot: int, drafts) -> dict:
    """At one slot's first decode state (``state``: every slot's caches,
    lengths and last tokens, cloned as serving reached its first decode
    step), the logits of that position by the plain decode step and by
    row 0 of the verify window (``Engine._verify``'s forward, drafts in
    the rows after it), each by the kernel path on the card (batch 1) and
    by the plain path on the CPU. Returns the rel-L2 between each pair."""
    cfg = V2_LITE
    caches, lens, last = state
    cpu = torch.device("cpu")
    cpu_params = to_device(params, cpu)
    got = {}
    for where, dev, p in (("card", DEV, params), ("cpu", cpu, cpu_params)):
        def one():
            return ([KVCache(*(t[slot:slot + 1].to(dev).clone()
                               for t in layer)) for layer in caches],
                    lens[slot:slot + 1].to(dev), last[slot:slot + 1].to(dev))
        c, ln, lt = one()
        got[where, "step"] = decode_step(p, lt, c, ln, cfg)[0][0].float().cpu()
        c, ln, lt = one()
        w = engine_mod._VERIFY_WINDOW
        toks = torch.zeros((1, w), dtype=torch.int32, device=dev)
        toks[0, 0] = lt[0]
        toks[0, 1:1 + len(drafts)] = torch.tensor(drafts, dtype=torch.int32)
        pos = ln[:, None] + torch.arange(w, device=dev,
                                         dtype=torch.int32)[None]
        logits, _ = forward(p, toks, c, pos, ln + w, cfg, prefill_start=ln)
        got[where, "verify"] = logits[0, 0].float().cpu()
    del cpu_params
    rel = lambda a, b: float((got[a] - got[b]).norm() / got[b].norm())
    return {"step_card_vs_cpu": rel(("card", "step"), ("cpu", "step")),
            "verify_card_vs_cpu": rel(("card", "verify"),
                                      ("cpu", "verify")),
            "card_verify_vs_step": rel(("card", "verify"), ("card", "step")),
            "cpu_verify_vs_step": rel(("cpu", "verify"), ("cpu", "step"))}


def phase_speculative(device: dict, params, prompts) -> dict:
    """(d) The first 16 of phase 4's requests (one wave: every run admits
    them in its first step, in one prefill per bucket, so every run
    decodes from the same caches) served by plain greedy decoding and with
    speculative_k=SPEC_K, drafted by prompt lookup and then by an oracle
    (each request's greedy continuation as the lookup run emitted it, as
    the JAX script's --spec-oracle records it with a speculative engine).
    Both speculative runs must emit the same tokens: drafts decide only
    how many land a verify. The verify window (K4, 256-row GEMMs) and the
    plain decode step (K2, 16-row GEMMs, other split plans) round
    differently, so each request is held to plain greedy serving by its
    logits, kept at every position by both runs: up to the position where
    its tokens first leave the plain run's (the two histories are equal
    there), within the phase-3 rel-L2 bound; and at that position, the
    plain step's top-1 margin over the speculative token below the largest
    difference of the two logit rows (a near-tie). A witness
    (``_verify_witness``) holds the decode step and the verify window at
    the earliest such request's first decode state to the plain path on
    the CPU, each within the same bound. Accepted / proposed drafts and
    decode tok/s each way."""
    cfg = V2_LITE
    prompts = prompts[:16]
    first_state = {}

    def run(record=True, keep_state=False, **kw):
        """Serve on a new engine; with ``record``, keep the logits of every
        decode position by (request, position): the plain step's rows, or
        the verify window's (those past what a verify accepted are kept
        until the next verify rewrites them). One copy a step on the card
        (its host time is in the run's tok/s)."""
        eng = Engine(params, cfg, max_slots=16, max_seq_len=4096,
                     device=DEV, **kw)
        records = []
        verifying = []
        real_step, real_forward = engine_mod.decode_step, engine_mod.forward
        real_verify = eng._verify

        def keep(logits, rows):
            if record:
                records.append((logits[:, :rows].clone(), [
                    (slot, req.req_id, len(req.output))
                    for slot, req in eng.scheduler.running.items()]))

        def step(*args, **kwargs):
            if keep_state and not first_state:
                first_state["state"] = engine_state(eng)
                first_state["slots"] = {
                    req.req_id: slot
                    for slot, req in eng.scheduler.running.items()}
            out = real_step(*args, **kwargs)
            keep(out[0][:, None], 1)
            return out

        def verify(toks, lens):
            verifying.append(True)
            try:
                return real_verify(toks, lens)
            finally:
                verifying.clear()

        def fwd(*args, **kwargs):
            out = real_forward(*args, **kwargs)
            if verifying:
                keep(out[0], SPEC_K + 1)
            return out

        eng._verify = verify
        engine_metrics.reset()
        engine_mod.decode_step, engine_mod.forward = step, fwd
        try:
            outs, wall, counts, plans, _ = serve(eng, prompts)
        finally:
            engine_mod.decode_step, engine_mod.forward = real_step, \
                real_forward
            del eng._verify     # the hook holds the engine: no cycle left
        snap = engine_metrics.snapshot()
        acc = (int(snap.get("engine.spec_accepted", 0)),
               int(snap.get("engine.spec_proposed", 0)))
        # Requests are numbered in the order generate submits them.
        ids = sorted({rid for _, where in records for _, rid, _ in where})
        kept = {(ids.index(rid), pos + j): block[slot, j]
                for block, where in records for slot, rid, pos in where
                for j in range(block.shape[1])}
        return outs, wall, counts, plans, acc, eng, kept

    plain, wall_p, counts_p, plans_p, _, eng_p, kept_p = run(
        keep_state=True)
    lookup, wall_l, counts_l, plans_l, acc_l, eng_l, kept_l = run(
        speculative_k=SPEC_K)
    orc, wall_o, counts, plans, acc_o, eng_o, _ = run(
        record=False, speculative_k=SPEC_K,
        draft_fn=serve_bench.recorded_drafts(prompts, lookup))
    if any(x[0] != y[0] for x, y in zip(lookup, plain)):
        raise RuntimeError("speculative: the first tokens (one admission, "
                           "the same in every run) differ")
    rel_l2 = lambda a, b: float((a - b).norm() / b.norm())
    first_diff, rels, near_ties = [], [], {}
    for i, (x, y) in enumerate(zip(lookup, plain)):
        d = next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
        first_diff.append(d)
        last = d if d is not None else len(x) - 1
        rels.append(max(rel_l2(kept_l[i, j], kept_p[i, j])
                        for j in range(1, last + 1)))
        if d is not None:
            lp, ll = kept_p[i, d], kept_l[i, d]
            near_ties[i] = (float(lp[y[d]] - lp[x[d]]),
                            float((lp - ll).abs().max()))
    del kept_p, kept_l
    same_plain = first_diff.count(None)
    ties_ok = all(m < gap for m, gap in near_ties.values())
    log(f"speculative decoding (fp8 experts, k={SPEC_K}, 16 slots, 16 "
        f"requests, 32 new tokens): plain greedy {eng_p.tokens_per_second:.1f}"
        f" tok/s over {eng_p.stats['decode_steps']} steps, {wall_p:.2f} s "
        f"wall; prompt lookup {acc_l[0]}/{acc_l[1]} drafts accepted, "
        f"{eng_l.tokens_per_second:.1f} tok/s over "
        f"{eng_l.stats['decode_steps']} verifies, {wall_l:.2f} s; oracle "
        f"{acc_o[0]}/{acc_o[1]}, {eng_o.tokens_per_second:.1f} tok/s over "
        f"{eng_o.stats['decode_steps']} verifies, {wall_o:.2f} s; oracle "
        f"tokens {'equal' if orc == lookup else 'DIFFER from'} the lookup "
        f"run's; {device['smi']}")
    log(f"  against plain greedy serving: {same_plain} of 16 outputs equal; "
        f"first position where each leaves it {first_diff}; logits rel-L2 "
        f"up to there, max a request {[round(r, 4) for r in rels]} (bound "
        f"{MODEL_REL_L2_TOL}); where they part (request: plain top-1 margin "
        f"over the speculative token, max |logit difference|) "
        f"{ {i: (round(m, 5), round(g, 5)) for i, (m, g) in near_ties.items()} }")
    # The witness, at the request that parts first (request 0 if none).
    i = min(range(16), key=lambda r: (first_diff[r] is None,
                                      first_diff[r] or 0))
    slot = first_state["slots"][sorted(first_state["slots"])[i]]
    witness = _verify_witness(params, first_state.pop("state"), slot,
                              plain[i][1:1 + SPEC_K])
    log(f"  witness at request {i}'s first decode state (batch 1), logits "
        f"rel-L2: decode step card vs CPU plain "
        f"{witness['step_card_vs_cpu']:.4f}, verify row 0 card vs CPU plain "
        f"{witness['verify_card_vs_cpu']:.4f}; verify vs step on the card "
        f"{witness['card_verify_vs_step']:.4f}, on the CPU "
        f"{witness['cpu_verify_vs_step']:.4f}")
    log(f"  counters of the oracle run (launches, plain calls): {counts}")
    check_path("plain greedy", counts_p, FP8_PATH, plans_p)
    # The verify window never decodes a single token: no K2.
    check_path("speculative (lookup)", counts_l, SPEC_PATH, plans_l)
    check_path("speculative (oracle)", counts, SPEC_PATH, plans)
    if orc != lookup:
        raise RuntimeError("speculative: oracle drafts changed the tokens")
    if not max(rels) < MODEL_REL_L2_TOL or not ties_ok:
        raise RuntimeError(f"speculative: against plain greedy, logits "
                           f"rel-L2 {rels}, partings {near_ties}")
    if not max(witness["step_card_vs_cpu"],
               witness["verify_card_vs_cpu"]) < MODEL_REL_L2_TOL:
        raise RuntimeError(f"speculative: witness {witness}")
    return {"run": f"speculative k={SPEC_K}",
            "plain": {"decode_tok_s": eng_p.tokens_per_second,
                      "steps": eng_p.stats["decode_steps"], "wall_s": wall_p},
            "lookup": {"accepted": acc_l[0], "proposed": acc_l[1],
                       "decode_tok_s": eng_l.tokens_per_second,
                       "verifies": eng_l.stats["decode_steps"],
                       "wall_s": wall_l},
            "oracle": {"accepted": acc_o[0], "proposed": acc_o[1],
                       "decode_tok_s": eng_o.tokens_per_second,
                       "verifies": eng_o.stats["decode_steps"],
                       "wall_s": wall_o},
            "logits_rel_l2_vs_plain": rels, "partings": near_ties,
            "outputs_equal_plain": same_plain,
            "first_divergence": first_diff, "witness": witness,
            "counts": counts}


# ---------------------------------------------------------------- phase 5

def _deepgemm_routed(mp, x: torch.Tensor, cfg, out_bufs: bool = True):
    """The routed experts of one MoE layer as a DeepGEMM caller runs them:
    the same router, top-k and per-token weights as models/moe.py, the
    routed rows laid out expert-contiguous in 128-row tiles with per-row
    ``m_indices``, ``m_grouped_gemm_fp8_fp8_bf16_nt_contiguous`` for w1
    into a preallocated buffer, SwiGLU, re-quantization, the same call for
    w2, and the weighted combine. Returns ((t, hidden) f32, the w2 output
    and the layout row of every (token, k))."""
    t, hidden = x.shape
    e = cfg.num_experts
    exp = mp.experts
    weights, topk_idx = route_topk(mp.router(x), cfg.top_k)
    slot, masked_m, _ = dispatch_masked(topk_idx, e)
    counts = masked_m.tolist()             # the caller plans on the host
    m_total, gids, _ = ggmod.make_contiguous_layout(counts, 128)
    spans = torch.tensor([-(-c // 128) * 128 for c in counts], device=DEV)
    offset = torch.cumsum(spans, 0) - spans
    rows = (offset[topk_idx.long()] + slot).reshape(-1)
    buf = torch.zeros((m_total, hidden), dtype=torch.bfloat16, device=DEV)
    buf[rows] = torch.repeat_interleave(x, cfg.top_k, dim=0)
    m_indices = torch.from_numpy(np.repeat(gids, 128)).to(DEV)
    h = (torch.empty((m_total, exp.w1_q.shape[1]), dtype=torch.bfloat16,
                     device=DEV) if out_bufs else None)
    h = deep_gemm.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(
        quant.quantize_fp8_act(buf), (exp.w1_q, exp.w1_s), h, m_indices)
    hq = quant.quantize_fp8_act(moemod._swiglu(h))
    y = (torch.empty((m_total, hidden), dtype=torch.bfloat16, device=DEV)
         if out_bufs else None)
    y = deep_gemm.m_grouped_gemm_fp8_fp8_bf16_nt_contiguous(
        hq, (exp.w2_q, exp.w2_s), y, m_indices)
    gathered = y[rows].reshape(t, cfg.top_k, hidden)
    out = torch.sum(gathered.to(torch.float32) * weights[:, :, None], dim=1)
    return out, y, rows


def _int8_routed_contiguous(mp, x: torch.Tensor, cfg):
    """The routed experts of one MoE layer with W8A8 int8 experts on the
    contiguous layout: the same routing, layout and combine as
    :func:`_deepgemm_routed`, activations quantized per token as the MoE
    layer quantizes them, ``m_grouped_int8_gemm_contiguous`` (K9) for w1
    and w2. Returns (t, hidden) f32."""
    t, hidden = x.shape
    exp = mp.experts
    weights, topk_idx = route_topk(mp.router(x), cfg.top_k)
    slot, masked_m, _ = dispatch_masked(topk_idx, cfg.num_experts)
    counts = masked_m.tolist()
    _, gids, _ = ggmod.make_contiguous_layout(counts, 128)
    spans = torch.tensor([-(-c // 128) * 128 for c in counts], device=DEV)
    offset = torch.cumsum(spans, 0) - spans
    rows = (offset[topk_idx.long()] + slot).reshape(-1)
    buf = torch.zeros((int(spans.sum()), hidden), dtype=torch.bfloat16,
                      device=DEV)
    buf[rows] = torch.repeat_interleave(x, cfg.top_k, dim=0)
    gemm = lambda a, w_q, w_s: i8mod.m_grouped_int8_gemm_contiguous(
        *quant.quantize_int8(a, axis=-1), w_q, w_s, gids, b_layout="t")
    y = gemm(moemod._swiglu(gemm(buf, exp.w1_q, exp.w1_s)), exp.w2_q,
             exp.w2_s)
    gathered = y[rows].reshape(t, cfg.top_k, hidden)
    return torch.sum(gathered.to(torch.float32) * weights[:, :, None], dim=1)


def phase_compat(device: dict) -> dict:
    """The compat API at V2_LITE's widths (module docstring, phase 5). The
    calls run first, between zeroing and reading the counters; every
    check against the plain path comes after."""
    cfg = dataclasses.replace(V2_LITE, num_layers=2)   # layer 1: MoE
    params = init_params(0, cfg, device=DEV)
    mp = params.layers[1].ffn
    mp8 = params_with_int8_experts(params).layers[1].ffn
    hidden, ffn = cfg.hidden_size, cfg.dense_intermediate
    g = _gen(70)
    bench_params = [1, 1, 4, 8, 6, 2]
    dense, fp8_calls = [], []
    for n, k in LITE_GEMMS:
        for m in DENSE_M:
            x = torch.randn(m, k, generator=g, device=DEV).to(torch.bfloat16)
            w = (torch.randn(k, n, generator=g, device=DEV)
                 / math.sqrt(k)).to(torch.bfloat16)
            dense.append((f"m={m} n={n} k={k}", x, w))
    # ... and V2_LITE_FULL's dense down projection, whose k is ragged.
    full_w2 = (V2_LITE_FULL.hidden_size, V2_LITE_FULL.dense_intermediate)
    fp8_shapes = [(m, n, k) for n, k in LITE_GEMMS + [full_w2]
                  for m in DENSE_M]
    for m, n, k in fp8_shapes:
        lhs = quant.quantize_fp8_act(
            torch.randn(m, k, generator=g, device=DEV))
        rhs = quant.quantize_fp8_weight(
            torch.randn(n, k, generator=g, device=DEV) / math.sqrt(k))
        fp8_calls.append((f"m={m} n={n} k={k}", lhs, rhs))
    xb = [torch.randn(4, m, hidden, generator=g, device=DEV).to(
        torch.bfloat16) for m in DENSE_M]
    wb = (torch.randn(4, hidden, hidden, generator=g, device=DEV)
          / math.sqrt(hidden)).to(torch.bfloat16)
    x_ffn = torch.randn(DENSE_M[0], ffn, generator=g, device=DEV).to(
        torch.bfloat16)
    w_ffn = (torch.randn(ffn, hidden, generator=g, device=DEV)
             / math.sqrt(ffn)).to(torch.bfloat16)
    x_moe = torch.randn(PREFILL_TOKENS, hidden, generator=g, device=DEV).to(
        torch.bfloat16)
    x_dec = torch.randn(DENSE_M[0], hidden, generator=g, device=DEV).to(
        torch.bfloat16)
    _, idx_dec = route_topk(mp.router(x_dec), cfg.top_k)
    slot_dec, mm_dec, cap_dec = dispatch_masked(idx_dec, cfg.num_experts)
    buf_dec = torch.zeros((cfg.num_experts, cap_dec, hidden),
                          dtype=torch.bfloat16, device=DEV)
    buf_dec[idx_dec.reshape(-1).long(), slot_dec.reshape(-1).long()] = \
        torch.repeat_interleave(x_dec, cfg.top_k, dim=0)
    lhs_dec = quant.quantize_fp8_act(buf_dec)
    torch.cuda.synchronize()

    # ---- the driven run: counters zeroed before, read after
    _kernels.reset_counters()
    t0 = time.perf_counter()
    api = []
    for label, x, w in dense:
        m, n = x.shape[0], w.shape[1]
        z32 = [torch.empty((m, n), device=DEV) for _ in range(2)]
        z16 = torch.empty((m, n), dtype=torch.bfloat16, device=DEV)
        same = (compat.run_mmad_rtc(x, w, z32[0]) is z32[0],
                compat.run_mmad_custom(x, w, z32[1]) is z32[1],
                compat.run_mmad_bench(x, w, z16, bench_params) is z16)
        api.append((label, x, w, z32 + [z16], all(same)))
    zb = [torch.empty((4, xi.shape[1], hidden), device=DEV) for xi in xb]
    batched_same = all(compat.run_mmad_custom(xi, wb, z) is z
                       for xi, z in zip(xb, zb))
    y_select = gemm(x_ffn, w_ffn)
    y_ksplit = gemm(x_ffn, w_ffn, config=k10_config(
        x_ffn, w_ffn, "nn", DENSE_M[0], hidden, splits=4))
    fp8_outs = []
    for label, lhs, rhs in fp8_calls:
        out = torch.empty((lhs[0].shape[0], rhs[0].shape[0]),
                          dtype=torch.bfloat16, device=DEV)
        fp8_outs.append((out, deep_gemm.gemm_fp8_fp8_bf16_nt(lhs, rhs, out)
                         is out))
    routed_dg, y_dg, rows_dg = _deepgemm_routed(mp, x_moe, cfg)
    routed_masked = moemod._moe_routed(mp, x_moe, cfg)
    routed_i8 = _int8_routed_contiguous(mp8, x_moe, cfg)
    routed_i8_masked = moemod._moe_routed(mp8, x_moe, cfg)
    out_dec = torch.empty((cfg.num_experts, cap_dec, mp.experts.w1_q.shape[1]),
                          dtype=torch.bfloat16, device=DEV)
    dec_same = deep_gemm.m_grouped_gemm_fp8_fp8_bf16_nt_masked(
        lhs_dec, (mp.experts.w1_q, mp.experts.w1_s), out_dec, mm_dec,
        expected_m=cap_dec // cfg.num_experts) is out_dec
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_now()

    # ---- checks against the plain path
    failures = []
    for label, x, w, zs, same in api:
        ref = gemm_plain(x, w)
        ok = same and all(gemm_close(z, ref if z.dtype == torch.float32
                                     else ref.to(z.dtype), x, w) for z in zs)
        if not ok:
            failures.append(f"run_mmad_* {label}")
    for xi, z in zip(xb, zb):
        if not (batched_same and gemm_close(z, gemm_plain(xi, wb), xi, wb)):
            failures.append(f"run_mmad_custom batched m={xi.shape[1]}")
    ref_ffn = gemm_plain(x_ffn, w_ffn)
    for name, y in (("gemm select_config", y_select),
                    ("gemm KSPLIT/4", y_ksplit)):
        if not gemm_close(y, ref_ffn, x_ffn, w_ffn):
            failures.append(name)
    for (label, lhs, rhs), (out, same) in zip(fp8_calls, fp8_outs):
        a_q, a_s, b_q, b_s, n = pad_fp8_operands_nt(*lhs, *rhs)
        ref = fp8mod.fp8_gemm_plain(a_q, a_s, b_q, b_s.t(), b_t=True)[:, :n]
        if not (same and within_one_bf16_ulp(out, ref)):
            failures.append(f"gemm_fp8_fp8_bf16_nt {label}")
    moe_bit_equal = torch.equal(routed_dg, routed_masked)
    moe_ulp = within_one_bf16_ulp(routed_dg, routed_masked)
    moe_rel = float((routed_dg - routed_masked).norm()
                    / routed_masked.norm())
    if not (moe_bit_equal or moe_ulp):
        failures.append(f"MoE prefill contiguous vs masked (rel-L2 "
                        f"{moe_rel:.3g})")
    # int8: both sums exact and every other step row by row, so the
    # contiguous path (K9) must equal the masked one (K6) bit for bit.
    int8_bit_equal = bool(torch.equal(routed_i8, routed_i8_masked))
    if not int8_bit_equal:
        failures.append("int8 MoE prefill contiguous (K9) vs masked (K6)")
    pad_rows = torch.ones(y_dg.shape[0], dtype=torch.bool, device=DEV)
    pad_rows[rows_dg] = False
    if bool((y_dg[pad_rows] != 0).any()):
        failures.append("MoE prefill: a padding row is not zero")
    ref_dec = ggmod.grouped_gemm_masked_plain(
        *lhs_dec, mp.experts.w1_q, mp.experts.w1_s.transpose(1, 2), mm_dec,
        b_t=True)
    for ei, r in enumerate(mm_dec.tolist()):
        if r and not within_one_bf16_ulp(out_dec[ei, :r], ref_dec[ei, :r]):
            failures.append(f"masked alias expert {ei}")
    if not dec_same:
        failures.append("masked alias did not return out")
    # The MoE layer's routed experts, timed both ways (after the counts).
    moe_ms = {"contiguous_K8": cold_ms(lambda: _deepgemm_routed(
                  mp, x_moe, cfg), reps=5),
              "masked_K3": cold_ms(lambda: moemod._moe_routed(
                  mp, x_moe, cfg), reps=5),
              "contiguous_K9": cold_ms(lambda: _int8_routed_contiguous(
                  mp8, x_moe, cfg), reps=5),
              "masked_K6": cold_ms(lambda: moemod._moe_routed(
                  mp8, x_moe, cfg), reps=5)}
    picked = {f"{label} bf16": _picked(x.shape[0], w.shape[1], w.shape[0],
                                       torch.bfloat16)
              for label, x, w in dense}
    picked["gemm " + f"m={DENSE_M[0]} n={hidden} k={ffn}"] = _picked(
        DENSE_M[0], hidden, ffn, torch.bfloat16)
    log(f"compat API: {len(api)} run_mmad_* shapes x 3 calls, 2 batched, "
        f"gemm twice, {len(fp8_calls)} gemm_fp8_fp8_bf16_nt, one MoE "
        f"prefill layer ({PREFILL_TOKENS} tokens, E={cfg.num_experts}, "
        f"top-{cfg.top_k}) with fp8 and with int8 experts each way and one "
        f"decode masked call in {wall:.2f} s wall; "
        f"{device['smi']}")
    log(f"  select_config: {picked}")
    log(f"  MoE prefill, contiguous (K8) vs masked (K3) routed output: "
        f"bit-equal={moe_bit_equal}, within one bf16 ulp={moe_ulp}, "
        f"rel-L2 {moe_rel:.3g}; routed experts between CUDA events (host "
        f"planning and the alias's id check included): K8 path "
        f"{moe_ms['contiguous_K8']:.3f} ms, K3 path "
        f"{moe_ms['masked_K3']:.3f} ms")
    log(f"  int8 MoE prefill (W8A8 experts), contiguous (K9) vs masked (K6) "
        f"routed output: bit-equal={int8_bit_equal}; K9 path "
        f"{moe_ms['contiguous_K9']:.3f} ms, K6 path "
        f"{moe_ms['masked_K6']:.3f} ms")
    log(f"  counters (launches, plain calls): {counts}")
    log(f"  launches by plan: {launch_plans()}")
    if failures:
        raise RuntimeError(f"compat API disagrees with the plain path: "
                           f"{failures}")
    check_path("compat", counts, COMPAT_PATH)
    return {"run": "compat", "wall_s": wall, "counts": counts,
            "select_config": picked, "moe_bit_equal": moe_bit_equal,
            "int8_moe_bit_equal": int8_bit_equal,
            "moe_rel_l2": moe_rel, "moe_routed_ms": moe_ms}


# ---------------------------------------------------------------- phase 6

def _kernel_layout(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """(b, s, heads, hd) → the plain prefill versions' (b, kvh, g, s, hd)."""
    b, s, heads, hd = q.shape
    return q.reshape(b, s, kvh, heads // kvh, hd).permute(0, 2, 3, 1, 4)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A plain prefill version's (b, kvh, g, s, …) → (b, s, heads, …)."""
    b, kvh, g, s = x.shape[:4]
    return x.permute(0, 3, 1, 2, *range(4, x.dim())).reshape(
        b, s, kvh * g, *x.shape[4:])


def _profile_prefill_forward(eng: Engine) -> dict:
    """One prefill forward of the serving run's largest bucket (1024: its
    first admissions' 1024-bucket prompts and a padding row) under
    torch.profiler, after the decode step's (``bench.prefill_profile``):
    the split of prefill time between K4 and the rest."""
    prof = prefill_profile.profile_bucket(eng, 1024)
    log(f"  one prefill forward (bucket 1024, {prof['rows']} rows, lengths "
        f"{prof['lengths']}) under torch.profiler: wall {prof['wall_ms']:.2f}"
        f" ms (unprofiled {prof['unprofiled_wall_ms']:.2f}), device kernels "
        f"{prof['device_ms']:.2f} ms ({prof['launches']} launches), K4 "
        f"{prof['k4_ms']:.3f} ms ({prof['k4_launches']} launches)")
    for k in prof["top"]:
        log(f"    {k['ms']:8.3f} ms  x{k['count']:<4d} {k['kernel'][:90]}")
    return prof


def _shards(cache, cp: int):
    """The cache's cp sequence shards, as the ring's ranks hold them."""
    s_local = cache[0].shape[2] // cp
    return [[t[:, :, r * s_local:(r + 1) * s_local].contiguous()
             for t in cache] for r in range(cp)]


def _flash_ring_in_turn(q, shards) -> torch.Tensor:
    """ring_flash_prefill's ring with every rank run in turn in this process
    through its own hop loop (``ring_attention._flash_ring``): where a rank
    would receive the next KV shard from the ring, it takes that shard.
    (b, s, heads, hd) f32."""
    cp = len(shards)
    s_local = q.shape[1] // cp
    return torch.cat([ringmod._finish(ringmod._flash_ring(
        q[:, r * s_local:(r + 1) * s_local], shards[r], r, cp,
        lambda kv, owner: shards[owner]), torch.float32)
        for r in range(cp)], dim=1)


def _f32_ring_in_turn(q, k, v, cp: int, zigzag: bool) -> torch.Tensor:
    """ring_attention_prefill's causal ring, every rank in turn through its
    own hop loop (``ring_attention._attn_ring``), rows in sequence order
    (zigzag: permuted before, un-permuted with zigzag_inverse after).
    (b, s, heads, hd) f32."""
    s = q.shape[1]
    if zigzag:
        order = torch.from_numpy(zigzag_order(cp, s)).to(q.device)
        q, k, v = q[:, order], k[:, order], v[:, order]
    s_local = s // cp
    sl = lambda t, r: t[:, r * s_local:(r + 1) * s_local]
    out = torch.cat([ringmod._finish(ringmod._attn_ring(
        sl(q, r), sl(k, r), sl(v, r), r, cp,
        lambda kv, owner: (sl(k, owner), sl(v, owner)), causal=True,
        zigzag=zigzag), torch.float32) for r in range(cp)], dim=1)
    if zigzag:
        out = out[:, torch.from_numpy(zigzag_inverse(cp, s)).to(q.device)]
    return out


def _attn_f32_plain(q, k, v, p0: int):
    """Plain causal attention in f32 of the query rows at positions p0, …
    over the dequantized k/v (b, s, kvh, hd): softmax(q·k/√hd)·v, and
    softmax·|v| (the scale of its tolerance)."""
    n, heads, hd = q.shape[1:]
    g = heads // k.shape[2]
    kk = k.repeat_interleave(g, dim=2)
    vv = v.repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(hd)
    pos = p0 + torch.arange(n, device=q.device)
    future = torch.arange(k.shape[1], device=q.device)[None] > pos[:, None]
    p = torch.softmax(sc.masked_fill(future, float("-inf")), dim=-1)
    return (torch.einsum("bhqk,bkhd->bqhd", p, vv),
            torch.einsum("bhqk,bkhd->bqhd", p, vv.abs()))


def _cp_plain_checks(q, cache, k_deq, v_deq, shards, outs):
    """Phase 6's kernels and rings against plain versions at phase 6's
    shapes, on CP_CHECK_ROWS rows at each end of every rank's shard (the
    first rows of a shard see the fewest keys of its diagonal hop, the last
    the most): every hop of the cp=4 flash ring (K4-stats) against the
    plain state; K4 over the whole cache and both flash rings against
    plain K4; the f32 rings against plain f32 attention. Returns
    {check: max abs error}, {check: the largest share of its per-element
    limit used}, failures."""
    kvh = cache[0].shape[1]
    cp = len(shards)
    s_local = shards[0][0].shape[2]
    n = CP_CHECK_ROWS
    ends = (0, s_local - n)
    errs, used, failures = {}, {}, []

    def note(name, got, ref, ok, tol):
        diff = (got.float() - ref.float()).abs()
        errs[name] = max(errs.get(name, 0.0), float(diff.max()))
        used[name] = max(used.get(name, 0.0),
                         float((diff / tol.clamp_min(1e-30)).max()))
        if not ok and name not in failures:
            failures.append(name)

    for r in range(cp):
        q_r = q[:, r * s_local:(r + 1) * s_local]
        for owner in range(cp):
            hop = ringmod._hop(q_r, *shards[owner], r - owner)
            for r0 in ends:
                qg = _kernel_layout(q_r[:, r0:r0 + n], kvh)
                st = torch.full((1,), (r - owner) * s_local + r0,
                                dtype=torch.int32, device=DEV)
                ln = torch.full((1,), s_local, dtype=torch.int32, device=DEV)
                ref = [_rows(x) for x in fpmod.flash_prefill_stats_plain(
                    qg, *shards[owner], st, ln)]
                pv = _rows(fpmod.flash_prefill_stats_plain(
                    qg, *abs_v(shards[owner]), st, ln)[0])
                got = [x[:, r0:r0 + n] for x in hop]
                note(f"k4_stats_hops_cp{cp}_vs_plain", got[0], ref[0],
                     state_close(got, ref, pv), PV_ROUNDING * pv)
        for r0 in ends:
            p0 = r * s_local + r0
            qg = _kernel_layout(q[:, p0:p0 + n], kvh)
            st = torch.full((1,), p0, dtype=torch.int32, device=DEV)
            ln = torch.full((1,), q.shape[1], dtype=torch.int32, device=DEV)
            ref = _rows(fpmod.flash_prefill_plain(qg, *cache, st, ln))
            pv = _rows(fpmod.flash_prefill_plain(qg, *abs_v(cache), st, ln))
            for name in ("k4_whole", "ring_flash_cp1",
                         f"ring_flash_cp{cp}"):
                got = outs[name][:, p0:p0 + n]
                note(f"{name}_vs_plain", got, ref,
                     output_close(got, ref, pv),
                     PV_ROUNDING * pv + 1e-4 * ref.abs())
            ref, pv = _attn_f32_plain(q[:, p0:p0 + n], k_deq, v_deq, p0)
            for name in (f"f32_ring_cp{cp}_contiguous",
                         f"f32_ring_cp{cp}_zigzag", "ring_attention_cp1"):
                if name not in outs or p0 + n > outs[name].shape[1]:
                    continue
                got = outs[name][:, p0:p0 + n]
                note(f"{name}_vs_plain_f32", got, ref,
                     bool(((got - ref).abs() <= F32_ATTN_TOL * pv).all()),
                     F32_ATTN_TOL * pv)
    return errs, used, failures


def phase_cp(device: dict) -> dict:
    """Context-parallel prefill at V2_LITE's attention width, then the first
    decode token and the o-projection through the direct ops (module
    docstring, phase 6). The calls run first, between zeroing and reading
    the counters; the checks against the plain versions come after."""
    cfg = V2_LITE
    s, heads, kvh, hd = CP_TOKENS, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    g = _gen(80)
    q = torch.randn(1, s, heads, hd, generator=g, device=DEV).to(
        torch.bfloat16)
    # The serving cache's quantization: per token and kv head, int8 values
    # with one f32 scale (models/attention.py).
    kq, ks = quant.quantize_int8(
        torch.randn(1, s, kvh, hd, generator=g, device=DEV), axis=-1)
    vq, vs = quant.quantize_int8(
        torch.randn(1, s, kvh, hd, generator=g, device=DEV), axis=-1)
    k_deq, v_deq = kq.float() * ks, vq.float() * vs       # (1, s, kvh, hd)
    cache = (kq.permute(0, 2, 1, 3).contiguous(),
             ks[..., 0].permute(0, 2, 1).contiguous(),
             vq.permute(0, 2, 1, 3).contiguous(),
             vs[..., 0].permute(0, 2, 1).contiguous())
    shards = _shards(cache, CP_RANKS)
    zero = torch.zeros(1, dtype=torch.int32, device=DEV)
    lens = torch.full((1,), s, dtype=torch.int32, device=DEV)
    # The decode of the last prompt token (row s-1 as the "new" row) and
    # the o-projection of the attention output.
    q_dec = torch.randn(1, heads, hd, generator=g, device=DEV).to(
        torch.bfloat16)
    new_row = [t[:, :, s - 1].contiguous() for t in cache]  # kq, ks, vq, vs
    w_q, w_s = quant.quantize_fp8_weight(
        torch.randn(cfg.hidden_size, heads * hd, generator=g, device=DEV)
        / math.sqrt(heads * hd))
    written = [t.clone() for t in cache]
    torch.cuda.synchronize()

    # ---- the driven run: counters zeroed before, read after
    _kernels.reset_counters()
    t0 = time.perf_counter()
    ref = fpmod.flash_prefill_gqa(q, *cache, zero, lens)       # K4, whole
    ring1 = ring_flash_prefill(q, *cache, cp=1, out_dtype=torch.float32)
    dense1 = ring_attention_prefill(
        q[:, :CP_DENSE_ROWS], k_deq[:, :CP_DENSE_ROWS],
        v_deq[:, :CP_DENSE_ROWS], cp=1, out_dtype=torch.float32)
    torch.cuda.synchronize()
    stats = _kernels.COUNTERS["flash_prefill_stats"]
    stats_before, t_ring = stats.launches, time.perf_counter()
    ring4 = _flash_ring_in_turn(q, shards)
    torch.cuda.synchronize()
    ring4_s = time.perf_counter() - t_ring
    stats_launches = stats.launches - stats_before
    zig4 = _f32_ring_in_turn(q, k_deq, v_deq, CP_RANKS, zigzag=True)
    cont4 = _f32_ring_in_turn(q, k_deq, v_deq, CP_RANKS, zigzag=False)
    read = fdmod.flash_decode_gqa(q_dec, *cache, lens)
    state = fdmod.flash_decode_gqa_state(q_dec, *cache, lens - 1)
    k2 = fdmod.flash_decode_gqa_inplace(
        q_dec, *written, new_row[0], new_row[2], new_row[1], new_row[3],
        lens)[0]
    x_q, x_s = quant.quantize_fp8_act(ring4.reshape(s, heads * hd))
    y_folded = fp8mod.fp8_gemm(x_q, x_s, w_q, w_s, b_layout="t",
                               scale_mode="folded", allow_relaxed=True)
    y_k1 = fp8mod.fp8_gemm(x_q, x_s, w_q, w_s, b_layout="t",
                           out_dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_now()

    # ---- checks: against the plain versions at these shapes, then the
    # siblings over every row
    outs = {"k4_whole": ref, "ring_flash_cp1": ring1,
            f"ring_flash_cp{CP_RANKS}": ring4,
            f"f32_ring_cp{CP_RANKS}_contiguous": cont4,
            f"f32_ring_cp{CP_RANKS}_zigzag": zig4,
            "ring_attention_cp1": dense1}
    errs, used, failures = _cp_plain_checks(q, cache, k_deq, v_deq, shards,
                                            outs)
    err = lambda a, b: float((a.float() - b.float()).abs().max())
    # The decode ops: K5a and K2 against plain over the same (written)
    # cache, K5b over the rows before the last, and K5b merged with the
    # last row exactly against K2.
    read_ref = fdmod.flash_decode_plain(q_dec, *cache, lens).reshape(
        1, heads, hd)
    read_pv = fdmod.flash_decode_plain(q_dec, *abs_v(cache), lens).reshape(
        1, heads, hd)
    k2_ref = fdmod.flash_decode_inplace_plain(
        q_dec, *[t.clone() for t in cache], new_row[0], new_row[2],
        new_row[1], new_row[3], lens).reshape(1, heads, hd)
    state_ref = [x.reshape(1, heads, *x.shape[3:]) for x in
                 fdmod.flash_decode_state_plain(q_dec, *cache, lens - 1)]
    state_pv = fdmod.flash_decode_state_plain(
        q_dec, *abs_v(cache), lens - 1)[0].reshape(1, heads, hd)
    merged = fdmod.merge_current_token(state, q_dec, new_row[0], new_row[1],
                                       new_row[2], new_row[3])
    # The o-projection: K12 and K1 against their plain versions (the folded
    # operands give Σ|a·b| for both to 2^-8).
    a_sc, b_sc = fp8mod.fold_operands(x_q, x_s, w_q, w_s.t(), b_t=True)
    folded_ref = fp8mod.fp8_gemm_folded_plain(x_q, x_s, w_q, w_s.t(),
                                              b_t=True)
    k1_ref = fp8mod.fp8_gemm_plain(x_q, x_s, w_q, w_s.t(), b_t=True,
                                   out_dtype=torch.float32)
    torch.cuda.synchronize()
    for name, got, want, ok in (
            ("k5a_vs_plain", read, read_ref,
             output_close(read, read_ref, read_pv)),
            ("k2_vs_plain", k2, k2_ref, output_close(k2, k2_ref, read_pv)),
            ("k5b_vs_plain", state[0], state_ref[0],
             state_close(state, state_ref, state_pv)),
            ("k12_vs_plain", y_folded, folded_ref,
             gemm_close(y_folded, folded_ref, a_sc, b_sc)),
            ("k1_vs_plain", y_k1, k1_ref,
             gemm_close(y_k1, k1_ref, a_sc, b_sc))):
        errs[name] = err(got, want)
        if not ok:
            failures.append(name)
    # Siblings over every row: the flash rings run K4's body (cp=1: the
    # same chunks; cp=4: other running maxima, so within ATTN_TOL), the f32
    # rings each other and the cp=1 f32 entry (f32 sum order only), K5a
    # over the written cache and K5b + the exact merge K2.
    siblings = {"ring_flash_cp1_vs_k4": (ring1, ref, ATTN_TOL),
                f"ring_flash_cp{CP_RANKS}_vs_k4": (ring4, ref, ATTN_TOL),
                f"f32_ring_cp{CP_RANKS}_zigzag_vs_contiguous":
                    (zig4, cont4, F32_SIBLING_TOL),
                "ring_attention_cp1_vs_contiguous_ring":
                    (dense1, cont4[:, :CP_DENSE_ROWS], F32_SIBLING_TOL),
                "k5a_vs_k2": (read, k2, ATTN_TOL),
                "k5b_merged_vs_k2": (merged, k2, ATTN_TOL)}
    limits = {}
    for name, (a, b, tol) in siblings.items():
        errs[name], limits[name] = err(a, b), tol
        if not errs[name] < tol:
            failures.append(f"{name} {errs[name]:.3g} >= {tol:.3g}")
    # K5a over the cache (its last row the one K2 takes as new, on K2's
    # grid): K2's output bit for bit.
    if not torch.equal(read, k2):
        failures.append("k5a_equals_k2 (route live, bit for bit)")
    rel_folded = float((y_folded.float() - y_k1).norm() / y_k1.norm())
    finite = all(bool(torch.isfinite(t).all())
                 for t in (ref, ring1, ring4, zig4, cont4, read, y_folded))
    if rel_folded >= FOLDED_REL_L2:
        failures.append(f"K12 o-projection rel-L2 vs K1 {rel_folded:.3g}")
    if not finite or ref.shape != (1, s, heads, hd):
        failures.append(f"outputs not finite or misshapen ({ref.shape})")
    timed = {"k4_whole_ms": cold_ms(lambda: fpmod.flash_prefill_gqa(
                 q, *cache, zero, lens), reps=3),
             "ring_flash_cp1_ms": cold_ms(lambda: ring_flash_prefill(
                 q, *cache, cp=1), reps=3),
             f"ring_flash_cp{CP_RANKS}_in_turn_ms": cold_ms(
                 lambda: _flash_ring_in_turn(q, shards), reps=3)}
    log(f"context-parallel prefill: V2_LITE attention ({heads} q / {kvh} kv "
        f"heads, hd {hd}), b=1, {s}-token prompt, int8 cache per token; "
        f"{wall:.2f} s wall for the whole driven run; the cp={CP_RANKS} flash "
        f"ring (its {CP_RANKS}x{CP_RANKS} hops in turn) {ring4_s * 1e3:.1f} ms "
        f"wall, {stats_launches} K4-stats launches; {device['smi']}")
    log(f"  max abs errors (plain checks on {CP_CHECK_ROWS} rows at each end "
        f"of every shard; siblings over every row, limit): " + ", ".join(
            f"{k} {v:.3g}" + (f" ({limits[k]:.3g})" if k in limits else "")
            for k, v in errs.items())
        + f"; K12 o-projection rel-L2 vs K1 {rel_folded:.3g}")
    log(f"  largest share of the per-element limit used: " + ", ".join(
        f"{k} {v:.3g}" for k, v in used.items()))
    log(f"  times (CUDA events, median of 3): {timed}")
    log(f"  counters (launches, plain calls): {counts}")
    log(f"  launches by plan: {launch_plans()}")
    if failures:
        raise RuntimeError(f"context-parallel prefill: {failures}")
    check_path("cp", counts, CP_PATH)
    return {"run": "cp", "wall_s": wall, "ring_flash_cp4_wall_ms":
            ring4_s * 1e3, "k4_stats_launches_in_ring": stats_launches,
            "errors": errs, "limits": limits, "limit_used": used,
            "k12_rel_l2_vs_k1": rel_folded, "times": timed,
            "counts": counts}


# ---------------------------------------------------------------- phase 7

def script_runs() -> list:
    """(name, main, argv, the kernels the run must launch) of every
    measurement script at full width; iterations and chain lengths cut
    (not widths) to keep the phase short."""
    dense = list(straggler_probe.PRIMES) + [(straggler_probe.BF16CUBE,) * 3]
    splits = any(select_config(m, n, k, torch.bfloat16, torch.float32,
                               device=DEV).kernel_type == KernelType.KSPLIT
                 for m, n, k in dense)
    probe = PROBE_PATH | ({"gemm_ksplit"} if splits else set())
    layers = ["--configs", *LAYER_CONFIGS, "--batch", str(SCRIPT_BATCH),
              "--cache-len", str(LAYER_CACHE), "--iters", "4",
              "--min-chain", "0.05"]
    cube = [str(d) for d in bench_shapes.HEADLINE]
    steps = ["--steps", str(SERVE_STEPS)]
    return [
        ("straggler_probe", straggler_probe.main,
         ["--iters", "8", "--min-chain", "0.02"], probe),
        ("profile_kernel", profile_kernel.main,
         ["--op", "fp8_gemm", "-m", cube[0], "-n", cube[1], "-k", cube[2],
          "--check", "--min-chain", "0.05"], {"fp8_gemm"}),
        ("headline", headline.main, [], {"fp8_gemm"}),
        ("serve_bench scan", serve_bench.main,
         ["--mode", "scan", "--model", "v2_lite", "--batch",
          str(SCRIPT_BATCH), *steps, "--max-seq", str(SCAN_CACHE)],
         DECODE_PATH),
        ("serve_bench engine", serve_bench.main,
         ["--mode", "engine", "--model", "v2_lite", "--batch",
          str(ENGINE_SLOTS), *steps], FP8_PATH),
        ("serve_bench mixed", serve_bench.main,
         ["--mode", "mixed", "--model", "v2_lite", "--batch",
          str(ENGINE_SLOTS), *steps], FP8_PATH),
        ("serve_bench chunksweep", serve_bench.main,
         ["--mode", "chunksweep", "--model", "v2_lite", "--batch",
          str(ENGINE_SLOTS), *steps], FP8_PATH),
        # One new token a request: the waves decode nothing.
        ("serve_bench prefix", serve_bench.main,
         ["--mode", "prefix", "--model", "v2_lite", "--batch",
          str(ENGINE_SLOTS)], PREFILL_PATH),
        # The recording engine's last tokens come from plain steps (K2):
        # the verify window no longer fits in the cache there.
        ("serve_bench speculative", serve_bench.main,
         ["--mode", "engine", "--model", "v2_lite", "--batch",
          str(ENGINE_SLOTS), *steps, "--speculative-k", str(SPEC_K),
          "--spec-oracle"], FP8_PATH),
        ("layer_bench fp8", layer_bench.main, layers, DECODE_PATH),
        ("layer_bench int8", layer_bench.main,
         layers + ["--expert-quant", "int8"], DECODE_INT8_PATH)]


def phase_scripts(device: dict) -> list:
    """Each measurement script's ``main(argv)`` in this process, on the
    card: the counters zeroed just before and read just after; each run
    must return 0 and launch exactly its kernel set, no plain version. The
    script's output is kept and printed."""
    runs = []
    for name, main_fn, argv, expected in script_runs():
        out = io.StringIO()
        torch.cuda.synchronize()
        _kernels.reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now()
        bare = {n: c.bare_launches for n, c in _kernels.COUNTERS.items()
                if c.bare_launches}
        lines = out.getvalue().splitlines()
        log(f"{name} {' '.join(argv)}: rc {rc}, {wall:.2f} s wall; "
            f"{device['smi']}")
        for ln in lines:
            log(f"  {ln[:600]}")
        log(f"  counters (launches, plain calls): "
            f"{ {n: c for n, c in counts.items() if any(c)} }"
            + (f"; bare-entry launches {bare}" if bare else "")
            + f"; by plan {launch_plans()}")
        if rc != 0:
            raise RuntimeError(f"{name}: rc {rc}")
        check_path(name, counts, expected)
        runs.append({"run": name, "argv": argv, "wall_s": wall,
                     "lines": lines, "counts": counts,
                     "bare_launches": bare})
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- phase 8

# The tiling phase's sweeps (op, shapes): K10 bf16 at 2048³ and at a prime
# shape (its candidates: route mma_tile, and the padded configs on route
# wgmma), K7 and K1 at V2_LITE's gate∥up projection of the dense FFN
# (n=22016, k=2048) at a decode batch and a prefill chunk.
TILING_SWEEPS = (("gemm", ((2048, 2048, 2048), (1279, 5003, 7681))),
                 ("int8_gemm_nt", ((16, 22016, 2048), (2048, 22016, 2048))),
                 ("fp8_gemm_nt", ((16, 22016, 2048), (2048, 22016, 2048))))
# Each variant's headline shape in the kernels line (its phase-2 row).
VARIANT_HEADLINE = {"gemm": "m=2048 n=2048 k=2048", "gemm_ksplit":
                    "m=16 n=2048 k=11008", "int8_gemm": "m=16 n=22016 k=2048",
                    "fp8_gemm": "m=16 n=22016 k=2048",
                    "grouped_gemm": "E=32 cap=96 ",
                    "int8_grouped_masked": "E=32 cap=96 ",
                    "grouped_gemm_contiguous": "E=32 block_m=128",
                    "int8_grouped_contiguous": "E=32 M_total=",
                    "fp8_gemm_folded": "m=16 n=22016 k=2048 b_layout=t"}
SWEEP_TIMEOUT_S = 600


def _variant_row(kernel, label, shape, got, ref, ok, run, plain_ms, bound,
                 equals):
    return {"kernel": kernel, "variant": label, "shape": shape,
            "ok": bool(ok), "equals_default": equals,
            "max_abs_err": float((got.float() - ref.float()).abs().max()),
            "ms": cold_ms(run), "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def check_variants() -> list:
    """Every compiled tile of K10/K11 (wgmma and ffma), K7 (wgmma) and K1
    (ring) at phase 2's shapes, each against its plain version (K10/K11
    within GEMM_REL_TOL of Σ|a·b|, K7 bit for bit, K1 within one bf16 ulp)
    and against the default tile's output bit for bit where the K step is
    unchanged (every K10 tile; K11's tiles at one split count; K7; K1's
    unsplit ring tiles), with its cold ms. K1's split plans (the default
    plan's count on each ring tile) are held to the plain version alone:
    they change the f32 order of the group sum."""
    rows = []
    f32 = torch.float32
    dense = [(m, n, k, torch.bfloat16) for n, k in LITE_GEMMS
             for m in DENSE_M]
    dense += [(2048, 2048, 2048, f32), (16, 22016, 2048, f32)]
    for i, (m, n, k, dtype) in enumerate(dense):
        a, b, _, _ = _dense_operands((), m, n, k, dtype, "nn", 300 + i)
        ref = gemm_plain(a, b)
        plain_ms = cold_ms(lambda: gemm_plain(a, b), reps=3)
        rt = gemm_route(a, b, "nn")
        base = gemm_with_config(a, b, config=k10_config(a, b, "nn", m, n))
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for bm, bn in analytic.TILES[("gemm", rt)]:
            cfg = GemmConfig(bm, bn, 64)
            got = gemm_with_config(a, b, config=cfg)
            torch.cuda.synchronize()
            rows.append(_variant_row(
                "gemm", gemm_plan_label(rt, bm, bn),
                f"m={m} n={n} k={k} {name}", got, ref,
                gemm_close(got, ref, a, b) and torch.equal(got, base),
                lambda: gemm_with_config(a, b, config=cfg), plain_ms,
                _gemm_bound(1, m, n, k, dtype), torch.equal(got, base)))
    for dtype in (torch.bfloat16, f32):
        m, n, k = 16, 2048, 11008
        a, b, _, _ = _dense_operands((), m, n, k, dtype, "nn", 320)
        splits = select_config(m, n, k, dtype, f32, device=DEV).k_split
        splits = max(splits, 2)
        ref = gemm_ksplit_plain(a, b, splits)
        plain_ms = cold_ms(lambda: gemm_ksplit_plain(a, b, splits), reps=3)
        rt = gemm_route(a, b, "nn")
        base = gemm_with_config(a, b, config=k10_config(a, b, "nn", m, n,
                                                        splits=splits))
        item = _ITEMSIZE[dtype]
        bound = bound_ms((m * k + k * n) * item + splits * m * n * 4,
                         2.0 * m * n * k, F32_OPS_PER_S if dtype == f32
                         else BF16_OPS_PER_S)
        for bm, bn in analytic.TILES[("gemm", rt)]:
            cfg = GemmConfig(bm, bn, 64, kernel_type=KernelType.KSPLIT,
                             k_split=splits)
            got = gemm_with_config(a, b, config=cfg)
            torch.cuda.synchronize()
            rows.append(_variant_row(
                "gemm_ksplit", gemm_plan_label(rt, bm, bn),
                f"m={m} n={n} k={k} {'f32' if dtype == f32 else 'bf16'} "
                f"k_split={splits}", got, ref,
                gemm_close(got, ref, a, b) and torch.equal(got, base),
                lambda: gemm_with_config(a, b, config=cfg), plain_ms, bound,
                torch.equal(got, base)))
    for i, (n, k) in enumerate(LITE_GEMMS[:3]):
        for m in DENSE_M:
            a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k), 330 + i)
            ref = i8mod.int8_gemm_plain(a_q, a_s, b_q, b_s, b_t=True)
            plain_ms = cold_ms(lambda: i8mod.int8_gemm_plain(
                a_q, a_s, b_q, b_s, b_t=True), reps=3)
            nbytes = m * k + m * 4 + n * k + n * 4 + m * n * 2
            bound = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
            for bm, bn in analytic.WGMMA_TILES:
                cfg = GemmConfig(bm, bn, 128)
                run = (lambda c=cfg: i8mod.int8_gemm_with_config(
                    a_q, a_s, b_q, b_s, config=c, b_layout="t"))
                got = run()
                torch.cuda.synchronize()
                rows.append(_variant_row(
                    "int8_gemm", f"wgmma {bm}x{bn}", f"m={m} n={n} k={k}",
                    got, ref, torch.equal(got, ref), run, plain_ms, bound,
                    torch.equal(got, ref)))
    for i, (n, k) in enumerate(LITE_GEMMS):
        for m in DENSE_M:
            g = _gen(340 + i)
            a_q, a_s = quant.quantize_fp8_act(
                torch.randn(m, k, generator=g, device=DEV))
            b_q, b_s = quant.quantize_fp8_weight(
                torch.randn(n, k, generator=g, device=DEV) / math.sqrt(k))
            ref = fp8mod.fp8_gemm_plain(a_q, a_s, b_q, b_s.t(), b_t=True)
            plain_ms = cold_ms(lambda: fp8mod.fp8_gemm_plain(
                a_q, a_s, b_q, b_s.t(), b_t=True), reps=3)
            kb = k // 128
            nbytes = m * k + m * kb * 4 + n * k + (n // 128) * kb * 4 \
                + m * n * 2
            bound = bound_ms(nbytes, 2.0 * m * n * k, FP8_OPS_PER_S)
            _, splits = fp8mod.ring_plan(m, n, k)
            unsplit = {}
            for t, (bm, bn) in enumerate(fp8mod.RING_TILES):
                for s in sorted({1, splits}):
                    cfg = GemmConfig(bm, bn, 128, kernel_type=(
                        KernelType.KSPLIT if s > 1 else KernelType.COMMON),
                        k_split=s)
                    run = (lambda c=cfg: fp8mod.fp8_gemm(
                        a_q, a_s, b_q, b_s, config=c, b_layout="t"))
                    got = run()
                    torch.cuda.synchronize()
                    ok = within_one_bf16_ulp(got, ref) and bool(
                        torch.isfinite(got).all())
                    equals = None
                    if s == 1:
                        unsplit[t] = got
                        equals = bool(torch.equal(got, unsplit[0]))
                        ok &= equals
                    rows.append(_variant_row(
                        "fp8_gemm", fp8mod.plan_label("ring", t, s),
                        f"m={m} n={n} k={k}", got, ref, ok, run, plain_ms,
                        bound, equals))
    return rows


def _sweep(tmp: str) -> list:
    """The sweeps of TILING_SWEEPS, each shape in a child process
    (``scripts/autotune_sweep``): their JSON lines."""
    from deepgemm_ascend_tpu_torch.scripts import autotune_sweep
    # a hung candidate ends its child (the watchdog), not the phase
    os.environ.setdefault("DGA_CANDIDATE_TIMEOUT_S", "120")
    out = []
    for op, shapes in TILING_SWEEPS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = autotune_sweep.main(
                ["--op", op, "--out-dir", tmp, "--shapes",
                 *(str(x) for shape in shapes for x in shape),
                 "--cache", os.path.join(tmp, "tilings.jsonl"),
                 "--child-timeout", str(SWEEP_TIMEOUT_S)])
        if rc != 0:
            raise RuntimeError(f"autotune_sweep --op {op}: rc {rc}")
        for line in buf.getvalue().splitlines():
            if line.startswith("{"):
                out.append(json.loads(line))
            else:
                log(f"  {line}")
    return out


def _winner_launch(op, m, n, k, win: GemmConfig):
    """(counter name, plan label) the wrapper must count for the winner
    (a kernel config: the XLA yardstick never wins a sweep)."""
    if op == "gemm":
        if win.pad_k:
            n, k = tiling_padding.padded_dims(op, m, n, k, torch.bfloat16)
        rt = analytic.expected_route(op, m, n, k, torch.bfloat16)
        name = ("gemm_ksplit" if win.kernel_type == KernelType.KSPLIT
                and win.k_split > 1 else "gemm")
        return name, gemm_plan_label(rt, win.block_m, win.block_n)
    if op.startswith("int8"):
        return "int8_gemm", f"wgmma {win.block_m}x{win.block_n}"
    splits = win.k_split if win.kernel_type == KernelType.KSPLIT else 1
    return "fp8_gemm", fp8mod.plan_label(
        "ring", fp8mod.RING_TILES.index((win.block_m, win.block_n)), splits)


def _sweep_operands(op, m, n, k):
    """The wrapper call of a swept shape with no config (the selector's)."""
    g = _gen(350)
    if op == "gemm":
        a, b, _, _ = _dense_operands((), m, n, k, torch.bfloat16, "nn", 351)
        return lambda: gemm(a, b), (torch.bfloat16, torch.float32), {}
    if op.startswith("int8"):
        a_q, a_s, b_q, b_s = _int8_operands((m, k), (n, k), 352)
        return (lambda: i8mod.int8_gemm(a_q, a_s, b_q, b_s, b_layout="t"),
                (torch.int8, torch.bfloat16), {})
    a_q, a_s = quant.quantize_fp8_act(torch.randn(m, k, generator=g,
                                                  device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(n, k, generator=g, device=DEV) / math.sqrt(k))
    return (lambda: fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t"),
            (torch.float8_e4m3fn, torch.bfloat16), {"k_granularity": 128})


def _variant_calls() -> list:
    """One public-wrapper call (config given) per compiled variant, at its
    headline shape: what a caller of gemm_with_config, int8_gemm_with_config
    or fp8_gemm with a config runs."""
    calls = []
    f32 = torch.float32
    for dtype in (torch.bfloat16, f32):
        a, b, _, _ = _dense_operands((), 2048, 2048, 2048, dtype, "nn", 360)
        rt = gemm_route(a, b, "nn")
        for bm, bn in analytic.TILES[("gemm", rt)]:
            calls.append(("gemm", gemm_plan_label(rt, bm, bn),
                          lambda a=a, b=b, c=GemmConfig(bm, bn, 64):
                          gemm_with_config(a, b, config=c)))
        a, b, _, _ = _dense_operands((), 16, 2048, 11008, dtype, "nn", 361)
        for bm, bn in analytic.TILES[("gemm", rt)]:
            c = GemmConfig(bm, bn, 64, kernel_type=KernelType.KSPLIT,
                           k_split=8)
            calls.append(("gemm_ksplit", gemm_plan_label(rt, bm, bn),
                          lambda a=a, b=b, c=c: gemm_with_config(
                              a, b, config=c)))
    a_q, a_s, b_q, b_s = _int8_operands((16, 2048), (22016, 2048), 362)
    for bm, bn in analytic.WGMMA_TILES:
        calls.append(("int8_gemm", f"wgmma {bm}x{bn}",
                      lambda c=GemmConfig(bm, bn, 128):
                      i8mod.int8_gemm_with_config(a_q, a_s, b_q, b_s,
                                                  config=c, b_layout="t")))
    g = _gen(363)
    fa_q, fa_s = quant.quantize_fp8_act(torch.randn(16, 2048, generator=g,
                                                    device=DEV))
    fb_q, fb_s = quant.quantize_fp8_weight(
        torch.randn(22016, 2048, generator=g, device=DEV) / math.sqrt(2048))
    for t, (bm, bn) in enumerate(fp8mod.RING_TILES):
        calls.append(("fp8_gemm", fp8mod.plan_label("ring", t, 1),
                      lambda c=GemmConfig(bm, bn, 128): fp8mod.fp8_gemm(
                          fa_q, fa_s, fb_q, fb_s, config=c, b_layout="t")))
    return calls


def _predictor_checks(files_by_op: dict, info) -> list:
    """Per swept op: a predictor trained on its records (torch Adam), its
    pick or decline at each swept shape held to the decline policy
    (``TilingPredictor.decide`` on its predicted times, then the roofline
    guardrail), and the selector's tier 2 answering the same through a
    fresh cache."""
    import numpy as np
    from deepgemm_ascend_tpu_torch.tiling import predictor as predmod
    from deepgemm_ascend_tpu_torch.tiling import selector as selmod
    from deepgemm_ascend_tpu_torch.tiling.cache import TilingCache
    out = []
    for op, shapes in TILING_SWEEPS:
        feats, log_t = predmod.load_sweep_records(files_by_op[op])
        w = predmod.train(feats, log_t, hidden=(16, 16), epochs=300, seed=0,
                          batch=8)
        p = predmod.TilingPredictor(w, op=op, strategy="topk_median")
        fam = analytic.family(op)
        in_dt, out_dt = {"gemm": (torch.bfloat16, torch.float32),
                         "int8": (torch.int8, torch.bfloat16),
                         "fp8": (torch.float8_e4m3fn, torch.bfloat16)}[fam]
        selmod.clear_predictors()
        selmod.register_predictor(p)
        for m, n, k in shapes:
            got = p.predict(m, n, k, in_dt, out_dt, op=op, info=info)
            native = analytic.get_best_config(m, n, k, in_dt, out_dt, op=op,
                                              info=info)
            tiles = np.asarray(sorted({
                (c.block_m, c.block_n, c.block_k)
                for c in analytic.enumerate_candidates(
                    op, m, n, k, in_dt, out_dt, info, splits=False)}),
                np.int64)
            want = None
            if not native.pad_k and len(tiles) >= p.min_candidates:
                times = np.exp(p.predict_batch(predmod._features(m, n, k,
                                                                  tiles)))
                nat = float(np.exp(p.predict_batch(predmod._features(
                    m, n, k, np.asarray([[native.block_m, native.block_n,
                                          native.block_k]], np.int64)))[0]))
                idx = p.decide(times, tiles, nat)
                if idx is not None:
                    bm, bn, bk = (int(v) for v in tiles[idx])
                    est = lambda c: analytic.estimate_time(
                        op, m, n, k, c, info, in_dt, out_dt).time_s
                    pick = native.replace(block_m=bm, block_n=bn, block_k=bk)
                    if est(pick) <= p.guard_factor * est(native):
                        want = pick
            if got != want:
                raise RuntimeError(f"predictor {op} {m}x{n}x{k}: {got} "
                                   f"against the policy's {want}")
            before = engine_metrics.snapshot()
            sel = select_config(m, n, k, in_dt, out_dt, op=op, device=DEV,
                                cache=TilingCache(),
                                **({"k_granularity": 128} if fam == "fp8"
                                   else {}))
            after = engine_metrics.snapshot()
            tier = ("tiling.predictor_pick" if want is not None
                    else "tiling.predictor_decline")
            if (sel != (want or native)
                    or after.get(tier, 0) != before.get(tier, 0) + 1):
                raise RuntimeError(f"selector tier 2, {op} {m}x{n}x{k}: "
                                   f"{sel}, {tier} did not move")
            out.append({"op": op, "shape": f"m={m} n={n} k={k}",
                        "records": int(len(feats)),
                        "pick": None if want is None else
                        autotune_describe(want),
                        "analytic": autotune_describe(native)})
        selmod.clear_predictors()
    return out


def _native_checks(info) -> dict:
    """The C++ host core, built with g++ here, against the port's Python
    over a grid of shapes, ops and types: equal configs and padding
    tags."""
    import itertools
    from deepgemm_ascend_tpu_torch import native
    from deepgemm_ascend_tpu_torch.tiling import padding as padmod
    t0 = time.perf_counter()
    if native.load() is None:
        raise RuntimeError("the C++ host core did not build or load")
    build_s = time.perf_counter() - t0
    ops = (("gemm", torch.bfloat16, torch.float32),
           ("gemm", torch.float32, torch.float32),
           ("gemm_nt", torch.bfloat16, torch.float32),
           ("int8_gemm_nt", torch.int8, torch.bfloat16),
           ("fp8_gemm_nt", torch.float8_e4m3fn, torch.bfloat16))
    n_cmp = 0
    for (op, in_dt, out_dt), m, n, k in itertools.product(
            ops, (1, 16, 64, 128, 1279, 2048), (512, 2048, 5003, 22016),
            (1408, 2048, 7681, 11008)):
        if op.startswith("fp8") and (n % 128 or k % 128):
            continue
        py = analytic.get_best_config(m, n, k, in_dt, out_dt, op=op,
                                      info=info)
        cc, _ = native.select_config_native(op, m, n, k, in_dt, out_dt,
                                            info.num_cores)
        if cc != py:
            raise RuntimeError(f"C++ core {op} {m}x{n}x{k}: {cc} != {py}")
        n_cmp += 1
    for m, n, k in straggler_probe.PRIMES:
        tag, _, _ = native.padding_tag_native(m, n, k, sms=info.num_cores)
        if tag != int(padmod.get_padding_tag(m, n, k, info=info).tag):
            raise RuntimeError(f"C++ core padding tag {m}x{n}x{k}")
    return {"configs_compared": n_cmp, "build_s": build_s}


def selection_host_cost(n_calls: int = 2000) -> list:
    """Host µs a call of K1's selection takes at the decode path's shapes
    (V2_LITE's projections at 16 rows, B stored K-major): the tiers
    (``select_config`` then ``fit_route``, a cache hit after the first
    call) and the wrapper's memoised selection (``launch_config``, the
    operands' route included), each the mean of ``n_calls`` calls."""
    from deepgemm_ascend_tpu_torch.scripts.autotune_sweep import V2_LITE_NK
    from deepgemm_ascend_tpu_torch.tiling.selector import fit_route
    fp8, bf16 = torch.float8_e4m3fn, torch.bfloat16
    rows = []
    for n, k in V2_LITE_NK:
        m = 16
        a_q = torch.zeros(m, k, dtype=fp8, device=DEV)
        b_q = torch.zeros(n, k, dtype=fp8, device=DEV)
        rt = fp8mod.route(a_q, b_q, "t")

        def tiers():
            cfg = select_config(m, n, k, fp8, bf16, op="fp8_gemm_nt",
                                k_granularity=128, device=DEV)
            return fit_route(cfg, rt, m, n, k, fp8, bf16, op="fp8_gemm_nt",
                             device=DEV)

        def memo():
            return fp8mod._selected(a_q, b_q, m, n, k, True, bf16, None)
        us = {}
        for name, fn in (("tiers", tiers), ("memo", memo)):
            fn()
            t0 = time.perf_counter()
            for _ in range(n_calls):
                fn()
            us[name] = (time.perf_counter() - t0) / n_calls * 1e6
        if tiers() != memo():
            raise RuntimeError(f"launch_config {m}x{n}x{k}: the memo's "
                               f"config is not the tiers'")
        rows.append({"shape": f"m={m} n={n} k={k}", "tiers_us": us["tiers"],
                     "memo_us": us["memo"]})
    return rows


# The grouped kernels' and K12's tiles (phase 8): K3 and K6 on V2_LITE's
# experts (E=32) at phase 2's loads of a decode step (16 tokens: cap 96),
# a 128-token prefill forward (cap 768) and a 2048-token chunk (cap
# 12288), with the MoE layer's expected_m; K8 and K9 on phase 2's
# 2048-token layouts (128-row m-tiles); K12 at m=16 and m=2048 of
# n=22016 k=2048.
EXPERT_NK = ((2816, 2048), (2048, 1408))
GROUPED_VARIANT_TOKENS = (16, 128, 2048)
FOLDED_VARIANT_M = (16, 2048)
FOLDED_VARIANT_NK = (22016, 2048)
# The grouped sweeps, in process (op, ((E, M_max or tokens an expert,
# expected_m), ...)) at EXPERT_NK, on routed loads (bench.loads): K3 and
# K6 at a decode step (cap 96, 3 rows an expert: 16 tokens) and a
# 512-token prefill forward (cap 3072, 96 rows an expert); K8 and K9 on
# 128 tokens an expert on average in 128-row m-tiles.
GROUPED_SWEEPS = (
    ("grouped_gemm_masked_nt", ((32, 96, 3), (32, 3072, 96))),
    ("int8_grouped_gemm_masked_nt", ((32, 96, 3), (32, 3072, 96))),
    ("grouped_gemm_contiguous_nt", ((32, 128, None),)),
    ("int8_grouped_gemm_contiguous_nt", ((32, 128, None),)))
# Each grouped kernel: its selector op, its counter's plan label of a
# (kernel route, tile code), and its variant rows' headline shape.
GROUPED_KERNELS = {
    "grouped_gemm": ("grouped_gemm_masked_nt",
                     lambda kr, c: fp8mod.plan_label(kr, c)),
    "int8_grouped_masked": ("int8_grouped_gemm_masked_nt",
                            lambda kr, c: i8mod.masked_plan_label(kr, c)),
    "grouped_gemm_contiguous": ("grouped_gemm_nt",
                                lambda kr, c: ggmod.contiguous_plan_label(
                                    kr, c)),
    "int8_grouped_contiguous": ("int8_grouped_gemm_nt",
                                lambda kr, c: i8mod.masked_plan_label(kr,
                                                                      c))}
SWEEP_KERNEL = {"grouped_gemm_masked_nt": "grouped_gemm",
                "int8_grouped_gemm_masked_nt": "int8_grouped_masked",
                "grouped_gemm_contiguous_nt": "grouped_gemm_contiguous",
                "int8_grouped_gemm_contiguous_nt": "int8_grouped_contiguous"}


def _valid(t: torch.Tensor, rows: list) -> torch.Tensor:
    """A masked output's valid rows, expert after expert."""
    return torch.cat([t[ei, :r] for ei, r in enumerate(rows) if r])


def _masked_variants(kernel: str, tokens: int, n: int, k: int,
                     seed: int) -> list:
    """Every compiled tile of K3 or K6 at phase 2's loads of ``tokens``
    routed over V2_LITE's experts, through its launch's plan: on the valid
    rows within one bf16 ulp (K3) or bit for bit (K6) of the plain
    version, and bit for bit the default tile's output (the wrapper with
    no config and the MoE layer's expected_m)."""
    e, bf16 = V2_LITE.num_experts, torch.bfloat16
    cap = tokens * 6
    expected = -(-cap // e)
    masked_m = _masked_m(e, tokens, 6, seed)
    rows = masked_m.tolist()
    valid, active = sum(rows), sum(1 for r in rows if r)
    op, label = GROUPED_KERNELS[kernel]
    if kernel == "int8_grouped_masked":
        a_q, a_s, b_q, b_s = _int8_operands((e, cap, k), (e, n, k), seed + 1)
        launch = lambda p: i8mod._launch_masked(
            a_q, a_s, b_q, b_s, masked_m, True, bf16, plan=p,
            expected_m=expected)
        default = lambda: i8mod.m_grouped_int8_gemm_masked(
            a_q, a_s, b_q, b_s, masked_m, b_layout="t", expected_m=expected)
        plain = lambda: i8mod.grouped_masked_plain(a_q, a_s, b_q, b_s,
                                                   masked_m, b_t=True)
        close = torch.equal
        nbytes = (valid * (k + 4) + active * (n * k + n * 4)
                  + valid * n * 2 + e * 4)
        bound = bound_ms(nbytes, 2.0 * valid * n * k, INT8_OPS_PER_S)
    else:
        g = _gen(seed + 1)
        a_q, a_s = quant.quantize_fp8_act(
            torch.randn(e, cap, k, generator=g, device=DEV))
        b_q, b_s = quant.quantize_fp8_weight(
            torch.randn(e, n, k, generator=g, device=DEV) / math.sqrt(k))
        bs_view = b_s.transpose(1, 2)
        launch = lambda p: ggmod._launch(a_q, a_s, b_q, bs_view,
                                         fp8mod._SHIFT, masked_m, True, bf16,
                                         plan=p, expected_m=expected)
        default = lambda: ggmod.m_grouped_gemm_masked(
            a_q, a_s, b_q, b_s, masked_m, b_layout="t", expected_m=expected)
        plain = lambda: ggmod.grouped_gemm_masked_plain(
            a_q, a_s, b_q, bs_view, masked_m, b_t=True)
        close = within_one_bf16_ulp
        kb = k // 128
        nbytes = (valid * (k + kb * 4) + active * (n * k + (n // 128) * kb
                                                   * 4)
                  + valid * n * 2 + e * 4)
        bound = bound_ms(nbytes, 2.0 * valid * n * k, FP8_OPS_PER_S)
    ref, base = _valid(plain(), rows), _valid(default(), rows)
    plain_ms = cold_ms(plain, reps=3)
    rt = analytic.expected_route(op, cap, n, k, a_q.dtype)
    out = []
    for _, tile in analytic.route_tiles(op, rt):
        p = analytic.kernel_plan(op, rt, *tile)
        got = _valid(launch(p), rows)
        torch.cuda.synchronize()
        equals = bool(torch.equal(got, base))
        out.append(_variant_row(
            kernel, label(*p), f"E={e} cap={cap} valid_rows={valid} n={n} "
            f"k={k} expected_m={expected}", got, ref,
            close(got, ref) and equals, lambda p=p: launch(p), plain_ms,
            bound, equals))
    return out


def _contiguous_variants(kernel: str, n: int, k: int, seed: int) -> list:
    """Every compiled tile of K8 or K9 on phase 2's 2048-token layout
    (128-row m-tiles), through its launch's plan: within one bf16 ulp (K8)
    or bit for bit (K9) of the plain version, and bit for bit the default
    tile's output (the wrapper with no config)."""
    e, bf16 = V2_LITE.num_experts, torch.bfloat16
    counts = _masked_m(e, 2048, 6, seed).tolist()
    m, gids, _ = ggmod.make_contiguous_layout(counts, 128)
    ids = torch.from_numpy(gids)
    active = sum(1 for c in counts if c)
    op, label = GROUPED_KERNELS[kernel]
    if kernel == "int8_grouped_contiguous":
        a_q, a_s, b_q, b_s = _int8_operands((m, k), (e, n, k), seed + 1)
        launch = lambda p: i8mod._launch_contiguous(a_q, a_s, b_q, b_s, ids,
                                                    128, True, bf16, plan=p)
        default = lambda: i8mod.m_grouped_int8_gemm_contiguous(
            a_q, a_s, b_q, b_s, ids, b_layout="t")
        plain = lambda: i8mod.grouped_contiguous_plain(a_q, a_s, b_q, b_s,
                                                       ids, b_t=True)
        close = torch.equal
        nbytes = (m * (k + 4) + active * (n * k + n * 4) + m * n * 2
                  + gids.size * 4)
        bound = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
        shape = f"E={e} M_total={m} tokens={sum(counts)} n={n} k={k}"
    else:
        g = _gen(seed + 1)
        a_q, a_s = quant.quantize_fp8_act(
            torch.randn(m, k, generator=g, device=DEV))
        b_q, b_s = quant.quantize_fp8_weight(
            torch.randn(e, n, k, generator=g, device=DEV) / math.sqrt(k))
        bs_view = b_s.transpose(1, 2)
        launch = lambda p: ggmod._launch_contiguous(
            a_q, a_s, b_q, bs_view, fp8mod._SHIFT, ids, 128, True, bf16,
            plan=p)
        default = lambda: ggmod.m_grouped_gemm_contiguous(
            a_q, a_s, b_q, b_s, ids, b_layout="t")
        plain = lambda: ggmod.grouped_gemm_contiguous_plain(
            a_q, a_s, b_q, bs_view, ids, b_t=True)
        close = within_one_bf16_ulp
        kb = k // 128
        nbytes = (m * (k + kb * 4) + active * (n * k + (n // 128) * kb * 4)
                  + m * n * 2 + gids.size * 4)
        bound = bound_ms(nbytes, 2.0 * m * n * k, FP8_OPS_PER_S)
        shape = (f"E={e} block_m=128 M_total={m} tokens={sum(counts)} "
                 f"n={n} k={k}")
    ref, base = plain(), default()
    plain_ms = cold_ms(plain, reps=3)
    rt = analytic.expected_route(op, 128, n, k, a_q.dtype)
    out = []
    for _, tile in analytic.route_tiles(op, rt):
        p = analytic.kernel_plan(op, rt, *tile)
        got = launch(p)
        torch.cuda.synchronize()
        equals = bool(torch.equal(got, base))
        out.append(_variant_row(kernel, label(*p), shape, got, ref,
                                close(got, ref) and equals,
                                lambda p=p: launch(p), plain_ms, bound,
                                equals))
    return out


def _folded_variants(m: int, n: int, k: int, seed: int) -> list:
    """Every compiled tile of K12 through a caller's config: within the
    plain version's tolerance (the same bf16 operands, another f32 sum
    order) and FOLDED_REL_L2 of K1; ``equals_default`` says whether it
    gives the default tile's bits, which is not required (module
    docstring of phase 8)."""
    g = _gen(seed)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m, k, generator=g, device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(n, k, generator=g, device=DEV) / math.sqrt(k))
    kw = dict(b_layout="t", scale_mode="folded", allow_relaxed=True)
    plain = lambda: fp8mod.fp8_gemm_folded_plain(a_q, a_s, b_q, b_s.t(),
                                                 b_t=True)
    ref, base = plain(), fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, **kw)
    k1 = fp8mod.fp8_gemm(a_q, a_s, b_q, b_s, b_layout="t",
                         out_dtype=torch.float32)
    a_sc, b_sc = fp8mod.fold_operands(a_q, a_s, b_q, b_s.t(), b_t=True)
    plain_ms = cold_ms(plain, reps=3)
    kb = k // 128
    nbytes = m * k + m * kb * 4 + n * k + (n // 128) * kb * 4 + m * n * 2
    bound = bound_ms(nbytes, 2.0 * m * n * k, BF16_OPS_PER_S)
    out = []
    for bm, bn in analytic.FOLDED_TILES:
        run = (lambda c=GemmConfig(bm, bn, 128): fp8mod.fp8_gemm(
            a_q, a_s, b_q, b_s, config=c, **kw))
        got = run()
        torch.cuda.synchronize()
        rel = float((got.float() - k1).norm() / k1.norm())
        row = _variant_row(
            "fp8_gemm_folded", f"folded {bm}x{bn}",
            f"m={m} n={n} k={k} b_layout=t", got, ref,
            gemm_close(got, ref, a_sc, b_sc) and rel < FOLDED_REL_L2, run,
            plain_ms, bound, bool(torch.equal(got, base)))
        out.append({**row, "rel_l2_vs_k1": rel})
    return out


def check_grouped_variants() -> list:
    """Phase 8 (a): every compiled tile of K3, K6, K8, K9 and K12 at
    phase 2's grouped shapes (``_masked_variants``,
    ``_contiguous_variants``, ``_folded_variants``), with its cold ms."""
    rows = []
    for tokens in GROUPED_VARIANT_TOKENS:
        for n, k in EXPERT_NK:
            for kernel in ("grouped_gemm", "int8_grouped_masked"):
                rows += _masked_variants(kernel, tokens, n, k,
                                         seed=370 + tokens + n)
    for n, k in EXPERT_NK:
        for kernel in ("grouped_gemm_contiguous", "int8_grouped_contiguous"):
            rows += _contiguous_variants(kernel, n, k, seed=380 + n)
    for m in FOLDED_VARIANT_M:
        rows += _folded_variants(m, *FOLDED_VARIANT_NK, seed=390 + m)
    return rows


def _grouped_sweep(tmp: str) -> list:
    """Phase 8 (b): GROUPED_SWEEPS through ``scripts/autotune_sweep`` in
    this process, the winners into the tiling cache in ``tmp``: their JSON
    lines."""
    from deepgemm_ascend_tpu_torch.scripts import autotune_sweep
    out = []
    for op, shapes in GROUPED_SWEEPS:
        for e, m, em in shapes:
            argv = ["--op", op, "--out-dir", tmp, "--in-process",
                    "--cache", os.path.join(tmp, "tilings.jsonl"),
                    "--shapes", *(str(x) for n, k in EXPERT_NK
                                  for x in (e, m, n, k))]
            if em is not None:
                argv += ["--expected-m", str(em)]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = autotune_sweep.main(argv)
            if rc != 0:
                raise RuntimeError(f"autotune_sweep --op {op}: rc {rc}")
            for line in buf.getvalue().splitlines():
                if line.startswith("{"):
                    out.append(json.loads(line))
                else:
                    log(f"  {line}")
    return out


def _grouped_call(op: str, e: int, m: int, n: int, k: int, em):
    """The public wrapper of a swept grouped op at its shape with no
    config (the tiers'), on the sweep's routed loads (``bench.loads``): E
    experts of M_max rows, ``em`` expected an expert, or E experts of M
    tokens on average laid out in min(128, M)-row m-tiles."""
    seed = 400 + m + n
    bf16 = torch.bfloat16
    if "masked" in op:
        mm = bench_loads.routed_masked_m(
            e, m, em if em is not None else m, generator=_gen(seed + 1),
            device=DEV)
        if op.startswith("int8"):
            a_q, a_s, b_q, b_s = _int8_operands((e, m, k), (e, n, k), seed)
            return lambda: i8mod.m_grouped_int8_gemm_masked(
                a_q, a_s, b_q, b_s, mm, b_layout="t", expected_m=em)
        g = _gen(seed)
        a_q, a_s = quant.quantize_fp8_act(
            torch.randn(e, m, k, generator=g, device=DEV))
        b_q, b_s = quant.quantize_fp8_weight(
            torch.randn(e, n, k, generator=g, device=DEV) / math.sqrt(k))
        return lambda: ggmod.m_grouped_gemm_masked(
            a_q, a_s, b_q, b_s, mm, b_layout="t", expected_m=em)
    m_total, gids, _ = ggmod.make_contiguous_layout(
        bench_loads.routed_counts(e, m, generator=_gen(seed + 1),
                                  device=DEV),
        min(128, m))
    ids = torch.from_numpy(gids)
    if op.startswith("int8"):
        a_q, a_s, b_q, b_s = _int8_operands((m_total, k), (e, n, k), seed)
        return lambda: i8mod.m_grouped_int8_gemm_contiguous(
            a_q, a_s, b_q, b_s, ids, b_layout="t", out_dtype=bf16)
    g = _gen(seed)
    a_q, a_s = quant.quantize_fp8_act(
        torch.randn(m_total, k, generator=g, device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(
        torch.randn(e, n, k, generator=g, device=DEV) / math.sqrt(k))
    return lambda: ggmod.m_grouped_gemm_contiguous(a_q, a_s, b_q, b_s, ids,
                                                   b_layout="t")


def _launched_labels(call) -> set:
    """(counter, plan label) of every launch ``call`` made."""
    before = {name: dict(c.plans) for name, c in _kernels.COUNTERS.items()}
    call()
    torch.cuda.synchronize()
    return {(name, lab) for name, c in _kernels.COUNTERS.items()
            for lab, cnt in c.plans.items()
            if cnt != before[name].get(lab, 0)}


def serve_grouped_from_cache(gsweeps: list, kind: str) -> list:
    """Phase 8 (c), with the swept cache as the card's: each swept shape
    through its public wrapper with no config hits the cache
    (``tiling.cache_hit``) and launches the winner's tile
    (``Counter.plans``); then an entry naming another compiled tile of the
    route, set in the card's cache, moves the next launch to that tile."""
    from deepgemm_ascend_tpu_torch.tiling import cache as cachemod
    from deepgemm_ascend_tpu_torch.tiling.selector import key_extra
    out = []
    for row in gsweeps:
        op, sop = row["op"], row["op"].replace("grouped_gemm_contiguous",
                                               "grouped_gemm")
        kernel = SWEEP_KERNEL[op]
        label = GROUPED_KERNELS[kernel][1]
        e, m, n, k, em = (row["e"], row["m"], row["n"], row["k"],
                          row["expected_m"])
        dt = torch.int8 if op.startswith("int8") else torch.float8_e4m3fn
        rt = analytic.expected_route(sop, m, n, k, dt)
        call = _grouped_call(op, e, row["shape_m"], n, k, em)
        win = GemmConfig.from_dict(row["winner_config"])
        hits = engine_metrics.snapshot().get("tiling.cache_hit", 0)
        launched = _launched_labels(call)
        hit = engine_metrics.snapshot().get("tiling.cache_hit", 0) - hits
        want = {(kernel, label(*analytic.kernel_plan(sop, rt, win.block_m,
                                                     win.block_n)))}
        other = next(t for _, t in analytic.route_tiles(sop, rt)
                     if t != (win.block_m, win.block_n)
                     and analytic.tile_admits(sop, rt, *t, m, n))
        key = cachemod.cache_key(sop, m, n, k, cachemod.dtype_name(dt),
                                 "bfloat16", key_extra(sop, m, 128, 1, em))
        cachemod.global_cache(kind).set(key, GemmConfig(*other, 128),
                                        persist=False)
        moved = _launched_labels(call)
        want_moved = {(kernel, label(*analytic.kernel_plan(sop, rt,
                                                           *other)))}
        ok = hit == 1 and launched == want and moved == want_moved
        out.append({"op": sop, "key": key, "winner": row["winner"],
                    "cache_hit": hit, "launched": sorted(launched),
                    "entry": "%dx%d" % other, "then_launched": sorted(moved),
                    "ok": ok})
        if not ok:
            raise RuntimeError(f"cache-served {key}: hit {hit}, launched "
                               f"{launched} vs {want}, then {moved} vs "
                               f"{want_moved}")
    return out


def _grouped_variant_calls() -> list:
    """One public-wrapper call per grouped and K12 tile that a caller's
    config names (K8's 64 x 128 tile at 128-row m-tiles only the tiers
    name: ``serve_grouped_from_cache``): (counter, label, call)."""
    calls = []
    e, (n, k) = V2_LITE.num_experts, EXPERT_NK[0]
    loads = _masked_m(e, 16, 6, 410)
    a_q, a_s = quant.quantize_fp8_act(torch.randn(e, 96, k, generator=_gen(
        411), device=DEV))
    b_q, b_s = quant.quantize_fp8_weight(torch.randn(
        e, n, k, generator=_gen(412), device=DEV) / math.sqrt(k))
    i_aq, i_as, i_bq, i_bs = _int8_operands((e, 96, k), (e, n, k), 413)
    for kernel, fn, args in (
            ("grouped_gemm", ggmod.m_grouped_gemm_masked,
             (a_q, a_s, b_q, b_s, loads)),
            ("int8_grouped_masked", i8mod.m_grouped_int8_gemm_masked,
             (i_aq, i_as, i_bq, i_bs, loads))):
        op, label = GROUPED_KERNELS[kernel]
        rt = analytic.expected_route(op, 96, n, k, args[0].dtype)
        for _, t in analytic.route_tiles(op, rt):
            calls.append((kernel, label(*analytic.kernel_plan(op, rt, *t)),
                          lambda fn=fn, args=args, c=GemmConfig(*t, 128):
                          fn(*args, config=c, b_layout="t")))
    ids = torch.arange(e, dtype=torch.int32)
    c_aq, c_as = quant.quantize_fp8_act(torch.randn(
        e * 128, k, generator=_gen(414), device=DEV))
    ci_aq, ci_as, _, _ = _int8_operands((e * 128, k), (1, n, k), 415)
    calls.append(("grouped_gemm_contiguous", "wgmma16 128x128",
                  lambda: ggmod.m_grouped_gemm_contiguous(
                      c_aq, c_as, b_q, b_s, ids, b_layout="t",
                      config=GemmConfig(128, 128, 128))))
    for bn, lab in ((64, "wgmma 64x64"), (256, "wgmma 128x256")):
        calls.append(("int8_grouped_contiguous", lab,
                      lambda bn=bn: i8mod.m_grouped_int8_gemm_contiguous(
                          ci_aq, ci_as, i_bq, i_bs, ids, b_layout="t",
                          config=GemmConfig(128, bn, 128))))
    g = _gen(416)
    fn_, fk = FOLDED_VARIANT_NK
    f_aq, f_as = quant.quantize_fp8_act(torch.randn(2048, fk, generator=g,
                                                    device=DEV))
    f_bq, f_bs = quant.quantize_fp8_weight(
        torch.randn(fn_, fk, generator=g, device=DEV) / math.sqrt(fk))
    for bm, bn in analytic.FOLDED_TILES:
        calls.append(("fp8_gemm_folded", f"folded {bm}x{bn}",
                      lambda c=GemmConfig(bm, bn, 128): fp8mod.fp8_gemm(
                          f_aq, f_as, f_bq, f_bs, config=c, b_layout="t",
                          scale_mode="folded", allow_relaxed=True)))
    return calls


def grouped_selection_host_cost(n_calls: int = 2000) -> list:
    """Host µs a call of the grouped wrappers' selection takes at the
    decode path's shapes (K3 and K6 at V2_LITE's experts, cap 96,
    expected_m 3): the tiers (``select_config`` then ``fit_route``) and
    the memoised selection the wrappers make
    (``grouped_gemm.selected_tile``), each the mean of ``n_calls``
    calls."""
    from deepgemm_ascend_tpu_torch.tiling.selector import fit_route
    bf16 = torch.bfloat16
    rows = []
    for op, dt in (("grouped_gemm_masked_nt", torch.float8_e4m3fn),
                   ("int8_grouped_gemm_masked_nt", torch.int8)):
        for n, k in EXPERT_NK:
            m = 96
            rt = analytic.expected_route(op, m, n, k, dt)

            def tiers():
                cfg = select_config(m, n, k, dt, bf16, op=op,
                                    k_granularity=128, device=DEV,
                                    expected_m=3)
                cfg = fit_route(cfg, rt, m, n, k, dt, bf16, op=op,
                                device=DEV, expected_m=3)
                return cfg.block_m, cfg.block_n

            def memo():
                return ggmod.selected_tile(op, rt, m, n, k, dt, bf16, DEV,
                                           3)
            us = {}
            for name, fn in (("tiers", tiers), ("memo", memo)):
                fn()
                t0 = time.perf_counter()
                for _ in range(n_calls):
                    fn()
                us[name] = (time.perf_counter() - t0) / n_calls * 1e6
            if tiers() != memo():
                raise RuntimeError(f"{op} {m}x{n}x{k}: the memo's tile is "
                                   f"not the tiers'")
            rows.append({"shape": f"{op} m={m} n={n} k={k} expected_m=3",
                         "tiers_us": us["tiers"], "memo_us": us["memo"]})
    return rows


def phase_tiling(device: dict) -> dict:
    """The tiling tiers on the card: every compiled variant against its
    plain version (``check_variants``); a sweep of TILING_SWEEPS in child
    processes, every candidate through the gate, the records in a
    temporary directory; the sweep's cache reloaded as the process-wide
    cache of this card, ``select_config`` hitting it
    (``tiling.cache_hit``) and the wrappers, called with no config,
    launching the winner's tile (``Counter.plans``); then the driven run —
    those calls, and one call of each compiled variant through its public
    wrapper with its config — with exactly K10, K11, K7 and K1 launched,
    every variant at least once and no plain version; a predictor trained
    on the records, held to its decline policy; and the C++ host core
    equal to the Python tiling on a grid."""
    import tempfile
    from deepgemm_ascend_tpu_torch.tiling import cache as cachemod
    from deepgemm_ascend_tpu_torch.tiling import platform as platmod
    info = platmod.detect(DEV)
    kind = info.device_kind
    variants = check_variants()
    t_grouped = time.perf_counter()
    variants += check_grouped_variants()
    grouped_s = {"variants": time.perf_counter() - t_grouped}
    bad = [(r["kernel"], r["variant"], r["shape"]) for r in variants
           if not r["ok"]]
    for r in variants:
        log(f"  variant {r['kernel']:12s} {r['variant']:16s} "
            f"{r['shape']:34s} ok={r['ok']} "
            f"equals_default_tile={r['equals_default']} "
            f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    if bad:
        raise RuntimeError(f"tile variants disagree: {bad}")
    tmp_dir = tempfile.TemporaryDirectory(prefix="dga_sweep_")
    tmp = tmp_dir.name
    t0 = time.perf_counter()
    try:
        sweeps = _sweep(tmp)
        sweep_s = time.perf_counter() - t0
        t_grouped = time.perf_counter()
        gsweeps = _grouped_sweep(tmp)
        grouped_s["sweep"] = time.perf_counter() - t_grouped
        files_by_op = {op: [os.path.join(tmp, f) for f in sorted(
            os.listdir(tmp)) if f.startswith(op + "_") and
            f.endswith(".jsonl")] for op, _ in TILING_SWEEPS}
        failed = []
        for op, files in files_by_op.items():
            for path in files:
                with open(path) as f:
                    failed += [(op, line.strip()) for line in f
                               if not json.loads(line)["correct"]]
        # The grouped sweeps: every kernel candidate through the gate (the
        # XLA yardstick's gate result is logged, as it never wins).
        for op, _ in GROUPED_SWEEPS:
            for f in sorted(os.listdir(tmp)):
                if not (f.startswith(op + "_") and f.endswith(".jsonl")):
                    continue
                with open(os.path.join(tmp, f)) as fh:
                    for line in fh:
                        rec = json.loads(line)
                        if rec["correct"]:
                            continue
                        if rec["config"].get("kernel_type") == int(
                                KernelType.XLA):
                            log(f"  sweep {f}: the XLA yardstick failed "
                                f"the gate")
                        else:
                            failed.append((op, line.strip()))
        for row in sweeps:
            log(f"  sweep {row['op']:12s} m={row['m']} n={row['n']} "
                f"k={row['k']}: candidates ms {row['candidates_ms']}; "
                f"analytic default {row['default']} "
                f"{row['default_ms']} ms; winner {row['winner']} "
                f"{row['winner_ms']} ms")
        for row in gsweeps:
            log(f"  sweep {row['op']:31s} E={row['e']} M={row['shape_m']} "
                f"n={row['n']} k={row['k']} expected_m={row['expected_m']} "
                f"(key m={row['m']}): candidates ms "
                f"{row['candidates_ms']}; analytic default "
                f"{row['default']} {row['default_ms']} ms; winner "
                f"{row['winner']} {row['winner_ms']} ms")
        if failed:
            raise RuntimeError(f"sweep candidates failed the gate: "
                               f"{failed}")
        # The driven run: the cache as the card's process-wide one, then
        # each variant through its public wrapper.
        cachemod.reset_global_cache(os.path.join(tmp, "tilings.jsonl"),
                                    kind=kind)
        _kernels.reset_counters()
        served = []
        t1 = time.perf_counter()
        for row in sweeps:
            op, m, n, k = row["op"], row["m"], row["n"], row["k"]
            win = GemmConfig.from_dict(row["winner_config"])
            call, (in_dt, out_dt), kw = _sweep_operands(op, m, n, k)
            before = engine_metrics.snapshot().get("tiling.cache_hit", 0)
            cfg = select_config(m, n, k, in_dt, out_dt, op=op, device=DEV,
                                **kw)
            hit = engine_metrics.snapshot().get("tiling.cache_hit", 0)
            want = _winner_launch(op, m, n, k, win)
            plans = {name: dict(c.plans) for name, c in
                     _kernels.COUNTERS.items()}
            call()
            torch.cuda.synchronize()
            new = {name: {lab: c.plans.get(lab, 0) - plans[name].get(lab, 0)
                          for lab in c.plans} for name, c in
                   _kernels.COUNTERS.items()}
            launched = {(name, lab) for name, labs in new.items()
                        for lab, cnt in labs.items() if cnt}
            ok = hit == before + 1 and cfg == win and launched == {want}
            served.append({"op": op, "shape": f"m={m} n={n} k={k}",
                           "winner": row["winner"], "cache_hit": hit -
                           before, "launched": sorted(launched), "ok": ok})
            if not ok:
                raise RuntimeError(f"cache-served {op} {m}x{n}x{k}: hit "
                                   f"{hit - before}, {cfg} vs winner {win}, "
                                   f"launched {launched} vs {want}")
        grouped_served = serve_grouped_from_cache(gsweeps, kind)
        calls = _variant_calls() + _grouped_variant_calls()
        k12 = _kernels.COUNTERS["fp8_gemm_folded"]
        folded = {}
        for name, lab, call in calls:
            before = k12.launches
            call()
            if name == "fp8_gemm_folded":
                folded[lab] = folded.get(lab, 0) + k12.launches - before
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = counts_now()
        plans = launch_plans()
        missing = [(name, lab) for name, lab, _ in calls
                   if not (folded if name == "fp8_gemm_folded" else
                           plans.get(name, {})).get(lab)]
        log(f"tiling: {len(variants)} variant rows held to their plain "
            f"versions; sweep of {len(sweeps)} shapes in child processes "
            f"in {sweep_s:.1f} s; the driven run (cache-served calls and "
            f"each compiled variant) {wall:.2f} s wall; {device['smi']}")
        log(f"  cache-served: {served}")
        log(f"  cache-served grouped: {grouped_served}")
        log(f"  K12 launches by tile (its wrapper counts no plan): "
            f"{folded}")
        log(f"  counters (launches, plain calls): {counts}")
        log(f"  launches by plan: {plans}")
        if missing:
            raise RuntimeError(f"tiling: variants not launched: {missing}")
        check_path("tiling", counts, TILING_PATH)
        predictor_rows = _predictor_checks(files_by_op, info)
        for r in predictor_rows:
            log(f"  predictor {r['op']:12s} {r['shape']}: "
                f"{'pick ' + r['pick'] if r['pick'] else 'declined'} "
                f"(analytic {r['analytic']}; {r['records']} records)")
        core = _native_checks(info)
        log(f"  C++ host core: {core['configs_compared']} configs equal to "
            f"Python's, built and loaded in {core['build_s']:.2f} s")
        host_cost = selection_host_cost()
        for r in host_cost:
            log(f"  K1 selection host cost {r['shape']}: tiers "
                f"{r['tiers_us']:.2f} us/call, memoised "
                f"{r['memo_us']:.2f} us/call")
        grouped_cost = grouped_selection_host_cost()
        for r in grouped_cost:
            log(f"  grouped selection host cost {r['shape']}: tiers "
                f"{r['tiers_us']:.2f} us/call, memoised "
                f"{r['memo_us']:.2f} us/call")
        log(f"  grouped additions: variant rows {grouped_s['variants']:.1f} "
            f"s, sweeps {grouped_s['sweep']:.1f} s")
    finally:
        cachemod.reset_global_cache(None, kind=kind)
        tmp_dir.cleanup()
    return {"run": "tiling", "wall_s": wall, "counts": counts,
            "plans": plans, "folded_launches": folded, "variants": variants,
            "sweeps": sweeps, "grouped_sweeps": gsweeps,
            "served": served, "grouped_served": grouped_served,
            "predictor": predictor_rows, "native": core,
            "selection_host_us": host_cost,
            "grouped_selection_host_us": grouped_cost,
            "grouped_s": grouped_s}


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 9

# (a) The loader at V2_LITE's widths, cut to 2 layers (1 dense + 1 MoE) for
# time; (b) the golden files' GEMM; (c) eval_quality's decode steps and
# batch; (d)/(e) the mesh runs' requests and new tokens, the meshes of the
# four ranks sharing the card, and their first-decode-step bounds: JAX's
# for tp = 1 meshes (tests/test_parallel.py:105) and for tp > 1 or dp > 1
# (:69).
LOADER_CFG = dataclasses.replace(V2_LITE, num_layers=2)
GOLDEN_SIZE = 2048
QUALITY_ARGS = ["--model", "v2_lite", "--steps", "24", "--batch", "4"]
MESH_REQUESTS = 16
MESH_NEW = 16
MESH_RANKS = 4
MESH_SHAPES = ((1, 4, 1), (1, 1, 4), (2, 2, 1))
MESH_TP1_REL_L2 = 1e-6
MESH_REL_L2 = 0.02
MESH_JOIN_S = 600
MESH_SEQ = 2048          # the teacher-forced runs' cache: prompts ≤ 1024


def hf_state(cfg, seed: int) -> dict:
    """A synthetic HF checkpoint of ``cfg`` (numpy, from ``seed``): torch
    ``(out, in)`` Linear weights N(0, 0.02²), unit norms."""
    rng = np.random.default_rng(seed)
    h = cfg.hidden_size

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    s = {"model.embed_tokens.weight": w(cfg.vocab_size, h),
         "model.norm.weight": np.ones((h,), np.float32),
         "lm_head.weight": w(cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        s[p + "input_layernorm.weight"] = np.ones((h,), np.float32)
        s[p + "post_attention_layernorm.weight"] = np.ones((h,), np.float32)
        for name, out, inp in (("q", cfg.q_dim, h), ("k", cfg.kv_dim, h),
                               ("v", cfg.kv_dim, h), ("o", h, cfg.q_dim)):
            s[p + f"self_attn.{name}_proj.weight"] = w(out, inp)
        if i < cfg.first_dense_layers:
            mlps = [("mlp.", cfg.dense_intermediate)]
        else:
            s[p + "mlp.gate.weight"] = w(cfg.num_experts, h)
            mlps = [(f"mlp.experts.{j}.", cfg.moe_intermediate)
                    for j in range(cfg.num_experts)]
            mlps.append(("mlp.shared_experts.",
                         cfg.moe_intermediate * cfg.num_shared_experts))
        for pre, inter in mlps:
            s[p + pre + "gate_proj.weight"] = w(inter, h)
            s[p + pre + "up_proj.weight"] = w(inter, h)
            s[p + pre + "down_proj.weight"] = w(h, inter)
    return s


def _tensors(obj, path=""):
    """(path, tensor) of every tensor in a parameter tree."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, list):
        for i, o in enumerate(obj):
            yield from _tensors(o, f"{path}[{i}]")
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), f"{path}.{f.name}")


def _unequal_tensors(a, b) -> list:
    """The paths where two parameter trees differ in dtype, shape or a
    byte."""
    ta, tb = dict(_tensors(a)), dict(_tensors(b))
    if ta.keys() != tb.keys():
        return sorted(ta.keys() ^ tb.keys())
    return [k for k, x in ta.items()
            if x.dtype != tb[k].dtype or x.shape != tb[k].shape
            or not torch.equal(x.contiguous().view(torch.uint8).cpu(),
                               tb[k].contiguous().view(torch.uint8).cpu())]


def check_loader(device: dict) -> dict:
    """(a) ``load_params`` of a synthetic HF checkpoint at V2_LITE's widths
    (2 layers) on the card, byte-equal to the same loader on the CPU; the
    loaded model's logits through the kernels (a 256-token prefill and 8
    decode steps) against the same parameters under ``exact_mode`` (the
    fp8 GEMMs as exact f32 products) within the phase-3 bound; and the
    ``save_quantized`` / ``load_quantized`` round trip bit for bit."""
    cfg = LOADER_CFG
    t0 = time.perf_counter()
    state = hf_state(cfg, 15)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = load_params(state, cfg, device=DEV)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    unequal = _unequal_tensors(card, load_params(state, cfg, device="cpu"))
    n_tensors = len(dict(_tensors(card)))
    del state
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 256)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=8)
    _kernels.reset_counters()
    kern = _model_logits(card, cfg, DEV, prompt, steps)
    counts = counts_now()
    with fp8mod.exact_mode():
        exact = _model_logits(card, cfg, DEV, prompt, steps)
    errs = [relative_l2_error(a.numpy(), b.numpy())
            for a, b in zip(kern, exact)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "quantized.pt")
        t0 = time.perf_counter()
        save_quantized(card, path)
        back = load_quantized(path, cfg, device=DEV)
        roundtrip_s = time.perf_counter() - t0
        file_mib = os.path.getsize(path) / 2 ** 20
    unequal_back = _unequal_tensors(back, card)
    log(f"loader: V2_LITE widths, {cfg.num_layers} layers (1 dense + 1 MoE, "
        f"{cfg.num_experts} experts), a synthetic HF checkpoint made in "
        f"{make_s:.1f} s; load_params on the "
        f"card {load_s:.2f} s, {n_tensors} tensors, "
        f"{n_tensors - len(unequal)} byte-equal to the CPU loader's; "
        f"logits through the kernels vs exact_mode rel-L2 prefill "
        f"{errs[0]:.4g}, decode max {max(errs[1:]):.4g} (bound "
        f"{MODEL_REL_L2_TOL}); save/load_quantized {file_mib:.0f} MiB in "
        f"{roundtrip_s:.2f} s, {n_tensors - len(unequal_back)} of "
        f"{n_tensors} tensors bit-equal; kernel path launches {counts}; "
        f"{device['smi']}")
    if unequal or unequal_back:
        raise RuntimeError(f"loader: card vs CPU differ at {unequal[:4]}, "
                           f"round trip at {unequal_back[:4]}")
    if not max(errs) < MODEL_REL_L2_TOL or not all(
            bool(torch.isfinite(x).all()) for x in kern):
        raise RuntimeError(f"loader: kernels vs exact rel-L2 {errs}")
    check_path("loader (kernel path)", counts, FP8_PATH)
    return {"run": "loader", "counts": counts, "rel_l2_vs_exact": errs,
            "load_s": load_s, "tensors": n_tensors,
            "roundtrip_s": roundtrip_s, "file_mib": file_mib}


def _script(main, argv) -> tuple:
    """(exit code, stdout lines) of a script's ``main(argv)`` here."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def check_golden(device: dict) -> dict:
    """(b) ``gen_golden`` at 2048³ in fp16 and bf16; the inputs through
    K10 (``ops.gemm``, f32 out) into a file that ``verify_output`` must
    pass against the golden; the ``torch_matmul`` cross-check the same."""
    n = str(GOLDEN_SIZE)
    rows = []
    _kernels.reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, stored, tdt in (("float16", "float16", torch.float16),
                                   ("bfloat16", "float32", torch.bfloat16)):
            d = os.path.join(tmp, dtype)
            rc_gen, _ = _script(gen_golden.main, [n, n, n, "--dtype", dtype,
                                                  "--out-dir", d])

            def inp(name):
                x = np.fromfile(os.path.join(d, "input", name),
                                np.dtype(stored))
                return torch.from_numpy(x.reshape(GOLDEN_SIZE, -1)).to(
                    DEV, tdt)
            out = gemm(inp("x1_gm.bin"), inp("x2_gm.bin"),
                       out_dtype=torch.float32)
            k10 = os.path.join(d, "output", "k10_out.bin")
            out.cpu().numpy().tofile(k10)
            golden = os.path.join(d, "output", "golden.bin")
            rc_k10, lines_k10 = _script(verify_output.main, [k10, golden])
            rc_mm, _ = _script(torch_matmul.main, [n, n, n, "--dtype", stored,
                                                   "--dir", d])
            rc_ref, lines_ref = _script(verify_output.main, [
                os.path.join(d, "output", "torch_out.bin"), golden])
            rows.append({"dtype": dtype, "rc": [rc_gen, rc_k10, rc_mm,
                                                rc_ref],
                         "k10": lines_k10[-1], "torch_matmul": lines_ref[-1]})
            log(f"golden {dtype} {n}³: K10 {lines_k10[-1]}; torch_matmul "
                f"{lines_ref[-1]}")
    counts = counts_now()
    log(f"  launches {counts}; {device['smi']}")
    if any(rc for r in rows for rc in r["rc"]):
        raise RuntimeError(f"golden scripts: {rows}, launches {counts}")
    check_path("golden (K10)", counts, {"gemm"})
    return {"run": "golden", "counts": counts, "rows": rows}


def check_quality(device: dict) -> dict:
    """(c) ``eval_quality`` at V2_LITE (8 layers), 24 decode steps, batch
    4, with fp8 and with int8 experts: its JSON lines, ``ok`` required."""
    lines = {}
    _kernels.reset_counters()
    for quant_ in ("fp8", "int8"):
        t0 = time.perf_counter()
        rc, out = _script(eval_quality.main,
                          QUALITY_ARGS + ["--expert-quant", quant_])
        line = json.loads(out[-1])
        lines[quant_] = line
        log(f"eval_quality {quant_} ({time.perf_counter() - t0:.1f} s): "
            f"{out[-1]}")
        if rc != 0 or not line["ok"]:
            raise RuntimeError(f"eval_quality {quant_}: rc {rc}, {line}")
    counts = counts_now()
    log(f"  launches {counts}; {device['smi']}")
    # Decode steps from empty caches: no prefill kernel.
    check_path("eval_quality", counts, DECODE_PATH | {"int8_grouped_masked"})
    return {"run": "eval_quality", "counts": counts, "lines": lines}


def forced_logits(mesh, params, prompts, tokens) -> tuple:
    """Teacher-forced logits on ``mesh``: ``prompts`` prefilled into slots
    0.. through the sharded prefill step, grouped by bucket and padded as
    the engine groups one admission; then MESH_NEW - 1 decode steps (the
    logits gathered), step t fed every request's token ``tokens[i][t]``,
    so that every mesh sees the same history and the logits read the
    merged caches. Returns (prefill last logits, [step logits]), each
    (requests, vocab) f32 on the CPU."""
    p = shardmod.shard_params(mesh, params, V2_LITE)
    caches = shardmod.shard_caches(
        mesh, init_cache(V2_LITE, len(prompts), MESH_SEQ, device=DEV),
        V2_LITE)
    groups = {}
    for i, prompt in enumerate(prompts):
        groups.setdefault(engine_mod._bucket(len(prompt)), []).append(i)
    last = [None] * len(prompts)
    for bucket, rows in groups.items():
        s_pad = 1 << (len(rows) - 1).bit_length()
        toks = np.zeros((s_pad, bucket), np.int32)
        lens = np.ones((s_pad,), np.int32)
        slots = np.full((s_pad,), -1, np.int32)
        for j, i in enumerate(rows):
            toks[j, :len(prompts[i])] = prompts[i]
            lens[j], slots[j] = len(prompts[i]), i
        got, _ = shardmod.make_sharded_prefill_step(
            mesh, V2_LITE, params, bucket, s_pad)(
            p, caches, torch.from_numpy(toks), slots, lens)
        for j, i in enumerate(rows):
            last[i] = got[j].float().cpu()
    step = shardmod.make_sharded_decode_step(mesh, V2_LITE, params)
    seq = torch.tensor([len(x) for x in prompts], dtype=torch.int32,
                       device=DEV)
    steps = []
    for t in range(MESH_NEW - 1):
        toks = torch.tensor([out[t] for out in tokens], dtype=torch.int32,
                            device=DEV)
        logits, _ = step(p, toks, caches, seq)
        seq += 1
        steps.append(logits.float().cpu())
    return torch.stack(last), steps


def phase_mesh_one(device: dict, serving: list) -> dict:
    """(d) A 1-rank NCCL group joined through a ``file://`` store in this
    process; phase 4's requests through ``Engine(mesh=make_mesh(1, 1, 1))``
    with fp8 experts at decode_chunk 1 and 8 and with int8 at 1: tokens and
    final caches equal phase 4's one-device runs' bit for bit, exactly
    phase 4's kernels (ring K1/K3, K2 live, K6) and no plain call. Then the
    reference of (e): the decode step from empty caches, the first
    MESH_REQUESTS requests served with MESH_NEW new tokens, and those
    tokens fed back (``forced_logits``). The group is destroyed at the
    end."""
    ref_runs = {r["run"]: r for r in serving if "cache_sha256" in r}
    prompts = serving_prompts(V2_LITE)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1, 1, 1)
            for experts, chunk in (("fp8", 1), ("fp8", CHUNK), ("int8", 1)):
                label = experts if chunk == 1 else f"{experts} chunk {chunk}"
                ref = ref_runs[label]
                params = serving_params(experts)
                eng = Engine(params, V2_LITE, max_slots=16, max_seq_len=4096,
                             decode_chunk=chunk, device=DEV, mesh=mesh)
                outs, wall, counts, plans, peak = serve(eng, prompts)
                same_caches = cache_digest(eng) == ref["cache_sha256"]
                log(f"one-rank mesh ({label}): 24 requests in {wall:.2f} s, "
                    f"decode {eng.tokens_per_second:.1f} tok/s; tokens "
                    f"{'equal' if outs == ref['outputs'] else 'DIFFER from'}"
                    f" phase 4's, caches "
                    f"{'equal' if same_caches else 'DIFFER'}; launches by "
                    f"plan {plans}; {device['smi']}")
                if outs != ref["outputs"] or not same_caches:
                    raise RuntimeError(f"one-rank mesh ({label}): tokens or "
                                       f"caches differ from phase 4's")
                check_path(f"one-rank mesh ({label})", counts,
                           FP8_PATH if experts == "fp8" else INT8_PATH, plans)
                runs.append({"run": f"mesh 1x1x1 {label}", "counts": counts,
                             "plans": plans, "wall_s": wall,
                             "decode_tok_s": eng.tokens_per_second})
                del eng, params
                torch.cuda.empty_cache()
            params = serving_params("fp8")
            fresh = fresh_step_logits(mesh, params)
            eng = Engine(params, V2_LITE, max_slots=16, max_seq_len=4096,
                         device=DEV, mesh=mesh)
            outs, *_ = serve(eng, prompts[:MESH_REQUESTS], MESH_NEW)
            if outs != [o[:MESH_NEW] for o in
                        ref_runs["fp8"]["outputs"][:MESH_REQUESTS]]:
                raise RuntimeError("one-rank mesh, 16 requests: the tokens "
                                   "are not phase 4's")
            del eng
            forced = forced_logits(mesh, params, prompts[:MESH_REQUESTS],
                                   outs)
            del params
        finally:
            shardmod.clear_program_memo()
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"runs": runs, "reference": (outs, forced, fresh)}


def fresh_step_logits(mesh, params) -> torch.Tensor:
    """One sharded decode step of 16 slots from empty caches (lengths 0,
    tokens 1, 8, 15, ...), its logits gathered — the step JAX's tests hold
    a mesh to one device by (``tests/test_parallel.py:69,105``)."""
    step = shardmod.make_sharded_decode_step(mesh, V2_LITE, params)
    p = shardmod.shard_params(mesh, params, V2_LITE)
    caches = shardmod.shard_caches(
        mesh, init_cache(V2_LITE, MESH_REQUESTS, 256, device=DEV), V2_LITE)
    toks = torch.arange(MESH_REQUESTS, dtype=torch.int32, device=DEV) * 7 + 1
    lens = torch.zeros(MESH_REQUESTS, dtype=torch.int32, device=DEV)
    logits, _ = step(p, toks, caches, lens)
    return logits.float().cpu()


def mesh_rank(rank: int, world: int, store: str, out_dir: str,
              ref_outs: list) -> None:
    """One of (e)'s ranks (a spawned process, the card shared): joins gloo
    through ``store`` and, for each of MESH_SHAPES, serves the first
    MESH_REQUESTS of phase 4's requests (MESH_NEW new tokens, fp8 experts,
    greedy) through the unmodified ``Engine(mesh=...)``, the counters
    zeroed before and read after; then feeds the one-rank mesh's tokens
    ``ref_outs`` back (``forced_logits``); writes ``<rank>.pt``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        params = serving_params("fp8")
        prompts = serving_prompts(V2_LITE)[:MESH_REQUESTS]
        out = {}
        for shape in MESH_SHAPES:
            mesh = make_mesh(*shape, device_type="cpu")
            fresh = fresh_step_logits(mesh, params)
            eng = Engine(params, V2_LITE, max_slots=16, max_seq_len=4096,
                         device=DEV, mesh=mesh)
            dist.barrier()
            outs, wall, counts, plans, _ = serve(eng, prompts, MESH_NEW)
            out[shape] = {"outputs": outs, "wall_s": wall, "counts": counts,
                          "plans": plans,
                          "decode_tok_s": eng.tokens_per_second}
            del eng
            torch.cuda.empty_cache()
            forced = forced_logits(mesh, params, prompts, ref_outs)
            if rank == 0:
                out[shape].update(fresh=fresh, forced=forced)
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        shardmod.clear_program_memo()
        dist.destroy_process_group()


def _partings(ref_outs, outs, ref_forced, forced) -> tuple:
    """(first position where each request's tokens leave the reference's,
    {request: (the reference's margin of its token over the mesh's,
    |Δ| of the two tokens' logits)}) — the margin and Δ from the
    teacher-forced logits at that position, where both have the same
    history: a parting the rounding explains has margin ≤ |Δ|."""
    first, ties = [], {}
    for i, (x, y) in enumerate(zip(outs, ref_outs)):
        d = next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None)
        first.append(d)
        if d is not None:
            (lp, lm) = ((ref_forced[0], forced[0]) if d == 0 else
                        (ref_forced[1][d - 1], forced[1][d - 1]))
            lp, lm = lp[i], lm[i]
            delta = (lm - lp).abs()
            ties[i] = (float(lp[y[d]] - lp[x[d]]),
                       float(delta[x[d]] + delta[y[d]]))
    return first, ties


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).norm() / ref.norm())


def phase_mesh_four(device: dict, reference) -> list:
    """(e) MESH_RANKS spawned processes joined over gloo, the tensors on
    the one card (gloo takes CUDA tensors in this torch), each mesh of
    MESH_SHAPES in turn. Rank 0's decode step from empty caches
    (``fresh_step_logits``) against (d)'s within MESH_TP1_REL_L2 (tp = dp
    = 1: only the f32 order of the ep psum differs) or MESH_REL_L2, JAX's
    bounds for that step. Serving through the unmodified engine (its
    sharded sampler, tp > 1 included): every rank's tokens identical, and
    each rank's launches exactly the fp8 serving kernels on their routes,
    no plain call; decode tok/s — gloo ranks sharing one card, a harness
    check and not a scaling figure. Teacher-forced (``forced_logits``, the
    one-rank mesh's tokens fed to both): the prefill's last logits and
    every decode step's logits, which read the caches the prefill merged
    over "data", within the phase-3 bound of (d)'s (two card paths that
    round differently: psums in other f32 orders, K1's split plans at
    other m). The served tokens equal (d)'s or part where the teacher-
    forced logits explain it: the reference's margin of its token over
    the mesh's no more than the two logits' differences."""
    runs = []
    ctx = mp.get_context("spawn")
    ref_outs, ref_forced, ref_fresh = reference
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, MESH_RANKS, os.path.join(tmp, "store"),
                                   tmp, ref_outs)) for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=MESH_JOIN_S)
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * MESH_RANKS:
            raise RuntimeError(f"four ranks: exit codes {codes}, hung {hung}")
        res = [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
               for r in range(MESH_RANKS)]
        wall = time.perf_counter() - t0
    for shape in MESH_SHAPES:
        r0 = res[0][shape]
        same_ranks = all(r[shape]["outputs"] == r0["outputs"] for r in res)
        fresh = _rel_l2(r0["fresh"], ref_fresh)
        bound = (MESH_TP1_REL_L2 if shape[0] == shape[2] == 1
                 else MESH_REL_L2)
        prefill = _rel_l2(r0["forced"][0], ref_forced[0])
        steps = [_rel_l2(a, b) for a, b in zip(r0["forced"][1],
                                               ref_forced[1])]
        first, ties = _partings(ref_outs, r0["outputs"], ref_forced,
                                r0["forced"])
        ties_ok = all(m <= gap for m, gap in ties.values())
        log(f"four ranks, mesh {shape} (dp, ep, tp), gloo on one shared "
            f"card: decode step from empty caches vs the one-rank mesh "
            f"rel-L2 {fresh:.3g} (bound {bound:g}); teacher-forced vs the "
            f"one-rank mesh: prefill logits rel-L2 {prefill:.3g}, decode "
            f"steps first {steps[0]:.3g} max {max(steps):.3g} (bound "
            f"{MODEL_REL_L2_TOL}); serving 16 requests: every rank's "
            f"tokens {'identical' if same_ranks else 'NOT identical'}, "
            f"{first.count(None)} of {MESH_REQUESTS} equal to the one-rank "
            f"mesh's, partings (request: position, reference margin, |Δ| "
            f"of the two logits) "
            f"{ {i: (first[i], round(m, 5), round(g, 5))
                 for i, (m, g) in ties.items()} }"
            f"; decode {r0['decode_tok_s']:.1f} tok/s on rank 0 (gloo "
            f"ranks on one shared card: a harness check, not a scaling "
            f"figure)")
        for r, rr in enumerate(res):
            log(f"  rank {r} launches (launches, plain calls) "
                f"{ {n: c for n, c in rr[shape]['counts'].items() if any(c)} }"
                f"; by plan {rr[shape]['plans']}")
            check_path(f"four ranks {shape} rank {r}", rr[shape]["counts"],
                       FP8_PATH, rr[shape]["plans"])
        if not same_ranks or not fresh < bound or not ties_ok or \
                not prefill < MODEL_REL_L2_TOL or \
                not max(steps) < MODEL_REL_L2_TOL:
            raise RuntimeError(f"four ranks {shape}: ranks identical "
                               f"{same_ranks}, fresh step rel-L2 {fresh}, "
                               f"teacher-forced prefill rel-L2 {prefill}, "
                               f"steps {steps}, partings {ties}")
        counts = {n: (sum(rr[shape]["counts"][n][0] for rr in res),
                      sum(rr[shape]["counts"][n][1] for rr in res))
                  for n in r0["counts"]}
        runs.append({"run": "mesh " + "x".join(map(str, shape)),
                     "counts": counts, "rel_l2_fresh_step": fresh,
                     "rel_l2_forced_prefill": prefill,
                     "rel_l2_forced_steps": steps,
                     "first_divergence": first, "partings": ties,
                     "decode_tok_s_rank0": r0["decode_tok_s"],
                     "wall_s": r0["wall_s"]})
    log(f"  four ranks, three meshes: {wall:.1f} s with the processes' "
        f"start; {device['smi']}")
    return runs


def phase_sharded(device: dict, serving: list) -> list:
    """Phase 9: the loader, the golden and quality scripts, and sharded
    serving on a one-rank mesh and on four ranks sharing the card. Returns
    one run a check (its counts read just after it)."""
    runs = [check_loader(device), check_golden(device),
            check_quality(device)]
    torch.cuda.empty_cache()
    one = phase_mesh_one(device, serving)
    runs += one["runs"]
    runs += phase_mesh_four(device, one["reference"])
    return runs


HEADLINE = {"fp8_gemm": "m=16 n=22016 k=2048",
            "grouped_gemm": "E=32 cap=96 ",
            "flash_decode": "kvh=4 g=4",
            "flash_prefill": "start=0",
            "int8_gemm": "m=16 n=22016 k=2048",
            "int8_grouped_contiguous": "n=2816",
            "int8_grouped_masked": "E=32 cap=96 ",
            "gemm": "m=2048 n=2048 k=2048 bf16 nn",
            "gemm_ksplit": "m=16 n=2048 k=11008 bf16 k_split=4",
            "grouped_gemm_contiguous": "E=32 block_m=128",
            "fp8_gemm_folded": "m=16 n=22016 k=2048 b_layout=t",
            "flash_decode_read": "kvh=4 g=4",
            "flash_decode_state": "kvh=4 g=4",
            "flash_prefill_stats": "start=0",
            "copy_probe": "8x128"}
NO_LIBRARY = {
    "grouped_gemm": "none: no PyTorch call runs a masked grouped product "
                    "with blockwise fp8 scales",
    "flash_decode": "none: no PyTorch attention reads an int8 cache with "
                    "per-token scales and writes it in place",
    "flash_prefill": "none: no PyTorch attention reads an int8 cache with "
                     "per-token scales",
    "flash_decode_read": "none: no PyTorch attention reads an int8 cache "
                         "with per-token scales",
    "flash_decode_state": "none: no PyTorch attention returns the raw "
                          "softmax state over an int8 cache",
    "flash_prefill_stats": "none: no PyTorch attention returns the raw "
                           "softmax state over an int8 cache"}


def variant_entries(kernels: dict, tiling: dict) -> list:
    """The kernels line's entries of the compiled tile variants: each
    variant's launches in the tiling phase's driven run, its numbers at its
    headline shape (``VARIANT_HEADLINE``) and the library yardstick of its
    kernel's phase-2 row at that shape."""
    out = []
    by_var = {}
    for r in tiling["variants"]:
        by_var.setdefault((r["kernel"], r["variant"]), []).append(r)
    for (name, label), rows in by_var.items():
        launches = (tiling["folded_launches"] if name == "fp8_gemm_folded"
                    else tiling["plans"].get(name, {})).get(label, 0)
        if not launches:
            continue
        head = next((r for r in rows
                     if r["shape"].startswith(VARIANT_HEADLINE[name])),
                    rows[0])
        source, replaces = KERNELS[name]
        lib = next((r for r in kernels["checks"][name]
                    if r["shape"].startswith(head["shape"])), {})
        lib_ms = lib.get("library_ms")
        if name == "fp8_gemm" and head["shape"].startswith("m=16 "):
            lib_ms = kernels["k1_library"][0]["ms"]
        out.append({
            "name": f"{name} {label}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_run": {"tiling": launches},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": lib_ms, "shape": head["shape"]})
    return out


def summarize(kernels: dict, runs: list) -> list:
    """One entry per kernel: its launches through its wrapper in the driven
    runs (phases 4 to 7) and, apart, those of its bare C entry (P0's
    dispatch floor, which no wrapper counts), the headline shape's phase-2
    numbers and its library yardstick."""
    summary = []
    for name, (source, replaces) in KERNELS.items():
        rows = kernels["checks"][name]
        head = next(r for r in rows if HEADLINE[name] in r["shape"])
        by_run = {run["run"]: run["counts"][name][0] for run in runs}
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
            "bare_launches": sum(run.get("bare_launches", {}).get(name, 0)
                                 for run in runs),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": lib_ms,
            "library_note": lib_note or NO_LIBRARY.get(name),
            "shape": head["shape"],
            **({"path": head["route"]} if "route" in head else {})})
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
    model = {experts: {**phase_model(experts),
                       "shards": check_moe_shards(experts)}
             for experts in ("fp8", "int8")}
    log("phase 4: serving, fp8 experts then int8 experts")
    serving = []
    for experts in ("fp8", "int8"):
        serving.append(phase_serving(device, experts))
        torch.cuda.empty_cache()      # the finished run's engine is gone
        serving += phase_features(device, experts, serving[-1]["outputs"])
        torch.cuda.empty_cache()
    runs = list(serving)
    log("phase 5: the reference-compatible API")
    runs.append(phase_compat(device))
    log("phase 6: context-parallel prefill and the direct attention/fp8 ops")
    runs.append(phase_cp(device))
    torch.cuda.empty_cache()
    log("phase 7: the measurement scripts")
    runs += phase_scripts(device)
    scripts = runs[len(serving) + 2:]
    log("phase 8: the tiling tiers and the tile variants")
    tiling = phase_tiling(device)
    runs.append(tiling)
    torch.cuda.empty_cache()
    log("phase 9: the loader, the golden and quality scripts, sharded "
        "serving")
    sharded = phase_sharded(device, serving)
    runs += sharded
    summary = summarize(kernels, runs) + variant_entries(kernels, tiling)
    log("kernels " + " | ".join(
        f"{k['name']}: launches="
        f"{ {r: n for r, n in k['launches_by_run'].items() if n} } "
        f"ok ms={k['ms']:.4f} "
        f"bound_ms={k['bound_ms']:.4f}" for k in summary))
    n = len(serving)
    report = {"device": device, "kernels": kernels, "model": model,
              "serving": serving, "compat": runs[n], "cp": runs[n + 1],
              "scripts": scripts, "tiling": tiling, "sharded": sharded,
              "total_s": time.perf_counter() - t_start}
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
