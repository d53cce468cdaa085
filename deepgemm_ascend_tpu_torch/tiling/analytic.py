"""Analytic tiling model: the compiled tile variants, their cost model and
the default config — tier 3 of the tiling system.

Port of ``deepgemm_ascend_tpu/tiling/analytic.py``. The JAX module
enumerates a grid of Pallas block sizes under the TPU's VMEM budget and
scores each with a roofline; on the card a tile is a compiled kernel
instance, so the port's candidates are **only the compiled variants** of
the op's kernel (:data:`TILES`), judged against the Hopper envelope
(shared memory an SM and a block, the register file: :func:`smem_footprint`,
:func:`judge_space`, in place of ``vmem_footprint``):

* K10/K11 (``gemm``, ``gemm_nt``/``_tn``/``_tt``, ``bgemm``): route
  "wgmma" 64 × 64, 128 × 128, 128 × 256; route "ffma" 16 × 128, 64 × 64,
  128 × 128; route "mma_tile" 64 × 64. 64-deep K stages on every route;
  K11's split counts from :data:`SPLITS`;
* K7 (``int8_gemm_nt``, B stored K-major): route "wgmma" 64 × 64,
  128 × 128, 128 × 256 with 128-deep stages; ``int8_gemm`` (B stored
  (k, n)): route "int8_tile" 64 × 64;
* K1 (``fp8_gemm_nt``): route "ring" 16 × 64 and 64 × 64, with 1-8 CTAs
  of a cluster splitting the 128-deep scale groups; ``fp8_gemm``: route
  "tile" 64 × 64. K12 (the folded scale mode of the same ops) has a route
  of its own, "folded": 64 × 64, 128 × 128 and 128 × 256;
* the grouped GEMMs, under JAX's op names with ``_nt`` for B stored
  K-major (the int8 ones too, where JAX's names carry no layout): K3
  (``grouped_gemm_masked[_nt]``) on K1's routes, ring 16 × 64 / 64 × 64,
  tile 64 × 64, never split; K8 (``grouped_gemm[_nt]``, the contiguous
  layout) on route "wgmma16" 64 × 128 / 128 × 128, tile 64 × 64; K6
  (``int8_grouped_gemm_masked[_nt]``) on operands TMA reads (route
  "wgmma" of ``ops.int8_gemm.route``) takes its ring kernel on 16 × 64 and
  its wgmma kernel on 64 × 64 / 128 × 256 (:data:`KERNEL_ROUTES`: the
  tile decides), else int8_tile 64 × 64; K9 (``int8_grouped_gemm[_nt]``)
  route wgmma 64 × 64 / 128 × 256, int8_tile 64 × 64. A contiguous op's
  key has the layout's m-tile as m (JAX's), and its tiles' rows divide
  it on the Hopper routes.

:func:`get_best_config` returns the config that the kernels picked before
their tiles became selectable — the rules that used to live inside the C
entries (``sm90::large_tile``: K10's, K7's and K12's; K1's
``ring_plan``) and in the grouped wrappers (K3's and K6's rows an expert
is expected to hold, K8's and K9's layout rule), and the fitted split
gate below — so that with no cache and no predictor every shape runs as
it did. The masked ops' answer depends on ``expected_m`` (the rows an
expert is expected to hold), which their selection key carries.
:func:`estimate_time` is the fitted model of K10 and K11 extended over
the variants; it ranks candidates for the autotuner's pruning and the
predictor's guardrail, never the default. The padding tag
(``tiling/padding.py``) is attached to the dense GEMM's configs.

The split gate
--------------

The JAX function minimises a per-core makespan over split counts, with a
gate (``nm·nn < cores and nk >= 2·cores``, :317) written for a TPU with
one or two TensorCores. The port instead models the two kernels as they
run on the card — K10 and K11 on the wgmma route of ``csrc/gemm.cu`` —
and sends a shape to KSPLIT only where the model, fitted to measured
times, says K11 wins clearly:

* the tile: where K10 takes 128 × 256 tiles (:func:`large_tile`: m > 64
  and at least :data:`FULL_GRID` of them) the card is full and nothing
  splits. Otherwise both kernels run bm × bn (64 × 64) tiles,
  :data:`SLOTS_PER_SM` blocks an SM;
* a kernel of ``blocks`` blocks, each streaming ``stages`` bk-deep K
  stages of its tile, takes :data:`LAUNCH_S` plus the
  :data:`NORM`-norm of two limits: the blocks' streams, ``ceil(blocks /
  slots) · stages · STAGE_S``, and the operand bytes over
  :data:`HBM_RATE`. K10 is ``tiles`` blocks of ``nk`` stages; K11 with s
  splits ``s·tiles`` blocks of ``ceil(nk / s)`` stages, plus
  :data:`REDUCE_S` for the wrapper's sum and the f32 partials written and
  read again (2·s·m·n·4 bytes);
* KSPLIT takes the fastest split count of :data:`SPLITS` whose splits
  are at least :data:`MIN_BLOCKS_PER_SPLIT` stages deep, if the model
  puts it below :data:`MARGIN` of K10's time; ties go to fewer splits.

The constants were fitted to ``scripts/ksplit_sweep.py``'s times of K10
and of K11 at every split count of :data:`SPLITS`, bf16, m ∈ {1, 16, 32,
64, 128, 256} over eleven (n, k) (NVIDIA H100 80GB HBM3, 700 W): the
model's RMS error over the 520 times it models is 6.7 %, and at each of
the 26 of those 66 shapes where it splits, K11 at the chosen count beat
K10, by 1.22-2.39× (``PERF.md`` §6). At decode the splits pay where K is
deep and the tiles are few (m = 16: n = 2048, k = 11008; n = 512 or
1024, k ≥ 4096); at k ≤ 2048 the sum's launch costs more than the
shorter streams save.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import List, Optional, Tuple

import torch

from ..config import GemmConfig, KernelType
from ..utils.common import ceil_div, round_up
from . import platform as plat
from .platform import PlatformInfo

# ---------------------------------------------------------------- variants

# The compiled tiles (rows, columns) of each (kernel family, route), in the
# order of the C entries' tile codes (csrc/gemm.cu, int8_gemm.cu,
# fp8_gemm.cuh).
WGMMA_TILES = ((64, 64), (128, 128), (128, 256))
FFMA_TILES = ((16, 128), (64, 64), (128, 128))
RING_TILES = ((16, 64), (64, 64))
# K8's wgmma16 tiles, K6's and K9's wgmma tiles, K12's folded tiles.
WGMMA16_TILES = ((64, 128), (128, 128))
GROUPED_WGMMA_TILES = ((64, 64), (128, 256))
FOLDED_TILES = WGMMA_TILES
TILES = {
    ("gemm", "mma_tile"): ((64, 64),),
    ("gemm", "wgmma"): WGMMA_TILES,
    ("gemm", "ffma"): FFMA_TILES,
    ("int8", "int8_tile"): ((64, 64),),
    ("int8", "wgmma"): WGMMA_TILES,
    ("fp8", "tile"): ((64, 64),),
    ("fp8", "ring"): RING_TILES,
    ("fp8", "folded"): FOLDED_TILES,
    ("fp8_masked", "tile"): ((64, 64),),
    ("fp8_masked", "ring"): RING_TILES,
    ("fp8_contiguous", "tile"): ((64, 64),),
    ("fp8_contiguous", "wgmma16"): WGMMA16_TILES,
    ("int8_masked", "int8_tile"): ((64, 64),),
    ("int8_masked", "ring"): ((16, 64),),
    ("int8_masked", "wgmma"): GROUPED_WGMMA_TILES,
    ("int8_contiguous", "int8_tile"): ((64, 64),),
    ("int8_contiguous", "wgmma"): GROUPED_WGMMA_TILES,
}
# The kernel routes that operands of a route open, where the config's tile
# picks one: K6's TMA operands run its ring kernel or its wgmma kernel.
KERNEL_ROUTES = {("int8_masked", "wgmma"): ("ring", "wgmma")}
# The K depth of a family's stage: 64 16-bit elements (K11 splits K in
# whole 64-deep blocks on every route), 128 int8, one 128-deep fp8 scale
# group. A config's block_k is this depth; the kernels read no other.
K_STEP = {"gemm": 64, "int8": 128, "fp8": 128, "fp8_masked": 128,
          "fp8_contiguous": 128, "int8_masked": 128, "int8_contiguous": 128}
# (stages, threads, blocks an SM) of each compiled instance; the stages
# set its shared memory (smem_footprint). K3 runs K1's ring instances, K6
# and K9 K7's wgmma ones; K6's ring ("ring8") and K12's are their own.
_INSTANCES = {
    ("wgmma", (64, 64)): (6, 256, 2),
    ("wgmma", (128, 128)): (6, 384, 1),
    ("wgmma", (128, 256)): (4, 384, 1),
    ("ffma", (16, 128)): (6, 128, 2),
    ("ffma", (64, 64)): (2, 256, 2),
    ("ffma", (128, 128)): (2, 256, 2),
    ("mma_tile", (64, 64)): (1, 128, 4),
    ("int8_tile", (64, 64)): (1, 128, 4),
    ("tile", (64, 64)): (1, 128, 4),
    ("ring", (16, 64)): (4, 160, 4),
    ("ring", (64, 64)): (4, 288, 2),
    ("ring8", (16, 64)): (6, 160, 3),
    ("wgmma16", (64, 128)): (2, 128, 2),
    ("wgmma16", (128, 128)): (4, 256, 1),
    ("folded", (64, 64)): (3, 256, 3),
    ("folded", (128, 128)): (3, 384, 1),
    ("folded", (128, 256)): (3, 384, 1),
}
# K12's raw e4m3 stages (csrc/fp8_gemm.cu: run_folded's RAW), 3 elsewhere.
_FOLDED_RAW = {(128, 128): 6}
# Register share a thread of these kernels keeps at least: a block fits the
# card only if its threads can each hold that many.
MIN_REGS = 64
# K1's ring: CTAs of a portable cluster, and the 128-deep scale groups a
# split runs at least and, where more splits can share K, at most.
MAX_SPLITS = 8
MIN_SPLIT_GROUPS = 2
MAX_SPLIT_GROUPS = 12

# Ops by kernel family; the suffix names the stored layout (gemm_<ab>,
# "_nt" for a B stored K-major).
_GEMM_LAYOUTS = {"gemm": "nn", "bgemm": "nn", "gemm_nt": "nt",
                 "gemm_tn": "tn", "gemm_tt": "tt"}
# The ops whose K11 path exists: split-K is nn only (ops/gemm.py).
KSPLIT_OPS = ("gemm", "bgemm")
_FAMILIES = {"int8_gemm": "int8", "fp8_gemm": "fp8",
             "grouped_gemm_masked": "fp8_masked",
             "grouped_gemm": "fp8_contiguous",
             "int8_grouped_gemm_masked": "int8_masked",
             "int8_grouped_gemm": "int8_contiguous"}
# The grouped ops (JAX's names and their "_nt" twins).
GROUPED_OPS = tuple(op + sfx for op in _FAMILIES if "grouped" in op
                    for sfx in ("", "_nt"))
MASKED = ("fp8_masked", "int8_masked")
CONTIGUOUS = ("fp8_contiguous", "int8_contiguous")


def family(op: str) -> str:
    """The kernel family of a selector op: "gemm" (K10/K11), "int8" (K7),
    "fp8" (K1, and K12 on its route), "fp8_masked" (K3),
    "fp8_contiguous" (K8), "int8_masked" (K6) or "int8_contiguous"
    (K9)."""
    if op in _GEMM_LAYOUTS:
        return "gemm"
    fam = _FAMILIES.get(op[:-3] if op.endswith("_nt") else op)
    if fam is None:
        raise ValueError(f"no tile variants for op {op!r}")
    return fam


def route_tiles(op: str, route: str) -> List[Tuple[str, Tuple[int, int]]]:
    """(kernel route, tile) of every compiled tile that operands taking
    ``route`` can run, in tile-code order a kernel route."""
    fam = family(op)
    return [(kr, t) for kr in KERNEL_ROUTES.get((fam, route), (route,))
            for t in TILES[(fam, kr)]]


def kernel_plan(op: str, route: str, block_m: int,
                block_n: int) -> Tuple[str, int]:
    """(kernel route, tile code) of a block_m × block_n tile on operands
    that take ``route``: the tile's index in its kernel route's compiled
    set. A tile outside them raises ``ValueError`` naming the compiled
    tiles (nothing is substituted)."""
    pairs = route_tiles(op, route)
    for kr, t in pairs:
        if t == (block_m, block_n):
            return kr, TILES[(family(op), kr)].index(t)
    raise ValueError(
        f"{op}: no compiled {block_m}x{block_n} tile on route {route!r}; "
        f"compiled: {', '.join('%dx%d' % t for _, t in pairs)}")


def instance(op: str, route: str, bm: int, bn: int):
    """(kernel route, (stages, threads, blocks an SM)) of a compiled
    tile."""
    kr, _ = kernel_plan(op, route, bm, bn)
    if family(op) == "int8_masked" and kr == "ring":
        kr = "ring8"
    return kr, _INSTANCES[(kr, (bm, bn))]


def expected_rows(op: str, m: int, expected_m: Optional[int]):
    """The ``expected_m`` a selection keys on: for a masked op the rows an
    expert is expected to hold, below M_max (``m``) and at least 0 — None
    where it is not given or not below M_max, which picks as M_max does;
    None for every other op, whose tile no hint moves."""
    if expected_m is None or family(op) not in MASKED or expected_m >= m:
        return None
    return max(0, int(expected_m))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def expected_route(op: str, m: int, n: int, k: int, in_dtype) -> str:
    """The route a launch of ``op`` takes on operands of this shape stored
    contiguously with 16-byte aligned bases (``ops.gemm.route``,
    ``ops.int8_gemm.route``, ``ops.fp8_gemm.route`` and the grouped
    wrappers' routes; a contiguous op's m is the layout's m-tile): only an
    offset view takes another. K12's route "folded" is the scale mode's,
    never expected."""
    fam = family(op)
    nt = op.endswith("_nt")
    if fam in ("int8", "int8_masked", "int8_contiguous"):
        tma = nt and k > 0 and k % 16 == 0
        if fam == "int8_contiguous":
            tma = tma and m % 64 == 0
        return "wgmma" if tma else "int8_tile"
    if fam in ("fp8", "fp8_masked"):
        return "ring" if nt and k > 0 else "tile"
    if fam == "fp8_contiguous":
        return "wgmma16" if nt and k > 0 and m % 64 == 0 else "tile"
    a_t, b_t = (c == "t" for c in _GEMM_LAYOUTS[op])
    pitch_a = m if a_t else k
    pitch_b = k if b_t else n
    if in_dtype == torch.float32:
        return "ffma" if pitch_a % 4 == 0 and pitch_b % 4 == 0 else "mma_tile"
    if in_dtype in (torch.bfloat16, torch.float16) and k > 0 \
            and pitch_a % 8 == 0 and pitch_b % 8 == 0:
        return "wgmma"
    return "mma_tile"


def tile_code(op: str, route: str, block_m: int, block_n: int) -> int:
    """The C entry's tile code of (block_m, block_n) on ``route``; a tile
    outside the route's compiled set raises ``ValueError`` (nothing is
    substituted)."""
    return kernel_plan(op, route, block_m, block_n)[1]


# ---------------------------------------------------------------- envelope

def smem_footprint(route: str, bm: int, bn: int, stages: int,
                   elem_bytes: int = 2) -> int:
    """Bytes of shared memory one block of a route's instance asks for:
    its stage ring (``sm90::Ring``: 128 bytes of K a row of A and B a
    stage, barriers and the 1024-byte swizzle slack; the FFMA ring's
    16-deep f32 stages with their raw transpose buffers; K1's ring of
    128-byte scale groups with their scales), or the tile routes' one
    stage."""
    if route in ("wgmma", "ring8"):
        return stages * (bm + bn) * 128 + 2 * stages * 8 + 1024
    if route == "wgmma16":       # two f16 B stages, raw e4m3 A and B
        return 2 * 2 * bn * 128 + stages * (bm + bn) * 128 \
            + stages * 8 + 1008
    if route == "folded":        # the bf16 ring, then the raw e4m3 one
        raw = _FOLDED_RAW.get((bm, bn), 3)
        return stages * (bm + bn) * 128 + raw * (bm + bn) * 64 \
            + (2 * stages + 2 * raw) * 8 + 1024
    if route == "ffma":
        return stages * 16 * ((bm + 4) + (bn + 4)) * 4 * 2
    if route == "ring":
        return stages * ((bm + bn) * 128 + (bm + bn) * 4 + 16) + 1024
    return (bm + bn) * (64 + 8) * elem_bytes


def judge_space(route: str, bm: int, bn: int,
                info: Optional[PlatformInfo] = None) -> bool:
    """True iff the compiled (route, bm × bn) instance fits the card: its
    blocks' shared memory within a block's and an SM's budget, and its
    threads each able to hold :data:`MIN_REGS` registers (≙ the JAX
    ``judge_space``'s VMEM check, `op_tiling/utils.cpp:28-47` in the
    reference)."""
    info = info or plat.H100
    inst = _INSTANCES.get((route, (bm, bn)))
    if inst is None:
        return False
    stages, threads, blocks = inst
    smem = smem_footprint(route, bm, bn, stages)
    return (smem <= info.smem_per_block
            and smem * blocks <= info.smem_per_sm
            and threads * blocks * MIN_REGS <= info.regs_per_sm)


# ---------------------------------------------------------------- K1's plan

def ring_tile(m: int) -> int:
    """Index into :data:`RING_TILES` for m rows: 16 rows at decode (m ≤ 16:
    mma's own M, no padded rows), else 64 × 64 (measured faster than a
    128 × 128 tile at prefill, ``scripts/ring_sweep.py``)."""
    return 0 if m <= 16 else 1


def ring_splits(m: int, n: int, k: int, tile: int,
                sms: int = plat.H100_SMS) -> int:
    """CTAs that split K1's 128-deep groups on the ring: 1 where the tiles
    fill at least half the card's SMs; else as many as put one CTA on
    about every SM, or as keep each split to MAX_SPLIT_GROUPS groups if
    that is more (deep K), at most MAX_SPLITS (a cluster) and with at
    least MIN_SPLIT_GROUPS groups each."""
    bm, bn = RING_TILES[tile]
    tiles = ceil_div(m, bm) * (n // bn)
    groups = k // 128
    if 2 * tiles > sms:
        return 1
    return max(1, min(MAX_SPLITS, groups // MIN_SPLIT_GROUPS,
                      max(sms // tiles, ceil_div(groups, MAX_SPLIT_GROUPS))))


def ring_plan(m: int, n: int, k: int, sms: int = plat.H100_SMS):
    """(tile index, splits) of K1's ring route for an (m, k) × (k, n)
    product on a card of ``sms`` SMs."""
    tile = ring_tile(m)
    return tile, ring_splits(m, n, k, tile, sms)


# ---------------------------------------------------------------- grouped rules

# The rows an expert is expected to hold that the masked kernels' tiles
# follow: K3 and K6 take 16-row ring tiles up to SMALL_ROWS (at decode: no
# padded fragments, a CTA walks its few valid tiles and zeroes the rest;
# scripts/ring_sweep.py: 16 rows ahead up to a mean of 12 rows an expert);
# beyond, K3 its 64-row ring tile and K6 its wgmma kernel, 64 x 64 up to
# MEDIUM_ROWS and 128 x 256 past them (scripts/decode_sweep.py at
# V2_LITE's experts: 64 x 64 ahead at 24 and 48 rows, 128 x 256 level at
# 96 and ahead from 192).
SMALL_ROWS = 16
MEDIUM_ROWS = 64


def _rows(m_max: int, expected_m: Optional[int]) -> int:
    return m_max if expected_m is None else max(0, min(m_max, expected_m))


def masked_ring_tile(m_max: int, expected_m: Optional[int] = None) -> int:
    """Index into :data:`RING_TILES` of K3's ring tile: 16 rows where an
    expert is expected to hold at most SMALL_ROWS rows — ``expected_m``
    (the caller's hint, DeepGEMM's name for it) or, without one, M_max —
    else 64."""
    return 0 if _rows(m_max, expected_m) <= SMALL_ROWS else 1


def masked_plan(m_max: int, expected_m: Optional[int] = None):
    """(kernel route, tile code) of K6 on operands that take the TMA
    routes, by the rows an expert is expected to hold (``expected_m`` or,
    without it, M_max): ``"ring"`` up to SMALL_ROWS, else ``"wgmma"`` on
    64 × 64 tiles (code 0) up to MEDIUM_ROWS and on 128 × 256 (code 1)
    beyond."""
    rows = _rows(m_max, expected_m)
    if rows <= SMALL_ROWS:
        return "ring", 0
    return "wgmma", int(rows > MEDIUM_ROWS)


def contiguous_tile(block_m: int) -> int:
    """The tile code of the contiguous kernels' Hopper routes (K8's
    wgmma16, K9's wgmma): 1, the 128-row tile, where 128 divides the
    layout's ``block_m`` (the MoE prefill's and DeepGEMM's layout), else
    0, the 64-row one."""
    return int(block_m % 128 == 0)


def folded_tile(m: int, n: int) -> Tuple[int, int]:
    """K12's tile (the rule ``csrc/fp8_gemm.cu`` compiled in before its
    tile became selectable): a 128-row tile where m > 64 and the grid of
    them reaches FULL_GRID blocks — 128 × 256 where 256 divides n, else
    128 × 128 — otherwise 64 × 64, three blocks an SM."""
    rows = ceil_div(m, 128)
    if n % 256 == 0:
        if m > 64 and rows * (n // 256) >= FULL_GRID:
            return 128, 256
    elif m > 64 and rows * (n // 128) >= FULL_GRID:
        return 128, 128
    return 64, 64


def grouped_tile(op: str, route: str, m: int,
                 expected_m: Optional[int] = None) -> Tuple[int, int]:
    """The tile a grouped op's wrapper picked before its tile became
    selectable, on ``route`` (``m``: M_max of a masked op, the layout's
    m-tile of a contiguous one): :func:`masked_ring_tile` (K3),
    :func:`masked_plan` (K6), :func:`contiguous_tile` (K8, K9); the tile
    routes their one 64 × 64."""
    fam = family(op)
    if fam == "fp8_masked" and route == "ring":
        return RING_TILES[masked_ring_tile(m, expected_m)]
    if fam == "int8_masked" and route == "wgmma":
        kr, code = masked_plan(m, expected_m)
        return TILES[(fam, kr)][code]
    if fam == "fp8_contiguous" and route == "wgmma16":
        return WGMMA16_TILES[contiguous_tile(m)]
    if fam == "int8_contiguous" and route == "wgmma":
        return GROUPED_WGMMA_TILES[contiguous_tile(m)]
    return 64, 64


# ---------------------------------------------------------------- the model

# The large-tile rule the C entries once compiled in (sm90::large_tile):
# K10's 128 × 256 tile where m > 64 and there are at least FULL_GRID of
# them.
LARGE_TILE = (128, 256)
FULL_GRID = 100
# Blocks of the 64 × 64 wgmma instance an SM holds (its launch bounds).
SLOTS_PER_SM = 2
# The fitted model (module docstring).
STAGE_S = 0.18e-6        # one block's time for one bk-deep stage
LAUNCH_S = 7.0e-6        # launch, pipeline fill and epilogue of a kernel
REDUCE_S = 3.5e-6        # K11's extra: the wrapper's sum of the partials
HBM_RATE = 2.5e12        # bytes a second the streams reach together
NORM = 1.5
SPLITS = (2, 3, 4, 6, 8, 12, 16)
MIN_BLOCKS_PER_SPLIT = 4
MARGIN = 0.85
# The share of an SM's peak that a 64 × 64 × 64 wgmma stage reaches in the
# fit above (2 blocks an SM, STAGE_S a stage); the other variants' stages
# are priced at the same share of their own work, never below STAGE_S.
STAGE_EFF = (2 * 2 * 64 ** 3) / (STAGE_S * plat.BF16_OPS_PER_S
                                 / plat.H100_SMS)


def large_tile(m: int, n: int) -> bool:
    """K10 runs 128 × 256 tiles (the large-tile rule above)."""
    return m > 64 and (ceil_div(m, LARGE_TILE[0])
                       * ceil_div(n, LARGE_TILE[1])) >= FULL_GRID


def model_seconds(m: int, n: int, k: int, splits: int, bm: int, bn: int,
                  bk: int, info: PlatformInfo) -> float:
    """The modelled time of K10 (``splits`` = 1) or of K11 with ``splits``
    splits on bm × bn tiles of bk-deep stages (module docstring)."""
    tiles, nk = ceil_div(m, bm) * ceil_div(n, bn), ceil_div(k, bk)
    slots = SLOTS_PER_SM * info.num_cores
    nbytes = (m * k + k * n) * 2
    extra = 0.0
    if splits > 1:
        nbytes += 2 * splits * m * n * 4
        extra = REDUCE_S
    stream = ceil_div(splits * tiles, slots) * ceil_div(nk, splits) * STAGE_S
    limits = stream ** NORM + (nbytes / HBM_RATE) ** NORM
    return LAUNCH_S + extra + limits ** (1 / NORM)


def select_kernel_type(
    m: int, n: int, k: int, bm: int, bn: int, bk: int,
    info: PlatformInfo,
) -> Tuple[KernelType, int]:
    """(kernel family, split count) for an (m, n, k) GEMM whose small tile
    is bm × bn with bk-deep stages: SMALL for a single tile, KSPLIT with
    the modelled fastest split count where the model puts K11 below
    MARGIN of K10, else COMMON."""
    nm, nn, nk = ceil_div(m, bm), ceil_div(n, bn), ceil_div(k, bk)
    if nm == 1 and nn == 1 and nk == 1:
        return KernelType.SMALL, 1
    if large_tile(m, n):
        return KernelType.COMMON, 1
    cost = {s: model_seconds(m, n, k, s, bm, bn, bk, info)
            for s in SPLITS if nk // s >= MIN_BLOCKS_PER_SPLIT}
    if cost:
        best = min(cost, key=lambda s: (cost[s], s))
        if cost[best] <= MARGIN * model_seconds(m, n, k, 1, bm, bn, bk,
                                                info):
            return KernelType.KSPLIT, best
    return KernelType.COMMON, 1


@dataclasses.dataclass(frozen=True)
class CostParams:
    """The model's constants for one (device, op): the fitted defaults
    above, or a refit from sweep records (``scripts/calibrate_cost_model``,
    written to the port's ``data/cost_model.json`` keyed by device kind
    and op; ≙ JAX's ``CostParams``)."""

    stage_s: float = STAGE_S
    launch_s: float = LAUNCH_S
    hbm_rate: float = HBM_RATE
    stage_eff: float = STAGE_EFF


_NOMINAL = CostParams()
_calibration: Optional[dict] = None
COST_MODEL_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                               "cost_model.json")


def _load_calibration() -> dict:
    """The port's fitted constants per device kind and op; {} when the file
    is absent (no TPU data file is read)."""
    global _calibration
    if _calibration is None:
        _calibration = {}
        if os.path.exists(COST_MODEL_PATH):
            try:
                with open(COST_MODEL_PATH) as f:
                    _calibration = json.load(f)
            except (OSError, ValueError):
                _calibration = {}
    return _calibration


def get_cost_params(op: Optional[str], info: PlatformInfo) -> CostParams:
    """The constants of (device, op): a calibrated entry where the port's
    cost model holds one (a layout-suffixed op falls back to its base op's
    entry), else the fitted defaults."""
    calib = _load_calibration().get(info.device_kind, {})
    entry = None
    if op is not None:
        entry = calib.get(op)
        if entry is None and op[-3:] in ("_nt", "_tn", "_tt"):
            entry = calib.get(op[:-3])
    if entry is None:
        return _NOMINAL
    return CostParams(**{f.name: float(entry.get(f.name,
                                                  getattr(_NOMINAL, f.name)))
                         for f in dataclasses.fields(CostParams)})


@dataclasses.dataclass(frozen=True)
class _Estimate:
    time_s: float
    compute_s: float
    memory_s: float
    smem_bytes: int


def _peak(fam: str, in_dtype) -> float:
    if fam.startswith("int8"):
        return plat.INT8_OPS_PER_S
    if fam.startswith("fp8"):
        return plat.FP8_OPS_PER_S
    return plat.peak_ops(in_dtype)


def estimate_time(op: str, m: int, n: int, k: int, config: GemmConfig,
                  info: PlatformInfo, in_dtype=torch.bfloat16,
                  out_dtype=torch.float32, batch: int = 1,
                  params: Optional[CostParams] = None,
                  route: Optional[str] = None) -> _Estimate:
    """The modelled time of one launch of ``op``'s kernel with ``config``:
    :func:`model_seconds`'s form (the launch, then the NORM-norm of the
    blocks' streams and the bytes) over the config's variant — its tile's
    blocks an SM, a stage priced at the 64 × 64 fit's share of the SM's
    peak for the tile's work (never below STAGE_S), the splits' extra sum
    — plus, for a padded config (``pad_k``), the pad copies
    (``padding.estimate_pad_cost``). For the 16-bit wgmma 64 × 64 variant
    it is :func:`model_seconds` exactly."""
    from . import padding
    params = params or get_cost_params(op, info)
    fam = family(op)
    if config.kernel_type == KernelType.XLA:
        route, bm, bn = "mma_tile", 64, 64
    else:
        bm, bn = config.block_m, config.block_n
    pad_s = 0.0
    if fam == "gemm" and config.pad_k:
        m, n, k, pad_s = (m, *padding.padded_dims(op, m, n, k, in_dtype),
                          padding.estimate_pad_cost(
                              m, n, k, K_STEP["gemm"], _itemsize(in_dtype),
                              _itemsize(in_dtype), info, op=op,
                              in_dtype=in_dtype, out_dtype=out_dtype))
    route = route or expected_route(op, m, n, k, in_dtype)
    bk = K_STEP[fam]
    splits = config.k_split
    tiles = ceil_div(m, bm) * ceil_div(n, bn) * max(batch, 1)
    nk = ceil_div(k, bk)
    if config.kernel_type == KernelType.XLA:   # priced as the mma_tile
        kroute, (stages, _, per_sm) = route, _INSTANCES[(route, (bm, bn))]
    else:
        kroute, (stages, _, per_sm) = instance(op, route, bm, bn)
    slots = per_sm * info.num_cores
    isz = _itemsize(in_dtype)
    nbytes = (m * k + k * n) * isz * max(batch, 1) \
        + m * n * _itemsize(out_dtype) * max(batch, 1)
    extra = 0.0
    if splits > 1 and fam == "gemm":
        nbytes += 2 * splits * m * n * 4 * max(batch, 1)
        extra = REDUCE_S
    sm_peak = _peak(fam, in_dtype) / plat.H100_SMS
    if route in ("mma_tile", "int8_tile", "tile"):
        eff = params.stage_eff / 4          # no async ring, mma.sync
    elif route == "ffma":
        eff = params.stage_eff * 0.8
    else:
        eff = params.stage_eff
    stage_s = max(params.stage_s, per_sm * 2 * bm * bn * bk / (sm_peak * eff))
    stream = ceil_div(splits * tiles, slots) * ceil_div(nk, splits) * stage_s
    memory_s = nbytes / params.hbm_rate
    limits = stream ** NORM + memory_s ** NORM
    time_s = params.launch_s + extra + limits ** (1 / NORM) + pad_s
    return _Estimate(time_s, stream, memory_s,
                     smem_footprint(kroute, bm, bn, stages))


# ---------------------------------------------------------------- candidates

def _fits_shape(bm: int, bn: int, m: int, n: int) -> bool:
    """A tile the shape can use: no more rows than m rounded up to 64, no
    more columns than n rounded up to 64 (the smallest tile always)."""
    return bm <= max(round_up(m, 64), 16) and bn <= max(round_up(n, 64), 64)


def tile_admits(op: str, route: str, bm: int, bn: int, m: int,
                n: int) -> bool:
    """Whether a compiled tile can run this problem at all: a contiguous
    op's Hopper tiles only where their rows divide the layout's m-tile
    (``m``: no tile spans two experts), K12's 128 × 256 only where 256
    divides n (its grid covers n / 256 tiles)."""
    fam = family(op)
    if fam in CONTIGUOUS and route not in ("tile", "int8_tile"):
        return m % bm == 0
    if route == "folded" and bn == 256:
        return n % 256 == 0
    return True


def enumerate_candidates(op: str, m: int, n: int, k: int,
                         in_dtype=torch.bfloat16, out_dtype=torch.float32,
                         info: Optional[PlatformInfo] = None,
                         batch: int = 1, splits: bool = True,
                         route: Optional[str] = None) -> List[GemmConfig]:
    """The configs ``op``'s kernel can run at this shape on the card: each
    compiled tile of the route the operands take (:func:`expected_route`)
    that fits the shape and the card (:func:`judge_space`), with K11's
    split counts (nn ops, :data:`SPLITS` with at least
    MIN_BLOCKS_PER_SPLIT stages a split, where the tiles leave the card
    short of a full wave) and K1's (1-8 CTAs of a cluster, at least
    MIN_SPLIT_GROUPS groups each, where the tiles leave half the SMs idle);
    for a dense shape whose row pitches keep it off the wgmma/ffma routes,
    also the padded configs (``pad_k``) of the route the padded operands
    take. ≙ the reference's candidate generator
    (``catlass_parameter.py:14-120``) with the card's constraints."""
    from . import padding
    info = info or plat.H100
    fam = family(op)
    route = route or expected_route(op, m, n, k, in_dtype)
    bk = K_STEP[fam]
    out: List[GemmConfig] = []
    sms = info.num_cores
    for _, (bm, bn) in route_tiles(op, route):
        kroute, (_, _, per_sm) = instance(op, route, bm, bn)
        if not (_fits_shape(bm, bn, m, n) and judge_space(kroute, bm, bn,
                                                          info)
                and tile_admits(op, route, bm, bn, m, n)):
            continue
        base = GemmConfig(block_m=bm, block_n=bn, block_k=bk)
        out.append(base)
        if not splits:
            continue
        tiles = ceil_div(m, bm) * ceil_div(n, bn) * max(batch, 1)
        slots = per_sm * sms
        if fam == "gemm" and op in KSPLIT_OPS and tiles < slots:
            nk = ceil_div(k, bk)
            out += [base.replace(kernel_type=KernelType.KSPLIT, k_split=s)
                    for s in SPLITS if nk // s >= MIN_BLOCKS_PER_SPLIT]
        if fam == "fp8" and route == "ring" and 2 * tiles <= sms:
            groups = k // 128
            out += [base.replace(kernel_type=KernelType.KSPLIT, k_split=s)
                    for s in range(2, MAX_SPLITS + 1)
                    if groups // s >= MIN_SPLIT_GROUPS]
    if fam == "gemm" and route == "mma_tile" and padding.paddable(
            op, m, n, k, in_dtype):
        pm, pn, pk = m, *padding.padded_dims(op, m, n, k, in_dtype)
        proute = expected_route(op, pm, pn, pk, in_dtype)
        if proute != "mma_tile":
            out += [c.replace(pad_k=True) for c in enumerate_candidates(
                op, pm, pn, pk, in_dtype, out_dtype, info, batch, splits,
                proute)]
    return out


# ---------------------------------------------------------------- default

def default_tile(op: str, route: str, m: int, n: int, batch: int = 1,
                 splits: int = 1, sms: int = plat.H100_SMS) -> Tuple[int, int]:
    """The tile the kernels picked before it became selectable: on route
    wgmma (K10, K11, K7) 128 × 256 where m > 64 and the grid of such tiles
    (batch and splits counted) fills the card (the large-tile rule), else
    64 × 64; on route ffma 16 × 128 at m ≤ 16, 128 × 128 where m > 64 and
    such tiles fill the card, else 64 × 64; K1's ring :func:`ring_tile`;
    the tile routes their one 64 × 64."""
    fam = family(op)
    if fam == "fp8" and route == "ring":
        return RING_TILES[ring_tile(m)]
    if route == "wgmma":
        tiles = ceil_div(m, 128) * ceil_div(n, 256) * batch * splits
        return (128, 256) if m > 64 and tiles >= FULL_GRID else (64, 64)
    if route == "ffma":
        if m <= 16:
            return 16, 128
        tiles = ceil_div(m, 128) * ceil_div(n, 128) * batch * splits
        return (128, 128) if m > 64 and tiles >= FULL_GRID else (64, 64)
    return 64, 64


def get_best_config(
    m: int, n: int, k: int,
    in_dtype=torch.bfloat16, out_dtype=torch.float32,
    *,
    op: str = "gemm",
    info: Optional[PlatformInfo] = None,
    batch: int = 1,
    route: Optional[str] = None,
    expected_m: Optional[int] = None,
) -> GemmConfig:
    """The analytic config of an (m, n, k) problem of ``op`` (≙ JAX
    ``get_best_config``, ``csrc/jit/get_best_config.hpp:33`` in the
    reference): the kernel family and split count of the split gate
    (:func:`select_kernel_type`, K11 for the nn ops only) or of K1's
    :func:`ring_plan`, the tile of :func:`default_tile` on the route the
    operands take (``route``, else :func:`expected_route`), the family's K
    step as block_k, the M-major raster the kernels ran before (JAX's
    N-major rule for n > m is not taken: it would move today's launches)
    — and, for the dense GEMM, the padding tag (:func:`_apply_padding_tag`:
    ``pad_k`` where padding the ragged pitches beats the mma_tile route,
    and then the padded problem's tile). The grouped ops: the tile of
    :func:`grouped_tile` (by ``expected_m`` for a masked op), never split;
    K12 (``route="folded"``): :func:`folded_tile`. Memoized per (shape,
    op, device)."""
    info = info or plat.H100
    key = (m, n, k, str(in_dtype), str(out_dtype), op, info, batch, route,
           expected_rows(op, m, expected_m))
    return _best(key)


@functools.lru_cache(maxsize=4096)
def _best(key) -> GemmConfig:
    m, n, k, in_s, out_s, op, info, batch, route, expected_m = key
    in_dtype = getattr(torch, in_s.replace("torch.", ""))
    out_dtype = getattr(torch, out_s.replace("torch.", ""))
    fam = family(op)
    route = route or expected_route(op, m, n, k, in_dtype)
    if fam == "gemm" and route == "mma_tile":
        padded = _apply_padding_tag(op, m, n, k, in_dtype, out_dtype, info,
                                    batch)
        if padded is not None:
            return padded
    return _rule_config(op, route, m, n, k, info, batch, expected_m)


def _rule_config(op, route, m, n, k, info, batch,
                 expected_m=None) -> GemmConfig:
    fam = family(op)
    if fam not in ("gemm", "int8", "fp8") or route == "folded":
        bm, bn = (folded_tile(m, n) if route == "folded"
                  else grouped_tile(op, route, m, expected_m))
        return GemmConfig(block_m=bm, block_n=bn, block_k=K_STEP[fam])
    if fam == "fp8":
        if route == "ring":
            tile, s = ring_plan(m, n, k, info.num_cores)
            bm, bn = RING_TILES[tile]
        else:
            (bm, bn), s = (64, 64), 1
        kt = KernelType.KSPLIT if s > 1 else KernelType.COMMON
        return GemmConfig(block_m=bm, block_n=bn, block_k=K_STEP[fam],
                          kernel_type=kt, k_split=s)
    kt, s = KernelType.COMMON, 1
    if fam == "gemm":
        kt, s = select_kernel_type(m, n, k, 64, 64, K_STEP["gemm"], info)
        if kt == KernelType.KSPLIT and op not in KSPLIT_OPS:
            kt, s = KernelType.COMMON, 1
    splits = s if kt == KernelType.KSPLIT else 1
    bm, bn = default_tile(op, route, m, n, batch, splits, info.num_cores)
    return GemmConfig(block_m=bm, block_n=bn, block_k=K_STEP[fam],
                      kernel_type=kt, k_split=s)


def _apply_padding_tag(op, m, n, k, in_dtype, out_dtype, info,
                       batch) -> Optional[GemmConfig]:
    """The padded config of a ragged dense problem where the padding cost
    model (``tiling/padding.get_padding_tag``) prices the pad copies below
    the mma_tile route's loss (``pad_k``: K, and N where the row pitch
    needs it, padded; the tile and family those of the padded problem);
    None where masking on the mma_tile route wins. ≙ JAX
    ``_apply_padding_tag`` (:409)."""
    from . import padding
    tag = padding.get_padding_tag(m, n, k, 64, 64, K_STEP["gemm"],
                                  _itemsize(in_dtype), _itemsize(in_dtype),
                                  info, op=op, in_dtype=in_dtype,
                                  out_dtype=out_dtype)
    if tag.tag != padding.PaddingTag.PAD_K:
        return None
    pn, pk = padding.padded_dims(op, m, n, k, in_dtype)
    proute = expected_route(op, m, pn, pk, in_dtype)
    return _rule_config(op, proute, m, pn, pk, info, batch).replace(
        pad_k=True)


def cache_clear() -> None:
    """Drop the memo (tests, a refit cost model)."""
    global _calibration
    _best.cache_clear()
    _calibration = None


get_best_config.cache_clear = cache_clear
