"""Dense GEMM (kernel K10) and split-K GEMM (kernel K11).

Port of ``deepgemm_ascend_tpu/ops/gemm.py``: ``gemm``, ``bgemm`` and
``gemm_with_config`` with the JAX signatures. ``a @ b`` with an f32
accumulator for bf16, fp16 and f32 inputs, output f32 by default (bf16 or
fp16 on request); ``layout`` names the storage of (A, B): "n" as the
logical operand ((m, k) / (k, n)), "t" transposed ((k, m) / (n, k)).

On a CUDA tensor the wrappers launch ``csrc/gemm.cu``: K10, or K11 when
the config is ``KernelType.KSPLIT`` with ``k_split > 1``, at least
``k_split`` K blocks and the nn layout (JAX :171-173); K11's f32 partials
are summed and cast here, as ``jnp.sum`` does outside the TPU kernel. Both
take one of three routes, decided here by :func:`route` and passed to the
kernel, which refuses a route it cannot take: ``"wgmma"`` (bf16/fp16
operands that TMA can describe: the Hopper main loop of
``csrc/sm90_gemm.cuh``, 128 × 256 tiles, or 64 × 64 for m ≤ 64 and where
128 × 256 tiles would leave most SMs idle, K11's splits counted),
``"ffma"`` (f32 operands with 16-byte aligned data and row pitches that
are multiples of 4: FFMA on the CUDA cores, 128 × 128 tiles of 8 × 8
outputs a thread fed by a two-stage shared-memory ring, 64 × 64 where
those leave most SMs idle, 16 × 128 at m ≤ 16; bit-equal to the f32
``"mma_tile"``) or ``"mma_tile"`` (everything else: fixed 64 × 64 output
tiles with 64-deep K blocks, :data:`TILE_M`, ...). Either way K11 splits
K in whole 64-deep blocks (:func:`_split_depth`). Each launch is counted
under its route too (``Counter.plans``); the wrappers' ``plan`` argument
forces a route. Of a ``GemmConfig`` the kernels
read ``kernel_type``, ``k_split``, ``swizzle`` (the raster order of the
output tiles) and ``pad_k`` (nn: K padded with zeros to a multiple of the
64-deep block); the block sizes are fixed.
``KernelType.XLA`` — the JAX package's product outside Pallas — is a plain
``torch.matmul`` in f32. On a CPU tensor the wrappers run the kernels'
plain versions, :func:`gemm_plain` and :func:`gemm_ksplit_plain`.

``bgemm`` flattens the leading dims into a third grid axis of one launch,
where the JAX package vmaps the 2-D kernel (:341-345).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import GemmConfig, KernelType, SwizzleDir
from ..tiling.padding import pad_k_operands
from ..tiling.selector import TILE_K, select_config
from ..utils.common import ceil_div
from . import _kernels

__all__ = ["gemm", "bgemm", "gemm_with_config", "gemm_plain",
           "gemm_ksplit_plain", "ksplit_partials_plain", "split_ranges",
           "route"]

K10 = _kernels.COUNTERS["gemm"]
K11 = _kernels.COUNTERS["gemm_ksplit"]
# The C interface's type codes, and K10's and K11's route codes.
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("mma_tile", "wgmma", "ffma")


def _check_layout(layout: str):
    if len(layout) != 2 or any(c not in "nt" for c in layout):
        raise ValueError(f"layout must be one of nn/nt/tn/tt, got {layout!r}")
    return layout[0] == "t", layout[1] == "t"


def _f32_product(a, b, a_t: bool, b_t: bool):
    """A (…, m, k) · B (…, k, n) in f32, from operands stored (…, k, m)
    for ``a_t`` and (…, n, k) for ``b_t``."""
    a = a.transpose(-1, -2) if a_t else a
    b = b.transpose(-1, -2) if b_t else b
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def gemm_plain(a, b, *, a_t: bool = False, b_t: bool = False,
               out_dtype=torch.float32):
    """Plain PyTorch version of K10 on any device: both operands in f32,
    one product, one rounding to ``out_dtype``."""
    K10.plain_calls += 1
    return _f32_product(a, b, a_t, b_t).to(out_dtype)


def _split_depth(k: int, k_split: int) -> int:
    """K range of one split: whole 64-deep blocks, as K11 divides them."""
    return ceil_div(ceil_div(k, TILE_K), k_split) * TILE_K


def split_ranges(k: int, k_split: int):
    """K11's K range of each split, as the wrapper passes them to the
    kernel (``k_per`` = :func:`_split_depth`): split s sums
    [s·k_per, (s+1)·k_per) cut at K; a split that starts at or past K is
    empty, (k, k), and adds zeros (JAX's clamped, zeroed overrun,
    gemm.py:240-242, :260-262)."""
    per = _split_depth(k, k_split)
    return [(min(s * per, k), min((s + 1) * per, k)) for s in range(k_split)]


def ksplit_partials_plain(a, b, k_split: int):
    """Plain PyTorch version of K11's output (nn): the f32 partials
    (…, k_split, m, n), one f32 product per split's K range."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    return torch.stack([torch.matmul(a[..., lo:hi], b[..., lo:hi, :])
                        for lo, hi in split_ranges(a.shape[-1], k_split)],
                       dim=-3)


def gemm_ksplit_plain(a, b, k_split: int, *, out_dtype=torch.float32):
    """Plain PyTorch version of K11 with the wrapper's sum (nn): the
    partials summed over the splits, then cast."""
    K11.plain_calls += 1
    return ksplit_partials_plain(a, b, k_split).sum(dim=-3).to(out_dtype)


def route(a, b, layout: str = "nn") -> str:
    """K10's and K11's route for the stored operands ``a``, ``b``
    (contiguous, any leading dims the batch) in ``layout``, where both have
    16-byte aligned ``data_ptr``s: ``"wgmma"`` where TMA can describe both
    — bf16/fp16, k > 0, row pitches (the stored last dims) that are
    multiples of 8 elements (16 bytes; a batch's matrix pitch then is too);
    ``"ffma"`` for f32 operands whose row pitches are multiples of 4
    elements (16-byte loads); else ``"mma_tile"``."""
    a_t, _ = _check_layout(layout)
    k = a.shape[-2] if a_t else a.shape[-1]
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    if b.dtype != a.dtype or not aligned:
        return "mma_tile"
    if a.dtype == torch.float32:
        return ("ffma" if a.shape[-1] % 4 == 0 and b.shape[-1] % 4 == 0
                else "mma_tile")
    if (a.dtype not in (torch.bfloat16, torch.float16) or k == 0
            or a.shape[-1] % 8 or b.shape[-1] % 8):
        return "mma_tile"
    return "wgmma"


def _cuda_checks(a, b, out_dtype):
    if b.device != a.device:
        raise ValueError(f"gemm: b is on {b.device}, a on {a.device}")
    if a.dtype != b.dtype or a.dtype not in _CODES:
        raise ValueError(f"gemm: operands must share one of bf16/fp16/f32 on "
                         f"CUDA, got {a.dtype}/{b.dtype}")
    if out_dtype not in _CODES:
        raise ValueError(f"gemm: out_dtype must be f32, bf16 or fp16 on "
                         f"CUDA, got {out_dtype}")


def _run(a, b, config: GemmConfig, layout: str, out_dtype, plan=None):
    """``a @ b`` over the leading dims shared by ``a`` and ``b``; shapes are
    validated by the callers. ``plan`` as for :func:`gemm_with_config`."""
    a_t, b_t = _check_layout(layout)
    if not isinstance(config, GemmConfig):
        raise TypeError(f"config must be a GemmConfig, got {type(config)}")
    if plan is not None and plan not in ROUTES:
        raise ValueError(f"gemm: plan must be one of {ROUTES}, got {plan!r}")
    if config.kernel_type == KernelType.XLA:
        return _f32_product(a, b, a_t, b_t).to(out_dtype)
    if config.pad_k and layout == "nn" and a.shape[-1] % TILE_K:
        a, b = pad_k_operands(a, b, TILE_K)
    lead = tuple(a.shape[:-2])
    m, k = (a.shape[-1], a.shape[-2]) if a_t else a.shape[-2:]
    n = b.shape[-2] if b_t else b.shape[-1]
    s = config.k_split
    ksplit = (config.kernel_type == KernelType.KSPLIT and s > 1
              and ceil_div(k, TILE_K) >= s and layout == "nn")
    dev = a.device
    if dev.type == "cpu":
        return (gemm_ksplit_plain(a, b, s, out_dtype=out_dtype) if ksplit
                else gemm_plain(a, b, a_t=a_t, b_t=b_t, out_dtype=out_dtype))
    if dev.type != "cuda":
        raise ValueError(f"gemm: unsupported device {dev}")
    _cuda_checks(a, b, out_dtype)
    a, b = a.contiguous(), b.contiguous()
    batch = math.prod(lead)
    stream = _kernels.stream_ptr(dev)
    rt = plan or route(a, b, layout)
    if ksplit:
        parts = torch.empty((*lead, s, m, n), dtype=torch.float32, device=dev)
        if parts.numel():
            rc = _kernels.entry("gemm_ksplit")(
                a.data_ptr(), b.data_ptr(), parts.data_ptr(), batch, m, n, k,
                s, _split_depth(k, s), _CODES[a.dtype], ROUTES.index(rt),
                stream)
            _kernels.check(rc, "gemm_ksplit")
            K11.launches += 1
            K11.count_plan(rt)
        return parts.sum(dim=-3).to(out_dtype)
    out = torch.empty((*lead, m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = _kernels.entry("gemm")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, n, k, int(a_t),
        int(b_t), _CODES[a.dtype], _CODES[out_dtype],
        int(config.swizzle == SwizzleDir.N_MAJOR), ROUTES.index(rt), stream)
    _kernels.check(rc, "gemm")
    K10.launches += 1
    K10.count_plan(rt)
    return out


def _check_2d(a, b, layout: str):
    """(m, n, k) of a 2-D product; raises as the JAX package does."""
    a_t, b_t = _check_layout(layout)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"gemm expects 2-D operands, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = (a.shape[1], a.shape[0]) if a_t else a.shape
    k2, n = (b.shape[1], b.shape[0]) if b_t else b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} (layout {layout})")
    return m, n, k


def gemm_with_config(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    config: GemmConfig,
    out_dtype=torch.float32,
    layout: str = "nn",
    plan: Optional[str] = None,
) -> torch.Tensor:
    """``a @ b`` with an explicit config (layouts and knobs as in the module
    docstring). ``plan``: one of ``ROUTES`` in place of :func:`route`'s
    choice, for tests and measurements; the kernel refuses a route it
    cannot take, and a CPU tensor runs the plain version whatever the
    plan."""
    _check_2d(a, b, layout)
    return _run(a, b, config, layout, out_dtype, plan)


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    out_dtype=torch.float32,
    config: Optional[GemmConfig] = None,
    layout: str = "nn",
    plan: Optional[str] = None,
) -> torch.Tensor:
    """Dense ``a @ b`` with the config from ``select_config`` (the kernel
    family for ``a``'s device), unless ``config`` is given; ``plan`` as for
    :func:`gemm_with_config`. The public analogue of the reference's
    ``run_mmad_rtc``."""
    m, n, k = _check_2d(a, b, layout)
    op = "gemm" if layout == "nn" else f"gemm_{layout}"
    cfg = select_config(m, n, k, a.dtype, out_dtype, op=op, override=config,
                        device=a.device)
    return gemm_with_config(a, b, config=cfg, out_dtype=out_dtype,
                            layout=layout, plan=plan)


def bgemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    out_dtype=torch.float32,
    config: Optional[GemmConfig] = None,
    plan: Optional[str] = None,
) -> torch.Tensor:
    """Batched GEMM (…, M, K) @ (…, K, N), nn, one launch for the batch;
    ``plan`` as for :func:`gemm_with_config`."""
    if a.dim() == 2:
        return gemm(a, b, out_dtype=out_dtype, config=config, plan=plan)
    if a.dim() != b.dim():
        raise ValueError(f"rank mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if a.shape[:-2] != b.shape[:-2] or b.shape[-2] != k:
        raise ValueError(f"bgemm shapes do not match: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    cfg = select_config(m, n, k, a.dtype, out_dtype, op="bgemm",
                        override=config, device=a.device)
    return _run(a, b, cfg, "nn", out_dtype, plan)
