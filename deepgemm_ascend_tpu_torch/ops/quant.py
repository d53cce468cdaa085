"""Blockwise FP8 / INT8 quantization utilities.

Port of ``deepgemm_ascend_tpu/ops/quant.py``, plain PyTorch (the JAX
quantizers are plain XLA too). The arithmetic is the same step for step --
an f32 divide by the scale, then the cast -- so the e4m3 bytes and the f32
scales match the JAX package bit for bit (tests/test_torch_quant.py):

* activations: per-(token, 128-channel-block) scales → A (m, k) e4m3 with
  scales (m, ⌈k/128⌉) f32;
* weights: per-(128×128 block) scales → B (k, n) e4m3 with scales
  (⌈k/128⌉, ⌈n/128⌉) f32;
* KV-cache: per-(head, token) int8 symmetric quantization, rounding half to
  even like ``jnp.round``.

Every division is an IEEE division of two tensors on the data's device: a
CUDA kernel dividing by a Python scalar multiplies by its reciprocal
instead, which rounds twice and moved the card's scales off the CPU's and
JAX's bits (:func:`_scale`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.common import ceil_div

BLOCK = 128
FP8_MAX = 448.0          # float8_e4m3fn max normal
INT8_MAX = 127.0
_SCALE_EPS = 1e-12       # avoid div-by-zero on all-zero blocks
FP8 = torch.float8_e4m3fn


def _scale(amax: torch.Tensor, q_max: float) -> torch.Tensor:
    """max(amax, eps) / q_max, rounded once on every device: the divisor a
    0-dim tensor on ``amax``'s device (made by a fill, so a captured CUDA
    graph can hold it), never a Python scalar."""
    return torch.clamp(amax, min=_SCALE_EPS) / amax.new_full((), q_max)


def _pad_to(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    size = x.shape[dim]
    pad = ceil_div(size, multiple) * multiple - size
    if pad == 0:
        return x
    dim = dim % x.dim()
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def quantize_fp8_act(
    x: torch.Tensor, block: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, k-block) FP8 quantization of activations.

    x: (..., m, k) float → (x_fp8 (..., m, k) e4m3, scales (..., m, ⌈k/block⌉) f32).
    Scale = amax(block)/448 so the block maps onto the full e4m3 range.
    """
    *lead, m, k = x.shape
    kb = ceil_div(k, block)
    xp = _pad_to(x.to(torch.float32), -1, block)
    g = xp.reshape(*lead, m, kb, block)
    amax = g.abs().amax(dim=-1)
    scales = _scale(amax, FP8_MAX)
    q = (g / scales[..., None]).reshape(*lead, m, kb * block)[..., :k]
    return q.to(FP8), scales


def quantize_fp8_weight(
    w: torch.Tensor, block: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(128×128 block) FP8 quantization of weights.

    w: (..., k, n) float → (w_fp8, scales (..., ⌈k/block⌉, ⌈n/block⌉) f32).
    The blocks are square, so quantizing Wᵀ gives the transposed bytes and
    scales: the port stores weights K-major this way (models/layers.py).
    """
    *lead, k, n = w.shape
    kb, nb = ceil_div(k, block), ceil_div(n, block)
    wp = _pad_to(_pad_to(w.to(torch.float32), -1, block), -2, block)
    g = wp.reshape(*lead, kb, block, nb, block)
    amax = g.abs().amax(dim=(-3, -1))
    scales = _scale(amax, FP8_MAX)
    q = (g / scales[..., :, None, :, None]).reshape(
        *lead, kb * block, nb * block)[..., :k, :n]
    return q.to(FP8), scales


def dequantize_fp8_act(x_q: torch.Tensor, scales: torch.Tensor,
                       block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize_fp8_act` (f32 out) — golden-model helper."""
    *lead, m, k = x_q.shape
    kb = scales.shape[-1]
    xp = _pad_to(x_q.to(torch.float32), -1, block)
    g = xp.reshape(*lead, m, kb, block) * scales[..., None]
    return g.reshape(*lead, m, kb * block)[..., :k]


def dequantize_fp8_weight(w_q: torch.Tensor, scales: torch.Tensor,
                          block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize_fp8_weight` (f32 out) — golden-model helper."""
    *lead, k, n = w_q.shape
    kb, nb = scales.shape[-2], scales.shape[-1]
    wp = _pad_to(_pad_to(w_q.to(torch.float32), -1, block), -2, block)
    g = wp.reshape(*lead, kb, block, nb, block) * scales[..., :, None, :, None]
    return g.reshape(*lead, kb * block, nb * block)[..., :k, :n]


def quantize_int8(
    x: torch.Tensor, axis: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice INT8 quantization along ``axis`` (KV-cache use)."""
    amax = x.to(torch.float32).abs().amax(dim=axis, keepdim=True)
    scales = _scale(amax, INT8_MAX)
    q = torch.clamp(torch.round(x / scales), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scales


def dequantize_int8(x_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return x_q.to(torch.float32) * scales
