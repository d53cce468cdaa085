"""The configuration's quantization, worked out in plain PyTorch.

Each function returns the dequantized float32 values, which is all the
reference needs: weights in square blocks, activations in 1 x block
groups along the last dim, the KV cache per token and head (the last dim).
``fp8`` is e4m3 with scale amax / 448, ``int8`` and ``int4`` are symmetric
integers with scale amax / 127 and amax / 7, rounded to nearest.
"""

from __future__ import annotations

import torch

BLOCK = 128
EPS = 1e-12
FP8_MAX = 448.0
INT_MAX = {"int8": 127.0, "int4": 7.0}


def _round_to(g: torch.Tensor, amax: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "fp8":
        s = amax.clamp(min=EPS) / FP8_MAX
        return (g / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    q = INT_MAX[kind]
    s = amax.clamp(min=EPS) / q
    return torch.clamp(torch.round(g / s), -q, q) * s


def _pad(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    extra = -n % BLOCK
    if not extra:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, extra]
    return torch.nn.functional.pad(x, widths)


def weight(w: torch.Tensor, kind: str) -> torch.Tensor:
    """(..., out, in) → the same shape, quantized in BLOCK x BLOCK blocks."""
    *lead, n, k = w.shape
    wp = _pad(_pad(w.to(torch.float32), -1), -2)
    nb, kb = wp.shape[-2] // BLOCK, wp.shape[-1] // BLOCK
    g = wp.reshape(*lead, nb, BLOCK, kb, BLOCK)
    amax = g.abs().amax(dim=(-3, -1), keepdim=True)
    return _round_to(g, amax, kind).reshape(*lead, nb * BLOCK, kb * BLOCK)[..., :n, :k]


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(..., k) → the same shape, quantized in groups of BLOCK along k."""
    *lead, k = x.shape
    xp = _pad(x.to(torch.float32), -1)
    g = xp.reshape(*lead, xp.shape[-1] // BLOCK, BLOCK)
    amax = g.abs().amax(dim=-1, keepdim=True)
    return _round_to(g, amax, kind).reshape(*lead, -1)[..., :k]


def per_row(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(..., d) → the same shape, one scale per row of d (a token's head)."""
    x = x.to(torch.float32)
    return _round_to(x, x.abs().amax(dim=-1, keepdim=True), kind)
