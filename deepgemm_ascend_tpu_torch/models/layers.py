"""Model building blocks: RMSNorm, RoPE, FP8, W8A8 int8 and bf16 linear
layers.

Port of ``deepgemm_ascend_tpu/models/layers.py``. The heavy matmuls go
through the FP8 GEMM kernel (ops/fp8_gemm.py) or the int8 one
(ops/int8_gemm.py); the small elementwise math is plain PyTorch, with the
JAX package's rounding points:

* ``rms_norm`` computes in f32, casts back to the input type, and only then
  multiplies by the weight;
* RoPE splits the head into halves and works in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import fp8_gemm as fp8mod
from ..ops import int8_gemm as i8mod
from ..ops import quant


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)           # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs     # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _normal(generator: torch.Generator, shape, scale: float,
            device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * scale


@dataclasses.dataclass
class Fp8Linear:
    """FP8 blockwise-quantized weight: y = x @ Wᵀ with W (out, in) e4m3.

    Stored K-major with compact (out/128, in/128) block scales — DeepGEMM's
    NT layout, which Hopper's fp8 tensor cores want. The JAX package stores
    (in, out) with a lane-expanded scale panel (a TPU layout device);
    models/convert.py maps one onto the other."""

    w_q: torch.Tensor       # (out, in) e4m3
    scales: torch.Tensor    # (out/128, in/128) f32

    @classmethod
    def create(cls, generator: torch.Generator, in_dim: int, out_dim: int,
               init_scale: Optional[float] = None, *,
               device) -> "Fp8Linear":
        init_scale = init_scale or (1.0 / (in_dim ** 0.5))
        w = _normal(generator, (out_dim, in_dim), init_scale, device)
        w_q, w_s = quant.quantize_fp8_weight(w)
        return cls(w_q=w_q, scales=w_s)

    def __call__(self, x: torch.Tensor, *,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
        """x: (..., in) bf16/f32 — activation-quantized on the fly."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        x_q, x_s = quant.quantize_fp8_act(x2)
        y = fp8mod.fp8_gemm(x_q, x_s, self.w_q, self.scales,
                            out_dtype=out_dtype, b_layout="t")
        return y.reshape(*lead, y.shape[-1])


@dataclasses.dataclass
class Int8Linear:
    """W8A8 linear: y = x @ Wᵀ with W (out, in) int8 and per-output-channel
    scales (1, out), activations quantized per token on the fly.

    Stored K-major, as :class:`Fp8Linear` is (the JAX package stores (in,
    out)); the scales are per channel, so the layout leaves them as they
    are. No model of either package uses it yet: it is the op's layer."""

    w_q: torch.Tensor       # (out, in) int8
    scales: torch.Tensor    # (1, out) f32

    @classmethod
    def create(cls, generator: torch.Generator, in_dim: int, out_dim: int,
               init_scale: Optional[float] = None, *,
               device) -> "Int8Linear":
        init_scale = init_scale or (1.0 / (in_dim ** 0.5))
        w = _normal(generator, (out_dim, in_dim), init_scale, device)
        w_q, w_s = quant.quantize_int8(w, axis=-1)
        return cls(w_q=w_q, scales=w_s.t().contiguous())

    @classmethod
    def from_weights(cls, w: torch.Tensor) -> "Int8Linear":
        """Quantize a dense (in, out) weight matrix (the JAX package's
        layout) per output channel."""
        w_q, w_s = quant.quantize_int8(w.to(torch.float32), axis=0)
        return cls(w_q=w_q.t().contiguous(), scales=w_s)

    def __call__(self, x: torch.Tensor, *,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
        """x: (..., in) bf16/f32 — activation-quantized per token."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        x_q, x_s = quant.quantize_int8(x2, axis=-1)
        y = i8mod.int8_gemm(x_q, x_s, self.w_q, self.scales,
                            out_dtype=out_dtype, b_layout="t")
        return y.reshape(*lead, y.shape[-1])


@dataclasses.dataclass
class BF16Linear:
    """Unquantized linear for small projections (routers): bf16 weights,
    f32 accumulation, bf16 out."""

    w: torch.Tensor         # (in, out) bf16

    @classmethod
    def create(cls, generator: torch.Generator, in_dim: int, out_dim: int,
               init_scale: Optional[float] = None, *,
               device) -> "BF16Linear":
        init_scale = init_scale or (1.0 / (in_dim ** 0.5))
        w = _normal(generator, (in_dim, out_dim), init_scale, device)
        return cls(w=w.to(torch.bfloat16))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                         self.w.to(torch.float32))
        return y.to(torch.bfloat16)
