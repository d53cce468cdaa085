"""Hopper envelope: the card's SM count and the data-sheet rates.

Port of ``deepgemm_ascend_tpu/tiling/platform.py``, re-derived for the
H100. The TPU module holds a table of TPU generations (VMEM, MXU shape,
megacore count) and reads ``DGA_DEVICE``; none of that applies here, and
this module reads neither. What the port's tiling needs is the number of
streaming multiprocessors that output tiles spread over
(``select_kernel_type``) and, for the bounds and rooflines that
``bench/`` and ``chip_smoke.py`` report, the published peak rates of one
H100 SXM (NVIDIA's data sheet, dense, at the 700 W power limit):
:data:`HBM_BYTES_PER_S` and :func:`peak_ops`, the counterparts of JAX's
``hbm_gbps`` and ``peak_flops`` (``platform.py:59-75``).

A CPU tensor counts as one core: the plain PyTorch versions run there, and
the kernel-family choice degenerates to the one-core answer (COMMON).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..utils.common import resolve_device

# Published peaks of one H100 SXM (data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12          # bf16 and fp16 tensor cores
FP8_OPS_PER_S = 1979e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12            # f32 FMA on the CUDA cores (not TF32)


def peak_ops(dtype) -> float:
    """Peak operations per second of a product whose inputs are ``dtype``.

    fp8 (e4m3, e5m2) is priced at its own tensor-core rate, twice bf16's.
    The JAX package prices fp8 at the bf16 rate (``platform.py:62-66``):
    that is a fact of the TPU v5e's MXU, which runs fp8 no faster than
    bf16, and Hopper does not share it. f32 is the CUDA cores' FMA rate
    (the kernels do not use TF32); JAX's f32 is a third of the MXU's bf16
    rate."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return FP8_OPS_PER_S
    if dtype == torch.int8:
        return INT8_OPS_PER_S
    if dtype in (torch.bfloat16, torch.float16):
        return BF16_OPS_PER_S
    if dtype == torch.float32:
        return F32_OPS_PER_S
    raise ValueError(f"no H100 peak rate for products of {dtype}")


@dataclasses.dataclass(frozen=True)
class PlatformInfo:
    """What the tiling reasons over: the device kind and its core count
    (SMs on a GPU, 1 for the CPU)."""

    device_kind: str
    num_cores: int


@functools.lru_cache(maxsize=None)
def _cuda_info(index: int) -> PlatformInfo:
    props = torch.cuda.get_device_properties(index)
    return PlatformInfo(props.name, props.multi_processor_count)


def detect(device="cuda") -> PlatformInfo:
    """The envelope of ``device`` (default: the current CUDA device; asking
    for CUDA where there is none raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return _cuda_info(dev.index if dev.index is not None
                          else torch.cuda.current_device())
    return PlatformInfo(dev.type, 1)
