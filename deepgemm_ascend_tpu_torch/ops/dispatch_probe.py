"""The dispatch-floor probe (kernel P0): a one-block copy of a small f32
tensor, whose time is the cost of one launch.

Port of the Pallas copy kernel in ``scripts/straggler_probe.py``
(``_copy_kernel``, :75-84), which the JAX probe times as the floor under
every Pallas dispatch. Here :func:`copy_probe` launches
``csrc/dispatch_probe.cu`` on a CUDA tensor, so timing it prices one launch
through the port's wrapper, ``ctypes`` and ``cudaLaunchKernel``;
:func:`raw_launch` hands out the bare C entry and its arguments, so that
the wrapper's share of a launch can be timed apart. On a CPU tensor
:func:`copy_probe` runs :func:`copy_probe_plain`.
"""

from __future__ import annotations

import torch

from . import _kernels

__all__ = ["copy_probe", "copy_probe_plain", "raw_launch", "PROBE_SHAPE",
           "MAX_ELEMENTS"]

COUNTER = _kernels.COUNTERS["copy_probe"]
# The JAX probe's tile, and the most elements the one block takes.
PROBE_SHAPE = (8, 128)
MAX_ELEMENTS = 1024


def copy_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P0: a copy."""
    COUNTER.plain_calls += 1
    return x.clone()


def _check(x: torch.Tensor) -> None:
    if (x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous()
            or x.numel() > MAX_ELEMENTS):
        raise ValueError(f"copy_probe takes a contiguous (r, c) f32 tensor "
                         f"of at most {MAX_ELEMENTS} elements, got "
                         f"{tuple(x.shape)} {x.dtype}")


def copy_probe(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied by one kernel launch (P0)."""
    _check(x)
    if x.device.type == "cpu":
        return copy_probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"copy_probe: unsupported device {x.device}")
    out = torch.empty_like(x)
    rc = _kernels.entry("copy_probe")(x.data_ptr(), out.data_ptr(),
                                      x.numel(), _kernels.stream_ptr(x.device))
    _kernels.check(rc, "copy_probe")
    COUNTER.launches += 1
    return out


def raw_launch(x: torch.Tensor, out: torch.Tensor):
    """(entry, args): P0's C entry point and the arguments that copy ``x``
    into ``out`` on the current stream. ``entry(*args)`` launches with no
    wrapper around it (no checks, no allocation, no count: the caller adds
    its launches to ``COUNTER.bare_launches``) and returns the launch's
    CUDA error code."""
    _check(x)
    if x.device.type != "cuda" or out.shape != x.shape or \
            out.dtype != x.dtype or out.device != x.device or \
            not out.is_contiguous():
        raise ValueError("raw_launch takes a CUDA tensor and an output of "
                         "its shape, type and device")
    return _kernels.entry("copy_probe"), (
        x.data_ptr(), out.data_ptr(), x.numel(), _kernels.stream_ptr(x.device))
