"""deepgemm_ascend_tpu_torch — the PyTorch/CUDA port of ``deepgemm_ascend_tpu``.

The JAX package beside it is the reference; this package mirrors its module
tree, and each module names its JAX twin. Plain tensor code is PyTorch;
every Pallas kernel on the ported path is a CUDA C++ kernel for Hopper
(``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use). On a CPU
tensor each kernel wrapper runs the kernel's plain PyTorch version instead,
which is what the CPU tests hold against the JAX package.

Ported: MoE serving (``models``, ``serving``) with FP8 or W8A8 int8
experts (``models.params_with_int8_experts``), on one device or sharded
over a dp/ep/tp mesh (``Engine(mesh=...)``, ``parallel/sharded.py``), from
random weights or an HF checkpoint (``models.load_params``); the
reference-compatible API (:mod:`.compat`: ``run_mmad_*`` and the DeepGEMM
aliases); context-parallel prefill (:mod:`.parallel`); the measurement
layer (:mod:`.bench`, ``utils/golden.py``) and the benchmark, quality and
golden scripts (:mod:`.scripts`, run as ``python -m
deepgemm_ascend_tpu_torch.scripts.<name>``); and all fifteen kernels
behind them — the dense GEMM
:func:`gemm` / :func:`bgemm` / :func:`gemm_with_config` (K10, and K11 when
:func:`select_config` or the caller picks split-K), :func:`fp8_gemm` (K1;
K12 with ``scale_mode="folded"``), :func:`m_grouped_gemm_contiguous` (K8),
:func:`m_grouped_gemm_masked` (K3), :func:`flash_decode_gqa_inplace`,
:func:`flash_decode_gqa`, :func:`flash_decode_gqa_state` (K2, K5a, K5b),
:func:`flash_prefill_gqa` (K4, K4-stats), the int8 family
:func:`int8_gemm`, :func:`m_grouped_int8_gemm_contiguous`,
:func:`m_grouped_int8_gemm_masked` (K7, K9, K6; with
:func:`make_contiguous_layout`, which plans the contiguous layouts), and
the dispatch probe P0 (``ops/dispatch_probe.py``).
The package never imports ``jax`` or ``deepgemm_ascend_tpu``.
"""

from . import compat
from .config import GemmConfig, KernelType, SwizzleDir
from .ops.flash_decode import (flash_decode_gqa, flash_decode_gqa_inplace,
                               flash_decode_gqa_state)
from .ops.flash_prefill import flash_prefill_gqa
from .ops.fp8_gemm import (exact_mode, expand_weight_scales, fp8_gemm,
                           fp8_gemm_with_config)
from .ops.gemm import bgemm, gemm, gemm_with_config
from .ops.grouped_gemm import (make_contiguous_layout,
                               m_grouped_gemm_contiguous,
                               m_grouped_gemm_masked)
from .ops.int8_gemm import (int8_gemm, int8_gemm_with_config,
                            m_grouped_int8_gemm_contiguous,
                            m_grouped_int8_gemm_masked)
from .tiling import select_config

__version__ = "0.1.0"

__all__ = [
    "GemmConfig", "KernelType", "SwizzleDir", "bgemm", "compat",
    "exact_mode", "expand_weight_scales", "flash_decode_gqa",
    "flash_decode_gqa_inplace", "flash_decode_gqa_state",
    "flash_prefill_gqa", "fp8_gemm", "fp8_gemm_with_config", "gemm",
    "gemm_with_config", "int8_gemm", "int8_gemm_with_config",
    "make_contiguous_layout", "m_grouped_gemm_contiguous", "m_grouped_gemm_masked",
    "m_grouped_int8_gemm_contiguous", "m_grouped_int8_gemm_masked",
    "select_config", "__version__",
]
