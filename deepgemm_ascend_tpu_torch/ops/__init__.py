"""The port's ops: quantizers, goldens and the kernel wrappers.

Import the modules themselves (``from deepgemm_ascend_tpu_torch.ops import
fp8_gemm as fp8mod``); the functions are re-exported at the package top.
"""
