"""The port stands alone: it never imports JAX or the JAX package, and its
entry points run on the card unless told otherwise."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "deepgemm_ascend_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deepgemm_ascend_tpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")
    if "_build" not in p.relative_to(PKG).parts) + ["chip_smoke.py"])
def test_no_jax_import_in_source(path):
    for mod in _imported_modules(ROOT / path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import deepgemm_ascend_tpu_torch\n"
        "import deepgemm_ascend_tpu_torch.models\n"
        "import deepgemm_ascend_tpu_torch.serving\n"
        "import deepgemm_ascend_tpu_torch.ops.reference\n"
        "import deepgemm_ascend_tpu_torch.utils.verify\n"
        "import deepgemm_ascend_tpu_torch.compat\n"
        "import deepgemm_ascend_tpu_torch.compat.deep_gemm\n"
        "import deepgemm_ascend_tpu_torch.tiling\n"
        "import deepgemm_ascend_tpu_torch.parallel\n"
        "import deepgemm_ascend_tpu_torch.bench\n"
        "import deepgemm_ascend_tpu_torch.bench.records\n"
        "import deepgemm_ascend_tpu_torch.utils.golden\n"
        "import deepgemm_ascend_tpu_torch.ops.dispatch_probe\n"
        "import deepgemm_ascend_tpu_torch.scripts.straggler_probe\n"
        "import deepgemm_ascend_tpu_torch.scripts.profile_kernel\n"
        "import deepgemm_ascend_tpu_torch.scripts.headline\n"
        "import deepgemm_ascend_tpu_torch.scripts.serve_bench\n"
        "import deepgemm_ascend_tpu_torch.scripts.layer_bench\n"
        "import deepgemm_ascend_tpu_torch.scripts.k12_fold_ablation\n"
        "import deepgemm_ascend_tpu_torch.scripts.k8_ablation\n"
        "import deepgemm_ascend_tpu_torch.scripts.ksplit_sweep\n"
        "import deepgemm_ascend_tpu_torch.scripts.ring_sweep\n"
        "import deepgemm_ascend_tpu_torch.scripts.decode_sweep\n"
        "import deepgemm_ascend_tpu_torch.scripts.phase2_ab\n"
        "import deepgemm_ascend_tpu_torch.tiling.autotune\n"
        "import deepgemm_ascend_tpu_torch.tiling.predictor\n"
        "import deepgemm_ascend_tpu_torch.native\n"
        "import deepgemm_ascend_tpu_torch.jit\n"
        "import deepgemm_ascend_tpu_torch.scripts.autotune_sweep\n"
        "import deepgemm_ascend_tpu_torch.scripts.calibrate_cost_model\n"
        "import deepgemm_ascend_tpu_torch.scripts.train_predictor\n"
        "import deepgemm_ascend_tpu_torch.scripts.publish_tilings\n"
        "import deepgemm_ascend_tpu_torch.scripts.report_benchmarks\n"
        "import deepgemm_ascend_tpu_torch.models.loader\n"
        "import deepgemm_ascend_tpu_torch.parallel.sharded\n"
        "import deepgemm_ascend_tpu_torch.scripts.gen_golden\n"
        "import deepgemm_ascend_tpu_torch.scripts.verify_output\n"
        "import deepgemm_ascend_tpu_torch.scripts.torch_matmul\n"
        "import deepgemm_ascend_tpu_torch.scripts.eval_quality\n"
        "import deepgemm_ascend_tpu_torch.scripts.prefix_spread\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deepgemm_ascend_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _jax_tree(cfg):
    """The JAX package's parameters as params_from_numpy takes them."""
    import jax
    from deepgemm_ascend_tpu import models as jmodels
    from torch_bridge import tree_of
    return tree_of(jmodels.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "engine",
                                   "params_from_numpy",
                                   "int8_experts_create", "run_mmad_numpy",
                                   "deep_gemm_numpy", "select_config",
                                   "load_params"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only host: the default device is CUDA")
    from deepgemm_ascend_tpu_torch.models import (TINY_DENSE, TINY,
                                                  Int8ExpertWeights,
                                                  init_cache, init_params,
                                                  params_from_numpy)
    from deepgemm_ascend_tpu_torch import compat, select_config
    from deepgemm_ascend_tpu_torch.compat import deep_gemm
    from deepgemm_ascend_tpu_torch.serving import Engine
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "init_params":
            init_params(0, TINY)
        elif entry == "init_cache":
            init_cache(TINY, 1, 16)
        elif entry == "params_from_numpy":
            params_from_numpy(_jax_tree(TINY_DENSE), TINY_DENSE)
        elif entry == "int8_experts_create":
            Int8ExpertWeights.create(torch.Generator(), 2, 128, 128)
        elif entry == "run_mmad_numpy":          # numpy operands, no z
            compat.run_mmad_rtc(np.ones((16, 32), np.float32),
                                np.ones((32, 8), np.float32))
        elif entry == "deep_gemm_numpy":
            deep_gemm.gemm_fp8_fp8_bf16_nt(
                (np.zeros((16, 128), np.uint8), np.ones((16, 1), np.float32)),
                (np.zeros((128, 128), np.uint8), np.ones((1, 1), np.float32)))
        elif entry == "select_config":           # the default device
            select_config(16, 2048, 11008)
        elif entry == "load_params":
            from deepgemm_ascend_tpu_torch.models import load_params
            load_params({}, TINY)
        else:
            Engine(init_params(0, TINY, device="cpu"), TINY, max_slots=1,
                   max_seq_len=32)


def test_kernel_wrappers_refuse_non_cpu_non_cuda_tensors():
    from deepgemm_ascend_tpu_torch.ops import fp8_gemm as fp8mod
    a = torch.zeros(16, 128, device="meta").to(torch.float8_e4m3fn)
    s = torch.zeros(16, 1, device="meta")
    b = torch.zeros(128, 128, device="meta").to(torch.float8_e4m3fn)
    bs = torch.zeros(1, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fp8mod.fp8_gemm(a, s, b, bs, b_layout="t")


@pytest.mark.parametrize("op", ["dense", "contiguous", "masked"])
def test_int8_wrappers_refuse_non_cpu_non_cuda_tensors(op):
    from deepgemm_ascend_tpu_torch.ops import int8_gemm as i8mod

    def meta(*shape, dtype=torch.int8):
        return torch.zeros(*shape, device="meta", dtype=dtype)
    f32 = torch.float32
    with pytest.raises(ValueError, match="unsupported device"):
        if op == "dense":
            i8mod.int8_gemm(meta(16, 128), meta(16, 1, dtype=f32),
                            meta(64, 128), meta(1, 64, dtype=f32),
                            b_layout="t")
        elif op == "contiguous":
            i8mod.m_grouped_int8_gemm_contiguous(
                meta(64, 128), meta(64, 1, dtype=f32), meta(2, 64, 128),
                meta(2, 1, 64, dtype=f32), torch.tensor([0, 1]),
                b_layout="t")
        else:
            i8mod.m_grouped_int8_gemm_masked(
                meta(2, 16, 128), meta(2, 16, 1, dtype=f32),
                meta(2, 64, 128), meta(2, 1, 64, dtype=f32),
                torch.tensor([3, 0]), b_layout="t")


@pytest.mark.parametrize("op", ["gemm", "ksplit", "contiguous"])
def test_gemm_wrappers_refuse_non_cpu_non_cuda_tensors(op):
    from deepgemm_ascend_tpu_torch import (GemmConfig, KernelType, gemm,
                                           gemm_with_config,
                                           m_grouped_gemm_contiguous)

    def meta(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device="meta", dtype=dtype)
    with pytest.raises(ValueError, match="unsupported device"):
        if op == "gemm":
            gemm(meta(16, 256), meta(256, 64))
        elif op == "ksplit":
            gemm_with_config(meta(16, 256), meta(256, 64), config=GemmConfig(
                kernel_type=KernelType.KSPLIT, k_split=2))
        else:
            fp8 = torch.float8_e4m3fn
            m_grouped_gemm_contiguous(
                meta(128, 128, dtype=fp8), meta(128, 1, dtype=torch.float32),
                meta(2, 128, 128, dtype=fp8),
                meta(2, 1, 1, dtype=torch.float32), torch.tensor([1]),
                b_layout="t")
