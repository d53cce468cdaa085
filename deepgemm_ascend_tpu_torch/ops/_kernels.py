"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

No JAX twin: on the TPU, Pallas compiled each kernel inside ``jit``. Here
each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, all sources at once (one ``nvcc`` process each,
started together), into ``deepgemm_ascend_tpu_torch/_build/<hash>/`` where
the hash covers every source and the flags, so an edited source rebuilds
and an unchanged one is reused within a checkout (``jit/compile_cache``
counts each load as a hit or a compile, and can move the build root).

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0. Kernels launch on PyTorch's current
stream, never synchronise and allocate nothing: the Python wrappers own
every buffer.

A source may export several kernels, each a C entry point with its own
signature (``csrc/int8_gemm.cu`` and ``csrc/flash_decode.cu`` hold three,
``csrc/gemm.cu``, ``csrc/grouped_gemm.cu``, ``csrc/fp8_gemm.cu`` and
``csrc/flash_prefill.cu`` two each, ``csrc/dispatch_probe.cu`` one). Each
kernel has a
:class:`Counter`, keyed by the kernel's name: ``launches`` is bumped by its
wrapper right where the kernel is launched, ``plain_calls`` by its plain
PyTorch version, ``bare_launches`` by a caller that launches the C entry
with no wrapper (P0's dispatch floor, ``scripts/straggler_probe.py``).
A CUDA graph's capture goes through the wrappers but runs nothing, and its
replays launch every captured kernel again without them: the engine that
captures counts the capture's launches under ``captured`` and each replay's
under ``replayed``, so :meth:`Counter.on_card` is what the card ran.
``chip_smoke.py`` zeroes them around each serving run to show which
kernels the run really went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# The two grouped int8 entries take the same arguments (the int8 epilogue
# needs no scale strides): a, a_s, b, b_s, the expert map, c, four sizes,
# three B strides, out_f32 and the stream.
_INT8_GROUPED = [_P] * 6 + [_I] * 4 + [_L] * 3 + [_I, _P]
# K1 and K12: a, a_s, b, b_s, c, m, n, k, four strides, the scale shift,
# out_f32 and the stream (K1: its route, ring tile and splits before it;
# K12 its tile).
_FP8 = [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I, _I, _P]
# Every kernel: its name (the key of its counter), the source that holds it
# (csrc/<source>.cu), its C entry point and that entry's signature. Every
# entry returns an int: the cudaError_t of the launch.
KERNELS = {
    # K1 also takes its route, ring tile and splits.
    "fp8_gemm": ("fp8_gemm", "dga_fp8_gemm", _FP8[:-1] + [_I, _I, _I, _P]),
    "fp8_gemm_folded": ("fp8_gemm", "dga_fp8_gemm_folded",
                        _FP8[:-1] + [_I, _P]),
    "grouped_gemm": ("grouped_gemm", "dga_grouped_gemm_masked",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                      _L, _L, _I, _I, _I, _I, _P]),
    # K8 also takes the experts, its route and tile.
    "grouped_gemm_contiguous": ("grouped_gemm", "dga_grouped_gemm_contiguous",
                                [_P] * 6 + [_I] * 4 + [_L] * 6
                                + [_I] * 5 + [_P]),
    # K10 and K11 end with their route and tile codes.
    "gemm": ("gemm", "dga_gemm", [_P, _P, _P] + [_I] * 11 + [_P]),
    "gemm_ksplit": ("gemm", "dga_gemm_ksplit", [_P, _P, _P] + [_I] * 9 + [_P]),
    # K2 also takes its arrival counts and its route.
    "flash_decode": ("flash_decode", "dga_flash_decode_inplace",
                     [_P] * 13 + [_I] * 7 + [_F, _P]),
    "flash_prefill": ("flash_prefill", "dga_flash_prefill",
                      [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _F, _P]),
    "flash_prefill_stats": ("flash_prefill", "dga_flash_prefill_stats",
                            [_P] * 10 + [_I] * 6 + [_F, _P]),
    # K5a and K5b also take K2's arrival counts and route.
    "flash_decode_read": ("flash_decode", "dga_flash_decode_read",
                          [_P] * 9 + [_I] * 7 + [_F, _P]),
    "flash_decode_state": ("flash_decode", "dga_flash_decode_state",
                           [_P] * 11 + [_I] * 7 + [_F, _P]),
    # K7 ends with its route and tile codes.
    "int8_gemm": ("int8_gemm", "dga_int8_gemm",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I, _P]),
    # K9 also takes the experts, its route and tile.
    "int8_grouped_contiguous": ("int8_gemm", "dga_int8_grouped_contiguous",
                                _INT8_GROUPED[:-1] + [_I, _I, _I, _P]),
    # K6 also takes its route and tile.
    "int8_grouped_masked": ("int8_gemm", "dga_int8_grouped_masked",
                            _INT8_GROUPED[:-1] + [_I, _I, _P]),
    "copy_probe": ("dispatch_probe", "dga_copy_probe", [_P, _P, _I, _P]),
}
# Test kernels built with the sources above, with no wrapper and no
# counter: K8's probe of whether an f16 wgmma sums a scale group as
# mma.sync does (csrc/grouped_gemm.cu, tests/test_torch_gpu.py).
PROBES = {
    "wgmma16_probe": ("grouped_gemm", "dga_wgmma16_probe", [_P, _P, _P, _P]),
}
SOURCES = tuple(dict.fromkeys(src for src, _, _ in KERNELS.values()))


@dataclasses.dataclass
class Counter:
    """Launch count of one kernel (through its wrapper, and bare), and call
    count of its plain version. ``plans``: a wrapper that picks among
    routes or tiles counts each launch under its plan's label too."""

    name: str
    launches: int = 0
    plain_calls: int = 0
    bare_launches: int = 0
    captured: int = 0
    replayed: int = 0
    plans: Dict[str, int] = dataclasses.field(default_factory=dict)

    def count_plan(self, label: str) -> None:
        self.plans[label] = self.plans.get(label, 0) + 1

    def on_card(self) -> int:
        """The launches through the wrapper that ran on the card: those a
        graph capture recorded left out, its replays' put in."""
        return self.launches - self.captured + self.replayed

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.bare_launches = 0
        self.captured = 0
        self.replayed = 0
        self.plans.clear()


COUNTERS: Dict[str, Counter] = {n: Counter(n) for n in KERNELS}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


class _Libraries:
    """The kernel entry points, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fns: Dict[str, Callable[..., int]] = {}
        self.build_dir: Path = BUILD_ROOT
        self.build_log: Dict[str, str] = {}

    def get(self) -> Dict[str, Callable[..., int]]:
        with self._lock:
            if not self._fns:
                from ..utils.logging import metrics
                with metrics.timer("setup.kernel_libraries_s"):
                    self.build_dir = BUILD_ROOT / _source_hash()
                    self._fns = self._build_all(self.build_dir)
            return self._fns

    def _build_all(self, out: Path) -> Dict[str, Callable[..., int]]:
        from ..jit.compile_cache import stats
        out.mkdir(parents=True, exist_ok=True)
        procs: List[tuple] = []
        for name in SOURCES:
            so = out / f"lib{name}.so"
            stats.record(f"{name}@{out.name}", so.exists())
            if so.exists():
                continue
            tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, so, tmp, proc in procs:
            log, _ = proc.communicate()
            self.build_log[name] = log
            (out / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        fns = {}
        for name, (source, symbol, argtypes) in {**KERNELS,
                                                 **PROBES}.items():
            fn = getattr(ctypes.CDLL(str(out / f"lib{source}.so")), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        return fns


_LIBS = _Libraries()


def loaded() -> bool:
    """Whether this process has loaded the kernel libraries."""
    return bool(_LIBS._fns)


def build() -> Path:
    """Build (or reuse) and load every kernel library; returns the build dir."""
    _LIBS.get()
    return _LIBS.build_dir


def build_log() -> Dict[str, str]:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the sources built by this process."""
    return dict(_LIBS.build_log)


def entry(kernel: str):
    """The C entry point of the kernel (or probe) named ``kernel`` (built
    at first use)."""
    return _LIBS.get()[kernel]


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        symbol = (KERNELS.get(kernel) or PROBES[kernel])[1]
        raise RuntimeError(f"{symbol}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

