"""Helpers shared by the ``test_torch_*`` parity tests (not a test module).

Data crosses between the JAX package and the PyTorch port as numpy arrays
only, and without rounding: fp8 as ``uint8`` views, bf16 as ``uint16``
views.
"""

import dataclasses

import numpy as np
import torch


def jax_to_numpy(x):
    """A JAX array (or numpy array) → numpy, keeping every bit."""
    a = np.asarray(x)
    name = str(a.dtype)
    if name == "float8_e4m3fn":
        return a.view(np.uint8)
    if name == "bfloat16":
        return a.view(np.uint16)
    return a


def to_torch(x):
    """A JAX array → CPU tensor of the same type and bits."""
    a = np.asarray(x)
    name = str(a.dtype)
    if name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor → numpy f32 (or its integer type) for comparisons."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float16):
        t = t.to(torch.float32)
    return t.numpy()


def fp8_bytes(x) -> np.ndarray:
    """The e4m3 bytes of a JAX array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def tree_of(obj):
    """JAX parameter dataclasses → nested dicts of numpy arrays (the input
    of ``deepgemm_ascend_tpu_torch.models.params_from_numpy``)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: tree_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [tree_of(o) for o in obj]
    if obj is None:
        return None
    return jax_to_numpy(obj)


def f32_close(got, ref, *, ratio=1e-4):
    """The outlier gate with an absolute floor of 1e-5 of the largest |ref|:
    two f32 sums of the same exact products in another order."""
    from deepgemm_ascend_tpu_torch.utils import verify
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    atol = 1e-5 * float(np.abs(ref).max(initial=0.0) + 1e-30)
    return verify.verify(got, ref, rtol=2e-4, atol=atol, max_ratio=ratio)


def bf16_within_one_ulp(got, ref) -> bool:
    """Each element within one bf16 ulp (of the larger magnitude), plus an
    absolute floor of 1e-6 of the largest |ref| for values near zero."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    tiny = 1e-6 * float(np.abs(ref).max(initial=0.0))
    return bool(np.all(np.abs(got - ref) <= ulp + tiny))


# K4's bucket geometries, (kvh, g, s, S, start, lens) per case: serving's
# buckets of 16 and 48 rows (wider than a q block of the kernel at groups 1
# and 2), ragged lengths with a padding row (length 1) and an empty one, a
# start at or past S (a ring hop that sees every key), and an S that is
# not a multiple of 64.
PREFILL_BUCKETS = [
    (4, 1, 16, 128, [0, 0, 0], [11, 1, 16]),
    (2, 2, 48, 128, [0, 0, 0], [48, 29, 1]),
    (1, 16, 16, 128, [128, 140], [128, 128]),
    (1, 8, 48, 96, [96, 0], [96, 40]),
    (2, 4, 16, 80, [0, 0, 64], [0, 16, 80]),
]
PREFILL_BUCKET_IDS = ["s16-g1-padding-row", "s48-g2-ragged",
                      "s16-g16-start-past-S", "s48-g8-S96",
                      "s16-g4-empty-row-S80"]
