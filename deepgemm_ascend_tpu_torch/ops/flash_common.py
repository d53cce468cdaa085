"""Shared numerics of the flash attention kernels (decode + prefill).

Port of ``deepgemm_ascend_tpu/ops/flash_common.py``. The TPU helpers for
block selection and one-hot scale rows are VMEM/Mosaic devices with no
counterpart here; what carries over is the arithmetic, which the CUDA
kernels share through ``csrc/flash_common.cuh`` and the plain versions
through :func:`softmax_pv`:

* scores ``s = (q_bf16 · k_int8) · (k_scale / √hd)`` in f32, masked to
  ``NEG_INF``;
* softmax with the empty-row guard (a row with no unmasked score yields 0,
  not a row of garbage);
* ``p · v_scale`` rounded to bf16 before the PV product;
* ``acc / l`` with ``l == 0`` giving 0.

The stats variants (K4-stats, K5b) return the raw state ``(acc, m, l)``
instead of ``acc / l``: an empty row keeps ``(0, NEG_INF, 0)``.

The CUDA kernels take two head sizes and five GQA group sizes
(:func:`cuda_geometry_ok`): head size 128 on the tensor cores (K2's route
"live", K4's wgmma kernel), 64 on the CUDA cores (K2, K5a and K5b's route
"span", K4's kernel of ``namespace cores``). A wrapper given any other on
the card raises (:func:`check_cuda_geometry`).

A kernel differs from its plain version in one place: it rounds each
``p · v_scale`` to bf16 against its running row max, the plain version
against the final one (K4's kernel on the CUDA cores takes the final max
in a first pass and rounds where the plain version does). Each rounding is within 2^-8 (bf16's unit
roundoff), so per element acc may differ by 2^-7 · Σ_j w_j·|v_j| (w_j the
plain version's bf16 ``p_j · v_scale_j``) plus the f32 sum order:
:func:`state_close` and :func:`output_close` hold a kernel to that, with
``Σ_j w_j·|v_j|`` taken from the plain version itself run on ``|v|``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8, 16)
# Per element, |acc_kernel - acc_plain| / Σ_j w_j·|v_j|: two bf16 roundings
# of 2^-8 each, and 2^-12 for the f32 sum order and the exp of another max.
PV_ROUNDING = 2.0 ** -7 + 2.0 ** -12


def cuda_geometry_ok(hd: int, g: int) -> bool:
    """Whether the CUDA kernels are built for head size ``hd`` and GQA
    group ``g`` (the plain versions take any)."""
    return hd in KERNEL_HEAD_DIMS and g in KERNEL_GROUPS


def check_cuda_geometry(name: str, hd: int, g: int) -> None:
    """Raise for a head size or GQA group the CUDA kernels are not built
    for (a CPU tensor takes the plain version, which has no such limit)."""
    if not cuda_geometry_ok(hd, g):
        raise ValueError(f"{name}: the CUDA kernel takes a head_dim in "
                         f"{KERNEL_HEAD_DIMS} and a GQA group in "
                         f"{KERNEL_GROUPS}, got head_dim={hd}, group={g}")


def softmax_state(s: torch.Tensor, v_s: torch.Tensor, v: torch.Tensor):
    """One-block softmax over the last dim of the masked scores ``s`` (…, T)
    and the PV product with the int8 values ``v`` (…, T, hd) as f32 and
    their per-token scales ``v_s`` (…, T), with the kernels' bf16 rounding
    point. Returns the unnormalized state: acc (…, hd), m (…), l (…), f32;
    a row with no unmasked score gives (0, NEG_INF, 0)."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > NEG_INF * 0.5, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = (p * v_s).to(torch.bfloat16).to(torch.float32) @ v
    return acc, m[..., 0], l


def softmax_pv(s: torch.Tensor, v_s: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """:func:`softmax_state` normalized: acc / l, with l == 0 giving 0.
    Returns (…, hd) f32."""
    acc, _, l = softmax_state(s, v_s, v)
    l = l[..., None]
    return acc / torch.where(l > 0, l, torch.ones_like(l))


def state_close(got, ref, pv_abs) -> bool:
    """Whether a kernel's state ``got`` = (acc, m, l) is the plain one-block
    state ``ref`` over the same keys: m to the f32 sum order of the scores
    (1e-5 relative), l within 1e-4, acc per element within
    ``PV_ROUNDING · pv_abs`` (``pv_abs``: the plain version's acc over |v|),
    and empty rows exactly (0, NEG_INF, 0)."""
    acc, m, l = (x.float() for x in got)
    acc_r, m_r, l_r = (x.float() for x in ref)
    empty = l_r == 0
    return (bool((m - m_r).abs().le(1e-5 * (1 + m_r.abs())).all())
            and bool((l - l_r).abs().le(1e-4 * l_r).all())
            and bool((acc - acc_r).abs().le(PV_ROUNDING * pv_abs).all())
            and bool((m[empty] == NEG_INF).all())
            and bool((l[empty] == 0).all())
            and bool((acc[empty] == 0).all()))


def output_close(got, ref, pv_abs) -> bool:
    """Whether a kernel's normalized output ``got`` = acc / l is the plain
    one ``ref``: per element within ``PV_ROUNDING · pv_abs + 1e-4·|ref|``
    (``pv_abs``: the plain version's normalized output over |v|; 1e-4 for
    l's f32 sum order); a row with no key gives 0 on both sides."""
    got, ref = got.float(), ref.float()
    tol = PV_ROUNDING * pv_abs.float() + 1e-4 * ref.abs()
    return bool(torch.isfinite(got).all()) and bool(
        (got - ref).abs().le(tol).all())
