"""Faults planted under a run, for showing that ``correct`` catches them,
and the control in the program's place.

Each plant patches the port where the fault would arise and returns a
function that undoes it. They are the same on the CPU and on the card:
``benchmark/tests/test_benchmark_run.py`` runs them under tiny cells, and
``python3 -m benchmark.calibrate --faults ...`` under a cell at its own
size. The benchmark's own runs plant nothing.
"""

from __future__ import annotations

import torch


def _patch(module, name: str, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    return lambda: setattr(module, name, real)


def altered_token():
    """The token sampled for slot 0 replaced by the next one in the vocabulary,
    at every step, prefill and decode alike."""
    from deepgemm_ascend_tpu_torch.serving import engine

    def make(real):
        def altered(logits, *a, **k):
            out = real(logits, *a, **k)
            first = torch.arange(out.shape[0], device=out.device) == 0
            return torch.where(first, (out + 1) % logits.shape[-1], out)
        return altered
    return _patch(engine, "sample_logits", make)


def state_unchanged():
    """The decode step's attention (K2) works on a copy of the KV cache, so
    the step leaves the cache as it was: no decoded token's keys and values
    are kept."""
    from deepgemm_ascend_tpu_torch.ops import flash_decode

    def make(real):
        def unchanged(q, k_q, k_s, v_q, v_s, *rest, **kw):
            out = real(q, k_q.clone(), k_s.clone(), v_q.clone(), v_s.clone(), *rest, **kw)
            return out[0], k_q, v_q, k_s, v_s
        return unchanged
    return _patch(flash_decode, "flash_decode_gqa_inplace", make)


def half_the_batch():
    """The decode step's logits of the second half of the slots replaced by
    those of the first half."""
    from deepgemm_ascend_tpu_torch.serving import engine

    def make(real):
        def half(params, tokens, caches, lens, cfg):
            logits, caches = real(params, tokens, caches, lens, cfg)
            h = logits.shape[0] // 2
            return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), caches
        return half
    return _patch(engine, "decode_step", make)


PLANTS = {"altered_token": altered_token, "state_unchanged": state_unchanged,
          "half_the_batch": half_the_batch}


def control_judge(hf, seed, device, reqs):
    """The check's readings with the control in the program's place: at each
    served position, the token that the configuration's reference puts
    first in its ``CONTROL`` precision (int4 for fp8 and int8)."""
    from benchmark import check
    r = check.judge(hf, seed, device, reqs, control=True)
    return {k[len("control_"):]: v for k, v in r.items() if k.startswith("control_")}
