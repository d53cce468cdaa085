"""Model-scale numerics evaluation: perplexity and kernel fidelity.

Port of ``scripts/eval_quality.py``. With random weights (no checkpoint is
shipped) absolute perplexity means nothing; what is measured is:

1. **Kernel fidelity**: the same model run twice on the same tokens —
   once through the kernels, once through the exact emulated-dequant f32
   path (``ops.fp8_gemm.exact_mode``) — with the perplexity delta, mean
   KL(exact ‖ kernel) and next-token top-1 agreement. This isolates the
   kernels' approximation at full model depth.
2. **Teacher-forced perplexity** of both paths on the kernel path's greedy
   text.

With ``--expert-quant int8`` the exact path runs on the same int8
parameters (``ok`` gates kernel arithmetic for both recipes); an exact run
on the original fp8 parameters measures the re-quantization cost apart
(``quant_*``), and a kernel-vs-exact run on the fp8 parameters is the
in-run control the ppl gate may lean on. Prints ONE JSON line with the JAX
script's keys; exit code 0 when ``ok``.

    python -m deepgemm_ascend_tpu_torch.scripts.eval_quality \\
        --model v2_lite --expert-quant int8 --batch 4 --steps 24
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..models import (TINY, V2_LITE, decode_step, init_cache, init_params,
                      params_with_int8_experts)
from ..ops import fp8_gemm as fp8mod
from ..utils.common import resolve_device

MODELS = {"tiny": TINY, "v2_lite": V2_LITE}


def _softmax(x):
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tiny", choices=list(MODELS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=24,
                    help="decode steps to evaluate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-flash", action="store_true",
                    help="route attention through the plain path "
                         "(diagnostic: isolates the flash kernels' share "
                         "of the fidelity numbers)")
    ap.add_argument("--expert-quant", choices=["fp8", "int8"], default="fp8",
                    help="int8: re-quantize the MoE experts to W8A8 "
                         "(models.params_with_int8_experts) and measure the "
                         "int8-vs-exact fidelity")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = MODELS[args.model]
    if args.no_flash:
        cfg = dataclasses.replace(cfg, use_flash_decode=False)
    params = init_params(args.seed, cfg, device=dev)
    params_kernel = params
    if args.expert_quant == "int8":
        params_kernel = params_with_int8_experts(params)
    # The cache extent rounded to a multiple of 128, as serving's caches
    # are.
    max_seq = max(128, ((args.steps + 8 + 127) // 128) * 128)

    def run(p, exact: bool, token_stream=None):
        """Decode ``steps`` steps on params ``p`` (through the exact path
        if ``exact``): (tokens (b, steps), logits (steps, b, V)). With
        ``token_stream`` the path is teacher-forced on those tokens;
        otherwise it runs greedily on its own."""
        caches = init_cache(cfg, args.batch, max_seq=max_seq, device=dev)
        toks = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
        lens = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
        all_logits, all_toks = [], []
        for t in range(args.steps):
            if exact:
                with fp8mod.exact_mode():
                    logits, caches = decode_step(p, toks, caches, lens, cfg)
            else:
                logits, caches = decode_step(p, toks, caches, lens, cfg)
            all_logits.append(logits.to(torch.float32).cpu().numpy())
            if token_stream is None:
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                toks = torch.from_numpy(token_stream[:, t]).to(dev)
            all_toks.append(toks.cpu().numpy())
            lens = lens + 1
        return np.stack(all_toks, 1), np.stack(all_logits, 0)

    # The exact path runs on the SAME params as the kernel path (int8
    # included), so `ok` gates kernel arithmetic for both recipes.
    toks_k, logit_k = run(params_kernel, exact=False)
    _, logit_e = run(params_kernel, exact=True, token_stream=toks_k)
    logit_q = None
    control_ppl_delta = None
    if args.expert_quant != "fp8":
        # The re-quantization cost: the exact path on the original fp8
        # params, teacher-forced on the same text.
        _, logit_q = run(params, exact=True, token_stream=toks_k)
        # The in-run fp8 control: kernel vs exact on the fp8 params, same
        # tokens; the int8 run's ppl gate is relative to it.
        _, logit_c = run(params, exact=False, token_stream=toks_k)

    p_k = _softmax(logit_k)
    p_e = _softmax(logit_e)
    agree = logit_k.argmax(-1) == logit_e.argmax(-1)
    # A flip is a fidelity problem only where the exact path was confident:
    # top-1 probability above top-2 by more than 0.05.
    part = np.partition(p_e, -2, axis=-1)
    margin = part[..., -1] - part[..., -2]
    confident_flip = (~agree) & (margin > 0.05)
    kl = np.sum(p_e * (np.log(p_e + 1e-12) - np.log(p_k + 1e-12)), axis=-1)

    b_idx = np.arange(args.batch)

    def ppl(probs):
        """Teacher-forced perplexity of the kernel path's text (step t
        predicts the token at t)."""
        nll = np.stack([-np.log(probs[t, b_idx, toks_k[:, t]] + 1e-12)
                        for t in range(args.steps)])
        return float(np.exp(nll.mean()))

    ppl_k, ppl_e = ppl(p_k), ppl(p_e)
    if logit_q is not None:
        p_qx = _softmax(logit_q)
        ppl_c, ppl_qx = ppl(_softmax(logit_c)), ppl(p_qx)
        control_ppl_delta = (abs(ppl_c - ppl_qx) / ppl_qx
                             if ppl_qx > 0 else 0.0)
    rel = abs(ppl_k - ppl_e) / ppl_e if ppl_e > 0 else 0.0

    out = {
        "metric": "fp8_kernel_fidelity",
        "expert_quant": args.expert_quant,
        "model": args.model,
        "steps": args.steps,
        "batch": args.batch,
        "top1_agreement": float(agree.mean()),
        "confident_disagreements": int(confident_flip.sum()),
        "mean_kl_exact_vs_kernel": float(kl.mean()),
        "max_kl": float(kl.max()),
        "ppl_kernel": round(ppl_k, 4),
        "ppl_exact": round(ppl_e, 4),
        "ppl_rel_delta": rel,
        # The JAX script's gate: no confident top-1 flip, mean KL < 2e-2,
        # and ppl within 2 % — or, with an in-run fp8 control, within 2×
        # the control's own drift.
        "ok": bool(confident_flip.sum() == 0 and kl.mean() < 2e-2
                   and (ppl_e <= 0 or rel < 0.02
                        or (control_ppl_delta is not None
                            and rel <= 2.0 * control_ppl_delta))),
    }
    if control_ppl_delta is not None:
        out["control_fp8_ppl_rel_delta"] = control_ppl_delta
    if logit_q is not None:
        # Exact on the re-quantized params vs exact on fp8: the pure
        # re-quantization cost, reported (its confident flips gated in
        # quant_ok).
        agree_q = logit_e.argmax(-1) == logit_q.argmax(-1)
        part_q = np.partition(p_qx, -2, axis=-1)
        margin_q = part_q[..., -1] - part_q[..., -2]
        kl_q = np.sum(p_qx * (np.log(p_qx + 1e-12) - np.log(p_e + 1e-12)),
                      axis=-1)
        flips_q = int(((~agree_q) & (margin_q > 0.05)).sum())
        out.update({
            "quant_top1_agreement": float(agree_q.mean()),
            "quant_confident_disagreements": flips_q,
            "quant_mean_kl": float(kl_q.mean()),
            "quant_ppl_rel_delta": (abs(ppl_e - ppl_qx) / ppl_qx
                                    if ppl_qx > 0 else 0.0),
            "quant_ok": flips_q == 0,
        })
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
