"""The spread of the prefix cache's warm vs cold first-token logits.

No JAX twin. ``chip_smoke.py`` phase 4 (c) admits 16 requests that share a
512-token system prompt on a cold engine and on one whose prefix store
holds the prompt, and bounds the rel-L2 of each request's first-token
logits between the two: the same rows, computed in forwards of 16384 and
256 rows, which K1 sums in other f32 orders. This script measures that
distance over system prompts drawn from ``--seeds`` seeds (V2_LITE, fp8
experts, on the card), one JSON line a seed: the largest rel-L2, the
requests whose logits differ at all, and the first tokens that differ.

    python -m deepgemm_ascend_tpu_torch.scripts.prefix_spread --seeds 24
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..models import TINY, V2_LITE, init_params
from ..serving import Engine
from ..serving import engine as engine_mod
from ..utils.common import resolve_device

MODELS = {"tiny": TINY, "v2_lite": V2_LITE}
SYSTEM, REQUESTS = 512, 16


def spread(params, cfg, seed: int, dev, system: int = SYSTEM) -> dict:
    """Phase 4 (c)'s two admissions over the system prompt of ``seed``."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab_size, size=system).tolist()
    prompts = [head + rng.integers(1, cfg.vocab_size, size=4).tolist()
               for _ in range(REQUESTS)]

    def wave(prefix_slots):
        eng = Engine(params, cfg, max_slots=REQUESTS, max_seq_len=4096,
                     prefix_cache_slots=prefix_slots, device=dev)
        eng.generate([prompts[0]], max_new_tokens=1)     # seed the store
        ids = [eng.scheduler.submit(p, 1) for p in prompts]
        kept = []
        real = engine_mod._prefill

        def recording(*args):
            kept.append(real(*args))
            return kept[-1]
        engine_mod._prefill = recording
        try:
            eng.step()                   # one batched admission
        finally:
            engine_mod._prefill = real
        firsts = [eng.scheduler.pop_result(i).output[0] for i in ids]
        return kept[0][:REQUESTS].float(), firsts

    cold, cold_first = wave(0)
    warm, warm_first = wave(4)
    rel = ((warm - cold).norm(dim=-1) / cold.norm(dim=-1)).tolist()
    return {"seed": seed, "max_rel_l2": max(rel),
            "requests_differing": sum(r > 0 for r in rel),
            "first_tokens_differing": sum(
                a != b for a, b in zip(cold_first, warm_first)),
            "rel_l2": rel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="v2_lite", choices=list(MODELS))
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--system", type=int, default=SYSTEM,
                    help="system prompt tokens (a multiple of 16)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = MODELS[args.model]
    params = init_params(0, cfg, device=dev)
    for seed in range(args.seeds):
        line = spread(params, cfg, seed, dev, args.system)
        print(json.dumps({"metric": "prefix_warm_vs_cold_rel_l2",
                          "model": args.model, **line}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
