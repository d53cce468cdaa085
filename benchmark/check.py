"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed with the longest among them, is
run through the configuration's plain reference (:func:`reference`:
:mod:`benchmark.reference.model` unless the configuration names another)
as prompt + served tokens. At every served position the reference's logits
say how far the served token's logit lies below its best. Each request's
mean gap is read, and the worst request's mean is the number compared: a
fault confined to one slot or one request is not diluted by the others.
Greedy decoding serves the top token, so a sound run reads no more than
the two computations' rounding differences; a token altered where it is
produced, a cache row lost or a layer computed wrong reads far more.

The longest request is compared whole, so the deepest positions of the
window are covered; every other request of the sample over its first
``PER_REQUEST`` served tokens, so that the sample reaches many requests
(and slots) for the reference's time.

The control is the reference in the next precision below the
configuration's (the reference module's ``CONTROL``: int4 for fp8 and
int8), in the program's place: at each of the same positions, the gap of
the token that it puts first.
"""

from __future__ import annotations

import importlib
import random
import re
import types
from typing import Dict, List, Sequence

import torch

from benchmark.weights import derive_seed

MIN_SERVED = 16          # a request with fewer served tokens is not sampled
PER_REQUEST = 64         # served tokens compared of each request but the longest
MAX_REQUESTS = 96
MAX_SEQ_TOKENS = 32768   # prompt + compared tokens of a sample, at most


def reference(hf: dict):
    """The configuration's reference: the module
    ``benchmark/reference/<name>.py`` that its ``reference`` key names
    (``model`` where it names none), which exposes ``Reference``,
    ``STATED`` and ``CONTROL``. Raises for a name that is no such module."""
    name = hf.get("reference", "model")
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"reference {name!r} is not the name of a module")
    try:
        mod = importlib.import_module(f"benchmark.reference.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"benchmark.reference.{name}":
            raise
        raise ValueError(f"no reference {name!r}: benchmark/reference/{name}.py "
                         f"is missing") from None
    missing = [k for k in ("Reference", "STATED", "CONTROL") if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"reference {name!r} does not expose {', '.join(missing)}")
    return mod


def sample(finished: Sequence, seed: int) -> List:
    """The longest finished request whole, then others in seeded order,
    each as its prompt and first ``PER_REQUEST`` served tokens, while the
    sample holds fewer than ``MAX_REQUESTS`` requests and
    ``MAX_SEQ_TOKENS`` tokens."""
    done = [r for r in finished if len(r.tokens) >= MIN_SERVED]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.tokens), r.rid))
    rest = done[1:]
    random.Random(derive_seed(seed, "sample")).shuffle(rest)
    out, total = [done[0]], len(done[0].prompt) + len(done[0].tokens)
    for r in rest:
        if len(out) >= MAX_REQUESTS:
            break
        n = len(r.prompt) + min(len(r.tokens), PER_REQUEST)
        if total + n > MAX_SEQ_TOKENS:
            continue
        out.append(r)
        total += n
    return [types.SimpleNamespace(prompt=list(r.prompt),
                                  tokens=list(r.tokens if i == 0 else r.tokens[:PER_REQUEST]))
            for i, r in enumerate(out)]


def _inputs(reqs):
    seqs = [list(r.prompt) + list(r.tokens[:-1]) for r in reqs]
    wanted = [range(len(r.prompt) - 1, len(r.prompt) + len(r.tokens) - 1) for r in reqs]
    return seqs, wanted


def gaps(ref_logits: List[torch.Tensor], chosen: List[torch.Tensor]) -> List[torch.Tensor]:
    """best logit - logit of the chosen token, at every position of each
    request."""
    out = []
    for lg, tok in zip(ref_logits, chosen):
        tok = tok.to(lg.device, torch.int64)
        out.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0])
    return out


def judge(hf: dict, seed: int, device, reqs: Sequence, *, control: bool = False) -> Dict:
    """The sample's readings (:func:`summary` of its gaps), and with
    ``control`` the control's, each prefixed ``control_``."""
    if not reqs:
        return {"served_compared": 0}
    plain = reference(hf)
    seqs, wanted = _inputs(reqs)
    ref = plain.Reference(hf, seed, device, plain.STATED).logits(seqs, wanted)
    served = [torch.as_tensor(r.tokens, dtype=torch.int64) for r in reqs]
    out = {**summary(gaps(ref, served)), "requests_compared": len(reqs)}
    if control:
        low = plain.Reference(hf, seed, device, plain.CONTROL).logits(seqs, wanted)
        cg = summary(gaps(ref, [lg.argmax(dim=-1) for lg in low]))
        out.update({"control_" + k: v for k, v in cg.items()})
    return out


def summary(per_request: List[torch.Tensor]) -> Dict:
    """The worst request's mean gap (the number compared), and the whole
    sample's widest, mean, 90th percentile and median gap."""
    g = torch.cat(per_request).float()
    return {"worst_request_mean_logit_gap": max(float(x.float().mean()) for x in per_request),
            "max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "p90_logit_gap": float(torch.quantile(g, 0.9)),
            "median_logit_gap": float(g.median()), "served_compared": int(g.numel())}
