"""The reference's MoE block (``benchmark/reference/model.py``, ``_ffn``)
against a computation by hand: softmax scores of the bfloat16 router logits,
the top k in stable descending order, their raw weights where the file says
``norm_topk_prob: false`` or says nothing (DeepSeek's default), weights that
sum to one where it says ``true``, and each chosen expert's SwiGLU times its
weight, plus the shared expert."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.reference import model as ref
from benchmark.reference import quant as rq
from benchmark.weights import SeededState

DATA = Path(__file__).resolve().parent / "data"
SEED = 1
LAYER = 1        # tiny_moe's one MoE layer (``first_k_dense_replace`` 1)


def _tiny_moe(**keys) -> dict:
    return dict(json.loads((DATA / "tiny_moe.json").read_text()), **keys)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _x(hf: dict) -> torch.Tensor:
    """A residual stream small beside the experts' output, so that adding
    the two in bfloat16 keeps the routed part."""
    g = torch.Generator().manual_seed(5)
    return _bf(0.01 * torch.randn((24, hf["hidden_size"]), generator=g))


def _swiglu(group: dict, prefix: str, h: torch.Tensor) -> torch.Tensor:
    """One SwiGLU FFN, its weights and inputs at the stated fp8."""
    def proj(name, v):
        w = rq.weight(group[f"{prefix}{name}.weight"].float(), "fp8")
        return _bf(rq.act(v, "fp8") @ w.t())
    gate, up = proj("gate_proj", h), proj("up_proj", h)
    return proj("down_proj", _bf(torch.nn.functional.silu(gate) * up))


def _by_hand(hf: dict, x: torch.Tensor, renormalize: bool) -> torch.Tensor:
    st = SeededState(hf, SEED, "cpu")
    norm = st.group(LAYER, "norms")["post_attention_layernorm.weight"].float()
    ms = x.pow(2).mean(-1, keepdim=True) + hf["rms_norm_eps"]
    h = _bf(_bf(x * torch.rsqrt(ms)) * norm)
    router = st.group(LAYER, "router")["mlp.gate.weight"].float()
    scores = torch.softmax(_bf(h @ router.t()), dim=-1)
    experts, shared = st.group(LAYER, "experts"), st.group(LAYER, "shared")
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        row = scores[t].tolist()
        # Python's sort is stable: of equal scores the lower index comes first.
        chosen = sorted(range(len(row)), key=lambda e: -row[e])[:hf["num_experts_per_tok"]]
        wt = scores[t, chosen]
        if renormalize:
            wt = wt / wt.sum()
        for e, w in sorted(zip(chosen, wt)):
            out[t] += _swiglu(experts, f"mlp.experts.{e}.", h[t:t + 1])[0] * w
    out += _swiglu(shared, "mlp.shared_experts.", h)
    return _bf(x + _bf(out))


def _reference(hf: dict, x: torch.Tensor) -> torch.Tensor:
    r = ref.Reference(hf, SEED, "cpu")
    assert r.s.is_moe(LAYER) and not r.s.is_moe(LAYER - 1)
    with torch.no_grad():
        return r._ffn(r._prepare(LAYER), x)


@pytest.mark.parametrize("renormalize", [False, True], ids=["raw", "renormalized"])
def test_the_reference_router_is_the_computation_by_hand(renormalize):
    hf = _tiny_moe(norm_topk_prob=renormalize)
    x = _x(hf)
    got, want = _reference(hf, x), _by_hand(hf, x, renormalize)
    # Equal on the CPUs tried. The room is one bfloat16 step of the largest
    # output, since an expert's rows run as one product in the reference and
    # one at a time here. Raw and renormalized lie some forty such steps apart.
    torch.testing.assert_close(got, want, rtol=0, atol=2 ** -7 * want.abs().max().item())


def test_raw_and_renormalized_weights_differ_and_no_key_reads_raw():
    raw = _tiny_moe(norm_topk_prob=False)
    x = _x(raw)
    got = _reference(raw, x)
    renormalized = _reference(_tiny_moe(norm_topk_prob=True), x)
    # Top 2 of 8 softmax scores sum to well under one, so the routed part
    # grows by their inverse when they are renormalized.
    routed, routed_renormalized = got - x, renormalized - x
    assert (routed - routed_renormalized).abs().max() > 0.1 * routed.abs().max()
    unstated = _tiny_moe()
    del unstated["norm_topk_prob"]
    assert torch.equal(_reference(unstated, x), got)
