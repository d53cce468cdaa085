"""The dense FFN handed to the port at a block multiple with zero padding
computes the published, ragged layer."""

import json
from pathlib import Path

import torch

from benchmark import program
from benchmark.reference import model as ref
from benchmark.reference import quant as rq
from benchmark.weights import SeededState

DATA = Path(__file__).resolve().parent / "data"


def test_zero_padded_dense_layer_is_the_ragged_layer():
    from deepgemm_ascend_tpu_torch.models.loader import load_params
    from deepgemm_ascend_tpu_torch.ops import quant
    hf = json.loads((DATA / "tiny_moe.json").read_text())     # intermediate 320
    cfg = program.model_config(hf)
    assert cfg.dense_intermediate == 384
    padded = SeededState(hf, 21, "cpu", pad_dense_to=384)
    ragged = SeededState(hf, 21, "cpu")
    g_pad = padded["model.layers.0.mlp.gate_proj.weight"]
    g = ragged["model.layers.0.mlp.gate_proj.weight"]
    assert torch.equal(g_pad[:320], g) and not g_pad[320:].any()
    # The same fp8 bytes and scales on the real rows: zeros raise no amax.
    q_pad, s_pad = quant.quantize_fp8_weight(g_pad.float())
    q, s = quant.quantize_fp8_weight(g.float())
    assert torch.equal(q_pad[:320].view(torch.uint8), q.view(torch.uint8))
    assert torch.equal(s_pad, s)
    # The port's layer at 384: its padding columns are exact zeros after
    # the gate and up product and after SwiGLU, so the intermediate's last
    # 1x128 group keeps the amax of its 64 real values.
    params = load_params(padded, cfg, device="cpu")
    ffn = params.layers[0].ffn
    x = torch.randn((40, 256), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    gu = ffn.w1(x)
    assert not gu[:, 320:384].any() and not gu[:, 704:].any()
    from deepgemm_ascend_tpu_torch.models.moe import _swiglu
    h = _swiglu(gu)
    assert not h[:, 320:].any()
    _, s_pad = quant.quantize_fp8_act(h)
    _, s_rag = quant.quantize_fp8_act(h[:, :320])
    assert torch.equal(s_pad, s_rag)
    q2, s2 = quant.quantize_fp8_weight(ragged["model.layers.0.mlp.down_proj.weight"].float())
    assert torch.equal(ffn.w2.w_q[:, :320].view(torch.uint8), q2.view(torch.uint8))
    assert torch.equal(ffn.w2.scales, s2)
    # And the reference's ragged layer is the same function: the port's
    # bf16 intermediate re-quantized to fp8 parts from the reference's f32
    # one by fp8 roundings only.
    got = ffn(x).float()
    want = ref._mlp(ragged.group(0, "dense"), "mlp.", ref.STATED)(x.float())
    err = (got - want).abs().max() / want.abs().max()
    assert err < 0.05, err
    # and the reference's quantizer gives the port's dequantized weights
    w = rq.weight(g.float(), "fp8")
    assert torch.equal(w, quant.dequantize_fp8_weight(q, s))


def test_the_published_deepseek_moe_router_is_refused():
    """DeepSeekMoE-16B weights its top-6 experts by their raw softmax scores
    (``norm_topk_prob: false``). While the port's ``ModelConfig`` has no
    ``norm_topk_prob`` field its router always renormalizes them, so the
    harness refuses to run that configuration under its name; once it has
    one, the published value is passed through."""
    import dataclasses

    import pytest
    from deepgemm_ascend_tpu_torch.models.config import ModelConfig
    hf = json.loads((DATA / "dsmoe16b.json").read_text())
    assert hf["norm_topk_prob"] is False and hf["reduced"] == []
    if "norm_topk_prob" in {f.name for f in dataclasses.fields(ModelConfig)}:
        assert program.model_config(hf).norm_topk_prob is False
    else:
        with pytest.raises(ValueError, match="renormalizes"):
            program.model_config(hf)
    assert program.model_config(dict(hf, norm_topk_prob=True)).num_experts == 64
