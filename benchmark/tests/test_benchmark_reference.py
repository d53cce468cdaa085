"""The configuration's reference (``check.reference``): the module that its
``reference`` key names under ``benchmark/reference/``, ``model`` where it
names none, looked up in a run's set-up."""

import json
import types
from pathlib import Path

import pytest
import torch

from benchmark import check, program, run
from benchmark.reference import model
from benchmark.tests.tiny import make_root

DATA = Path(__file__).resolve().parent / "data"


def _tiny_moe(**keys) -> dict:
    return dict(json.loads((DATA / "tiny_moe.json").read_text()), **keys)


def test_no_key_is_the_model_reference():
    assert check.reference(_tiny_moe()) is model
    assert check.reference(_tiny_moe(reference="model")) is model
    assert model.STATED == model.Precision("fp8", "fp8", "int8")
    assert model.CONTROL == model.Precision("int4", "int4", "int4")


def test_the_check_builds_the_named_reference_in_its_stated_and_control_precisions(monkeypatch):
    made = []

    class Spy(model.Reference):
        def __init__(self, hf, seed, device, prec):
            made.append(prec)
            super().__init__(hf, seed, device, prec)

    monkeypatch.setattr(model, "Reference", Spy)
    req = types.SimpleNamespace(prompt=[5, 6, 7, 8], tokens=[9, 10, 11])
    check.judge(_tiny_moe(), 1, "cpu", [req], control=True)
    assert made == [model.STATED, model.CONTROL]


def test_naming_the_model_reference_gives_the_same_logits():
    seqs, wanted = [[3, 14, 15, 92, 65], [35, 89, 79]], [range(1, 5), range(0, 3)]
    outs = []
    for hf in (_tiny_moe(), _tiny_moe(reference="model")):
        ref = check.reference(hf)
        outs.append(ref.Reference(hf, 1, "cpu", ref.STATED).logits(seqs, wanted))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    req = types.SimpleNamespace(prompt=[3, 14, 15, 92], tokens=[65, 35, 89])
    assert (check.judge(_tiny_moe(), 1, "cpu", [req], control=True)
            == check.judge(_tiny_moe(reference="model"), 1, "cpu", [req], control=True))


@pytest.mark.parametrize("name, words", [
    ("no_such_reference", "is missing"), ("../model", "not the name"),
    ("quant", "does not expose Reference, STATED, CONTROL")])
def test_a_reference_that_is_not_there_fails_in_set_up(tmp_path, monkeypatch, name, words):
    root = make_root(tmp_path)
    conf = root / "benchmark" / "configs" / "tiny_moe.json"
    conf.write_text(json.dumps(dict(json.loads(conf.read_text()), reference=name)))
    monkeypatch.setattr(program, "build", lambda *a, **k: pytest.fail("served"))
    with pytest.raises(ValueError, match=words):
        run.run(["--workload", "tiny_moe.decode", "--seed", "1", "--seconds", "1"],
                root=root, device="cpu", emit=lambda line: pytest.fail("printed"))
