"""The port's example scripts (``examples/torch_*.py``), each ``main`` run
in this process on the CPU with a few steps."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_train_lm", "torch_serve_batched",
         "torch_resilient_training")


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_lm_lowers_its_loss():
    """The tiny preset, 10 steps: the last three batches' mean loss under
    the first three's (the loader's order varies from run to run, and one
    batch's loss with it, by about 0.07)."""
    out = load("torch_train_lm").main(["--device", "cpu", "--steps", "10"])
    losses = [h["loss"] for h in out["history"]]
    assert out["final_step"] == 10 and len(losses) == 10
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_lm_100m_preset_is_the_override_through_build_model():
    """The 100m preset's config and parameter count, without training it."""
    mod = load("torch_train_lm")
    trainer = mod.Trainer(mod.build_job("tiny", 1, False, "cpu"))
    mod.use_config(trainer, mod.reduce_for_smoke(mod.get_arch("gemma-2b"))
                   .with_(**mod.OVERRIDE_100M))
    assert trainer.model.cfg.d_model == 768 and trainer.cfg.num_layers == 12
    assert 100e6 < mod.count_params(trainer.model.param_specs()) < 130e6


def test_serve_batched_commits_one_response_per_prompt():
    ds = load("torch_serve_batched").main(
        ["--device", "cpu", "--requests", "6", "--steps", "3"])
    assert len(ds.prompt) == len(ds.response) == 6
    for i in range(6):
        response = np.asarray(ds.response[i])
        assert response.shape == (3,) and response.dtype == np.int32
    assert [n.message for n in ds.log()][:2] == ["responses", "requests"]


def test_resilient_training_survives_its_two_failures():
    result = load("torch_resilient_training").main(
        ["--device", "cpu", "--steps", "6"])
    assert result["restarts"] == 2 and result["final_step"] == 6
    assert np.isfinite(result["out"]["final_loss"])


def test_quickstart_renders_its_row():
    row = load("torch_quickstart").main(["--device", "cpu"])
    assert "labels = " in row and "boxes = " in row


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_the_card_unless_told_the_cpu(name, monkeypatch):
    """With no ``--device`` an example asks for the CUDA device, which this
    CPU build lacks."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        load(name).main([])
