"""The port's trainer end to end on the CPU: the JAX package's three trainer
tests (``tests/test_distributed_system.py::test_trainer_*``), on
``device="cpu"``.

The third JAX test trains granite's MoE smoke config; its port trains it
too, and gemma-2b's smoke config through the same TQL filter and gradient
compression.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.storage import MemoryProvider
from repro_torch.distributed import HostFailure
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.train import Trainer, TrainJob


def test_trainer_loss_decreases_and_checkpoints():
    job = TrainJob(arch="gemma-2b", steps=12, global_batch=4, seq_len=64,
                   checkpoint_every=6, num_docs=16, log_every=100, device="cpu")
    t = Trainer(job)
    out = t.run(restore=False)
    assert out["final_step"] == 12
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert t.ckpt.latest_step() == 12
    assert flash_attention.launches == 0      # the CPU runs the plain version


def test_trainer_restores_after_failure():
    job = TrainJob(arch="gemma-2b", steps=10, global_batch=4, seq_len=64,
                   checkpoint_every=2, num_docs=16, fail_at=(5,),
                   log_every=100, device="cpu")
    ckpt = CheckpointManager(MemoryProvider(), keep=3)
    t1 = Trainer(job, ckpt=ckpt)
    with pytest.raises(HostFailure):
        t1.run(restore=False)
    assert ckpt.latest_step() >= 4
    # restarted job: the transient fault doesn't re-fire (real-world restart)
    job2 = dataclasses.replace(job, fail_at=())
    t2 = Trainer(job2, ckpt=ckpt, data_ds=t1.data_ds)
    out = t2.run(restore=True)          # resumes from checkpoint
    assert out["final_step"] == 10
    first_resumed = out["history"][0]["step"] if out["history"] else 10
    assert first_resumed >= 4           # at most checkpoint_every recomputed


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma-2b"])
def test_trainer_with_tql_filter_and_compression(arch):
    job = TrainJob(arch=arch, steps=4, global_batch=2,
                   seq_len=64, grad_compress=True, num_docs=12,
                   tql_filter="SELECT * FROM dataset WHERE doc_id % 2 == 0",
                   log_every=100, device="cpu")
    out = Trainer(job).run(restore=False)
    assert np.isfinite(out["final_loss"])
    assert "error_fb" in out["state"]


def test_trainer_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainJob())
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        Trainer(TrainJob(model_axis=2, device="cpu"))
