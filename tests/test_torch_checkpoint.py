"""The port's checkpoints into the lake: save then restore within the port,
and a checkpoint written by either package restoring in the other, through
a directory on disk, bf16 leaves included.

The state is a real train state of the gemma-2b smoke config cast to bf16
(``{"params", "opt": {"step", "m", "v"}}``), so the leaf keys, dtypes and
shapes are those a trainer saves; leaves must come back bit for bit.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core.storage import LocalProvider as JaxLocalProvider
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.core.storage import LocalProvider, MemoryProvider
from repro_torch.launch.steps import (init_state, make_train_step,
                                      train_state_specs)
from repro_torch.models import abstract, build_model, named_leaves
from repro_torch.models.param import _numpy_to_tensor
from repro_torch.optim import AdamW, cosine_schedule


def _state(grad_compress=False, seed=0):
    """A train state with random leaves: bf16 params, fp32 moments, an int32
    step (and fp32 error feedback)."""
    cfg = reduce_for_smoke(get_arch("gemma-2b")).with_(dtype="bfloat16")
    model = build_model(cfg)
    opt = AdamW(cosine_schedule(1e-3, 2, 10))
    gen = torch.Generator().manual_seed(seed)
    state = init_state(model, opt, gen, "cpu", grad_compress=grad_compress)
    for _, leaf in named_leaves(state):
        if leaf.dim():
            leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    state["opt"]["step"].fill_(7)
    specs = train_state_specs(model, opt, grad_compress=grad_compress)
    return state, specs


def _assert_same(got, want):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("grad_compress", [False, True])
def test_save_then_restore(grad_compress):
    state, specs = _state(grad_compress)
    ckpt = CheckpointManager(MemoryProvider(), keep=2)
    ckpt.save(state, 4)
    ckpt.save(state, 8, blocking=True)
    assert ckpt.latest_step() == 8
    _assert_same(ckpt.restore(abstract(specs)), state)
    _assert_same(ckpt.restore(abstract(specs), step=4), state)
    ckpt.save(state, 12)
    ckpt.wait()
    assert ckpt.saved_steps == [8, 12]          # retention: keep=2
    with pytest.raises(FileNotFoundError):
        ckpt.restore(abstract(specs), step=4)
    # a new manager over the same storage finds every committed step
    assert CheckpointManager(ckpt.ds.storage).saved_steps == [4, 8, 12]


def test_async_save_holds_the_state_of_its_step(monkeypatch):
    """A train step that runs while the background write is still pending
    (it updates the state in place) does not reach the saved checkpoint."""
    state, specs = _state()
    cfg = reduce_for_smoke(get_arch("gemma-2b")).with_(dtype="bfloat16")
    step = make_train_step(build_model(cfg),
                           AdamW(cosine_schedule(1e-3, 2, 10)))
    before = {k: v.clone() for k, v in named_leaves(state)}
    stepped = threading.Event()
    write = CheckpointManager._write

    def held_write(self, leaves, step_no):
        stepped.wait(timeout=60)
        write(self, leaves, step_no)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    ckpt = CheckpointManager(MemoryProvider())
    ckpt.save(state, 7)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
    state, _ = step(state, {"tokens": tokens[:, :-1],
                            "targets": tokens[:, 1:],
                            "loss_mask": torch.ones(2, 16)})
    stepped.set()
    assert not torch.equal(state["params"]["embed"], before["params/embed"])
    _assert_same(ckpt.restore(abstract(specs)), before)


def _to_jax(state):
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), state)


def test_port_checkpoint_restores_in_jax(tmp_path):
    state, _ = _state(seed=1)
    ckpt = CheckpointManager(LocalProvider(str(tmp_path)))
    ckpt.save(state, 3)
    ckpt.wait()
    like = _to_jax(state)
    got = JaxCheckpointManager(JaxLocalProvider(str(tmp_path))).restore(like)
    got = {k: _numpy_to_tensor(np.asarray(v))
           for k, v in named_leaves(jax.tree_util.tree_map(np.asarray, got))}
    assert got["params/embed"].dtype == torch.bfloat16
    _assert_same(got, dict(named_leaves(state)))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    state, specs = _state(seed=2)
    jckpt = JaxCheckpointManager(JaxLocalProvider(str(tmp_path)))
    jckpt.save(_to_jax(state), 5)
    jckpt.wait()
    ckpt = CheckpointManager(LocalProvider(str(tmp_path)))
    assert ckpt.latest_step() == 5
    got = ckpt.restore(abstract(specs))
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].dim() == 0
    _assert_same(got, state)
