"""The ``dots`` and ``dots_no_batch`` remat policies (``models/layers.py::
maybe_remat``) against the JAX package's ``checkpoint_dots`` and
``checkpoint_dots_with_no_batch_dims``, and what each keeps.

A policy changes what the backward pass recomputes, never a number: the
loss and gradients of ``build_model(cfg.with_(remat=p))`` and a train step
are held against JAX's at smoke size in fp32 (the loss at 2e-5, gradients
and parameters at 1e-4).  What each keeps shows in the dry-run counter's
peak: none >= dots >= dots_no_batch >= full.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.model import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.steps import (make_train_step, trace_cell,
                                      train_state_specs)
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.models.param import unflatten
from repro_torch.optim import AdamW, cosine_schedule

from test_torch_train import (_assert_tree_close, _batch, _configs, _perturb,
                              _to_jax, _to_torch)

ARCHS = ["gemma-2b", "granite-moe-1b-a400m", "mamba2-1.3b"]
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4
EPS = 1e-6          # as test_torch_train's steps: updates fixed by gradients


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_matches_jax(arch, policy):
    jcfg, cfg = _configs(arch, remat=policy)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    np_params = _perturb(jmodel.init(jax.random.PRNGKey(0)), seed=1)
    batch = _batch(cfg, B=2, S=32, seed=2)
    jopt = JaxAdamW(jax_cosine_schedule(1e-3, 2, 10), eps=EPS)
    opt = AdamW(cosine_schedule(1e-3, 2, 10), eps=EPS)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    state = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jstate), "cpu",
                            train_state_specs(model, opt))

    def loss_grads_and_step(jstate, batch):   # one compile for both
        (loss, _), grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
            jstate["params"], batch)
        return (loss, grads) + jax_make_train_step(jmodel, jopt)(jstate,
                                                                 batch)
    jloss, jgrads, jstate, jmetrics = jax.jit(loss_grads_and_step)(
        jstate, _to_jax(batch))

    params = state["params"]
    paths, leaves = zip(*named_leaves(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, _ = model.loss_fn(unflatten(zip(paths, leaves)), _to_torch(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), \
        (loss.item(), float(jloss))
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[path], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=path)

    # one train step of each package from the same state
    state, metrics = make_train_step(model, opt)(state, _to_torch(batch))
    assert abs(metrics["loss"].item() - float(jmetrics["loss"])) <= \
        LOSS_RTOL * abs(float(jmetrics["loss"]))
    _assert_tree_close(state["params"], jstate["params"], GRAD_TOL, "params")


@pytest.mark.parametrize("arch", ARCHS)
def test_peak_falls_as_the_policy_keeps_less(arch):
    _, cfg = _configs(arch)
    shape = ShapeConfig("smoke_train", 64, 4, "train")
    peak = {p: trace_cell(cfg, shape, None, remat=p)[0].peak_bytes
            for p in ("none", "dots", "dots_no_batch", "full")}
    assert peak["none"] >= peak["dots"] >= peak["dots_no_batch"] >= \
        peak["full"], peak
    assert peak["none"] > peak["full"], peak
