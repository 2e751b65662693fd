"""The train step and its state (port of ``repro.launch.steps``:
``make_train_step``, ``train_state_specs``, ``init_state``).

The step updates its state IN PLACE and returns it, as the JAX trainer
donates the state to its jitted step.  Lowering a cell for the dry run
(``build_cell``, ``lower_cell``) waits for ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.model import Model
from repro_torch.models.param import (ParamSpec, named_leaves, tree_map,
                                      unflatten)
from repro_torch.optim import (AdamW, apply_updates, compress_grads,
                               init_error_feedback)


def make_train_step(model: Model, optimizer: AdamW, *,
                    grad_compress: bool = False, microbatches: int = 1):
    """state {"params", "opt"[, "error_fb"]} x batch -> (state, metrics)."""

    def value_and_grad(params, batch):
        paths, leaves = zip(*named_leaves(params))
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = model.loss_fn(unflatten(zip(paths, leaves)), batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return unflatten(zip(paths, grads)), metrics

    def compute_grads(params, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        # gradient accumulation over microbatches (memory knob), in fp32
        def split(x):
            return x.reshape((microbatches, x.shape[0] // microbatches)
                             + tuple(x.shape[1:]))
        mb = {k: split(v) for k, v in batch.items()}
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        per_mb = []
        for i in range(microbatches):
            g, metrics = value_and_grad(params, {k: v[i] for k, v in mb.items()})
            tree_map(lambda a, x: a.add_(x.float() / microbatches), grads, g)
            per_mb.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                   for k in per_mb[0]}
        return grads, metrics

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = compute_grads(params, batch)
        if grad_compress:
            grads, new_fb = compress_grads(grads, state["error_fb"])
        updates, opt_state, opt_metrics = optimizer.update(
            grads, state["opt"], params)
        new_state = {"params": apply_updates(params, updates),
                     "opt": opt_state}
        if grad_compress:
            new_state["error_fb"] = new_fb
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return new_state, metrics

    return train_step


def train_state_specs(model: Model, optimizer: AdamW, *,
                      grad_compress: bool = False) -> Dict[str, Any]:
    psp = model.param_specs()
    out = {"params": psp, "opt": optimizer.state_specs(psp)}
    if grad_compress:
        out["error_fb"] = tree_map(
            lambda s: ParamSpec(s.shape, s.axes, init="zeros", dtype="float32"),
            psp)
    return out


def init_state(model: Model, optimizer: AdamW, generator: torch.Generator,
               device, *, grad_compress: bool = False) -> Dict[str, Any]:
    params = model.init(generator, device)
    out = {"params": params, "opt": optimizer.init(params)}
    if grad_compress:
        out["error_fb"] = init_error_feedback(params)
    return out
