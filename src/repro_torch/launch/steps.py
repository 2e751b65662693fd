"""The train, prefill and decode steps and the train state (port of
``repro.launch.steps``: ``make_train_step``, ``make_prefill_step``,
``make_decode_step``, ``train_state_specs``, ``init_state``).

The train step updates its state IN PLACE and returns it, as the JAX trainer
donates the state to its jitted step; the decode step so updates its cache.

Under a mesh (a model built with ``make_shard_fn(mesh, rules)``) the state is
a tree of DTensors placed by ``sharding_for_specs`` (``state_placements``),
the step runs in the model's ``spmd()`` context, and each gradient is
redistributed to its parameter's placements (a pending sum over the batch
ranks reduce-scattered) before the optimizer, which then works on every
rank's shards alone; its metrics come back whole, as plain tensors.
``grad_compress`` stays the numerics-only ``compress_grads``, as in JAX's
step; the int8 collective is ``distributed.collectives``.  Lowering a cell
for the dry run (``build_cell``, ``lower_cell``) waits for ROADMAP Queue 1
item 17.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.distributed.sharding import (distribute, is_dtensor,
                                              place_tree, replicate,
                                              sharding_for_specs)
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
        # a leaf the loss does not reach (a stack of no layers, as deepseek-v3
        # cut to its dense layers has) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grads = [distribute(g, p.device_mesh, p.placements)
                 if is_dtensor(p) else g for g, p in zip(grads, leaves)]
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
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        per_mb = []
        for i in range(microbatches):
            g, metrics = value_and_grad(params, {k: v[i] for k, v in mb.items()})
            tree_map(lambda a, x: a.add_(x.float() / microbatches), grads, g)
            per_mb.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                   for k in per_mb[0]}
        return grads, metrics

    def train_step(state, batch):
        with model.spmd():
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
            metrics = {k: _whole(v) for k, v in metrics.items()}
        return new_state, metrics

    return train_step


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor, the same on every rank."""
    return replicate(x).to_local() if is_dtensor(x) else x


def make_prefill_step(model: Model):
    """(params, batch) -> (the last token's logits, the cache of length S),
    under ``torch.inference_mode()``: a prefill that recorded autograd would
    keep every layer's activations.  ``head`` is ``model.logits_weight``, as
    ``Model.prefill`` takes it."""
    @torch.inference_mode()
    def prefill_step(params, batch, *, head=None):
        return model.prefill(params, batch, head=head)
    return prefill_step


def make_decode_step(model: Model):
    """(params, cache, tokens, pos) -> (logits, cache), the cache written in
    place, under ``torch.inference_mode()``.  A cache made in inference mode
    (a prefill's) may be written in place only inside it, so this step runs
    there, and so must whatever pads a prefill cache to the decode length.
    ``head`` is ``model.logits_weight``, as ``Model.decode_step`` takes it."""
    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos: int, *, head=None):
        return model.decode_step(params, cache, tokens, pos, head=head)
    return decode_step


def train_state_specs(model: Model, optimizer: AdamW, *,
                      grad_compress: bool = False) -> Dict[str, Any]:
    psp = model.param_specs()
    out = {"params": psp, "opt": optimizer.state_specs(psp)}
    if grad_compress:
        out["error_fb"] = tree_map(
            lambda s: ParamSpec(s.shape, s.axes, init="zeros", dtype="float32"),
            psp)
    return out


def state_placements(model: Model, optimizer: AdamW, mesh, rules, *,
                     grad_compress: bool = False):
    """The train state's DTensor placements on ``mesh`` by ``rules``."""
    return sharding_for_specs(
        train_state_specs(model, optimizer, grad_compress=grad_compress),
        mesh, rules)


def init_state(model: Model, optimizer: AdamW, generator: torch.Generator,
               device, *, grad_compress: bool = False, mesh=None,
               rules=None) -> Dict[str, Any]:
    """The initial state; with ``mesh``, placed by ``rules``: every rank
    draws the whole state from the same seed and keeps its own shards."""
    params = model.init(generator, device)
    out = {"params": params, "opt": optimizer.init(params)}
    if grad_compress:
        out["error_fb"] = init_error_feedback(params)
    if mesh is not None:
        out = place_tree(out, state_placements(
            model, optimizer, mesh, rules, grad_compress=grad_compress), mesh)
    return out
