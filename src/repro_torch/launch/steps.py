"""The train, prefill and decode steps, the train state and a dry-run cell
(port of ``repro.launch.steps``: ``make_train_step``, ``make_prefill_step``,
``make_decode_step``, ``train_state_specs``, ``init_state``,
``abstract_state``, ``input_specs``, ``build_cell``; ``trace_cell`` in
place of ``lower_cell``).

The train step updates its state IN PLACE and returns it, as the JAX trainer
donates the state to its jitted step; the decode step so updates its cache.

Under a mesh (a model built with ``make_shard_fn(mesh, rules)``) the state is
a tree of DTensors placed by ``sharding_for_specs`` (``state_placements``),
the step runs in the model's ``spmd()`` context, and each gradient is
redistributed to its parameter's placements (a pending sum over the batch
ranks reduce-scattered) before the optimizer, which then works on every
rank's shards alone; its metrics come back whole, as plain tensors.
``grad_compress`` stays the numerics-only ``compress_grads``, as in JAX's
step; the int8 collective is ``distributed.collectives``.

A dry-run cell (``launch/dryrun.py``) is one (arch x shape x mesh) step run
once under ``FakeTensorMode`` and ``op_analysis.OpCounter``: the state and
inputs are fake tensors of each rank's shard (``abstract_state``), so that
nothing of their size is allocated, and the kernel wrappers report their
calls in place of launching (``kernels/_fake.py``).  What XLA's lowering
and compiled memory analysis give the JAX dry run, the counter gives here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (batch_specs, distribute,
                                              is_dtensor, make_rules,
                                              make_shard_fn, place_tree,
                                              placements_for, replicate,
                                              sharded, sharding_for_specs,
                                              spec_for)
from repro_torch.models.model import Model, build_model
from repro_torch.models.param import (ParamSpec, named_leaves, torch_dtype,
                                      tree_map, unflatten)
from repro_torch.optim import (AdamW, apply_updates, compress_grads,
                               cosine_schedule, init_error_feedback)


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


# ------------------------------------------------------------- dry-run cell
def _abstract_leaf(shape, dtype, mesh, placements) -> torch.Tensor:
    """A tensor of ``shape`` made in the current mode (a fake one under
    ``FakeTensorMode``); under a mesh, a DTensor of ``placements`` built
    from this rank's shard alone, never the whole tensor."""
    if mesh is None:
        return torch.empty(shape, dtype=dtype)
    return sharded(torch.empty, shape, dtype, mesh, placements,
                   device=mesh.device_type)


def _abstract(specs, placements, mesh):
    """A tree of ParamSpecs or meta tensors -> :func:`_abstract_leaf`s."""
    if isinstance(specs, dict):
        return {k: _abstract(specs[k], None if placements is None
                             else placements[k], mesh) for k in specs}
    dtype = specs.dtype if isinstance(specs.dtype, torch.dtype) else \
        torch_dtype(specs.dtype)
    return _abstract_leaf(tuple(specs.shape), dtype, mesh, placements)


def abstract_state(specs, mesh, rules):
    """A ParamSpec tree as tensors placed by ``rules`` on ``mesh`` (plain
    tensors with no mesh), each built from its shard alone: under
    ``FakeTensorMode``, the counterpart of JAX's ``abstract(specs)``."""
    placements = None if mesh is None else \
        sharding_for_specs(specs, mesh, rules)
    return _abstract(specs, placements, mesh)


def input_specs(cfg: ModelConfig, shape_cfg: ShapeConfig, model: Model,
                mesh, rules) -> Tuple[Any, Any]:
    """(specs, placements) of the step's inputs for ``shape_cfg.kind``;
    placements are None with no mesh.

    train:   {"tokens","targets","loss_mask"[, "image_embeds"]} (meta tensors)
    prefill: {"tokens"[, "image_embeds"]}
    decode:  (the cache's ParamSpecs at full seq_len, tokens (B,) or (B, K)
             as a meta tensor, pos = seq_len - 1, the last slot, a host int)
    """
    if shape_cfg.kind in ("train", "prefill"):
        from repro_torch.launch.mesh import MeshDesc
        metas, placements = batch_specs(cfg, shape_cfg,
                                        mesh or MeshDesc((), ()), rules)
        return metas, None if mesh is None else placements
    B = shape_cfg.global_batch
    cache_sp = model.cache_specs(B, shape_cfg.seq_len)
    tok_shape = (B, cfg.num_codebooks) if cfg.num_codebooks else (B,)
    tok_axes = ("batch", None) if cfg.num_codebooks else ("batch",)
    tokens = torch.empty(tok_shape, dtype=torch.int32, device="meta")
    specs = (cache_sp, tokens, shape_cfg.seq_len - 1)
    if mesh is None:
        return specs, None
    return specs, (sharding_for_specs(cache_sp, mesh, rules),
                   placements_for(spec_for(tok_shape, tok_axes, mesh, rules),
                                  mesh), None)


def build_cell(arch_cfg: ModelConfig, shape_cfg: ShapeConfig, mesh, *,
               attn_impl: str = "kernel", fsdp: Optional[bool] = None,
               microbatches: int = 1, grad_compress: bool = False,
               remat: Optional[str] = None):
    """Everything needed to trace one (arch x shape x mesh) cell -> (model,
    step, its arguments, rules).  The arguments are made in the current
    mode: fake ones under ``FakeTensorMode``, as ``trace_cell`` calls it."""
    long_ctx = shape_cfg.name == "long_500k"
    # when the cache sequence is marked shardable, decode shapes put it on
    # the model axis (batch already owns the data axes)
    seq_axis = None
    if arch_cfg.seq_shard_attn and not long_ctx:
        seq_axis = "model" if shape_cfg.kind == "decode" else "data"
    rules = make_rules(shape_cfg.kind, long_context=long_ctx,
                       fsdp=arch_cfg.fsdp_params if fsdp is None else fsdp,
                       seq_shard=seq_axis)
    if remat is not None:
        arch_cfg = arch_cfg.with_(remat=remat)
    model = build_model(arch_cfg, shard_fn=make_shard_fn(mesh, rules),
                        attn_impl=attn_impl)
    specs, placements = input_specs(arch_cfg, shape_cfg, model, mesh, rules)
    if shape_cfg.kind == "train":
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000),
                    moment_dtype=arch_cfg.adam_moment_dtype)
        fn = make_train_step(model, opt, microbatches=microbatches,
                             grad_compress=grad_compress)
        state = abstract_state(train_state_specs(
            model, opt, grad_compress=grad_compress), mesh, rules)
        args = (state, _abstract(specs, placements, mesh))
    elif shape_cfg.kind == "prefill":
        fn = make_prefill_step(model) if mesh is None else \
            _meshed(model, model.prefill)
        args = (abstract_state(model.param_specs(), mesh, rules),
                _abstract(specs, placements, mesh))
    else:
        fn = make_decode_step(model) if mesh is None else \
            _meshed(model, model.decode_step)
        (cache_sp, tokens, pos) = specs
        cache_pl, tok_pl, _ = placements or (None, None, None)
        args = (abstract_state(model.param_specs(), mesh, rules),
                _abstract(cache_sp, cache_pl, mesh),
                _abstract(tokens, tok_pl, mesh), pos)
    return model, fn, args, rules


def _meshed(model: Model, fn):
    """``fn`` as a meshed ``Server`` runs a step: in the model's ``spmd()``
    context, under ``no_grad`` (DTensor makes no views of inference
    tensors)."""
    def run(*args):
        with torch.no_grad(), model.spmd():
            return fn(*args)
    return run


def _local_leaves(tree):
    """The tensors of a nested tuple/dict, each rank's shard of a DTensor."""
    from torch.utils._pytree import tree_flatten
    return [t.to_local() if is_dtensor(t) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def trace_cell(arch_cfg: ModelConfig, shape_cfg: ShapeConfig, mesh, **kw):
    """Run one cell's step once on fake tensors under an ``OpCounter``, the
    counterpart of ``lower_cell`` -> (costs, memory, model, rules).

    ``memory`` is one device's bytes as XLA's memory analysis names them:
    ``argument_bytes`` (state and inputs), ``output_bytes``,
    ``alias_bytes`` (outputs that are an input's storage: the train state
    and the decode cache, updated in place), ``temp_bytes`` (the peak less
    the arguments and the outputs that alias none: the rest that is alive
    at the peak), and beside them ``peak_bytes``, ``state_bytes`` (the
    first argument: the train state, or the parameters) and
    ``largest_bytes`` (the largest storage the step held).  The
    collectives of the step's embedding lookups (``Model.lookup``) are also
    in ``costs.scoped["lookup"]``.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .mesh import H100
    from .op_analysis import OpCounter
    with FakeTensorMode():
        model, fn, args, rules = build_cell(arch_cfg, shape_cfg, mesh, **kw)
        ins = _local_leaves(args)
        counter = OpCounter(node_size=H100["node_size"])
        counter.hold(ins)
        model.lookup = counter.scope("lookup", model.lookup)
        with counter:
            out = fn(*args)
        del model.lookup
        held = {t.untyped_storage()._cdata for t in ins}
        outs = _local_leaves(out)
        state = _local_leaves(args[0])
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    argument = nbytes(ins)
    output = nbytes(outs)
    alias = nbytes(t for t in outs if t.untyped_storage()._cdata in held)
    peak = counter.costs.peak_bytes
    memory = {"argument_bytes": argument, "output_bytes": output,
              "temp_bytes": peak - argument - (output - alias),
              "alias_bytes": alias, "peak_bytes": peak,
              "state_bytes": nbytes(state),
              "largest_bytes": counter.costs.largest_bytes}
    return counter.costs, memory, model, rules

