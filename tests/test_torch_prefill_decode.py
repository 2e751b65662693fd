"""Prefill, then decode from its cache, on the CPU: the port's
``make_prefill_step`` and ``make_decode_step`` against the JAX package
doing the same and against the train forward over the whole sequence.

Neither package pads a prefill cache to a decode length, so the tests do:
each leaf is zero-padded along the axes where ``cache_specs(B, S + n)``
is longer (the time axis of a global cache, and of a local one shorter
than its window); the SSM state and conv tail have none.  Weights come
from JAX through numpy (``from_numpy_tree``).  Tolerances: decode logits at
1e-4 of the largest logit against JAX's (``tests/test_torch_serve.py``),
at 2e-2 against the forward (``tests/test_models.py``, moe at its dropless
capacity factor 16).

A windowed prefill cache holds positions S-window .. S-1 at slots
0 .. window-1 (JAX's ``k[:, -window:]``), while decode reads and writes
position p at slot ``p % window``; so decode continues from it correctly
only when S is at most the window or a multiple of it.  The last test
records that property of the reference at S = 100, window 64: the port
keeps JAX's cache and continues as JAX does, and both leave the forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import tree_map

from test_torch_prefill import _batch, _configs, _perturb, _rel, _tt

DECODE_RTOL = 1e-4
FORWARD_RTOL = 2e-2
STEPS = 8
# (arch, prompt length): starcoder2 (all local) and gemma3 (L/G periods and a
# tail) at twice their smoke window of 64, so the ring buffer is in phase;
# mamba2 and zamba2 at 24, so that the prompt and the forward's S + 8 each
# fit the scan's chunks of 32
CASES = [("gemma-2b", 64), ("starcoder2-3b", 128), ("gemma3-27b", 128),
         ("mamba2-1.3b", 24), ("zamba2-2.7b", 24),
         ("granite-moe-1b-a400m", 64), ("deepseek-v3-671b", 64)]


def _pad_torch(cache, specs):
    """The cache zero-padded, leaf by leaf, to the shapes of ``specs``."""
    def pad(leaf, spec):
        out = leaf.new_zeros(spec.shape)
        out[tuple(slice(0, n) for n in leaf.shape)] = leaf
        return out
    return tree_map(pad, cache, specs)


def _pad_jax(cache, specs):
    return jax.tree_util.tree_map(
        lambda leaf, spec: jnp.pad(leaf, [(0, want - have) for have, want in
                                          zip(leaf.shape, spec.shape)]),
        cache, specs)


@functools.lru_cache(maxsize=None)
def _setup(arch, S):
    jcfg, cfg = _configs(arch, dropless=True)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(4))), seed=4)
    tokens = _batch(cfg, 2, S + STEPS, seed=5)["tokens"]
    return jcfg, cfg, np_params, tokens


@functools.lru_cache(maxsize=None)
def _jax_continuation(arch, S):
    """JAX: prefill S tokens, pad the cache, decode the next STEPS."""
    jcfg, _, np_params, tokens = _setup(arch, S)
    model = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    last, cache = jax.jit(model.prefill)(
        params, {"tokens": jnp.asarray(tokens[..., :S])})
    cache = _pad_jax(cache, model.cache_specs(2, S + STEPS))
    step = jax.jit(model.decode_step)
    out = []
    for t in range(S, S + STEPS):
        logits, cache = step(params, cache, jnp.asarray(tokens[..., t]),
                             jnp.int32(t))
        out.append(np.asarray(logits))
    return np.asarray(last), np.stack(out)


def _torch_continuation(model, params, tokens, S):
    """The port: ``make_prefill_step`` over S tokens, the cache padded in
    inference mode, ``make_decode_step`` over the next STEPS."""
    last, cache = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(tokens[..., :S])})
    with torch.inference_mode():
        cache = _pad_torch(cache, model.cache_specs(2, S + STEPS))
    step = make_decode_step(model)
    out = []
    for t in range(S, S + STEPS):
        logits, cache = step(params, cache,
                             torch.from_numpy(tokens[..., t]).long(), t)
        out.append(logits.numpy())
    return last.numpy(), np.stack(out)


def _forward(model, params, tokens):
    """The train forward's logits at every position, (S, B, ...)."""
    S = tokens.shape[-1]
    with torch.no_grad():
        h = model._embed_tokens(params, _tt({"tokens": tokens}))
        h = model.backbone(params, h, torch.arange(S, dtype=torch.int32)
                           .expand(tokens.shape[0], S))
        logits = model._logits(params, rmsnorm(params["final_ln"], h,
                                               model.cfg.norm_eps))
    return logits.movedim(1, 0).numpy()


@pytest.mark.parametrize("impl", ["kernel", "torch", "torch_pairs"])
@pytest.mark.parametrize("arch,S", CASES)
def test_prefill_then_decode_matches_jax_and_forward(arch, S, impl):
    _, cfg, np_params, tokens = _setup(arch, S)
    want_last, want = _jax_continuation(arch, S)
    model = build_model(cfg, attn_impl=impl)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    last, got = _torch_continuation(model, params, tokens, S)
    assert _rel(last, want_last) <= DECODE_RTOL
    assert _rel(got, want) <= DECODE_RTOL
    fwd = _forward(model, params, tokens)
    assert _rel(last, fwd[S - 1]) < FORWARD_RTOL
    assert _rel(got, fwd[S:]) < FORWARD_RTOL


def test_decode_needs_inference_mode_for_a_prefill_cache():
    """A prefill cache is made in inference mode; written in place outside
    it, it raises, which is why the decode step and the padding run there."""
    _, cfg, np_params, tokens = _setup("gemma-2b", 64)
    model = build_model(cfg)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    _, cache = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(tokens[:, :64])})
    with pytest.raises(RuntimeError, match="[Ii]nference"):
        model.decode_step(params, cache, torch.zeros(2, dtype=torch.long), 63)


def test_windowed_prefill_cache_is_not_in_ring_order():
    """S = 100 with window 64 (starcoder2's smoke layers, all local): the
    port's cache equals JAX's, slot i holding position 36 + i; decode at
    position 100 writes slot 36 over position 72 and keeps position 36,
    outside the window, so both packages' continuations leave the forward
    alike, and stay equal to each other."""
    arch, S = "starcoder2-3b", 100
    jcfg, cfg, np_params, tokens = _setup(arch, S)
    jmodel = jax_build_model(jcfg)
    _, jcache = jax.jit(jmodel.prefill)(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(tokens[:, :S])})
    model = build_model(cfg)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    _, cache = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(tokens[:, :S])})
    jleaves = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jcache)))
    for path, leaf in named_leaves(cache):
        assert leaf.shape[2] == cfg.sliding_window
        assert _rel(leaf, jleaves[path]) <= DECODE_RTOL, path
    _, want = _jax_continuation(arch, S)
    _, got = _torch_continuation(model, params, tokens, S)
    assert _rel(got, want) <= DECODE_RTOL
    fwd = _forward(model, params, tokens)[S:]
    jax_off, port_off = _rel(want, fwd), _rel(got, fwd)
    assert jax_off > FORWARD_RTOL and port_off > FORWARD_RTOL, (jax_off,
                                                                 port_off)
    assert abs(jax_off - port_off) <= DECODE_RTOL * 10
