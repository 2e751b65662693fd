"""The port's training forward, gradients and train step on the CPU against
the JAX package's.

The JAX reference is ``build_model(cfg)`` with its identity shard function
and ``launch/steps.py::make_train_step``, as ``tests/test_models.py`` runs
them.  Weights (and optimizer state) are drawn once in JAX, passed through
numpy and carried into the port by path.  Tolerances: the loss at 1e-4
relative; gradients at 1e-4 (``tests/test_kernels.py``'s gradient
tolerance), and params and moments after each step at 1e-4 of each leaf's
largest magnitude: the two frameworks sum in other orders, nothing else.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce_for_smoke
from repro.launch.steps import init_state as jax_init_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.model import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.steps import make_train_step, train_state_specs
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.optim import AdamW, cosine_schedule

RTOL = 1e-4

# gemma-2b: MQA, tied table; starcoder2-3b: sliding window and qkv bias;
# gemma3-27b: local/global periods plus a tail; musicgen-medium: codebooks;
# phi-3-vision: the image-embed splice
LOSS_ARCHS = ["gemma-2b", "starcoder2-3b", "gemma3-27b", "musicgen-medium",
              "phi-3-vision-4.2b"]


def _configs(arch, **kw):
    jcfg = jax_reduce_for_smoke(jax_get_arch(arch)).with_(**kw)
    cfg = reduce_for_smoke(get_arch(arch)).with_(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _perturb(tree, seed):
    """Constant leaves (norm scales, qkv biases) get noise so that the
    comparison sees them."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a.astype(np.float32)
                    + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(perturb, tree)


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, (shape[0],) + shape[1:-1]
                          + (S + 1,)).astype(np.int32)
    batch = {"tokens": tokens[..., :-1], "targets": tokens[..., 1:],
             "loss_mask": (rng.uniform(size=(B, S)) < 0.9).astype(np.float32)}
    if cfg.num_image_tokens:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, 1024)).astype(np.float32)
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _leaf_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / (np.max(np.abs(want), initial=0.0) + 1e-30))


def _assert_tree_close(got_tree, want_tree, rtol, what, flips=0.0):
    """Every leaf within ``rtol`` of its largest magnitude, but for at most
    a share ``flips`` of its elements."""
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, want_tree)))
    got = dict(named_leaves(got_tree))
    assert set(got) == set(want), what
    for path in sorted(want):
        g = got[path].detach().float().numpy().astype(np.float64)
        w = want[path].astype(np.float64)
        off = np.abs(g - w) > rtol * (np.max(np.abs(w), initial=0.0) + 1e-30)
        assert off.sum() <= flips * off.size, (what, path, _leaf_err(g, w),
                                                int(off.sum()))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jcfg, cfg = _configs(arch)
    jmodel = jax_build_model(jcfg)
    np_params = _perturb(jmodel.init(jax.random.PRNGKey(0)), seed=1)
    batch = _batch(cfg, seed=2)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params), _to_jax(batch))

    model = build_model(cfg.with_(remat=remat))   # remat changes no number
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    paths, leaves = zip(*named_leaves(params))
    leaves = [p.requires_grad_() for p in leaves]
    loss, metrics = model.loss_fn(params, _to_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= RTOL * abs(float(jloss)), \
        (loss.item(), float(jloss))
    assert metrics["ce"].item() == loss.item()
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-4, rtol=1e-4,
                                   err_msg=path)


def test_torch_attention_impl_gives_the_same_loss():
    _, cfg = _configs("starcoder2-3b")
    jmodel = jax_build_model(jax_reduce_for_smoke(jax_get_arch("starcoder2-3b")))
    np_params = _perturb(jmodel.init(jax.random.PRNGKey(3)), seed=3)
    batch = _to_torch(_batch(cfg, S=80, seed=4))   # past the 64-token window
    losses = []
    for impl in ("kernel", "torch"):
        model = build_model(cfg, attn_impl=impl)
        params = from_numpy_tree(np_params, "cpu", model.param_specs())
        losses.append(model.loss_fn(params, batch)[0].item())
    assert abs(losses[0] - losses[1]) <= RTOL * abs(losses[1]), losses


STEP_VARIANTS = [dict(), dict(microbatches=2), dict(grad_compress=True)]
# AdamW's first steps move an element by lr * g / (|g| + eps).  With the
# default eps of 1e-8, an element whose gradient is float noise around zero
# (|g| ~ 1e-9, where the two frameworks' sums differ by as much as g itself)
# moves by an arbitrary share of lr in each package.  Both optimizers take
# eps = 1e-6 here, so that every element's update is fixed by its gradient to
# far better than the tolerance.
EPS = 1e-6
# Int8 compression rounds g / scale to the nearest level.  Where that lies
# within float noise of a half-level, the two packages may round to
# neighbouring levels: one level is 1/127 of the leaf's largest value.  Such
# elements may number at most 1 in 1000 of a leaf;
# ``test_compress_grads_matches_jax`` holds the quantizer itself exactly.
FLIPS = {"grad_compress": 1e-3}


@pytest.mark.parametrize("variant", STEP_VARIANTS,
                         ids=["plain", "microbatches2", "grad_compress"])
def test_three_train_steps_match_jax(variant):
    jcfg, cfg = _configs("gemma-2b")
    jmodel = jax_build_model(jcfg)
    jopt = JaxAdamW(jax_cosine_schedule(1e-3, 2, 10), eps=EPS)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, **variant))
    jstate = jax_init_state(jmodel, jopt, jax.random.PRNGKey(1),
                            grad_compress=variant.get("grad_compress", False))
    jstate = dict(jstate, params=_perturb(jstate["params"], seed=5))
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)

    model = build_model(cfg)
    opt = AdamW(cosine_schedule(1e-3, 2, 10), eps=EPS)
    step = make_train_step(model, opt, **variant)
    specs = train_state_specs(model, opt,
                              grad_compress=variant.get("grad_compress", False))
    state = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jstate), "cpu",
                            specs)
    flips = FLIPS.get("grad_compress" if variant.get("grad_compress") else "",
                      0.0)
    for i in range(3):
        batch = _batch(cfg, B=4, S=32, seed=10 + i)
        jstate, jmetrics = jstep(jstate, _to_jax(batch))
        state, metrics = step(state, _to_torch(batch))
        assert int(state["opt"]["step"]) == i + 1
        for key in ("loss", "grad_norm"):
            assert abs(metrics[key].item() - float(jmetrics[key])) <= \
                RTOL * abs(float(jmetrics[key])), (i, key)
        _assert_tree_close(state["params"], jstate["params"], RTOL,
                           ("params", i), flips)
        for moment in ("m", "v"):
            _assert_tree_close(state["opt"][moment], jstate["opt"][moment],
                               RTOL, (moment, i), flips)
        if "error_fb" in jstate:
            # a residual is at most half a level, 1/254 of the largest value
            # the quantizer saw: held at RTOL of that value
            _assert_tree_close(state["error_fb"], jstate["error_fb"],
                               254 * RTOL, ("error_fb", i), flips)


def test_compress_grads_matches_jax():
    from repro.optim import compress_grads as jax_compress_grads
    from repro_torch.optim import compress_grads
    rng = np.random.default_rng(6)
    grads = {"a": rng.standard_normal((64, 32)).astype(np.float32),
             "b": {"c": (rng.standard_normal(100) * 1e-3).astype(np.float32)}}
    fb = jax.tree_util.tree_map(
        lambda g: (0.01 * rng.standard_normal(g.shape)).astype(np.float32), grads)
    jg, je = jax_compress_grads(jax.tree_util.tree_map(jnp.asarray, grads),
                                jax.tree_util.tree_map(jnp.asarray, fb))
    g, e = compress_grads(from_numpy_tree(grads, "cpu"),
                          from_numpy_tree(fb, "cpu"))
    _assert_tree_close(g, jg, 1e-6, "grads")
    _assert_tree_close(e, je, 1e-6, "error feedback")
    from repro.optim import compression_ratio as jax_compression_ratio
    from repro_torch.optim import compression_ratio
    assert compression_ratio(g) == jax_compression_ratio(jg)


def test_cosine_schedule_matches_jax():
    jlr = jax_cosine_schedule(3e-4, 10, 100)
    lr = cosine_schedule(3e-4, 10, 100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jlr(jnp.int32(s)))
        got = lr(torch.tensor(s, dtype=torch.int32)).item()
        assert abs(got - want) <= 1e-7 * max(want, 1e-30) + 1e-12, (s, got, want)
