"""The port's MoE family on the CPU against the JAX package's: the MoE layer
(output, aux loss, expert choices, gradients, dropped assignments), loss and
gradients of the smoke models, train steps, decode logits and greedy
generation, and the determinism of the combine.

Two configs: granite-moe-1b-a400m's smoke config (softmax router, GQA with 4
heads over 2 KV heads) and a GQA variant of it with deepseek-v3's MoE
options (the sigmoid router, one shared expert, one leading dense layer);
MLA and MTP are not ported yet.

The JAX reference is ``build_model(cfg)`` with its identity shard function
and ``launch/steps.py::make_train_step``, as ``tests/test_models.py`` runs
them, and ``moe_apply`` called without a shard function: on jax 0.9 JAX's
``Trainer`` and ``Server`` build through ``make_shard_fn(mesh)``, where
``moe_apply`` fails (ROADMAP, the reference-side failures).
Weights come from JAX's ``materialize`` through numpy and are carried into
the port by path.

Tolerances: the layer at 2e-5 in fp32 and 2e-2 in bf16 (``tests/
test_kernels.py``'s ``TOL``), with equal expert ids; gradients at 1e-4;
the loss at 1e-4 relative and params and moments after each step at 1e-4 of
each leaf's largest magnitude (``tests/test_torch_train.py``); decode logits
at 1e-4 of the largest logit against JAX's decode, and at 2e-2 against the
train forward (``tests/test_models.py``).

The router is fp32 with random weights, so no two scores of a token tie:
``torch.topk`` and ``jax.lax.top_k`` may order equal scores differently.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce_for_smoke
from repro.launch.steps import init_state as jax_init_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro.models.param import materialize as jax_materialize
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.serve import Server, ServeJob
from repro_torch.launch.steps import make_train_step, train_state_specs
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.models import moe
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import unflatten
from repro_torch.optim import AdamW, cosine_schedule

ARCH = "granite-moe-1b-a400m"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
RTOL = 1e-4
DECODE_RTOL = 2e-2
EPS = 1e-6   # see tests/test_torch_train.py: AdamW's eps on noise gradients
# deepseek-v3's MoE options, on granite's GQA smoke config
VARIANTS = {"granite": {},
            "sigmoid_shared_dense": dict(router="sigmoid", num_shared=1,
                                         first_dense_layers=1)}


def _configs(variant="granite", moe_kw=None, **kw):
    moe_kw = dict(VARIANTS[variant], **(moe_kw or {}))
    jcfg = jax_reduce_for_smoke(jax_get_arch(ARCH))
    cfg = reduce_for_smoke(get_arch(ARCH))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **moe_kw), **kw)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _perturb(tree, seed):
    """Constant leaves (norm scales) get noise so that the comparison sees
    them."""
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
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "loss_mask": (rng.uniform(size=(B, S)) < 0.9).astype(np.float32)}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- the layer
def _layer(variant="granite", dtype="float32", cf=1.25, seed=0, B=4, S=32,
           scale=1.0):
    """One MoE layer of the smoke config: its numpy params, an input, and
    both packages' configs."""
    jcfg, cfg = _configs(variant, dict(capacity_factor=cf), dtype=dtype)
    params = jax.tree_util.tree_map(
        np.asarray, jax_materialize(jax_moe.moe_specs(jcfg),
                                    jax.random.PRNGKey(seed)))
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
         * scale).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return jcfg, cfg, params, x


def _x_torch(x):
    return from_numpy_tree({"x": x}, "cpu")["x"]


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_apply_matches_jax(variant, dtype, cf):
    jcfg, cfg, params, x = _layer(variant, dtype, cf)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want, want_aux = jax_moe.moe_apply(jparams, jnp.asarray(x), jcfg)
    jidx, _, _ = jax_moe._route(jparams, jnp.asarray(x).reshape(-1, cfg.d_model),
                                jcfg)
    tparams, tx = from_numpy_tree(params, "cpu"), _x_torch(x)
    got, aux = moe.moe_apply(tparams, tx, cfg)
    idx, _, _ = moe._route(tparams, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    assert abs(aux.item() - float(want_aux)) <= tol * abs(float(want_aux))
    T = x.shape[0] * x.shape[1]
    _, _, _, keep = moe.dispatch(idx, moe.capacity(T, cfg), cfg.moe.num_experts)
    # at capacity factor 0.5 some assignments are dropped (the keep/pos_c
    # path runs); at 1.25 the random router may drop a few or none
    assert (not keep.all()) if cf < 1 else keep.float().mean() > 0.9


def test_capacity_is_jax_rule():
    for T, cf, k, E in [(128, 1.25, 2, 8), (128, 0.5, 2, 8), (4, 1.25, 8, 32),
                        (4096, 1.25, 8, 32), (3, 16.0, 2, 8)]:
        cfg = reduce_for_smoke(get_arch(ARCH)).with_(
            moe=dataclasses.replace(get_arch(ARCH).moe, capacity_factor=cf,
                                    top_k=k, num_experts=E))
        cap = int((T * k / E) * cf)
        assert moe.capacity(T, cfg) == max(8, -(-cap // 8) * 8)
    assert moe.capacity(4096, get_arch(ARCH)) == 1280


def test_dispatch_positions_match_bincount():
    """Queue positions from ``searchsorted`` equal JAX's ``bincount`` and
    ``cumsum`` rule, on ids with empty and crowded experts."""
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(6, 3, replace=False) for _ in range(40)])
    idx[idx == 2] = 5                          # expert 2 empty, 5 crowded
    idx = np.sort(idx, axis=1)
    order, se, pos, keep = moe.dispatch(torch.from_numpy(idx), 8, 8)
    flat = idx.reshape(-1)
    want_order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=8)
    starts = np.cumsum(counts) - counts
    want_pos = np.arange(flat.size) - starts[flat[want_order]]
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(se.numpy(), flat[want_order])
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_pos < 8)


def test_moe_capacity_drops_are_bounded():
    """tests/test_models.py::test_moe_capacity_drops_are_bounded on the port:
    the default capacity factor of 1.25 drops few assignments under
    near-uniform routing, and the aux loss is ~1 (balanced); both as JAX's
    on the same weights and input."""
    jcfg, cfg = _configs()
    jmodel = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0)))
    p = jax.tree_util.tree_map(lambda a: a[0], params["moe_blocks"])["moe"]
    x = (np.random.default_rng(0).standard_normal((4, 64, cfg.d_model))
         * 0.02).astype(np.float32)
    want, want_aux = jax_moe.moe_apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp = from_numpy_tree(p, "cpu")
    out, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert out.shape == x.shape
    assert aux.item() == pytest.approx(1.0, rel=0.5)
    assert abs(aux.item() - float(want_aux)) <= TOL["float32"] * float(want_aux)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])
    idx, _, _ = moe._route(tp, torch.from_numpy(x).reshape(-1, cfg.d_model),
                           cfg)
    _, _, _, keep = moe.dispatch(idx, moe.capacity(256, cfg), 8)
    assert keep.float().mean().item() > 0.9


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_apply_gradients_match_jax(variant, cf):
    """d/d(x, every param) of sum(out * g) + 3 * aux, at 1e-4."""
    jcfg, cfg, params, x = _layer(variant, "float32", cf, seed=1)
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jax_moe.moe_apply(p, xx, jcfg)
        return jnp.sum(out * g) + 3.0 * aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    tparams = from_numpy_tree(params, "cpu")
    paths, leaves = zip(*named_leaves(tparams))
    leaves = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(unflatten(zip(paths, leaves)), tx, cfg)
    loss = torch.sum(out * torch.from_numpy(g)) + 3.0 * aux
    grads = torch.autograd.grad(loss, leaves + [tx])
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jgp)))
    assert set(want) == set(paths)
    for path, gr in zip(paths, grads):
        np.testing.assert_allclose(gr.numpy(), want[path], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=path)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_combine_is_deterministic_and_expert_ordered(variant, cf):
    """In bf16, two calls are bit-equal, and the output is, bit for bit,
    each token's k weighted expert rows added one at a time in ascending
    expert id, starting from zeros: JAX's scatter-add order."""
    _, cfg, params, x = _layer(variant, "bfloat16", cf, seed=4)
    p, tx = from_numpy_tree(params, "cpu"), _x_torch(x)
    got, _ = moe.moe_apply(p, tx, cfg)
    again, _ = moe.moe_apply(p, tx, cfg)
    assert torch.equal(got, again)

    # the expert rows as moe_apply computes them, then the combine by hand
    T, d = x.shape[0] * x.shape[1], cfg.d_model
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    x2d = tx.reshape(T, d)
    idx, w, _ = moe._route(p, x2d, cfg)
    cap = moe.capacity(T, cfg)
    order, se, pos, keep = moe.dispatch(idx, cap, E)
    slot = torch.where(keep, se * cap + pos, E * cap)
    buf = x2d.new_zeros((E * cap + 1, d)).index_copy(
        0, slot, x2d[order // k])[:E * cap].view(E, cap, d)
    out_buf = torch.bmm(torch.nn.functional.silu(torch.bmm(buf, p["wg"]))
                        * torch.bmm(buf, p["wi"]), p["wo"])
    want = torch.zeros(T, d, dtype=torch.bfloat16)
    for i in range(T * k):                    # sorted: ascending expert id
        a = int(order[i])
        t, e, c = a // k, int(se[i]), int(pos[i])
        if c < cap:
            want[t] = want[t] + out_buf[e, c] * w[t, a % k].to(torch.bfloat16)
    if cfg.moe.num_shared:
        sh = x2d @ p["shared_wi"]
        want = want + (torch.nn.functional.silu(x2d @ p["shared_wg"]) * sh) \
            @ p["shared_wo"]
    assert torch.equal(got.reshape(T, d), want)


# ------------------------------------------------------- loss and gradients
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(variant):
    jcfg, cfg = _configs(variant)
    jmodel = jax_build_model(jcfg)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0))), seed=1)
    batch = _batch(cfg, seed=2)
    (loss, metrics), grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params), _to_jax(batch))
    return (np_params, batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads))))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_jax(variant, remat, impl):
    np_params, batch, jloss, jmetrics, jgrads = _jax_loss_and_grads(variant)
    _, cfg = _configs(variant)
    model = build_model(cfg.with_(remat=remat), attn_impl=impl)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    paths, leaves = zip(*named_leaves(params))
    leaves = [p.requires_grad_() for p in leaves]
    loss, metrics = model.loss_fn(unflatten(zip(paths, leaves)),
                                  _to_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == set(jmetrics) == {"ce", "aux", "loss"}
    for key, want in jmetrics.items():
        assert abs(metrics[key].item() - want) <= RTOL * abs(want), \
            (key, metrics[key].item(), want)
    assert loss.item() == metrics["loss"].item()
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_and_cache_specs_match_jax(variant):
    jcfg, cfg = _configs(variant)
    for jtree, tree in [
            (jax_build_model(jcfg).param_specs(),
             build_model(cfg).param_specs()),
            (jax_build_model(jcfg).cache_specs(3, 50),
             build_model(cfg).cache_specs(3, 50))]:
        want = dict(named_leaves(jtree))
        got = dict(named_leaves(tree))
        assert list(got) == list(want), variant
        for path, s in got.items():
            w = want[path]
            assert (s.shape, s.axes, s.dtype, s.init, s.fan_in) == \
                (w.shape, w.axes, w.dtype, w.init, w.fan_in), (variant, path)


# ---------------------------------------------------------------- train step
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_train_steps_match_jax(variant):
    jcfg, cfg = _configs(variant)
    jmodel = jax_build_model(jcfg)
    jopt = JaxAdamW(jax_cosine_schedule(1e-3, 2, 10), eps=EPS)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt))
    jstate = jax_init_state(jmodel, jopt, jax.random.PRNGKey(1))
    jstate = dict(jstate, params=_perturb(jstate["params"], seed=5))
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)

    model = build_model(cfg)
    opt = AdamW(cosine_schedule(1e-3, 2, 10), eps=EPS)
    step = make_train_step(model, opt)
    state = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jstate), "cpu",
                            train_state_specs(model, opt))
    for i in range(3):
        batch = _batch(cfg, B=4, S=32, seed=10 + i)
        jstate, jmetrics = jstep(jstate, _to_jax(batch))
        state, metrics = step(state, _to_torch(batch))
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert abs(metrics[key].item() - float(jmetrics[key])) <= \
                RTOL * abs(float(jmetrics[key])), (i, key)
        for tree in ("params", "m", "v"):
            got = state[tree] if tree == "params" else state["opt"][tree]
            want = jstate[tree] if tree == "params" else jstate["opt"][tree]
            want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, want)))
            for path, t in named_leaves(got):
                w = want[path]
                err = np.max(np.abs(t.numpy() - w)) / (np.max(np.abs(w)) + 1e-30)
                assert err <= RTOL, (i, tree, path, err)


def test_microbatched_step_averages_aux():
    """``make_train_step``'s microbatch mean takes ``aux`` with the other
    metrics: two microbatches report the mean of their two passes."""
    _, cfg = _configs()
    np_params, _, _, _, _ = _jax_loss_and_grads("granite")
    model = build_model(cfg)
    opt = AdamW(cosine_schedule(1e-3, 2, 10), eps=EPS)
    batch = _to_torch(_batch(cfg, B=4, S=32, seed=7))
    halves = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
    want = [model.loss_fn(from_numpy_tree(np_params, "cpu"), h)[1]["aux"]
            for h in halves]
    state = {"params": from_numpy_tree(np_params, "cpu")}
    state["opt"] = opt.init(state["params"])
    _, metrics = make_train_step(model, opt, microbatches=2)(state, batch)
    assert metrics["aux"].item() == pytest.approx(
        (want[0].item() + want[1].item()) / 2, rel=1e-6)


# -------------------------------------------------------------------- decode
def _jax_logits(jmodel, np_params, tokens):
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    steps = tokens.shape[1]
    cache = jmodel.init_cache(tokens.shape[0], steps)
    step = jax.jit(jmodel.decode_step)
    out = []
    for t in range(steps):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t]),
                             jnp.int32(t))
        out.append(np.asarray(logits))
    return np.stack(out)


def _torch_logits(model, params, tokens):
    steps = tokens.shape[1]
    cache = model.init_cache(tokens.shape[0], steps, "cpu")
    head = model.logits_weight(params)
    out = []
    for t in range(steps):
        tok = torch.from_numpy(np.ascontiguousarray(tokens[:, t])).long()
        logits, cache = model.decode_step(params, cache, tok, t, head=head)
        out.append(logits.numpy())
    return np.stack(out)


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_logits_match_jax(variant):
    """Dropless capacity (factor 16, as tests/test_models.py); each decoded
    position's logits against JAX's decode at 1e-4 of the largest, through
    the kernel and the plain attention; then against the port's own train
    forward at 2e-2."""
    jcfg, cfg = _configs(variant, dict(capacity_factor=16.0))
    jmodel = jax_build_model(jcfg)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1))), seed=1)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = _jax_logits(jmodel, np_params, tokens)
    for impl in ("kernel", "torch"):
        model = build_model(cfg, attn_impl=impl)
        params = from_numpy_tree(np_params, "cpu", model.param_specs())
        got = _torch_logits(model, params, tokens)
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _rel_err(got, want) <= RTOL, (variant, impl)

    B, S = tokens.shape
    h = model._embed_tokens(params, {"tokens": torch.from_numpy(tokens)})
    h = model.backbone(params, h, torch.arange(S).expand(B, S))
    fwd = model._logits(params, rmsnorm(params["final_ln"], h, cfg.norm_eps))
    fwd = fwd.detach().numpy().transpose(1, 0, 2)
    for t in range(S):
        assert _rel_err(got[t], fwd[t]) < DECODE_RTOL, t


def _jax_greedy(jcfg, np_params, prompts, new):
    """A greedy loop over JAX's ``decode_step``: the prompt absorbed token
    by token, then each new token the argmax over the real vocabulary."""
    jmodel = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    B, P = prompts.shape
    cache = jmodel.init_cache(B, P + new)
    step = jax.jit(jmodel.decode_step)
    out = np.zeros((B, P + new), np.int32)
    out[:, :P] = prompts
    for t in range(P + new - 1):
        logits, cache = step(params, cache, jnp.asarray(out[:, t]),
                             jnp.int32(t))
        if t + 1 >= P:
            out[:, t + 1] = np.argmax(
                np.asarray(logits)[:, :jcfg.vocab_size], axis=-1)
    return out


def test_greedy_generation_matches_jax():
    """``Server.generate`` on granite's smoke config, token for token."""
    jcfg, cfg = _configs()
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = _jax_greedy(jcfg, np_params, prompts, 6)
    srv = Server(ServeJob(arch=ARCH, batch=2, prompt_len=8, max_new_tokens=6),
                 params=from_numpy_tree(np_params, "cpu"), device="cpu")
    np.testing.assert_array_equal(srv.generate(prompts), want)
    assert srv.stats["tokens"] == 2 * 6
