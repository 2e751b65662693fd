"""The port's MLA attention, latent decode cache and multi-token prediction
(deepseek-v3) on the CPU against the JAX package's: the MLA functions, in
fp32 and bf16 with gradients; decode step by step with its caches; the spec
trees at smoke and full size; the loss with its ``mtp`` term and gradients;
train steps; decode logits and greedy generation; and a ``Trainer`` whose
checkpoint restores the MLA and ``mtp`` leaves.

The config is ``reduce_for_smoke(deepseek-v3-671b)``: 4 layers (1 dense and
3 MoE), d 128, 4 heads, q_lora 64, kv_lora 32, rope 16, nope 32, v 32, 8
experts of which 2 are chosen, one shared, the sigmoid router, MTP depth 1.
The JAX reference is ``build_model(cfg)`` with its identity shard function
and ``launch/steps.py::make_train_step``, as ``tests/test_models.py`` runs
them (see ``tests/test_torch_moe.py`` for why not JAX's ``Trainer``).
Weights come from JAX's ``materialize`` through numpy and are carried into
the port by path with ``from_numpy_tree``.

Tolerances are ``tests/test_torch_moe.py``'s: 2e-5 in fp32 and 2e-2 in bf16
(``tests/test_kernels.py``'s ``TOL``); gradients 1e-4; losses 1e-4
relative, params and moments after each step 1e-4 of each leaf's largest
magnitude; decode logits 1e-4 of the largest logit against JAX's decode and
2e-2 against the train forward (``tests/test_models.py``, at its dropless
capacity factor 16).
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
from repro.models import attention as jax_attn
from repro.models.model import build_model as jax_build_model
from repro.models.param import materialize as jax_materialize
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.serve import Server, ServeJob
from repro_torch.launch.steps import make_train_step, train_state_specs
from repro_torch.launch.train import Trainer, TrainJob
from repro_torch.models import attention as attn
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import abstract, count_params, unflatten
from repro_torch.optim import AdamW, cosine_schedule

ARCH = "deepseek-v3-671b"
FULL_PARAMS = 671_712_655_360     # JAX's spec tree of the full config
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
RTOL = 1e-4
DECODE_RTOL = 2e-2
EPS = 1e-6   # see tests/test_torch_train.py: AdamW's eps on noise gradients


def _configs(dtype="float32", moe_kw=None):
    jcfg = jax_reduce_for_smoke(jax_get_arch(ARCH)).with_(dtype=dtype)
    cfg = reduce_for_smoke(get_arch(ARCH)).with_(dtype=dtype)
    if moe_kw:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw))
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


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


# ------------------------------------------------------------ the layer
def _layer(dtype, B=2, S=24, seed=0):
    """One MLA layer's numpy params (norm scales perturbed), an input x and
    its positions, in ``dtype``."""
    jcfg, cfg = _configs(dtype)
    params = _perturb(jax.tree_util.tree_map(
        np.asarray, jax_materialize(jax_attn.mla_specs(jcfg),
                                    jax.random.PRNGKey(seed))), seed + 1)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.dtype(dtype)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return jcfg, cfg, params, x, pos


def _jt(params, x, pos):
    return (jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            jnp.asarray(pos))


def _tt(params, x, pos):
    tree = from_numpy_tree(dict(params, x=x), "cpu")
    x_t = tree.pop("x")
    return tree, x_t, torch.from_numpy(np.array(pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_projections_match_jax(dtype):
    """``_mla_rms``, ``mla_project_q`` and ``mla_latents``, each output in
    the input's dtype."""
    jcfg, cfg, params, x, pos = _layer(dtype)
    jp, jx, jpos = _jt(params, x, pos)
    tp, tx, tpos = _tt(params, x, pos)
    tol = TOL[dtype]
    want = jax_attn._mla_rms(jp["kv_norm"], jx @ jp["w_dkv"])
    got = attn._mla_rms(tp["kv_norm"], tx @ tp["w_dkv"])
    assert got.dtype == tx.dtype
    _close(got, want, tol, "_mla_rms")
    for name in ("mla_project_q", "mla_latents"):
        want = getattr(jax_attn, name)(jp, jx, jpos, jcfg)
        got = getattr(attn, name)(tp, tx, tpos, cfg)
        for g, w, part in zip(got, want, ("first", "second")):
            assert g.dtype == tx.dtype and tuple(g.shape) == w.shape
            _close(g, w, tol, f"{name} {part}")


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_train_matches_jax(dtype, impl):
    """S = 600 is no multiple of the 512-row block, so the padded path
    runs.  The output at ``TOL``; the gradients of sum(out * g) with respect
    to x and every param, against ``jax.vjp``: at 1e-4 in fp32, and in bf16
    at 2e-2 of each leaf's largest magnitude."""
    jcfg, cfg, params, x, pos = _layer(dtype, B=1, S=600, seed=3)
    jp, jx, jpos = _jt(params, x, pos)
    want, vjp = jax.vjp(
        lambda p, xx: jax_attn.mla_train(p, xx, jpos, jcfg), jp, jx)
    g = np.random.default_rng(4).standard_normal(want.shape).astype(np.float32)
    g = np.asarray(jnp.asarray(g, jnp.dtype(dtype)))
    jgp, jgx = vjp(jnp.asarray(g))

    tp, tx, tpos = _tt(params, x, pos)
    paths, leaves = zip(*named_leaves(tp))
    leaves = [t.requires_grad_() for t in leaves]
    tx.requires_grad_()
    got = attn.mla_train(unflatten(zip(paths, leaves)), tx, tpos, cfg,
                         impl=impl)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype], "output")
    grads = torch.autograd.grad(got, leaves + [tx],
                                from_numpy_tree({"g": g}, "cpu")["g"])
    jgrads = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jgp)))
    jgrads["x"] = np.asarray(jgx)
    for path, gr in zip(paths + ("x",), grads):
        w = np.asarray(jgrads[path], np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_np(gr), w, atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=path)
        else:
            err = np.max(np.abs(_np(gr) - w)) / (np.max(np.abs(w)) + 1e-30)
            assert err <= TOL[dtype], (path, err)


def test_mla_train_rejects_an_unknown_impl():
    _, cfg, params, x, pos = _layer("float32")
    tp, tx, tpos = _tt(params, x, pos)
    with pytest.raises(ValueError, match="impl"):
        attn.mla_train(tp, tx, tpos, cfg, impl="xla")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype):
    """16 positions, one at a time, on a 16-entry cache: each step's output
    and both caches after it, against JAX's; the port's caches are the
    tensors it was given, written in place."""
    jcfg, cfg, params, x, _ = _layer(dtype, B=2, S=16, seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = from_numpy_tree(params, "cpu")
    xs = from_numpy_tree({"x": x}, "cpu")["x"]
    m, B, T = cfg.mla, x.shape[0], x.shape[1]
    jckv = jnp.zeros((B, T, m.kv_lora_rank), jnp.dtype(dtype))
    jkr = jnp.zeros((B, T, m.rope_head_dim), jnp.dtype(dtype))
    ckv = torch.zeros((B, T, m.kv_lora_rank), dtype=xs.dtype)
    kr = torch.zeros((B, T, m.rope_head_dim), dtype=xs.dtype)
    tol = TOL[dtype]
    for t in range(T):
        want, jckv, jkr = jax_attn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                              jckv, jkr, t, jcfg)
        got, ckv2, kr2 = attn.mla_decode(tp, xs[:, t:t + 1], ckv, kr, t, cfg)
        assert ckv2 is ckv and kr2 is kr
        assert got.dtype == xs.dtype and tuple(got.shape) == want.shape
        _close(got, want, tol, f"output at {t}")
        _close(ckv, jckv, tol, f"ckv at {t}")
        _close(kr, jkr, tol, f"kr at {t}")
        assert not ckv[:, t + 1:].any() and not kr[:, t + 1:].any()


# ------------------------------------------------------------ spec trees
def _assert_same_specs(tree, jtree, what):
    want = dict(named_leaves(jtree))
    got = dict(named_leaves(tree))
    assert list(got) == list(want), what
    for path, s in got.items():
        w = want[path]
        assert (s.shape, s.axes, s.dtype, s.init, s.fan_in) == \
            (w.shape, w.axes, w.dtype, w.init, w.fan_in), (what, path)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_and_cache_specs_match_jax(size):
    """Paths, shapes, axes, dtypes, inits and fan-ins of the parameter and
    cache spec trees; the full config's parameters counted from its specs,
    without allocating."""
    if size == "smoke":
        jcfg, cfg = _configs()
    else:
        jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    specs = model.param_specs()
    _assert_same_specs(specs, jmodel.param_specs(), f"{size} params")
    _assert_same_specs(model.cache_specs(3, 50), jmodel.cache_specs(3, 50),
                       f"{size} cache")
    assert model.cfg.attention == "mla"
    assert {"proj", "block", "ln"} <= set(specs["mtp"])
    assert "w_dq" in specs["mtp"]["block"]["attn"]
    if size == "full":
        assert count_params(specs) == FULL_PARAMS


def test_unknown_attention_kind_raises():
    with pytest.raises(ValueError, match="attention"):
        build_model(reduce_for_smoke(get_arch(ARCH)).with_(attention="mqa"))


# ------------------------------------------------------- loss and gradients
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    jcfg, cfg = _configs()
    jmodel = jax_build_model(jcfg)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0))), seed=1)
    batch = _batch(cfg, seed=2)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jmodel.loss_fn,
                                                    has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params), _to_jax(batch))
    return (np_params, batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads))))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(remat, impl):
    """ce, aux, mtp and loss = ce + 0.01 aux + 0.3 mtp at 1e-4 relative;
    the gradient of every leaf, the MLA and ``mtp`` leaves among them, at
    1e-4."""
    np_params, batch, jloss, jmetrics, jgrads = _jax_loss_and_grads()
    _, cfg = _configs()
    model = build_model(cfg.with_(remat=remat), attn_impl=impl)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    paths, leaves = zip(*named_leaves(params))
    leaves = [p.requires_grad_() for p in leaves]
    loss, metrics = model.loss_fn(unflatten(zip(paths, leaves)),
                                  _to_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == set(jmetrics) == {"ce", "aux", "mtp", "loss"}
    for key, want in jmetrics.items():
        assert abs(metrics[key].item() - want) <= RTOL * abs(want), \
            (key, metrics[key].item(), want)
    assert loss.item() == metrics["loss"].item()
    assert loss.item() == pytest.approx(
        metrics["ce"].item() + 0.01 * metrics["aux"].item()
        + 0.3 * metrics["mtp"].item(), rel=1e-6)
    assert any(p.startswith("mtp/block/attn/") for p in paths)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=path)


# ---------------------------------------------------------------- train step
def test_three_train_steps_match_jax():
    jcfg, cfg = _configs()
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
        for key in ("loss", "ce", "aux", "mtp", "grad_norm"):
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
    return np.stack(out), cache


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def test_decode_logits_match_jax_and_the_forward():
    """At dropless capacity (factor 16, as tests/test_models.py): each
    decoded position's logits against JAX's decode at 1e-4 of the largest,
    under both impls; the latent caches filled at every position; then
    against the port's own train forward, through ``mla_train``, at 2e-2."""
    jcfg, cfg = _configs(moe_kw=dict(capacity_factor=16.0))
    jmodel = jax_build_model(jcfg)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1))), seed=1)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = _jax_logits(jmodel, np_params, tokens)
    for impl in ("kernel", "torch"):
        model = build_model(cfg, attn_impl=impl)
        params = from_numpy_tree(np_params, "cpu", model.param_specs())
        got, cache = _torch_logits(model, params, tokens)
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _rel_err(got, want) <= RTOL, impl
        assert set(cache) == {"dense_layers", "moe_layers"}
        for layers in cache.values():
            assert set(layers) == {"ckv", "kr"}
            assert bool(layers["ckv"].abs().sum(-1).gt(0).all())

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
    """``Server.generate`` on deepseek-v3's smoke config, token for token."""
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


# ------------------------------------------------------------------- trainer
def _cut(trainer, layers):
    """The trainer's model cut to its first ``layers`` layers after
    construction, as the chip script cuts deepseek-v3's depth."""
    trainer.cfg = trainer.cfg.with_(num_layers=layers)
    trainer.model = build_model(trainer.cfg)
    trainer.step_fn = make_train_step(trainer.model, trainer.opt)


@pytest.mark.parametrize("layers", [4, 1], ids=["smoke", "dense_only"])
def test_trainer_checkpoint_restores_mla_and_mtp_leaves(layers):
    """``Trainer.run`` on the CPU with bf16 moments, as deepseek-v3's config
    keeps them: a finite loss, and a checkpoint whose restore equals the
    state bit for bit, the MLA and ``mtp`` leaves among them.  One layer
    keeps only the leading dense layer, and an MoE stack of length 0, as
    the chip script's depth-3 cut of the full config does."""
    job = TrainJob(arch=ARCH, steps=3, global_batch=2, seq_len=32, lr=3e-3,
                   warmup=1, checkpoint_every=3, num_docs=8, log_every=100,
                   device="cpu")
    trainer = Trainer(job)
    _cut(trainer, layers)
    assert trainer.opt.moment_dtype == "bfloat16"
    out = trainer.run(restore=False)
    assert out["final_step"] == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert trainer.ckpt.latest_step() == 3
    back = trainer.ckpt.restore(abstract(train_state_specs(trainer.model,
                                                           trainer.opt)))
    mine, theirs = dict(named_leaves(out["state"])), dict(named_leaves(back))
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key].dtype == theirs[key].dtype and \
            torch.equal(mine[key], theirs[key]), key
    assert "params/dense_blocks/attn/w_uk" in mine
    assert "opt/m/mtp/block/attn/kv_norm" in mine
    assert "params/mtp/proj" in mine
    moe_leaf = mine["params/moe_blocks/attn/w_dkv"]
    assert moe_leaf.shape[0] == layers - 1


# ------------------------------------------------------------ chip_smoke.py
def test_chip_smoke_counts_and_groups_mla():
    """The card script's launch counts give MLA no flash and no decode
    launch, and its grouped trace puts ``mla_train`` and ``_mtp_loss`` in
    groups of their own (``_mtp_loss``'s block, logits and loss all in
    "MTP")."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = get_arch(ARCH)
    assert chip_smoke._attention_layers(cfg) == 0
    assert chip_smoke.train_launches(cfg.with_(num_layers=3), 8) == \
        {"flash_attention": 0, "ssd_scan": 0}
    assert chip_smoke._attention_layers(get_arch("granite-moe-1b-a400m")) == 24
    group = chip_smoke._trace_group
    assert group("gemm", ["aten::mm", "scope:mla_train",
                          "scope:_dense_block"]) == "MLA attention (plain)"
    for inner in ("scope:mla_train", "scope:_logits", "scope:_dense_block"):
        assert group("gemm", [inner, "scope:_mtp_loss"]) == "MTP"
    assert group("gemm", ["aten::bmm", "scope:moe_apply",
                          "scope:_dense_block"]) == "expert GEMMs"
    assert {"MLA attention (plain)", "MTP"} <= set(chip_smoke.TRACE_GROUPS)
