"""The port's ssm (mamba2) and hybrid (zamba2) families on the CPU against the
JAX package's: the Mamba2 layer and its decode step, loss and gradients,
train steps, decode logits and greedy serving, and the trainer.

The JAX references run as its own tests run them: ``build_model(cfg)`` with
``attn_impl="xla"`` and ``"pallas_interpret"`` (the ssd and flash kernels in
interpret mode).  Weights are drawn once in JAX, passed through numpy and
carried into the port by path.  Tolerances: the loss at 1e-4 relative,
gradients at 1e-4 (``tests/test_kernels.py``), decode logits at 1e-4 of the
largest logit, layer outputs at 2e-4 (the ssd tolerance); decode against the
train forward at 2e-2 (``tests/test_models.py``).
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
from repro.launch.serve import Server as JaxServer
from repro.launch.serve import ServeJob as JaxServeJob
from repro.launch.steps import init_state as jax_init_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build_model
from repro.models.param import materialize as jax_materialize
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.launch.serve import Server, ServeJob
from repro_torch.launch.steps import make_train_step, train_state_specs
from repro_torch.launch.train import Trainer, TrainJob
from repro_torch.models import build_model, from_numpy_tree, named_leaves
from repro_torch.models import ssm
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import unflatten
from repro_torch.optim import AdamW, cosine_schedule

RTOL = 1e-4
GRAD_TOL = 1e-4
SSD_TOL = 2e-4
ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
JAX_IMPLS = ["xla", "pallas_interpret"]


def _configs(arch, **kw):
    jcfg = jax_reduce_for_smoke(jax_get_arch(arch)).with_(**kw)
    cfg = reduce_for_smoke(get_arch(arch)).with_(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _perturb(tree, seed):
    """Constant leaves (norm scales, D, conv bias) get noise so that the
    comparison sees them."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a.astype(np.float32)
                    + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(perturb, tree)


def _batch(cfg, B=2, S=64, seed=0):
    """S=64 is two of the smoke configs' 32-token chunks."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "loss_mask": (rng.uniform(size=(B, S)) < 0.9).astype(np.float32)}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------ mamba2 layer
def _layer(seed=0, S=64):
    """One mamba2 layer of the smoke config: its numpy params and an input."""
    jcfg, cfg = _configs("mamba2-1.3b")
    specs = jax_ssm.ssm_specs(jcfg)
    params = _perturb(jax_materialize(specs, jax.random.PRNGKey(seed)), seed)
    u = (np.random.default_rng(seed).standard_normal((2, S, cfg.d_model))
         * 0.5).astype(np.float32)
    return jcfg, cfg, params, u


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_mamba2_forward_matches_jax(impl, jax_impl):
    jcfg, cfg, params, u = _layer()
    want, want_st = jax_ssm.mamba2_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(u), jcfg,
        impl="pallas_interpret" if jax_impl == "pallas" else "xla",
        return_state=True)
    got, st = ssm.mamba2_forward(from_numpy_tree(params, "cpu"),
                                 torch.from_numpy(u), cfg, impl=impl,
                                 return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_mamba2_forward_with_initial_state_matches_jax():
    jcfg, cfg, params, u = _layer(seed=1)
    nh, s = cfg.ssm_heads, cfg.ssm
    h0 = np.random.default_rng(2).standard_normal(
        (2, nh, s.d_state, s.head_dim)).astype(np.float32)
    want = jax_ssm.mamba2_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(u), jcfg,
                                  init_state=jnp.asarray(h0))
    got = ssm.mamba2_forward(from_numpy_tree(params, "cpu"),
                             torch.from_numpy(u), cfg, impl="torch",
                             init_state=torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_mamba2_decode_steps_match_jax():
    """40 steps of the O(1) recurrence, past one 32-token chunk."""
    jcfg, cfg, params, u = _layer(seed=3, S=40)
    s = cfg.ssm
    conv_dim = cfg.expand_dim + 2 * s.n_groups * s.d_state
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = from_numpy_tree(params, "cpu")
    jst = jnp.zeros((2, cfg.ssm_heads, s.d_state, s.head_dim), jnp.float32)
    jcs = jnp.zeros((2, s.conv_kernel - 1, conv_dim), jnp.float32)
    st, cs = torch.zeros(jst.shape), torch.zeros(jcs.shape)
    step = jax.jit(functools.partial(jax_ssm.mamba2_decode_step, cfg=jcfg))
    for t in range(u.shape[1]):
        want, jst, jcs = step(jparams, jnp.asarray(u[:, t:t + 1]), jst, jcs)
        got, st, cs = ssm.mamba2_decode_step(
            tparams, torch.from_numpy(u[:, t:t + 1]), st, cs, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSD_TOL,
                                   rtol=SSD_TOL, err_msg=str(t))
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_kernel_impl_rejects_initial_state_and_ragged_s():
    _, cfg, params, u = _layer(seed=4)
    tparams = from_numpy_tree(params, "cpu")
    h0 = torch.zeros(2, cfg.ssm_heads, cfg.ssm.d_state, cfg.ssm.head_dim)
    with pytest.raises(ValueError, match="initial state"):
        ssm.mamba2_forward(tparams, torch.from_numpy(u), cfg, impl="kernel",
                           init_state=h0)
    for impl in ("kernel", "torch"):     # 48 tokens: 1.5 chunks of 32
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ssm.mamba2_forward(tparams, torch.from_numpy(u[:, :48]), cfg,
                               impl=impl)
    with pytest.raises(ValueError, match="unknown ssm impl"):
        ssm.mamba2_forward(tparams, torch.from_numpy(u), cfg, impl="xla")


# ------------------------------------------------------- loss and gradients
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, jax_impl):
    jcfg, cfg = _configs(arch)
    jmodel = jax_build_model(jcfg, attn_impl=jax_impl)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0))), seed=1)
    batch = _batch(cfg, seed=2)
    (loss, _), grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params), _to_jax(batch))
    return (np_params, batch, float(loss),
            dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads))))


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat, jax_impl):
    np_params, batch, jloss, jgrads = _jax_loss_and_grads(arch, jax_impl)
    _, cfg = _configs(arch)
    model = build_model(cfg.with_(remat=remat))   # remat changes no number
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    paths, leaves = zip(*named_leaves(params))
    leaves = [p.requires_grad_() for p in leaves]
    loss, metrics = model.loss_fn(unflatten(zip(paths, leaves)),
                                  _to_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - jloss) <= RTOL * abs(jloss), (loss.item(), jloss)
    assert metrics["ce"].item() == loss.item()
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_impl_gives_the_same_loss(arch):
    np_params, batch, jloss, _ = _jax_loss_and_grads(arch, "xla")
    _, cfg = _configs(arch)
    for impl in ("kernel", "torch"):
        model = build_model(cfg, attn_impl=impl)
        params = from_numpy_tree(np_params, "cpu", model.param_specs())
        loss = model.loss_fn(params, _to_torch(batch))[0].item()
        assert abs(loss - jloss) <= RTOL * abs(jloss), (impl, loss, jloss)


# ---------------------------------------------------------------- train step
EPS = 1e-6   # see tests/test_torch_train.py: AdamW's eps on noise gradients


def test_three_train_steps_match_jax():
    jcfg, cfg = _configs("mamba2-1.3b")
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
        batch = _batch(cfg, B=4, S=64, seed=10 + i)
        jstate, jmetrics = jstep(jstate, _to_jax(batch))
        state, metrics = step(state, _to_torch(batch))
        for key in ("loss", "grad_norm"):
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
    return np.stack(out)


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_jax(arch, jax_impl):
    jcfg, cfg = _configs(arch)
    jmodel = jax_build_model(jcfg, attn_impl=jax_impl)
    np_params = _perturb(jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1))), seed=1)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = _jax_logits(jmodel, np_params, tokens)
    for impl in ("kernel", "torch"):
        model = build_model(cfg, attn_impl=impl)
        params = from_numpy_tree(np_params, "cpu", model.param_specs())
        got = _torch_logits(model, params, tokens)
        assert got.shape == want.shape and np.isfinite(got).all()
        err = _rel_err(got, want)
        assert err <= RTOL, (arch, jax_impl, impl, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_train_forward(arch):
    """tests/test_models.py's rule on the port alone: the logits of every
    decoded position against the train forward's, at 2e-2 relative; 64
    positions are two chunks, so the chunked scan's carried state is held
    against the recurrence."""
    np_params, batch, _, _ = _jax_loss_and_grads(arch, "xla")
    _, cfg = _configs(arch)
    model = build_model(cfg)
    params = from_numpy_tree(np_params, "cpu", model.param_specs())
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = model._embed_tokens(params, _to_torch(batch))
    h = model.backbone(params, h, torch.arange(S).expand(B, S))
    want = model._logits(params, rmsnorm(params["final_ln"], h, cfg.norm_eps))
    want = want.detach().numpy().transpose(1, 0, 2)
    got = _torch_logits(model, params, tokens)
    for t in range(S):
        assert _rel_err(got[t], want[t]) < 2e-2, t


def test_cache_specs_match_jax():
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        jspecs = jax_build_model(jcfg).cache_specs(3, 50)
        specs = build_model(cfg).cache_specs(3, 50)
        want = dict(named_leaves(jax.tree_util.tree_map(
            lambda s: s, jspecs, is_leaf=lambda x: not isinstance(x, dict))))
        got = dict(named_leaves(specs))
        assert list(got) == list(want), arch
        for path, s in got.items():
            w = want[path]
            assert (s.shape, s.dtype, s.init) == (w.shape, w.dtype, w.init), \
                (arch, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_jax_server(arch):
    kw = dict(arch=arch, batch=2, prompt_len=8, max_new_tokens=6)
    jsrv = JaxServer(JaxServeJob(**kw))
    prompts = np.random.default_rng(0).integers(
        0, jsrv.cfg.vocab_size, (2, 8)).astype(np.int32)
    want = jsrv.generate(prompts)
    np_params = jax.tree_util.tree_map(np.asarray, jsrv.params)
    srv = Server(ServeJob(**kw), params=from_numpy_tree(np_params, "cpu"),
                 device="cpu")
    np.testing.assert_array_equal(srv.generate(prompts), want)
    assert srv.stats["tokens"] == 2 * 6


# ------------------------------------------------------------------- trainer
def test_trainer_runs_and_checkpoints_mamba2():
    job = TrainJob(arch="mamba2-1.3b", steps=12, global_batch=4, seq_len=64,
                   lr=3e-3, warmup=2, checkpoint_every=6, num_docs=12,
                   log_every=100, device="cpu")
    launches = ssd.launches
    t = Trainer(job)
    out = t.run(restore=False)
    assert out["final_step"] == 12
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert t.ckpt.latest_step() == 12
    assert ssd.launches == launches        # the CPU runs the plain version
    again = Trainer(dataclasses.replace(job, steps=13), ckpt=t.ckpt,
                    data_ds=t.data_ds)
    out = again.run(restore=True)
    assert out["history"][0]["step"] == 12 and out["final_step"] == 13
