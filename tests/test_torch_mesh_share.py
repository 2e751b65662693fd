"""Each rank's share on a mesh, on gloo ranks on the CPU: the vocab-parallel
cross entropy and ``moe_apply`` on expert shards, against the JAX package's
functions on the whole arrays and against the port with no mesh.

The ranks are 4 processes running ``_torch_dist_tasks.py share``; the
references are made here while they run.  Tolerances: the loss at 2e-5 and
its gradient at 1e-4 (fp32); the MoE layer's output and aux loss at
``test_torch_moe.py``'s 2e-5 against JAX and its gradients at 1e-4; the
output bit for bit against the port with no mesh (which assignments drop,
and the order the combine adds a token's rows in, are the same), the aux
loss and gradients there at 1e-5 (their sums over tokens meet across ranks
in another order), as is the output where a shared expert's hidden dim is
split over the model axis (its product is such a sum).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce_for_smoke
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch.models import moe
from repro_torch.models.layers import softmax_cross_entropy

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dist_tasks as tasks  # noqa: E402
from test_torch_distributed import _join, _start  # noqa: E402

CE_TOL, CE_GRAD_TOL = 2e-5, 1e-4
MOE_TOL, MOE_GRAD_TOL, MESHLESS_TOL = 2e-5, 1e-4, 1e-5


def _jax_cfg(cfg):
    jcfg = jax_reduce_for_smoke(jax_get_arch("granite-moe-1b-a400m"))
    jcfg = jcfg.with_(moe=dataclasses.replace(
        jcfg.moe, **dataclasses.asdict(cfg.moe)))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg


def _meshless_moe(cfg, params, x, g):
    """The port with no mesh: (out, aux, dx, {path: grad}, keep)."""
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(tp, tx, cfg)
    (torch.sum(out * torch.from_numpy(g)) + 3 * aux).backward()
    T = x.shape[0] * x.shape[1]
    idx, _, _ = moe._route(tp, tx.detach().reshape(T, -1), cfg)
    keep = moe.dispatch(idx, moe.capacity(T, cfg), cfg.moe.num_experts)[3]
    return (out.detach().numpy(), aux.item(), tx.grad.numpy(),
            {k: t.grad.numpy() for k, t in tp.items()}, keep.numpy())


def _jax_moe(cfg, params, x, g):
    """JAX's layer on the whole arrays: (out, aux, dx, {path: grad})."""
    jcfg = _jax_cfg(cfg)

    def loss(p, xx):
        out, aux = jax_moe.moe_apply(p, xx, jcfg)
        return jnp.sum(out * g) + 3.0 * aux, (out, aux)
    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return (np.asarray(out), float(aux), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()})


@pytest.fixture(scope="module")
def share(tmp_path_factory):
    """Every rank's results, and the references: JAX's loss and gradient
    for each case, and JAX's and the meshless port's MoE layer."""
    procs, outs = _start(tmp_path_factory.mktemp("share"), "share", 4)
    try:
        ce = {}
        for name, (logits, targets, mask, _) in tasks.ce_cases().items():
            fn = lambda l: jax_layers.softmax_cross_entropy(
                l, jnp.asarray(targets),
                None if mask is None else jnp.asarray(mask))
            value, grad = jax.value_and_grad(fn)(jnp.asarray(logits))
            ce[name] = (float(value), np.asarray(grad))
        ref = {}
        for variant in tasks.MOE_VARIANTS:
            cfg = tasks.moe_config(variant)
            inputs = tasks.moe_inputs(cfg)
            ref[variant] = {"jax": _jax_moe(cfg, *inputs),
                            "port": _meshless_moe(cfg, *inputs)}
    finally:
        results = _join(procs, outs, timeout=400)
    return results, ce, ref


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("shape", tasks.SHARE_MESHES["ce"],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", list(tasks.ce_cases()))
def test_vocab_parallel_loss_matches_jax(share, shape, case):
    """Value and gradient against ``jax.value_and_grad`` of JAX's loss on
    the whole logits; each rank held only its share of them."""
    results, ce, _ = share
    logits, targets, _, _ = tasks.ce_cases()[case]
    V = logits.shape[-1]
    # the targets fall in every vocabulary shard
    assert len(set((targets.reshape(-1) * 4) // V)) == 4
    want_loss, want_grad = ce[case]
    data, model = shape
    for out in results:
        got = out["ce", shape, case]
        assert got["local"] == (logits.shape[0] // data,) + \
            logits.shape[1:-1] + (V // model,)
        assert abs(float(got["loss"]) - want_loss) <= CE_TOL * abs(want_loss)
        _close(got["grad"], want_grad, CE_GRAD_TOL)


def test_meshless_loss_is_unchanged():
    """With no mesh the loss is the plain arithmetic it was: logsumexp
    minus the gathered gold logit, masked, in fp32."""
    logits, targets, mask, _ = tasks.ce_cases()["masked"]
    lt = torch.from_numpy(logits)
    tt = torch.from_numpy(targets)
    m = torch.from_numpy(mask)
    got = softmax_cross_entropy(lt, tt, m)
    nll = torch.logsumexp(lt, -1) - torch.gather(lt, -1, tt[..., None])[..., 0]
    assert torch.equal(got, torch.sum(nll * m) / torch.clamp(m.sum(), min=1.0))


@pytest.mark.parametrize("shape", tasks.SHARE_MESHES["moe"],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", list(tasks.MOE_VARIANTS))
def test_moe_on_expert_shards_matches_jax_and_the_meshless_port(
        share, shape, variant):
    results, _, ref = share
    out, aux, dx, grads = ref[variant]["jax"]
    p_out, p_aux, p_dx, p_grads, keep = ref[variant]["port"]
    assert not keep.all()                       # the router overflows
    cfg = tasks.moe_config(variant)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    for r in results:
        got = r["moe", shape, variant]
        assert got["wi_local"] == (E // shape[1], d, f)
        if cfg.moe.num_shared and shape[1] > 1:
            # the shared expert's product over its model-split hidden dim
            # is a sum across ranks
            _close(got["out"], p_out, MESHLESS_TOL)
        else:
            np.testing.assert_array_equal(got["out"], p_out)
        _close(got["out"], out, MOE_TOL)
        assert abs(float(got["aux"]) - aux) <= MOE_TOL * abs(aux)
        assert abs(float(got["aux"]) - p_aux) <= MESHLESS_TOL * abs(p_aux)
        _close(got["dx"], dx, MOE_GRAD_TOL)
        _close(got["dx"], p_dx, MESHLESS_TOL)
        assert sorted(got["grads"]) == sorted(grads)
        for k, want in grads.items():
            _close(got["grads"][k], want, MOE_GRAD_TOL)
            _close(got["grads"][k], p_grads[k], MESHLESS_TOL)
