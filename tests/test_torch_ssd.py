"""The port's SSD scan (``ssd_chunked``, ``ssd_reference`` and the kernel
wrapper ``ops.ssd``) on the CPU against the JAX package's.

On the CPU the wrapper's forward is ``ssd_chunked``; it is held here against
JAX's ``ssd_chunked``, its oracle ``ref_ssd`` and its Pallas kernel in
interpret mode; its backward recomputes through ``ssd_chunked``, as JAX's
custom VJP does.  The CUDA kernel itself is held against the plain version
on the card by ``chip_smoke.py``.  Tolerances are ``tests/test_kernels.py``'s:
2e-4 for the ssd values, 1e-4 for gradients, and 2e-2 for bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ref_ssd as jax_ref_ssd
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops, ref_ssd, ssd
from repro_torch.models.ssm import _segsum, ssd_chunked, ssd_reference

TOL = 2e-4
GRAD_TOL = 1e-4
BF16_TOL = 2e-2

# the shapes of tests/test_kernels.py::test_ssd_sweep (B, S, nh, P, G, N, Q)
SWEEP = [
    (2, 128, 4, 32, 1, 16, 32),
    (1, 256, 8, 64, 2, 32, 64),
    (2, 64, 2, 16, 1, 8, 64),            # single chunk
    (1, 96, 4, 32, 4, 16, 32),           # groups == heads/1
]


def _inputs(B, S, nh, P, G, N, seed=0):
    """test_ssd_sweep's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((B, S, nh, P)) * 0.5).astype(np.float32),
        rng.uniform(1e-3, 0.1, (B, S, nh)).astype(np.float32),
        (-rng.uniform(0.5, 4.0, (nh,))).astype(np.float32),
        (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32),
        (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32),
    )


def _jax(arrays, dtype=jnp.float32):
    x, dt, A, Bm, Cm = arrays
    return (jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype))


def _torch(arrays, dtype=torch.float32):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


PAIRS = {
    # the port's function, and the JAX function it is held against
    "chunked": (lambda *a, Q: ssd_chunked(*a, chunk=Q),
                lambda *a, Q: jax_ssd_chunked(*a, chunk=Q)),
    "reference": (lambda *a, Q: ssd_reference(*a),
                  lambda *a, Q: jax_ref_ssd(*a)),
    "ops_vs_kernel": (lambda *a, Q: ssd(*a, chunk=Q),
                      lambda *a, Q: jax_ssd(*a, Q, True)),
    "ops_vs_oracle": (lambda *a, Q: ssd(*a, chunk=Q),
                      lambda *a, Q: jax_ref_ssd(*a)),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("B,S,nh,P,G,N,Q", SWEEP)
def test_ssd_matches_jax(pair, B, S, nh, P, G, N, Q):
    arrays = _inputs(B, S, nh, P, G, N)
    ours, theirs = PAIRS[pair]
    y, st = ours(*_torch(arrays), Q=Q)
    yw, stw = theirs(*_jax(arrays), Q=Q)
    assert y.shape == (B, S, nh, P) and y.dtype == torch.float32
    assert st.shape == (B, nh, N, P) and st.dtype == torch.float32
    _close(y, yw, TOL)
    _close(st, stw, TOL)


@pytest.mark.parametrize("B,S,nh,P,G,N,Q", SWEEP)
def test_ssd_grads_match_jax_kernel(B, S, nh, P, G, N, Q):
    """Gradients of all five inputs through ``ops.ssd`` against ``jax.vjp``
    through JAX's interpreted kernel, for cotangents on y and on the state."""
    arrays = _inputs(B, S, nh, P, G, N, seed=1)
    rng = np.random.default_rng(2)
    gy = rng.standard_normal((B, S, nh, P)).astype(np.float32)
    gst = rng.standard_normal((B, nh, N, P)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_ssd(*a, Q, True), *_jax(arrays))
    want = vjp((jnp.asarray(gy), jnp.asarray(gst)))
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    y, st = ssd(*inputs, chunk=Q)
    got = torch.autograd.grad((y, st), inputs,
                              (torch.from_numpy(gy), torch.from_numpy(gst)))
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("output", ["y", "state"])
def test_ssd_grad_of_one_output_matches_jax(output):
    """A loss of y alone (or the state alone) gives the other output no
    gradient: the backward takes it as zeros, as JAX does."""
    arrays = _inputs(1, 64, 2, 16, 1, 8, seed=3)
    which = 0 if output == "y" else 1

    def f(x_):
        return jax_ssd(x_, *_jax(arrays)[1:], 32, True)[which].sum()
    want = jax.grad(f)(_jax(arrays)[0])
    x, *rest = _torch(arrays)
    x.requires_grad_()
    ssd(x, *rest, chunk=32)[which].sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("fn", ["ops", "chunked"])
def test_ssd_bf16_matches_jax_kernel(fn):
    """bf16 inputs: the port's plain version (which ``ops.ssd`` runs on the
    CPU) against JAX's interpreted kernel, which computes in fp32."""
    B, S, nh, P, G, N, Q = SWEEP[1]
    arrays = _inputs(B, S, nh, P, G, N, seed=4)
    yw, stw = jax_ssd(*_jax(arrays, jnp.bfloat16), Q, True)
    t = _torch(arrays, torch.bfloat16)
    y, st = ssd(*t, chunk=Q) if fn == "ops" else ssd_chunked(*t, chunk=Q)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    _close(y, yw, BF16_TOL)
    _close(st, stw, BF16_TOL)


def test_ssd_init_state_matches_jax():
    arrays = _inputs(2, 128, 4, 32, 1, 16, seed=5)
    h0 = np.random.default_rng(6).standard_normal((2, 4, 16, 32)).astype(
        np.float32)
    yw, stw = jax_ssd_chunked(*_jax(arrays), chunk=32, init_state=jnp.asarray(h0))
    rw, rstw = jax_ref_ssd(*_jax(arrays), init_state=jnp.asarray(h0))
    y, st = ssd_chunked(*_torch(arrays), chunk=32,
                        init_state=torch.from_numpy(h0))
    r, rst = ssd_reference(*_torch(arrays), init_state=torch.from_numpy(h0))
    for got, want in ((y, yw), (st, stw), (r, rw), (rst, rstw)):
        _close(got, want, TOL)


def test_segsum_masks_before_exp_so_gradients_are_finite():
    a = -torch.rand(2, 3, 16, dtype=torch.float64) * 30
    a.requires_grad_()
    L = torch.exp(_segsum(a))
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    L.sum().backward()
    assert torch.isfinite(a.grad).all()


def test_ref_ssd_is_the_model_oracle():
    assert ref_ssd is ssd_reference


def test_ssd_rejects_ragged_s_bad_shapes_and_devices():
    x, dt, A, Bm, Cm = _torch(_inputs(1, 96, 4, 16, 1, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(x, dt, A, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_chunked(x, dt, A, Bm, Cm, chunk=64)
    with pytest.raises(ValueError):
        ssd(x, dt[:, :-1], A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError):
        ssd(x, dt, A, Bm[:, :, :, :4], Cm, chunk=32)
    with pytest.raises(ValueError):    # 4 heads do not split into 3 groups
        ssd(x, dt, A, Bm.repeat(1, 1, 3, 1), Cm.repeat(1, 1, 3, 1), chunk=32)
    with pytest.raises(ValueError):    # neither CPU nor CUDA
        ssd(*(t.to("meta") for t in (x, dt, A, Bm, Cm)), chunk=32)


def test_cpu_forward_launches_no_kernel():
    before = ssd.launches
    ssd(*_torch(_inputs(1, 64, 2, 16, 1, 8)), chunk=32)
    assert ssd.launches == before
    assert ops.SOURCE.exists() and ops.SOURCE.suffix == ".cu"
