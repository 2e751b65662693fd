"""The port's SSD scan (``ssd_chunked``, ``ssd_reference`` and the kernel
wrapper ``ops.ssd``) on the CPU against the JAX package's.

On the CPU the wrapper's forward is ``ssd_chunked``; it is held here against
JAX's ``ssd_chunked``, its oracle ``ref_ssd`` and its Pallas kernel in
interpret mode; its backward recomputes through ``ssd_chunked``, as JAX's
custom VJP does.  The CUDA kernels themselves are held against the plain
version on the card by ``chip_smoke.py``.  Tolerances are
``tests/test_kernels.py``'s: 2e-4 for the ssd values, 1e-4 for gradients,
and 2e-2 for bf16.

The bf16 route's four passes are emulated in plain torch (``_emulate_passes``:
C·Bᵀ in fp32, M, w∘B and h_prev as bf16 hi/lo pairs, each 16-wide MMA step
added to an fp32 accumulator in the kernel's order) and held to the card's
gates against JAX's interpreted kernel: ``2e-2`` on bf16, half a bf16 ulp
against fp32 (``2e-5 + 2**-8 |y32|``), and the state within the fp32 ``2e-5``.
What of the launch plan runs in Python (tile constants, shared memory, grids,
strides) is checked against the CUDA source.
"""

import functools
import re

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
CARD_TOL = 2e-5          # chip_smoke.py's fp32 gate
HALF_ULP = 2.0 ** -8     # half a bf16 ulp, relative
SM_SHARED = 232448       # the most shared memory an H100 block may have

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


# ----------------------------------------------- the bf16 route's arithmetic
def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _parts(v, split: bool):
    """v (fp32) as the MMA takes it: hi = bf16(v), lo = bf16(v - hi); or one
    bf16 alone."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def _mma(parts, b, acc):
    """acc (fp32) plus the sum of each of ``parts`` (..., M, K) times b
    (..., K, N), 16 columns of K at a time, each part's step an exact
    product added into the fp32 accumulator, as m16n8k16 MMAs do."""
    K = b.shape[-2]
    for k in range(0, K, 16):
        for a in parts:
            step = a[..., k:k + 16].double() @ b[..., k:k + 16, :].double()
            acc = (acc.double() + step).float()
    return acc


def _emulate_passes(x, dt, A, Bm, Cm, Q, split=("M", "W", "H")):
    """The bf16 route's four passes in plain torch on fp32 tensors whose x,
    B and C hold bf16 values: chunk state, C·Bᵀ, state passing, chunk scan.
    ``split`` names the operands carried as hi/lo pairs (M, w∘B, h_prev);
    the others go in as one bf16.  -> y (rounded to bf16), final state."""
    Bsz, S, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, nh, P).movedim(3, 2)          # (B,nc,nh,Q,P)
    Bc = Bm.reshape(Bsz, nc, Q, G, N).movedim(3, 2)          # (B,nc,G,Q,N)
    Cc = Cm.reshape(Bsz, nc, Q, G, N).movedim(3, 2)
    Bh = Bc.repeat_interleave(nh // G, dim=2)                # (B,nc,nh,Q,N)
    Ch = Cc.repeat_interleave(nh // G, dim=2)
    dth = dt.reshape(Bsz, nc, Q, nh).movedim(3, 2)           # (B,nc,nh,Q)
    # pass 1: a_cum, w = dt exp(a_tot - a_cum), states = (w o B)^T X
    a_cum = torch.cumsum(dth * A[:, None], dim=-1)
    a_tot = a_cum[..., -1:]
    w = dth * torch.exp(a_tot - a_cum)
    wb = (w[..., None] * Bh).transpose(-1, -2)               # (B,nc,nh,N,Q)
    states = _mma(_parts(wb, "W" in split), xc,
                  torch.zeros(Bsz, nc, nh, N, P))
    # pass 2: C·Bᵀ once per group, fp32
    cb = _mma((Cc,), Bc.transpose(-1, -2), torch.zeros(Bsz, nc, G, Q, Q))
    cb = cb.repeat_interleave(nh // G, dim=2)                # (B,nc,nh,Q,Q)
    # pass 3: the state before each chunk
    h = torch.zeros(Bsz, nh, N, P)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(a_tot[:, c, :, 0])[..., None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nc,nh,N,P)
    # pass 4: exp(a_cum_i) (C h_prev) + sum_j M_ij x_j, j <= i
    inter = torch.zeros(Bsz, nc, nh, Q, P)
    for k in range(0, N, 16):
        for part in _parts(h_prev, "H" in split):
            step = Ch[..., k:k + 16].double() @ part[..., k:k + 16, :].double()
            inter = (inter.double() + step).float()
    acc = inter * torch.exp(a_cum)[..., None]
    ii = torch.arange(Q)
    M = cb * torch.exp(a_cum[..., :, None] - a_cum[..., None, :]) \
        * dth[..., None, :]
    M = torch.where(ii[:, None] >= ii[None, :], M, torch.zeros(()))
    acc = _mma(_parts(M, "M" in split), xc, acc)
    y = acc.movedim(2, 3).reshape(Bsz, S, nh, P)
    return _bf16(y), h


def _card_inputs(B, S, nh, P, G, N, seed=0):
    """chip_smoke.py::_ssd_inputs' draws (numpy), with x, B and C rounded to
    bf16 as the card's bf16 cases hold them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, P), dtype=np.float32) * 0.5
    dt = rng.uniform(1e-3, 0.1, (B, S, nh))
    A = -rng.uniform(0.5, 4.0, (nh,))
    Bm = rng.standard_normal((B, S, G, N), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((B, S, G, N), dtype=np.float32) * 0.3
    t = [torch.from_numpy(np.asarray(a, np.float32))
         for a in (x, dt, A, Bm, Cm)]
    for i in (0, 3, 4):
        t[i] = _bf16(t[i])
    return t


@functools.lru_cache(maxsize=None)
def _jax_card_refs(B, S, nh, P, G, N, Q):
    """JAX's interpreted kernel on the card inputs: y from bf16 inputs, and
    y and the state from the same values in fp32."""
    t = _card_inputs(B, S, nh, P, G, N)
    arrays = [a.numpy() for a in t]
    y16, _ = jax_ssd(*_jax(arrays, jnp.bfloat16), Q, True)
    y32, st32 = jax_ssd(*_jax(arrays), Q, True)
    return (torch.from_numpy(np.asarray(y16, np.float32)),
            torch.from_numpy(np.array(y32)), torch.from_numpy(np.array(st32)))


def _gate_misses(B, S, nh, P, G, N, Q, split=("M", "W", "H")):
    """Outputs of the emulated passes outside each of the card's gates."""
    y, st = _emulate_passes(*_card_inputs(B, S, nh, P, G, N), Q, split)
    y16, y32, st32 = _jax_card_refs(B, S, nh, P, G, N, Q)
    return {
        "bf16": int(((y - y16).abs() > BF16_TOL + BF16_TOL * y16.abs()).sum()),
        "fp32": int(((y - y32).abs() > CARD_TOL + HALF_ULP * y32.abs()).sum()),
        "state": int(((st - st32).abs() > CARD_TOL + CARD_TOL * st32.abs())
                     .sum()),
    }


# (B, S, nh, P, G, N, Q): the sweep, a ragged chunk (Q = S = 200), widths
# the kernel reads an element at a time (N=12, P=20; N=4, P=7, Q=50), and
# mamba2's widths at a short S
EMULATED = SWEEP + [(2, 200, 4, 16, 1, 8, 200), (1, 128, 2, 20, 1, 12, 64),
                    (1, 100, 3, 7, 1, 4, 50), (1, 512, 2, 64, 1, 128, 256)]


@pytest.mark.parametrize("B,S,nh,P,G,N,Q", EMULATED)
def test_emulated_passes_meet_the_card_gates(B, S, nh, P, G, N, Q):
    assert _gate_misses(B, S, nh, P, G, N, Q) == \
        {"bf16": 0, "fp32": 0, "state": 0}


# B1 S1024 nh4 P64 N128 Q256, seed 0: each of M, w∘B and h_prev taken as one
# bf16 (the other two as hi/lo pairs) misses the fp32 gate; all three as
# pairs meet it
@pytest.mark.parametrize("single", [None, "M", "W", "H"])
def test_each_fp32_operand_needs_its_hi_lo_pair(single):
    split = tuple(op for op in ("M", "W", "H") if op != single)
    misses = _gate_misses(1, 1024, 4, 64, 1, 128, 256, split)
    if single is None:
        assert misses == {"bf16": 0, "fp32": 0, "state": 0}
    else:
        assert misses["fp32"] > 0, misses


# ------------------------------------------------- the bf16 route's launches
def test_constants_mirror_the_cuda_source():
    src = ops.SOURCE.read_text()

    def constexpr(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert constexpr("kMaxN") == ops.MAX_N
    assert constexpr("kMaxP") == ops.MAX_P
    assert constexpr("kMaxQ") == ops.MAX_Q
    assert constexpr("kMT") == ops.TILE
    assert constexpr("kMmaThreads") == ops.MMA_THREADS
    assert constexpr("kCBRows") == ops.CB_ROWS
    assert constexpr("kCBThreads") == ops.CB_THREADS
    assert constexpr("kPassThreads") == ops.PASS_THREADS
    # two warps of 16 rows make a C·Bᵀ block, four an MMA block
    assert ops.CB_THREADS // 32 * 16 == ops.CB_ROWS
    assert ops.MMA_THREADS // 32 * 16 == ops.TILE
    # each P rounded up to 16 has its instantiation
    assert re.findall(r"PP == (\d+)\)\s*return launch_mma<\1>", src) == \
        ["16", "32", "48"]
    assert "return launch_mma<64>" in src
    # a chunk-state block takes 64 state rows, or all 128 past N = 64
    assert "NP > kMT ? 2 * kMT : kMT" in src
    assert [ops.state_rows(N) for N in (4, 64, 68, 128)] == [64, 64, 128, 128]


@pytest.mark.parametrize("Q", [1, 8, 16, 63, 64, 65, 96, 200, 256, 512, 1000,
                               1024])
def test_every_pass_fits_shared_memory(Q):
    for N in range(4, ops.MAX_N + 1, 4):
        for P in range(1, ops.MAX_P + 1):
            smem = ops.smem_bytes(N, P, Q)
            assert max(smem.values()) <= SM_SHARED, (N, P, Q, smem)
    # at mamba2's widths three chunk-scan blocks share an SM
    assert 3 * (ops.smem_bytes(128, 64, 256)["chunk_scan"] + 1024) \
        <= 228 * 1024


# the three timed shapes (B, S, nh, P, G, N, Q): mamba2's training shape,
# zamba2's, and a long sequence at mamba2's widths
TIMED = [(4, 2048, 64, 64, 1, 128, 256), (2, 1024, 80, 64, 1, 64, 256),
         (1, 32768, 64, 64, 1, 128, 256)]


@pytest.mark.parametrize("B,S,nh,P,G,N,Q", TIMED)
def test_grids_fill_the_card(B, S, nh, P, G, N, Q):
    blocks = ops.grids(B, S, nh, P, G, N, Q)
    assert set(blocks) == {"chunk_state", "chunk_cb", "state_pass",
                           "chunk_scan"}
    assert min(blocks.values()) >= 132, blocks
    # the chunk scan: a block per (b, chunk, head, 64-row tile)
    assert blocks["chunk_scan"] == B * (S // Q) * nh * (Q // 64)


@pytest.mark.parametrize("B,S,nh,P,G,N,Q,mb", [
    (4, 2048, 64, 64, 1, 128, 256, (67.1, 8.4, 2.1)),
    (1, 32768, 64, 64, 1, 128, 256, (268.4, 33.6, 8.4))])
def test_scratch_sizes(B, S, nh, P, G, N, Q, mb):
    shapes = ops.scratch_shapes(B, S, nh, P, G, N, Q)
    got = tuple(round(4 * int(np.prod(shapes[k])) / 1e6, 1)
                for k in ("states", "cb", "acum"))
    assert got == mb
    # a ragged chunk's C·Bᵀ rows are padded to whole 64-row tiles
    assert ops.scratch_shapes(2, 200, 4, 16, 1, 8, 200)["cb"] == \
        (2, 1, 1, 256, 256)


def test_xbc_views_pass_their_own_strides():
    """x, B and C as ``mamba2_forward`` slices them from its conv output go to
    the bf16 passes with the view's own strides, and are not copied."""
    B, S, nh, P, G, N = 2, 64, 4, 16, 1, 8
    conv_dim = nh * P + 2 * G * N
    xbc = torch.randn(B, S, conv_dim).to(torch.bfloat16)
    d_in = nh * P
    views = (xbc[..., :d_in].reshape(B, S, nh, P),
             xbc[..., d_in:d_in + G * N].reshape(B, S, G, N),
             xbc[..., d_in + G * N:].reshape(B, S, G, N))
    for v in views:
        assert not v.is_contiguous()
        t, strides = ops._strided(v)
        assert t is v and t.data_ptr() == v.data_ptr()
        assert strides == v.stride()[:3]
        assert strides[1] == conv_dim
    # a last dimension that is not contiguous is copied
    odd = torch.randn(B, S, 2 * d_in)[..., ::2].reshape(B, S, nh, P)
    t, strides = ops._strided(odd)
    assert t.is_contiguous() and strides == (S * nh * P, nh * P, P)
