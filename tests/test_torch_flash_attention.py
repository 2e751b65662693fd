"""The port's flash attention and blockwise attention on the CPU against the
JAX package's.

On the CPU the wrapper's forward is its plain version, held here against the
JAX oracle and the Pallas kernel in interpret mode; its backward recomputes
through the plain version, as JAX's custom VJP does.  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py``.
Tolerances are ``tests/test_kernels.py``'s: ``TOL`` for values, 1e-4 for
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import ref_attention as jax_ref_attention
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.kernels.flash_attention import flash_attention, ref_attention
from repro_torch.models.attention import blockwise_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the shapes of tests/test_kernels.py::test_flash_attention_sweep
SWEEP = [
    (2, 256, 4, 2, 64, 0, 128, 128),
    (1, 512, 8, 1, 128, 0, 128, 256),    # MQA
    (2, 256, 4, 4, 64, 96, 64, 64),      # sliding window
    (1, 384, 6, 2, 32, 0, 128, 128),     # non-pow2 heads, padded seq
]
# what the CUDA kernel takes beyond the TPU kernel: S not a tile multiple,
# D of 40 and 96 (phi-3-vision's head dim)
RAGGED = [
    (1, 77, 4, 1, 40, 0),
    (2, 100, 6, 2, 96, 0),
    (1, 130, 2, 2, 32, 50),
]


def _inputs(B, S, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,bq,bk", SWEEP)
def test_flash_attention_matches_jax(dtype, B, S, H, Hkv, D, window, bq, bk):
    arrays = _inputs(B, S, H, Hkv, D)
    jq, jk, jv = _jax(arrays, dtype)
    tq, tk, tv = _torch(arrays, dtype)
    kernel = jax_flash_attention(jq, jk, jv, True, window, None, bq, bk, True)
    oracle = jax_ref_attention(jq, jk, jv, causal=True, window=window)
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    plain = ref_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, S, H, D)
    for ours in (got, plain):
        _close(ours, kernel, TOL[dtype])
        _close(ours, oracle, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window", RAGGED)
def test_flash_attention_ragged_matches_jax_oracle(dtype, B, S, H, Hkv, D,
                                                   window):
    arrays = _inputs(B, S, H, Hkv, D, seed=1)
    want = jax_ref_attention(*_jax(arrays, dtype), causal=True, window=window)
    got = flash_attention(*_torch(arrays, dtype), causal=True, window=window)
    _close(got, want, TOL[dtype])


def test_flash_attention_grad_matches_jax():
    # tests/test_kernels.py::test_flash_attention_grad_matches_ref's setup
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 128, 2, 32)).astype(np.float32)
               for _ in range(3))

    def f_ref(q_, k_, v_):
        return jax_ref_attention(q_, k_, v_, causal=True).sum()

    want = jax.grad(f_ref, argnums=(0, 1, 2))(*_jax((q, k, v), "float32"))
    tq, tk, tv = (t.requires_grad_() for t in _torch((q, k, v), "float32"))
    flash_attention(tq, tk, tv, causal=True).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_flash_attention_window_grad_matches_plain_autograd():
    tq, tk, tv = (t.requires_grad_() for t in
                  _torch(_inputs(2, 70, 4, 2, 16, seed=2), "float32"))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 70, 4, 16)).astype(np.float32))
    got = torch.autograd.grad(flash_attention(tq, tk, tv, window=20),
                              (tq, tk, tv), g)
    want = torch.autograd.grad(ref_attention(tq, tk, tv, window=20),
                               (tq, tk, tv), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,qb,kb", [
    (2, 256, 4, 2, 64, 0, 128, 128),
    (2, 256, 4, 4, 64, 96, 64, 64),      # sliding window
    (1, 100, 6, 2, 32, 0, 32, 48),       # ragged S: padded to block multiples
    (1, 64, 2, 1, 16, 0, 512, 512),      # one block
])
def test_blockwise_attention_matches_jax(dtype, B, S, H, Hkv, D, window, qb, kb):
    arrays = _inputs(B, S, H, Hkv, D, seed=4)
    scale = 1.0 / np.sqrt(D)
    want = jax_blockwise(*_jax(arrays, dtype), scale=scale, causal=True,
                         window=window, q_block=qb, kv_block=kb)
    got = blockwise_attention(*_torch(arrays, dtype), scale=scale, causal=True,
                              window=window, q_block=qb, kv_block=kb)
    assert got.dtype == TORCH_DTYPE[dtype]
    _close(got, want, TOL[dtype])


def test_flash_attention_rejects_bad_shapes_and_devices():
    q = torch.zeros(1, 8, 2, 12)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 1, 12), torch.zeros(1, 9, 1, 12))
    with pytest.raises(ValueError):   # neither CPU nor CUDA
        flash_attention(*(t.to("meta") for t in
                          (q, torch.zeros(1, 8, 1, 12), torch.zeros(1, 8, 1, 12))))
