"""The port's decode attention on the CPU against the JAX package's.

On the CPU the wrapper runs its plain version, which is held here against the
JAX oracle and the Pallas kernel in interpret mode.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``; what of its
design runs in Python (the split plan) is checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import ref_decode_attention
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.decode_attention.ops import MAX_SPLIT, plan

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the shapes of tests/test_kernels.py::test_decode_attention_sweep
SWEEP = [
    (2, 4, 2, 64, 512, 100, 0, 128),
    (1, 8, 8, 128, 1024, 1023, 0, 256),
    (2, 4, 1, 64, 256, 300, 256, 64),    # ring buffer window, pos > T
    (1, 2, 2, 32, 128, 0, 0, 128),       # first token
]


def _inputs(B, H, Hkv, D, T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,T,pos,window,bt", SWEEP)
def test_plain_version_matches_jax(dtype, B, H, Hkv, D, T, pos, window, bt):
    arrays = _inputs(B, H, Hkv, D, T)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    decode_attention.launches = 0
    got = decode_attention(tq, tk, tv, pos=pos, window=window)
    assert decode_attention.launches == 0      # the CPU runs no kernel
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    got = got.float().numpy()
    want_ref = ref_decode_attention(jq, jk, jv, pos=pos, window=window)
    want_kernel = jax_decode_attention(jq, jk, jv, pos=jnp.int32(pos),
                                       window=window, block_t=bt,
                                       interpret=True)
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,H,Hkv,limit,n_sm", [
    (4, 8, 1, 64, 132), (4, 8, 1, 32768, 132), (1, 2, 2, 1, 132),
    (2, 4, 1, 257, 132), (128, 16, 16, 4096, 132), (1, 64, 8, 524288, 132),
    (1, 12, 1, 1000, 8), (3, 6, 2, 31, 132),
])
def test_split_plan_covers_the_valid_keys(B, H, Hkv, limit, n_sm):
    gm, split_len, n_split = plan(B, H, Hkv, limit, n_sm)
    assert gm in (1, 2, 4, 8) and gm >= min(H // Hkv, 8)
    assert 1 <= n_split <= MAX_SPLIT
    # every valid key in exactly one launched split, and no split empty
    assert (n_split - 1) * split_len < limit <= n_split * split_len


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,T,pos,window", [
    (2, 32, 32, 96, 300, 299, 0),        # phi-3-vision widths, ragged T
    (1, 12, 1, 40, 77, 50, 0),           # two head groups, D=40
    (3, 6, 2, 8, 33, 100, 33),           # G=3, D=8, ring buffer past T
    (4, 8, 1, 256, 64, 32, 0),           # gemma-2b at the served cache
])
def test_plain_version_matches_jax_at_other_widths(dtype, B, H, Hkv, D, T, pos,
                                                   window):
    arrays = _inputs(B, H, Hkv, D, T, seed=1)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    got = decode_attention(tq, tk, tv, pos=pos, window=window)
    want = ref_decode_attention(jq, jk, jv, pos=pos, window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_wrapper_rejects_what_no_version_takes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 16))
    with pytest.raises(ValueError, match="pos"):
        decode_attention(q, k, v, pos=-1)
    with pytest.raises(ValueError, match="does not fit"):
        decode_attention(q[:, :3], k, v, pos=0)
    with pytest.raises(ValueError, match=r"\(B,H,D\)"):
        decode_attention(q, k, v[:, :8], pos=0)
    # a device that is neither the CPU nor CUDA gets no fallback
    with pytest.raises(ValueError, match="no decode attention"):
        decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), pos=0)
