"""The port's flash attention and blockwise attention on the CPU against the
JAX package's.

On the CPU the wrapper's forward is its plain version, held here against the
JAX oracle and the Pallas kernel in interpret mode; its backward recomputes
through the plain version, as JAX's custom VJP does.  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py``; here its
bf16 route's arithmetic is emulated in plain torch (``_emulate_mma``) and
held to the card's two gates.  Tolerances are ``tests/test_kernels.py``'s:
``TOL`` for values, 1e-4 for gradients; and ``chip_smoke.py``'s gate of half
a bf16 ulp against fp32, ``2e-5 + 2**-8 |want32|``.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import ref_attention as jax_ref_attention
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.kernels.flash_attention import (flash_attention, ops,
                                                 ref_attention)
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


# --- the bf16 kernel's arithmetic (csrc/flash_attention.cu,
# flash_fwd_mma_kernel), emulated on the CPU


def _emulate_mma(q, k, v, window, split=True):
    """bf16 q (B,S,H,D), k/v (B,T,Hkv,D) -> bf16, causal, as the tensor-core
    kernel computes it: q tiles of BQ rows, each walking K/V tiles of BK keys
    (``ops.mma_tiles``) from the window's lower edge to the causal diagonal;
    fp32 scores, online softmax in fp32; P carried as bf16 hi and lo
    (``split``) or rounded to bf16 once; fp32 accumulation; the output
    rounded to bf16 once."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G, (_, BK, BQ) = H // Hkv, ops.mma_tiles(D)
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    out = torch.zeros(B, Hkv, G, S, D)
    for q0 in range(0, S, BQ):
        rows = torch.arange(q0, min(q0 + BQ, S))
        k_hi = min(T, q0 + len(rows))
        k_lo = max(0, q0 - window + 1) if window else 0
        m = torch.full((B, Hkv, G, len(rows)), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, G, len(rows), D)
        for k0 in range(k_lo, k_hi, BK):
            keys = torch.arange(k0, min(k0 + BK, k_hi))
            s = qf[..., rows, :] @ kf[..., keys, :].transpose(-1, -2) * scale
            ok = keys[None, :] <= rows[:, None]
            if window:
                ok = ok & (rows[:, None] - keys[None, :] < window)
            m_new = torch.maximum(m, s.masked_fill(~ok, -1e30).amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            hi = p.bfloat16().float()
            pv = hi @ vf[..., keys, :]
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vf[..., keys, :]
            acc = acc * corr[..., None] + pv
            m = m_new
        out[..., rows, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).bfloat16()


def _fp32_gate_misses(got, want32):
    """Outputs outside chip_smoke.py's second gate: half a bf16 ulp of the
    fp32 reference plus the fp32 TOL."""
    diff32 = (got.float() - want32).abs()
    return int((diff32 > TOL["float32"] + 2.0 ** -8 * want32.abs()).sum())


def _bf16_case(B, S, H, Hkv, D, seed):
    arrays = [a.astype(np.float32) for a in _inputs(B, S, H, Hkv, D, seed)]
    tq, tk, tv = _torch(arrays, "bfloat16")
    # the fp32 reference on the bf16 inputs, as the card's gate takes it
    rounded = [t.float().numpy() for t in (tq, tk, tv)]
    return (tq, tk, tv), rounded


@pytest.mark.parametrize("B,S,H,Hkv,D,window,bq,bk", SWEEP)
def test_mma_emulation_matches_jax_kernel_and_fp32_gate(B, S, H, Hkv, D,
                                                        window, bq, bk):
    (tq, tk, tv), rounded = _bf16_case(B, S, H, Hkv, D, seed=0)
    jq, jk, jv = _jax(rounded, "bfloat16")
    kernel = jax_flash_attention(jq, jk, jv, True, window, None, bq, bk, True)
    want32 = torch.from_numpy(np.array(jax_ref_attention(
        *_jax(rounded, "float32"), causal=True, window=window)))
    got = _emulate_mma(tq, tk, tv, window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    _close(got, kernel, TOL["bfloat16"])
    assert _fp32_gate_misses(got, want32) == 0


# D=256 (gemma-2b) and D=40, S ragged against the 64-row q tile and the
# K/V tile.  One bf16 P misses the fp32 gate on 143,571 of 681,984 outputs
# (21%) at D=256 and on 10,204 of 48,000 (21%) at D=40 on this data; hi + lo
# misses none.
@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (1, 333, 8, 1, 256, 0),
    (1, 300, 4, 1, 40, 0),
])
def test_mma_hi_lo_split_meets_fp32_gate(B, S, H, Hkv, D, window):
    (tq, tk, tv), rounded = _bf16_case(B, S, H, Hkv, D, seed=3)
    want32 = torch.from_numpy(np.array(jax_ref_attention(
        *_jax(rounded, "float32"), causal=True, window=window)))
    split = _emulate_mma(tq, tk, tv, window)
    assert _fp32_gate_misses(split, want32) == 0
    single = _emulate_mma(tq, tk, tv, window, split=False)
    assert _fp32_gate_misses(single, want32) > 0.1 * single.numel()


SMEM_PER_BLOCK = 232448     # the most shared memory an H100 block may have


def _mma_smem_bytes(D):
    """Shared memory of one bf16 block at head dim ``D``: the Q tile and two
    K and two V tiles, rows padded by 16 bytes (``mma_smem_bytes`` in the
    CUDA source)."""
    DP, BK, BQ = ops.mma_tiles(D)
    return 2 * (BQ + 4 * BK) * (DP + 8)


@pytest.mark.parametrize("D", range(8, ops.MAX_D + 1, 8))
def test_mma_tile_choice(D):
    DP, BK, BQ = ops.mma_tiles(D)
    assert DP >= D and DP % 16 == 0 and BK % 16 == 0 and BQ % 16 == 0
    assert _mma_smem_bytes(D) <= SMEM_PER_BLOCK
    if D == 256:   # gemma-2b: two blocks on an SM's 228 KB, 1 KB each reserved
        assert 2 * (_mma_smem_bytes(D) + 1024) <= 228 * 1024


def test_mma_tiles_mirror_the_cuda_source():
    src = ops.SOURCE.read_text()
    body = src[src.index("int dispatch<__nv_bfloat16>"):]
    body = body[:body.index("\n}\n")]
    table = re.findall(r"(?:if \(D <= (\d+)\)\s*)?"
                       r"return launch_mma<(\d+), (\d+), (\d+)>", body)
    assert [tuple(map(int, t[1:])) for t in table] == list(ops.MMA_TILES)
    assert all(int(t[0]) == int(t[1]) for t in table[:-1])
    assert table[-1][0] == "" and int(table[-1][1]) == ops.MAX_D
    assert re.search(r"constexpr int kMaxD = (\d+);", src).group(1) == \
        str(ops.MAX_D)
