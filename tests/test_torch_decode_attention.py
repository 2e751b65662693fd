"""The port's decode attention on the CPU against the JAX package's.

On the CPU the wrapper runs its plain version, which is held here against the
JAX oracle and the Pallas kernel in interpret mode.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``; what of its
design runs in Python (the split plan, the scratch, the build's cache) is
checked here, and its bf16 route's arithmetic is emulated in plain torch
(``_emulate_mma``) and held to the card's two gates: ``TOL``, and half a
bf16 ulp against fp32, ``2e-5 + 2**-8 |want32|``.
"""

import ctypes
import math
import re
import subprocess
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import ref_decode_attention
from repro_torch.distributed.sharding import merge_partials, slice_limit
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_partial,
                                                  decode_attention_ref, ops)
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


def _slice_partials(q, k, v, pos, n):
    """The partial entry on each of ``n`` equal slices of the caches, each
    with its share of the ``min(pos + 1, T)`` valid keys (none, some or
    all), as the ranks of a key-split mesh call it -> stacked (outs, lses)
    and the limits."""
    T = k.shape[1]
    T_loc, valid = T // n, min(pos + 1, T)
    outs, lses, limits = [], [], []
    for r in range(n):
        limit = slice_limit(valid, r * T_loc, T_loc)
        sl = slice(r * T_loc, (r + 1) * T_loc)
        out, lse = decode_attention_partial(q, k[:, sl], v[:, sl],
                                            limit=limit)
        assert out.dtype == q.dtype and lse.dtype == torch.float32
        outs.append(out)
        lses.append(lse)
        limits.append(limit)
    return torch.stack(outs), torch.stack(lses), limits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,T,pos,window,bt", SWEEP)
def test_partials_of_every_split_merge_to_jax(dtype, B, H, Hkv, D, T, pos,
                                              window, bt):
    """The plain partial over 1, 2, 4, 8 and 16 slices of the cache (some
    slices empty when pos is early, one partly valid; the ring past T is
    all valid): each slice's lse is the log-sum-exp of its scaled scores,
    and the slices merged by log-sum-exp give the whole cache's decode,
    held against the plain version and JAX's kernel in interpret mode."""
    arrays = _inputs(B, H, Hkv, D, T, seed=4)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    want_kernel = np.asarray(jax_decode_attention(
        jq, jk, jv, pos=jnp.int32(pos), window=window, block_t=bt,
        interpret=True), np.float32)
    want_plain = decode_attention_ref(tq, tk, tv, pos=pos,
                                      window=window).float().numpy()
    q64, k64 = (t.double().numpy() for t in (tq, tk))
    scores = np.einsum("bgnd,btgd->bgnt", q64.reshape(B, Hkv, H // Hkv, D),
                       k64) / np.sqrt(D)
    decode_attention.launches = 0
    for n in (1, 2, 4, 8, 16):
        outs, lses, limits = _slice_partials(tq, tk, tv, pos, n)
        assert sum(limits) == min(pos + 1, T)
        for r, limit in enumerate(limits):
            s = scores[..., r * (T // n):r * (T // n) + limit]
            want_lse = np.log(np.exp(s).sum(-1)).reshape(B, H) if limit \
                else np.full((B, H), -np.inf)
            np.testing.assert_allclose(lses[r].numpy(), want_lse, rtol=1e-5,
                                       atol=1e-5)
            if not limit:
                assert not outs[r].any()
        got = merge_partials(outs, lses).numpy()
        for want in (want_plain, want_kernel):
            np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                       rtol=TOL[dtype], err_msg=f"{n} slices")
    assert decode_attention.launches == 0      # the CPU runs no kernel


def test_partial_of_an_empty_slice_is_zeros_and_minus_inf():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 32, 8))
    out, lse = decode_attention_partial(q, k, v, limit=0)
    assert out.shape == (2, 4, 32) and not out.any()
    assert lse.shape == (2, 4) and bool((lse == -math.inf).all())
    with pytest.raises(ValueError, match="limit"):
        decode_attention_partial(q, k, v, limit=9)
    with pytest.raises(ValueError, match="limit"):
        decode_attention_partial(q, k, v, limit=-1)


def test_launch_arguments_mirror_the_cuda_source(fake_toolchain):
    """The C entry point's parameters, in order, are what ``ops._bind``
    declares: the lse pointer after the partials' scratch; and the bf16
    route converts its log2 max by ln 2."""
    src = ops.SOURCE.read_text()
    sig = re.search(r'extern "C" int decode_attention_launch\(([^)]*)\)',
                    src).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.startswith("float ") else ctypes.c_int
             for p in params]
    names = [re.sub(r"^.*[ *]", "", p) for p in params]
    assert names[5:8] == ["part_acc", "part_ml", "lse"]
    assert ops.build().decode_attention_launch.argtypes == kinds
    ln2 = float(re.search(r"constexpr float kLn2 = ([\d.]+)f;", src).group(1))
    assert ln2 == pytest.approx(math.log(2), rel=1e-7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,D,limit,n_sm", [
    (4, 8, 1, 256, 64, 132), (4, 8, 1, 256, 32768, 132), (1, 2, 2, 32, 1, 132),
    (2, 4, 1, 64, 257, 132), (128, 16, 16, 128, 4096, 132),
    (1, 64, 8, 128, 524288, 132), (1, 12, 1, 40, 1000, 8), (3, 6, 2, 8, 31, 132),
    (4, 32, 32, 80, 64, 132), (1, 64, 2, 96, 5000, 132),   # G=32: two tiles
])
def test_split_plan_covers_the_valid_keys(dtype, B, H, Hkv, D, limit, n_sm):
    p = plan(B, H, Hkv, D, limit, n_sm, dtype)
    if dtype == torch.bfloat16:   # an MMA's 8 columns; whole warps' keys
        assert p.heads == ops.MMA_HEADS and p.split_len % 16 == 0
    else:
        assert p.heads in (1, 2, 4, 8) and p.heads >= min(H // Hkv, 8)
    assert 1 <= p.n_split <= MAX_SPLIT
    # every valid key in exactly one launched split, and no split empty
    assert (p.n_split - 1) * p.split_len < limit <= p.n_split * p.split_len
    assert p.launches == (1 if p.n_split == 1 else 2)


# gemma-2b's served cache (T=64) at every position, so at each one where the
# plan changes (fp32: the split's length at every pos; bf16: its 16-key warp
# chunks at pos 16, 32 and 48, all in one K/V tile of 64 keys): always one
# split, written by one launch with no partials
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", range(64))
def test_served_cache_is_one_launch_without_partials(dtype, pos):
    p = plan(4, 8, 1, 256, min(pos + 1, 64), 132, dtype)
    assert p.n_split == 1 and p.launches == 1
    assert p.split_len >= pos + 1
    assert ops.scratch(p, 4, 8, 256, torch.device("cpu")) == (None, None)
    if dtype == torch.bfloat16:
        assert p.split_len == 16 * (pos // 16 + 1) <= 16 * ops.mma_tile(256)[1]
    else:
        assert p.split_len == pos + 1


# the timed long cache, and a ring buffer past it: enough blocks for every
# SM of an H100, partials for each split
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [32767, 32768 + 5000])
def test_long_cache_fills_the_card(dtype, pos):
    B, H, D, n_sm = 4, 8, 256, 132
    p = plan(B, H, 1, D, min(pos + 1, 32768), n_sm, dtype)
    blocks = B * -(-H // p.heads) * p.n_split
    assert p.launches == 2 and blocks >= n_sm
    acc, ml = ops.scratch(p, B, H, D, torch.device("cpu"))
    assert acc.shape == (B * H, p.n_split, D) and ml.shape == (B * H, p.n_split, 2)
    assert acc.dtype == ml.dtype == torch.float32


def test_constants_mirror_the_cuda_source():
    src = ops.SOURCE.read_text()

    def constexpr(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert constexpr("kMaxD") == ops.MAX_D
    assert constexpr("kMaxSplit") == ops.MAX_SPLIT
    assert constexpr("kHeads") == ops.MMA_HEADS
    body = src[src.index("int dispatch_mma("):]
    body = body[:body.index("\n}\n")]
    table = re.findall(r"(?:if \(D <= (\d+)\)\s*)?"
                       r"return launch_mma<(\d+), (\d+), (\d+)>", body)
    assert [tuple(map(int, t[1:])) for t in table] == list(ops.MMA_TILES)
    assert all(int(t[0]) == int(t[1]) for t in table[:-1])
    assert table[-1][0] == "" and int(table[-1][1]) == ops.MAX_D
    # the wrapper's heads per block are what each route's dispatch takes
    assert "gm == kHeads" in src
    assert re.findall(r"case (\d+): launch_simt<\1>", src) == ["1", "2", "4", "8"]


@pytest.mark.parametrize("D", range(8, ops.MAX_D + 1, 8))
def test_mma_tile_fits_an_sm(D):
    DP, warps, stages = ops.mma_tile(D)
    assert DP >= D and DP % 16 == 0
    smem = ops.mma_smem_bytes(D)
    assert 2 * (ops.MMA_HEADS + 2 * stages * 16 * warps) * (DP + 8) <= smem
    assert smem <= 232448           # the most a block may have
    # over a long cache the plan launches about as many blocks as fit on
    # the card at once, and no more
    per_sm = ops.SM_SHARED // (smem + 1024)
    assert per_sm >= 1
    blocks = plan(1, 8, 1, D, 1 << 20, 132).n_split
    assert 0.95 * per_sm * 132 <= blocks <= per_sm * 132


class _FakeLib:
    """Stands in for a loaded library: any function, with settable types."""

    def __init__(self, path):
        self.path = path
        self.functions = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.functions.setdefault(name, types.SimpleNamespace())


@pytest.fixture
def fake_toolchain(monkeypatch, tmp_path):
    """``_build`` with its output in ``tmp_path``, nvcc replaced by a stub that
    writes the library file and ctypes' loader by ``_FakeLib``; returns the
    list of compiler commands run."""
    runs = []

    def run(cmd, **kwargs):
        runs.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"library")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(ctypes, "CDLL", _FakeLib)
    return runs


def test_second_build_reads_no_source(fake_toolchain, monkeypatch):
    lib = ops.build()
    assert len(fake_toolchain) == 1
    fn = lib.decode_attention_launch
    assert fn.restype is ctypes.c_int and len(fn.argtypes) == 19
    assert Path(lib.path) == ops.library_path()

    def no_read(self, *args, **kwargs):
        raise AssertionError(f"read {self} again")
    monkeypatch.setattr(Path, "read_bytes", no_read)
    monkeypatch.setattr(Path, "read_text", no_read)
    fn.argtypes = None            # bound once, on the first load only
    for _ in range(3):
        assert ops.build() is lib
    assert len(fake_toolchain) == 1 and fn.argtypes is None


def test_edited_source_builds_anew_in_a_new_process(fake_toolchain, tmp_path):
    src = tmp_path / "kernel.cu"
    src.write_text("// version 1\n")
    first = _build.load(src)
    _build._loaded.clear()        # a new process: the library is on disk
    assert Path(_build.load(src).path) == Path(first.path)
    assert len(fake_toolchain) == 1
    src.write_text("// version 2\n")
    _build._loaded.clear()
    second = _build.load(src)
    assert len(fake_toolchain) == 2 and second.path != first.path


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


# --- the bf16 kernel's arithmetic (csrc/decode_attention.cu,
# decode_mma_kernel and decode_combine_kernel), emulated on the CPU


def _emulate_mma(q, k, v, pos, split=True, n_sm=132):
    """bf16 q (B,H,D), caches (B,T,Hkv,D) -> bf16, as the tensor-core route
    computes it: the splits of ``ops.plan``; in each, warps of 16 keys a K/V
    tile, each with its own online softmax in log2 units over fp32 scores;
    P carried as bf16 hi and lo (``split``) or rounded to bf16 once; fp32
    accumulation; the warps merged, then the splits (the combine), and the
    output rounded to bf16 once."""
    B, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G, limit = H // Hkv, min(pos + 1, T)
    p = ops.plan(B, H, Hkv, D, limit, n_sm)
    warps = ops.mma_tile(D)[1]
    scale_log2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) * \
        torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf = q.float().reshape(B, Hkv, G, D)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))   # (B,Hkv,T,D)

    def merge(parts):
        m = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(mi - m) for mi, _, _ in parts]
        return (m, sum(li * wi for (_, li, _), wi in zip(parts, w)),
                sum(ai * wi[..., None] for (_, _, ai), wi in zip(parts, w)))

    splits = []
    for sp in range(p.n_split):
        start = sp * p.split_len
        end = min(start + p.split_len, limit)
        per_warp = []
        for w in range(warps):
            m = torch.full((B, Hkv, G), -1e30)
            l, acc = torch.zeros(B, Hkv, G), torch.zeros(B, Hkv, G, D)
            for k0 in range(start + 16 * w, end, 16 * warps):
                keys = torch.arange(k0, min(k0 + 16, end))
                s = (qf @ kf[:, :, keys].transpose(-1, -2)) * scale_log2
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                pr = torch.exp2(s - m_new[..., None])
                l = l * corr + pr.sum(-1)
                hi = pr.bfloat16().float()
                pv = hi @ vf[:, :, keys]
                if split:
                    pv = pv + (pr - hi).bfloat16().float() @ vf[:, :, keys]
                acc = acc * corr[..., None] + pv
                m = m_new
            per_warp.append((m, l, acc))
        splits.append(merge(per_warp))
    _, l, acc = merge(splits)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, H, D) \
        .bfloat16()


def _fp32_gate_misses(got, want32):
    """Outputs outside chip_smoke.py's second gate: half a bf16 ulp of the
    fp32 reference plus the fp32 TOL."""
    diff32 = (got.float() - want32).abs()
    return int((diff32 > TOL["float32"] + 2.0 ** -8 * want32.abs()).sum())


def _bf16_case(B, H, Hkv, D, T, seed):
    """bf16 inputs, and the same values in fp32 for the reference."""
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _inputs(B, H, Hkv, D, T, seed))
    return (tq, tk, tv), [t.float().numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("B,H,Hkv,D,T,pos,window,bt", SWEEP + [
    (2, 32, 32, 96, 300, 299, 0, 100),    # phi-3-vision widths, ragged T
    (1, 12, 1, 40, 77, 50, 0, 77),        # G=12 in one tile, D=40
    (3, 6, 2, 8, 33, 100, 33, 33),        # G=3, D=8, ring buffer past T
    (4, 32, 32, 80, 64, 63, 0, 64),       # zamba2's shared block as served
    (1, 64, 2, 64, 200, 150, 0, 200),     # G=32: two A tiles
])
def test_mma_emulation_matches_jax_kernel_and_fp32_gate(B, H, Hkv, D, T, pos,
                                                        window, bt):
    (tq, tk, tv), rounded = _bf16_case(B, H, Hkv, D, T, seed=2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in rounded)
    kernel = jax_decode_attention(jq, jk, jv, pos=jnp.int32(pos), window=window,
                                  block_t=bt, interpret=True)
    want32 = torch.from_numpy(np.array(ref_decode_attention(
        *(jnp.asarray(a) for a in rounded), pos=pos, window=window)))
    got = _emulate_mma(tq, tk, tv, pos)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(kernel, np.float32),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    assert _fp32_gate_misses(got, want32) == 0


def test_mma_hi_lo_split_meets_fp32_gate():
    """gemma-2b's decode width (G=8, D=256, batch 4) over a 4096-entry
    cache, 64 splits of 64 keys: hi + lo meets the gate on every output; one
    bf16 P misses it on 582 of the 8192 (7%) on this data."""
    (tq, tk, tv), rounded = _bf16_case(4, 8, 1, 256, 4096, seed=3)
    want32 = torch.from_numpy(np.array(ref_decode_attention(
        *(jnp.asarray(a) for a in rounded), pos=4095)))
    split = _emulate_mma(tq, tk, tv, 4095)
    single = _emulate_mma(tq, tk, tv, 4095, split=False)
    assert _fp32_gate_misses(split, want32) == 0
    assert _fp32_gate_misses(single, want32) > 0.05 * single.numel()
