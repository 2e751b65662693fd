"""The port's crop-normalize wrapper (``kernels.fused_preprocess``) on the CPU
against the JAX package's.

On the CPU the wrapper runs its plain version (``ref.py``); it is held here
against JAX's Pallas kernel in interpret mode and its oracle
``ref_preprocess``, on the same uint8 images drawn with numpy, at
``tests/test_kernels.py``'s atol of 1e-6.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels.fused_preprocess import fused_preprocess as jax_fused
from repro.kernels.fused_preprocess.ref import ref_preprocess as jax_ref
from repro_torch.kernels.fused_preprocess import (
    fused_preprocess, ops, ref_preprocess)

ATOL = 1e-6
SWEEP_MEAN, SWEEP_STD = (0.48, 0.45, 0.41), (0.23, 0.22, 0.23)
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)

# (images shape, crop, mean, std): the JAX sweep's three crops, then the
# image feed's centre 224 crop of the lake's 250 x 250 images
CASES = [((3, 64, 64, 3), crop, SWEEP_MEAN, SWEEP_STD)
         for crop in ((0, 0, 32, 32), (8, 16, 32, 32), (1, 1, 30, 30))] + [
    ((2, 250, 250, 3), (13, 13, 224, 224), IMAGENET_MEAN, IMAGENET_STD)]


def _images(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape,crop,mean,std", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_matches_jax_kernel_and_oracle(shape, crop, mean, std):
    imgs = _images(shape)
    before = fused_preprocess.launches
    got = fused_preprocess(torch.from_numpy(imgs), crop, mean, std)
    assert fused_preprocess.launches == before   # the CPU launches nothing
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], crop[2], crop[3], shape[3])
    kernel = np.asarray(jax_fused(imgs, crop, mean, std, True))
    oracle = np.asarray(jax_ref(imgs, crop, mean, std))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=ATOL)


def test_plain_version_is_the_oracle_op_for_op():
    imgs = _images((2, 40, 36, 3), seed=1)
    crop = (3, 5, 20, 17)
    got = ref_preprocess(torch.from_numpy(imgs), crop, SWEEP_MEAN, SWEEP_STD)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ref(imgs, crop, SWEEP_MEAN, SWEEP_STD)))


@pytest.mark.parametrize("crop", [(0, 0, 65, 8), (-1, 0, 8, 8),
                                  (0, 60, 8, 8), (60, 0, 8, 8)])
def test_window_outside_the_image_raises(crop):
    imgs = torch.from_numpy(_images((1, 64, 64, 3)))
    with pytest.raises(ValueError, match="leaves"):
        fused_preprocess(imgs, crop, SWEEP_MEAN, SWEEP_STD)


@pytest.mark.parametrize("shape,crop", [((0, 64, 64, 3), (0, 0, 32, 32)),
                                        ((2, 64, 64, 3), (4, 4, 0, 32)),
                                        ((2, 64, 64, 3), (4, 4, 32, 0))])
def test_empty_output(shape, crop):
    out = fused_preprocess(torch.from_numpy(_images(shape)), crop,
                           SWEEP_MEAN, SWEEP_STD)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == (shape[0], crop[2], crop[3], 3)


def test_single_channel():
    imgs = _images((2, 16, 16, 1), seed=2)
    got = fused_preprocess(torch.from_numpy(imgs), (2, 3, 9, 11), (0.5,),
                           (0.25,))
    want = np.asarray(jax_fused(imgs, (2, 3, 9, 11), (0.5,), (0.25,), True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_what_the_wrapper_refuses():
    imgs = torch.from_numpy(_images((1, 8, 8, 3)))
    with pytest.raises(ValueError, match="want 3 means"):
        fused_preprocess(imgs, (0, 0, 4, 4), (0.5, 0.5), (0.2, 0.2))
    with pytest.raises(ValueError, match=r"want images \(B,H,W,C\)"):
        fused_preprocess(imgs[0], (0, 0, 4, 4), SWEEP_MEAN, SWEEP_STD)
    # neither the CPU nor CUDA: no plain version to fall back on
    meta = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no fused preprocess for device"):
        fused_preprocess(meta, (0, 0, 4, 4), SWEEP_MEAN, SWEEP_STD)
    # the wrapper's limit mirrors the CUDA source's
    assert f"kMaxC = {ops.MAX_C};" in ops.SOURCE.read_text()


# ------------------------------------------------------------------------
# The CUDA kernel's design, emulated in numpy: the table of outputs it builds
# in shared memory, and its work split (segments of G rows, passes in which
# each thread takes QUADS quads of 4 output elements, a warp's lanes on
# neighbouring quads; the aligned words a quad loads, the bytes taken out of
# them, float4 stores, quads across a row's end and the last partial quad
# element by element, a quad's first channel, the blocks' walk over the
# segments, the divisions done as multiplies).

def _table(mean, std):
    """The kernel's shared-memory table: channel c's 256 outputs from
    c * TABLE_STRIDE on, each ``(v / 255 - mean[c]) / std[c]`` in fp32."""
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    tab = np.zeros(len(mean) * ops.TABLE_STRIDE, np.float32)
    for c, (m, s) in enumerate(zip(mean, std)):
        tab[c * ops.TABLE_STRIDE:c * ops.TABLE_STRIDE + 256] = \
            (v - np.float32(m)) / np.float32(s)
    return tab


def _fast_div(d: int):
    """The kernel's ``fast_div``: (d, mul, shr) with mul = ceil(2^p / d),
    p = 31 + ceil(log2 d); mul = 0 for d = 1."""
    if d == 1:
        return d, 0, 0
    p = 31 + (d - 1).bit_length()
    return d, ((1 << p) + d - 1) // d, p - 32


def _quot(f, x: int) -> int:
    """The kernel's ``quot``: x // d by a 32-bit multiply-high, 0 <= x < 2^31."""
    d, mul, shr = f
    assert 0 <= x < 2 ** 31
    return x if mul == 0 else ((x * mul) >> 32) >> shr


def _funnelshift_r(lo: int, hi: int, shift: int) -> int:
    return (((hi << 32) | lo) >> (shift & 31)) & 0xFFFFFFFF


def _emulate(images, crop, mean, std, blocks):
    """The kernel's output, computed as its threads compute it on a grid of
    at most ``blocks`` blocks; fails if an element is written other than
    once, a loaded word holds no byte of its quad, a float4 store is not
    16-byte aligned, or a division done as a multiply is not exact.  The
    batch starts 16-byte aligned, as PyTorch's allocations do."""
    B, H, W, C = images.shape
    y0, x0, h, w = crop
    flat = images.reshape(-1)
    words = np.frombuffer(np.pad(flat, (0, -flat.size % 4)).tobytes(), "<u4")
    mean32 = np.asarray(mean, np.float32)
    std32 = np.asarray(std, np.float32)
    tab = _table(mean, std) if C <= ops.TABLE_C else None
    L = w * C
    f_len, f_h, f_c = _fast_div(L), _fast_div(h), _fast_div(C)
    segment = 4 * ops.THREADS * ops.QUADS
    align = 1 if L % 4 == 0 else 2 if L % 2 == 0 else 4
    G = align if L >= segment // align else segment // L // align * align
    assert (G * L) % 4 == 0
    rows = B * h
    segments = -(-rows // G)
    blocks = min(segments, blocks)
    out = np.zeros(rows * L, np.float32)
    writes = np.zeros(out.size, np.int64)

    def row_src(b, y, i):
        t = y + i
        db = _quot(f_h, t)
        assert db == t // h
        return ((b + db) * H + y0 + t - db * h) * W * C + x0 * C

    def norm(v, c):
        if tab is not None:
            return tab[c * ops.TABLE_STRIDE + v]
        return (np.float32(v) / np.float32(255.0) - mean32[c]) / std32[c]

    def divmod_len(o):
        i = _quot(f_len, o)
        assert i == o // L
        return i, o - i * L

    def channel(col):
        c = col - _quot(f_c, col) * C
        assert c == col % C
        return c

    step = blocks * G
    db, dy = divmod(step, h)
    for blk in range(blocks):
        b, y = divmod(blk * G, h)
        for s in range(blk, segments, blocks):
            r0 = s * G
            n = min(G, rows - r0) * L
            seg_out = r0 * L
            assert seg_out % 4 == 0
            for pass_ in range(0, n, segment):
                for t in range(ops.THREADS):
                    for u in range(ops.QUADS):
                        o = pass_ + 4 * (t + u * ops.THREADS)
                        if o >= n:
                            continue
                        i, col = divmod_len(o)
                        v = np.zeros(4, np.float32)
                        if o + 4 <= n and col + 4 <= L:
                            addr = row_src(b, y, i) + col
                            shift = 8 * (addr & 3)
                            word = addr >> 2
                            lo = int(words[word])
                            hi = int(words[word + 1]) if shift else 0
                            # each word loaded holds a byte of the quad
                            assert 4 * word < addr + 4
                            assert not shift or 4 * (word + 1) < addr + 4
                            q = _funnelshift_r(lo, hi, shift)
                            c = channel(col)
                            for j in range(4):
                                v[j] = norm((q >> (8 * j)) & 0xFF, c)
                                c = 0 if c + 1 == C else c + 1
                        else:
                            for j in range(4):
                                if o + j < n:
                                    ij, cj = divmod_len(o + j)
                                    v[j] = norm(int(flat[row_src(b, y, ij) + cj]),
                                                channel(cj))
                        if o + 4 <= n:
                            assert (seg_out + o) % 4 == 0
                            out[seg_out + o:seg_out + o + 4] = v
                            writes[seg_out + o:seg_out + o + 4] += 1
                        else:
                            out[seg_out + o:seg_out + n] = v[:n - o]
                            writes[seg_out + o:seg_out + n] += 1
            b, y = b + db, y + dy
            if y >= h:
                b, y = b + 1, y - h
    assert (writes == 1).all(), np.unique(writes)
    return out.reshape(B, h, w, C)


CH1 = ((0.449,), (0.226,))
CH2 = ((0.3, 0.6), (0.2, 0.25))
CH3 = (IMAGENET_MEAN, IMAGENET_STD)
CH4 = (IMAGENET_MEAN + (0.5,), IMAGENET_STD + (0.25,))
CH7 = (tuple(0.1 * c for c in range(7)), tuple(0.2 + 0.05 * c for c in range(7)))
CH64 = (tuple(c / 64 for c in range(64)), tuple(0.1 + c / 128 for c in range(64)))

# (images shape, crop, (mean, std), grid): every source offset mod 16 with
# one channel and with three (rows of odd length, so the offset also moves
# row by row, and quads cross rows' ends), an odd w*C, C = 4, one row, a
# row longer than a pass, rows shorter than a quad (w*C of 3 and 2), grids
# whose blocks walk several segments (carrying y into b), a window ending on
# the batch's last byte, and C above the table's limit
DESIGN_CASES = (
    [((2, 7, 45, 1), (1, x0, 4, 23), CH1, 3) for x0 in range(16)]
    + [((2, 6, 41, 3), (1, x0, 4, 21), CH3, 3) for x0 in range(16)]
    + [((2, 9, 50, 3), (2, 5, 6, 37), CH3, 2),
       ((2, 6, 45, 1), (0, 3, 5, 32), CH1, 4),
       ((2, 8, 30, 4), (1, 3, 5, 19), CH4, 2),
       ((1, 5, 40, 3), (2, 4, 1, 30), CH3, 5),
       ((1, 3, 1500, 3), (0, 1, 2, 1450), CH3, 1),
       ((3, 5, 9, 1), (1, 2, 4, 3), CH1, 2),
       ((2, 4, 6, 2), (0, 1, 3, 1), CH2, 1),
       ((3, 7, 210, 3), (1, 3, 5, 200), CH3, 2),
       ((5, 9, 700, 1), (2, 3, 6, 690), CH1, 2),
       ((100, 5, 30, 3), (1, 2, 2, 27), CH3, 2),
       ((2, 7, 43, 3), (3, 22, 4, 21), CH3, 3),
       ((2, 6, 20, 7), (1, 2, 4, 9), CH7, 2),
       ((1, 4, 5, 64), (1, 1, 2, 3), CH64, 1)])


@pytest.mark.parametrize("C,chans", [(1, CH1), (3, CH3), (4, CH4)])
def test_table_is_the_oracle_bit_for_bit(C, chans):
    """The table the kernel builds, looked up by every byte value in every
    channel, is JAX's oracle bit for bit."""
    mean, std = chans
    imgs = np.stack([np.roll(np.arange(256, dtype=np.uint8), 37 * c)
                     for c in range(C)], -1).reshape(1, 16, 16, C)
    tab = _table(mean, std)
    got = tab[np.arange(C) * ops.TABLE_STRIDE + imgs.astype(np.int64)]
    want = np.asarray(jax_ref(imgs, (0, 0, 16, 16), mean, std))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,crop,chans,grid", DESIGN_CASES,
                         ids=[f"{c[0]}-{c[1]}-grid{c[3]}" for c in DESIGN_CASES])
def test_kernel_work_split_emulated(shape, crop, chans, grid):
    mean, std = chans
    imgs = _images(shape, seed=sum(shape) + sum(crop))
    got = _emulate(imgs, crop, mean, std, grid)
    np.testing.assert_array_equal(got, np.asarray(jax_ref(imgs, crop, mean,
                                                          std)))
    kernel = np.asarray(jax_fused(imgs, crop, mean, std, True))
    np.testing.assert_allclose(got, kernel, rtol=0, atol=ATOL)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 23, 81, 224, 672, 4350,
                               2 ** 20 + 1, 2 ** 28 - 1, 2 ** 28, 2 ** 29 - 1])
def test_fast_div_is_exact(d):
    """The kernel's division by a multiply is exact over 0 <= x < 2^31."""
    xs = np.random.default_rng(d).integers(0, 2 ** 31, 2000)
    edges = [0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31 - 1 - d,
             (2 ** 31 - 1) // d * d, (2 ** 31 - 1) // d * d - 1]
    f = _fast_div(d)
    for x in [int(x) for x in xs] + [e for e in edges if 0 <= e < 2 ** 31]:
        assert _quot(f, x) == x // d, (d, x)


def test_design_constants_mirror_the_source():
    src = ops.SOURCE.read_text()
    for name, value in (("kTableC", ops.TABLE_C), ("kQuads", ops.QUADS),
                        ("kThreads", ops.THREADS)):
        assert f"{name} = {value};" in src
    assert f"kStride = 256 + {ops.TABLE_STRIDE - 256};" in src
