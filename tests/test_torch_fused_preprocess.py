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
