"""The image path as a whole, the port's against the JAX package's, on the CPU.

Query, then stream, then crop and normalize: both packages build the same
image lake with ``build_image_dataset`` from one seed (the paper's random
dataset, quant8-deflated uint8), select rows with their tensor engine
(``engine="jax"``; the port's ``engine="torch"`` on ``device="cpu"``),
stream the view through ``view.dataloader`` and their ``DeviceFeeder``, and
crop-normalize each batch with ``fused_preprocess`` (JAX's Pallas kernel in
interpret mode; the port's wrapper, whose CPU path is its plain version).
Rows, labels and images must agree, the images within 1e-6
(``tests/test_kernels.py``).
"""

import numpy as np
import pytest
import torch

from repro.core.dataset import Dataset as JaxDataset
from repro.core.storage import MemoryProvider as JaxMemoryProvider
from repro.core.tql import execute_query as jax_execute_query
from repro.data.pipeline import DeviceFeeder as JaxDeviceFeeder
from repro.data.synthetic import build_image_dataset as jax_build_image_dataset
from repro.kernels.fused_preprocess import fused_preprocess as jax_fused
from repro_torch.core.dataset import Dataset
from repro_torch.core.storage import MemoryProvider
from repro_torch.core.tql import execute_query
from repro_torch.data import DeviceFeeder, build_image_dataset
from repro_torch.kernels.fused_preprocess import fused_preprocess

ATOL = 1e-6
LAKE = dict(num_images=48, size=(64, 64), seed=5)
CROP = (4, 4, 56, 56)                                  # the centre 56 of 64
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)   # ImageNet's
WHERE = "SELECT * FROM dataset WHERE MEAN(images) > 127 AND labels != 1"
TOPK = WHERE + " ORDER BY MEAN(images) DESC LIMIT 16"


@pytest.fixture(scope="module")
def lakes():
    jds = jax_build_image_dataset(JaxDataset(JaxMemoryProvider()), **LAKE)
    ds = build_image_dataset(Dataset(MemoryProvider()), **LAKE)
    return jds, ds


def _loader(view):
    return view.dataloader(batch_size=8, tensors=["images", "labels"],
                           shuffle=False)


def _jax_path(jds, q):
    view = jax_execute_query(jds, q, engine="jax")
    out = [(np.asarray(b["labels"]),
            np.asarray(jax_fused(b["images"], CROP, MEAN, STD, True)))
           for b in JaxDeviceFeeder(iter(_loader(view)), {})]
    return view.indices.tolist(), out


def _port_path(ds, q):
    view = execute_query(ds, q, engine="torch", device="cpu")
    out = []
    for b in DeviceFeeder(iter(_loader(view)), "cpu"):
        assert b["images"].dtype == torch.uint8       # shipped as raw bytes
        assert b["images"].shape[1:] == (64, 64, 3)
        out.append((b["labels"].numpy(),
                    fused_preprocess(b["images"], CROP, MEAN, STD).numpy()))
    return view.indices.tolist(), out


def test_the_two_lakes_hold_equal_bytes(lakes):
    jds, ds = lakes
    assert len(jds) == len(ds) == LAKE["num_images"]
    for i in (0, 17, 47):
        np.testing.assert_array_equal(np.asarray(ds.images[i]),
                                      np.asarray(jds.images[i]))


@pytest.mark.parametrize("q", [WHERE, TOPK], ids=["where", "topk"])
def test_image_path_equals_jax(lakes, q):
    jds, ds = lakes
    want_rows, want = _jax_path(jds, q)
    got_rows, got = _port_path(ds, q)
    assert got_rows == want_rows
    assert 8 < len(got_rows) < LAKE["num_images"]
    assert len(got) == len(want) == -(-len(want_rows) // 8)
    for (g_lab, g_img), (w_lab, w_img) in zip(got, want):
        # the port ships labels as the loader gives them (int64); JAX's
        # device_put narrows them to int32, as it runs with 64-bit types off
        assert (g_lab.dtype, w_lab.dtype) == (np.int64, np.int32)
        np.testing.assert_array_equal(g_lab, w_lab)
        assert g_img.dtype == w_img.dtype == np.float32
        assert g_img.shape == w_img.shape
        assert g_img.shape[1:] == (CROP[2], CROP[3], 3)
        np.testing.assert_allclose(g_img, w_img, rtol=0, atol=ATOL)


def test_labels_follow_the_selected_rows(lakes):
    _, ds = lakes
    rows, out = _port_path(ds, WHERE)
    labels = np.concatenate([lab.reshape(len(lab), -1)[:, 0] for lab, _ in out])
    np.testing.assert_array_equal(labels, np.asarray(rows) % 10)
    assert (labels != 1).all()
