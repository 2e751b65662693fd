"""Synthetic Deep Lake datasets for training/benchmarks.

Mirrors the paper's experiment data: the "random dataset" of Fig 5 (random
images, here with the quant8 JPEG-class codec) and token corpora for the LM
architectures.  Everything is written through the public Dataset API, so
benchmarks exercise the actual ingestion path (Fig 5a).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.dataset import Dataset


def build_token_dataset(ds: Dataset, *, num_docs: int = 256,
                        doc_len: int = 1024, vocab_size: int = 50_000,
                        seed: int = 0, commit: bool = True) -> Dataset:
    """Documents of int32 tokens (ragged lengths ±25%) + doc ids."""
    if "tokens" not in ds.tensor_names:
        ds.create_tensor("tokens", htype="tokens", dtype="int32",
                         sample_compression="zlib",
                         min_chunk_size=256 << 10, max_chunk_size=1 << 20)
        ds.create_tensor("doc_id", htype="class_label")
    rng = np.random.default_rng(seed)
    for i in range(num_docs):
        n = int(doc_len * rng.uniform(0.75, 1.25))
        ds.append({"tokens": rng.integers(0, vocab_size, n).astype(np.int32),
                   "doc_id": np.int64(i)})
    if commit:
        ds.commit(f"synthetic tokens x{num_docs}")
    return ds


def build_image_dataset(ds: Dataset, *, num_images: int = 512,
                        size: Tuple[int, int] = (250, 250), channels: int = 3,
                        codec: str = "quant8", seed: int = 0,
                        num_classes: int = 10, commit: bool = True) -> Dataset:
    """The paper's 'random dataset': colored (size x size) images (Fig 5)."""
    if "images" not in ds.tensor_names:
        ds.create_tensor("images", htype="image", dtype="uint8",
                         sample_compression=codec,
                         min_chunk_size=4 << 20, max_chunk_size=16 << 20)
        ds.create_tensor("labels", htype="class_label")
    rng = np.random.default_rng(seed)
    h, w = size
    for i in range(num_images):
        # smooth random fields compress like photos (pure noise wouldn't)
        base = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, channels))
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
        img = np.clip(img + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8)
        ds.append({"images": img, "labels": np.int64(i % num_classes)})
    if commit:
        ds.commit(f"synthetic images x{num_images}")
    return ds
