"""Linked tensors (§4.4): ``link[htype]`` columns store pointers into other
storage providers instead of payload bytes, giving a consolidated view over
data scattered across sources.  All features (query, version control,
streaming) work on linked tensors; streaming is slower than materialized
data — which is exactly the materialization motivation the paper gives.
"""

from __future__ import annotations

import io
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .storage import StorageProvider


class LinkRegistry:
    """Maps provider aliases ('s3a', 'gcs1', ...) to storage providers.

    Link values are strings ``alias://key``.  Payloads are stored in .npy
    format (self-describing shape/dtype), the offline stand-in for raw
    JPEG/PNG files referenced by URL.
    """

    _global: Optional["LinkRegistry"] = None

    def __init__(self) -> None:
        self._providers: Dict[str, StorageProvider] = {}
        self._lock = threading.Lock()

    @classmethod
    def global_registry(cls) -> "LinkRegistry":
        if cls._global is None:
            cls._global = cls()
        return cls._global

    def register(self, alias: str, provider: StorageProvider) -> None:
        with self._lock:
            self._providers[alias] = provider

    def split(self, url: str) -> Tuple[str, str]:
        if "://" not in url:
            raise ValueError(f"bad link {url!r}; want alias://key")
        alias, key = url.split("://", 1)
        return alias, key

    def provider(self, alias: str) -> StorageProvider:
        with self._lock:
            if alias not in self._providers:
                raise KeyError(f"no provider registered for alias {alias!r}")
            return self._providers[alias]

    # ------------------------------------------------------------------ I/O
    def put_array(self, url: str, arr: np.ndarray) -> None:
        alias, key = self.split(url)
        buf = io.BytesIO()
        np.save(buf, arr)
        self.provider(alias).put(key, buf.getvalue())

    def fetch_array(self, url: str) -> np.ndarray:
        alias, key = self.split(url)
        raw = self.provider(alias).get(key)
        return np.load(io.BytesIO(raw), allow_pickle=False)


def link_value(url: str) -> np.ndarray:
    """Encode a link url as the uint8 payload stored in a link[...] tensor."""
    return np.frombuffer(url.encode(), dtype=np.uint8).copy()


def resolve_link(value: np.ndarray, registry: Optional[LinkRegistry] = None) -> np.ndarray:
    reg = registry or LinkRegistry.global_registry()
    return reg.fetch_array(bytes(value.tobytes()).decode())


def resolving_transform(link_tensors, registry: Optional[LinkRegistry] = None
                        ) -> Callable[[dict], dict]:
    """Loader transform that resolves the given link columns on the fly."""
    names = set(link_tensors)

    def tf(sample: dict) -> dict:
        out = dict(sample)
        for k in names & set(out):
            out[k] = resolve_link(np.asarray(out[k]), registry)
        return out

    return tf
