"""TQL built-in tensor functions (§4.3).

Each function has a row implementation (single sample, numpy) and optionally a
batched implementation (leading batch axis) used by the vectorized/XLA
execution path.  ``register_function`` lets applications add UDFs — the paper's
example uses ``IOU`` as a user-defined function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np


@dataclass
class FunctionSpec:
    name: str
    row: Callable[..., object]
    batched: Optional[Callable[..., object]] = None  # operates on (N, ...) arrays


_REGISTRY: Dict[str, FunctionSpec] = {}


def register_function(name: str, row: Callable[..., object],
                      batched: Optional[Callable[..., object]] = None) -> None:
    _REGISTRY[name.upper()] = FunctionSpec(name.upper(), row, batched)


def get_function(name: str) -> FunctionSpec:
    try:
        return _REGISTRY[name.upper()]
    except KeyError:
        raise ValueError(f"unknown TQL function {name!r}; have {sorted(_REGISTRY)}") \
            from None


def _reduce_all(np_reduce, empty, method):
    """Whole-sample reduction with an explicit empty-input identity.

    SUM of nothing is 0; MEAN/STD/MIN/MAX of nothing have no value and
    yield NaN (np.min/np.max raise on empty input, so the identity must
    be supplied rather than delegated).  The batched path returns the
    same identity per empty row so both execution paths agree.  The
    batched form reduces with ``xp``'s function of the name ``method``.
    """
    def row(x):
        a = np.asarray(x)
        return np_reduce(a) if a.size else empty

    def batched(x, xp=np):
        a = x
        if a.ndim <= 1:
            return a
        if 0 in a.shape[1:]:  # every row's reduced slice is empty
            return xp.full((a.shape[0],), empty, dtype="float64")
        return getattr(xp, method)(a, axis=tuple(range(1, a.ndim)))
    return row, batched


def _pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (N,4) and (M,4) LTRB boxes."""
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def iou(a, b) -> float:
    """Mean best-match IoU between two box sets (the paper's Fig-4 UDF)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.size == 0 or b.size == 0:
        return 0.0
    m = _pairwise_iou(a, b)
    return float(m.max(axis=1).mean())


def normalize_boxes(boxes, crop) -> np.ndarray:
    """Re-express LTRB boxes in the coordinates of ``crop`` = [l, t, r, b],
    scaled to [0, 1] (the paper's Fig-4 NORMALIZE)."""
    boxes = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
    l, t, r, b = [float(v) for v in np.asarray(crop).reshape(-1)[:4]]
    w, h = max(r - l, 1e-12), max(b - t, 1e-12)
    out = boxes.copy()
    out[:, 0::2] = (out[:, 0::2] - l) / w
    out[:, 1::2] = (out[:, 1::2] - t) / h
    return np.clip(out, 0.0, 1.0)


def contains(haystack, needle) -> bool:
    h = np.asarray(haystack)
    if h.dtype == np.uint8 and isinstance(needle, str):  # text htype
        return needle in h.tobytes().decode(errors="replace")
    return bool(np.isin(np.asarray(needle), h).all())


def _register_defaults() -> None:
    for name, red, empty in (("MEAN", np.mean, np.nan), ("SUM", np.sum, 0.0),
                             ("MAX", np.max, np.nan), ("MIN", np.min, np.nan),
                             ("STD", np.std, np.nan)):
        row, batched = _reduce_all(red, empty, name.lower())
        register_function(name, row, batched)
    register_function("ABS", lambda x: np.abs(np.asarray(x)),
                      lambda x, xp=np: xp.abs(x))
    register_function("SQRT", lambda x: np.sqrt(np.asarray(x, dtype=np.float64)),
                      lambda x, xp=np: xp.sqrt(x))
    register_function("CLIP", lambda x, lo, hi: np.clip(np.asarray(x), lo, hi),
                      lambda x, lo, hi, xp=np: xp.clip(x, lo, hi))
    register_function(
        "ANY", lambda x: bool(np.any(x)),
        lambda x, xp=np: xp.any(x, axis=tuple(range(1, x.ndim))) if x.ndim > 1 else x)
    register_function(
        "ALL", lambda x: bool(np.all(x)),
        lambda x, xp=np: xp.all(x, axis=tuple(range(1, x.ndim))) if x.ndim > 1 else x)
    register_function(
        "L2_NORM", lambda x: float(np.linalg.norm(np.asarray(x, dtype=np.float64))),
        lambda x, xp=np: xp.sqrt(xp.sum(
            xp.asarray(x, dtype="float32") ** 2,
            axis=tuple(range(1, x.ndim)))))
    register_function("SHAPE", lambda x: np.asarray(np.asarray(x).shape, dtype=np.int64))
    register_function("IOU", iou)
    register_function("NORMALIZE", normalize_boxes)
    register_function("CONTAINS", contains)
    register_function("LEN", lambda x: int(np.asarray(x).shape[0])
                      if np.asarray(x).ndim else 1)
    register_function("CAST_FLOAT", lambda x: np.asarray(x, dtype=np.float32),
                      lambda x, xp=np: xp.asarray(x, dtype="float32"))
    # RANDOM is handled specially by the executor (deterministic per query).


_register_defaults()
