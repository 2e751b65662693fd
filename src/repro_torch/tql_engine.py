"""TQL's tensor engine on a torch device: ``execute_query(..., engine="torch")``.

The JAX package delegates a query's expression graph to XLA (§4.3, "external
tensor computation frameworks"); the port evaluates the same graph as torch
operations on one device, the card unless the caller names another.
``VectorEval`` (``core/tql/executor.py``) evaluates with an array namespace
``xp``: numpy for the numpy engine, a :class:`TorchNamespace` for this one.
The namespace has the few functions that the evaluator and the batched TQL
functions (``core/tql/functions.py``) call, with numpy's signatures (tuple
``axis``, dtypes by name); arithmetic and comparisons are torch's own
operators.

Types follow the JAX engine, which runs with 64-bit types off, so that both
engines agree at a threshold: float64 and int64 columns and constants narrow
to float32 and int32 on the way to the device, as ``jnp.asarray`` narrows
them (int64 wraps as it does there); MEAN and STD (ddof 0) are float32 for
integer input, MAX and MIN keep the input's type, SUM of bool or signed
integers is int32.  Means, sums and deviations accumulate in float64 (or
int64) and round once, where XLA accumulates in float32.  Two departures,
both where torch has no arithmetic on unsigned types wider than 8 bits:
uint16, uint32 and uint64 columns widen to int32 or int64, and SUM of a
uint8 column is int64 where JAX's is uint32 (the values agree below 2**32).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

# numpy dtype -> the dtype a column or constant takes on the device
_DEVICE_DTYPE = {np.dtype(np.float64): np.dtype(np.float32),
                 np.dtype(np.int64): np.dtype(np.int32),
                 np.dtype(np.uint16): np.dtype(np.int32),
                 np.dtype(np.uint32): np.dtype(np.int64),
                 np.dtype(np.uint64): np.dtype(np.int64)}


def engine_device(device: Any = None) -> torch.device:
    """The device ``engine="torch"`` evaluates on: ``device``, or the current
    CUDA device when it is None (raises without one).  A CUDA device gets an
    explicit index, since scan worker threads evaluate on it too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "engine='torch' evaluates on the CUDA device and there is "
                "none; pass device='cpu' to evaluate on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _torch_dtype(name) -> torch.dtype:
    """A numpy dtype (or its name) as the engine's torch dtype."""
    dt = np.dtype(name)
    return getattr(torch, _DEVICE_DTYPE.get(dt, dt).name)


def _over(t: torch.Tensor, axis: tuple):
    """(t, dims) to reduce over; numpy's ``axis=()`` reduces nothing, where
    torch's ``dim=()`` reduces everything, so it becomes a new axis of 1."""
    return (t, tuple(axis)) if axis else (t.unsqueeze(-1), (-1,))


class TorchNamespace:
    """The array functions ``VectorEval`` and the batched TQL functions call,
    over tensors on ``device``."""

    def __init__(self, device: Any = None) -> None:
        self.device = engine_device(device)

    # ------------------------------------------------------------ transfer
    def asarray(self, v, dtype=None) -> torch.Tensor:
        if not torch.is_tensor(v):
            a = np.asarray(v)
            a = a.astype(_DEVICE_DTYPE.get(a.dtype, a.dtype), copy=False)
            v = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return v if dtype is None else v.to(_torch_dtype(dtype))

    @staticmethod
    def to_numpy(v) -> np.ndarray:
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    def full(self, shape, fill_value, dtype=None) -> torch.Tensor:
        return torch.full(tuple(shape), fill_value, device=self.device,
                          dtype=None if dtype is None else _torch_dtype(dtype))

    # ---------------------------------------------------------- elementwise
    def logical_and(self, a, b) -> torch.Tensor:
        return torch.logical_and(self.asarray(a), self.asarray(b))

    def logical_or(self, a, b) -> torch.Tensor:
        return torch.logical_or(self.asarray(a), self.asarray(b))

    def logical_not(self, a) -> torch.Tensor:
        return torch.logical_not(self.asarray(a))

    def abs(self, x) -> torch.Tensor:
        return torch.abs(self.asarray(x))

    def sqrt(self, x) -> torch.Tensor:
        return torch.sqrt(self.asarray(x))

    def clip(self, x, lo, hi) -> torch.Tensor:
        return torch.clamp(self.asarray(x), lo, hi)

    # ---------------------------------------------- reductions over ``axis``
    def any(self, x, axis: tuple) -> torch.Tensor:
        return torch.any(*_over(self.asarray(x), axis))

    def all(self, x, axis: tuple) -> torch.Tensor:
        return torch.all(*_over(self.asarray(x), axis))

    def max(self, x, axis: tuple) -> torch.Tensor:
        return torch.amax(*_over(self.asarray(x), axis))

    def min(self, x, axis: tuple) -> torch.Tensor:
        return torch.amin(*_over(self.asarray(x), axis))

    def sum(self, x, axis: tuple) -> torch.Tensor:
        t, dims = _over(self.asarray(x), axis)
        if t.is_floating_point():
            return t.sum(dims, dtype=torch.float64).to(t.dtype)
        total = t.sum(dims, dtype=torch.int64)
        return total if t.dtype == torch.uint8 else total.to(torch.int32)

    def mean(self, x, axis: tuple) -> torch.Tensor:
        t, dims = _over(self.asarray(x), axis)
        n = math.prod(t.shape[d] for d in dims)
        out = t.dtype if t.is_floating_point() else torch.float32
        return (t.sum(dims, dtype=torch.float64) / n).to(out)

    def std(self, x, axis: tuple) -> torch.Tensor:
        t, dims = _over(self.asarray(x), axis)
        out = t.dtype if t.is_floating_point() else torch.float32
        return torch.std(t.to(torch.float64), dim=dims, correction=0).to(out)
