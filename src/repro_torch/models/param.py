"""Parameter specification system (PyTorch port of ``repro.models.param``).

Every model declares its parameters as a nested dict of :class:`ParamSpec`
(shape + logical axis names + init).  A parameter's name is its path in that
dict joined by ``/`` (``blocks/attn/wq``), the same path the JAX package's
pytree gives it, so weights carry over between the two packages by name.
From one spec tree we derive:

* ``materialize(specs, generator, device)`` — real tensors,
* ``tree_map(fn, tree, *rest)``              — ``fn`` over matching leaves,
* ``abstract(specs)``                       — tensors on the meta device (no
                                              allocation, even for 671B),
* ``count_params`` / ``param_bytes``,
* ``from_numpy_tree(tree, device)``         — a JAX pytree (parameters or a
                                              train state), turned into numpy
                                              arrays, as tensors.

The logical axes are kept on each spec for the distribution slice; nothing in
this module maps them to devices yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis per dim
    init: str = "normal"              # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 1.0
    dtype: str = "bfloat16"
    fan_in: Optional[int] = None      # explicit fan-in for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a spec's dtype name ("bfloat16", "float32", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted as JAX flattens them."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from named_leaves(tree[key], path)
        else:
            yield path, tree[key]


def unflatten(pairs) -> Dict[str, Any]:
    """The nested dict of (path, leaf) pairs: inverse of :func:`named_leaves`."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same paths."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def abstract(specs, dtype_override: Optional[str] = None):
    return unflatten(
        (path, torch.empty(s.shape, dtype=torch_dtype(dtype_override or s.dtype),
                           device="meta"))
        for path, s in named_leaves(specs))


def _init_leaf(s: ParamSpec, generator: torch.Generator, device,
               dt: torch.dtype) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=device)
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=device)
    if s.init == "normal":
        fan_in = s.fan_in or (s.shape[-2] if len(s.shape) >= 2
                              else max(s.shape[-1], 1))
        std = s.scale / np.sqrt(fan_in)
        return (torch.randn(s.shape, generator=generator, **f32) * std).to(dt)
    if s.init == "ssm_a":
        # mamba2 A init: -uniform(1, 16) in log space, per head; kept fp32
        u = torch.empty(s.shape, **f32).uniform_(1.0, 16.0, generator=generator)
        return torch.log(u)
    if s.init == "ssm_dt":
        u = torch.empty(s.shape, **f32).uniform_(1e-3, 1e-1, generator=generator)
        return torch.log(torch.expm1(u))
    raise ValueError(f"unknown init {s.init!r}")


def materialize(specs, generator: torch.Generator, device,
                dtype_override: Optional[str] = None):
    """Real tensors for a spec tree, drawn in path order from ``generator``.

    ``generator`` lives on ``device``.  Its numbers differ from
    ``jax.random``'s, so parity tests carry weights over with
    :func:`from_numpy_tree` instead of drawing them twice.
    """
    return unflatten(
        (path, _init_leaf(s, generator, device,
                          torch_dtype(dtype_override or s.dtype)))
        for path, s in named_leaves(specs))


def count_params(specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in named_leaves(specs))


def param_bytes(specs) -> int:
    return sum(int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
               for _, s in named_leaves(specs))


def _numpy_to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")       # own, writable copy: no aliasing
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16: torch cannot take it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy_tree(tree, device, specs=None):
    """A nested dict of numpy arrays (a JAX parameter pytree passed through
    ``np.asarray``) as a nested dict of tensors on ``device``.

    With ``specs``, the two trees must have the same paths, and every array
    the shape and dtype of its spec.
    """
    if specs is not None:
        want = dict(named_leaves(specs))
        have = {p for p, _ in named_leaves(tree)}
        if have != set(want):
            raise ValueError(f"parameter paths differ: missing "
                             f"{sorted(set(want) - have)}, extra "
                             f"{sorted(have - set(want))}")
    pairs = []
    for path, a in named_leaves(tree):
        a = np.asarray(a)
        if specs is not None:
            s = want[path]
            if tuple(a.shape) != tuple(s.shape) or a.dtype.name != s.dtype:
                raise ValueError(f"{path}: got {a.shape} {a.dtype.name}, "
                                 f"spec {s.shape} {s.dtype}")
        pairs.append((path, _numpy_to_tensor(a).to(device)))
    return unflatten(pairs)
