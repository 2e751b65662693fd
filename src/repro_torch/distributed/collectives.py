"""Explicit collectives for the cross-pod data-parallel path (port of
``repro.distributed.collectives``).

The gradient reductions of a DTensor train step run at the accumulation
dtype.  For the *cross-pod* hop (slow links) there is an explicit quantized
all-reduce: an int8 payload and a per-shard scale, error feedback handled by
the caller (``optim.grad_compress``).  The numerics are JAX's: the scale is
``absmax / 127`` in the input's dtype, values round half to even (as
``jnp.round``), the int8 payload is summed as int32, the scales are summed,
and the result is ``total * (scale_sum / n) / n``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.param import named_leaves, tree_map


def quantized_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce mean over ``group`` with an int8 wire format; ``x`` is this
    rank's shard, the result has its shape and dtype on every rank."""
    absmax = torch.max(torch.abs(x)) + 1e-12
    # divided by a tensor: CUDA divides by a host scalar as a product with
    # its reciprocal, which can miss the quotient by an ulp and move a value
    # across a rounding boundary
    scale = absmax / absmax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    # the wire payload is int8; summed as int32 so that no shard overflows
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    scale_sum = scale.reshape(1).clone()     # the scales are tiny
    dist.all_reduce(scale_sum, group=group)
    n = torch.ones(1, dtype=torch.float32, device=x.device)
    dist.all_reduce(n, group=group)
    # the mean of the dequantized shards (per-shard scale ~ shared scale)
    return (total.float() * (scale_sum.float() / n) / n).to(x.dtype)


def make_quantized_allreduce(mesh, axis_name: str = "pod"):
    """Tree-level quantized mean-all-reduce over the mesh axis ``axis_name``.

    Each leaf (a DTensor on ``mesh``, or a tensor every rank holds whole) is
    split on dim 0 over ``axis_name`` and replicated over the other axes, as
    JAX's ``in_specs``; the result is the mean of those shards, a tensor of
    one shard's shape that every rank holds, as JAX's ``out_specs``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import distribute, mesh_axis_names
    dim = mesh_axis_names(mesh).index(axis_name)
    group = mesh.get_group(dim)

    def one(x):
        placements = [Replicate()] * mesh.ndim
        placements[dim] = Shard(0)
        local = distribute(x, mesh, placements).to_local()
        return quantized_psum(local, group)

    def allreduce(tree: Any) -> Any:
        return tree_map(one, tree)

    return allreduce


def collective_wire_bytes(tree, compressed: bool) -> int:
    leaves = [l for _, l in named_leaves(tree)]
    if compressed:
        return sum(l.numel() + 4 for l in leaves)
    return sum(l.numel() * l.element_size() for l in leaves)
