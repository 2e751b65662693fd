"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Per-leaf symmetric quantization with an error-feedback residual keeps the
optimizer trajectory unbiased; ``compress_grads`` models the numerics of a
quantized all-reduce around the optimizer.  The quantized collective itself
comes with the distribution slice (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.param import (named_leaves, torch_dtype, tree_map,
                                      unflatten)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_grads(grads, error_fb):
    """-> (dequantized grads as seen post-allreduce, new error residuals)."""
    def per_leaf(g, e):
        gf = g.float() + e
        q, scale = _quantize(gf)
        deq = _dequantize(q, scale)
        return deq.to(g.dtype), gf - deq

    pairs = [(path, per_leaf(g, e)) for (path, g), (_, e) in
             zip(named_leaves(grads), named_leaves(error_fb))]
    return (unflatten((path, t[0]) for path, t in pairs),
            unflatten((path, t[1]) for path, t in pairs))


def compression_ratio(tree, from_dtype: str = "bfloat16") -> float:
    itemsize = torch_dtype(from_dtype).itemsize
    leaves = [l for _, l in named_leaves(tree)]
    nbytes_in = sum(l.numel() * itemsize for l in leaves)
    nbytes_out = sum(l.numel() + 4 for l in leaves)
    return nbytes_in / nbytes_out
