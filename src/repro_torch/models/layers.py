"""Shared neural layers: norms, rotary embeddings, GLU MLPs, embedding,
the loss and rematerialisation.

PyTorch port of ``repro.models.layers``: every layer is ``fn(params, x, ...)``
over plain tensors, with the JAX package's numerics (fp32 norm statistics,
fp32 rotary angles, tanh-approximated GELU, fp32 cross entropy).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import replicate, unshard

from .param import ParamSpec


# ----------------------------------------------------------------- norms
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ------------------------------------------------------------------ rope
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    Rotates by halves (not interleaved), with fp32 angles.
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- mlp
def mlp_specs(d_model: int, d_ff: int, variant: str, dtype: str,
              stack: Tuple[int, ...] = ()) -> dict:
    ax = (None,) * len(stack)
    gated = variant.endswith("_glu")
    specs = {
        "wi": ParamSpec(stack + (d_model, d_ff), ax + ("fsdp", "model"), dtype=dtype),
        "wo": ParamSpec(stack + (d_ff, d_model), ax + ("model", "fsdp"), dtype=dtype),
    }
    if gated:
        specs["wg"] = ParamSpec(stack + (d_model, d_ff), ax + ("fsdp", "model"),
                                dtype=dtype)
    return specs


def mlp(params: dict, x: torch.Tensor, variant: str) -> torch.Tensor:
    h = x @ params["wi"]
    if variant == "silu_glu":
        h = F.silu(x @ params["wg"]) * h
    elif variant == "gelu_glu":
        h = F.gelu(x @ params["wg"], approximate="tanh") * h
    elif variant == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(variant)
    return h @ params["wo"]


# ------------------------------------------------------------- embeddings
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


# ------------------------------------------------------------------- loss
def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE in fp32: logsumexp minus the gold logit, masked.

    Vocab-sharded DTensor logits are gathered over the vocab first: DTensor
    has no rule for a gather along a sharded dim (GSPMD inserts the
    cross-shard max/sum reductions instead).  The batch sums are reduced
    before the division, so the loss is whole on every rank.
    """
    logits = unshard(logits.float(), -1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return replicate(torch.sum(nll * m)) / torch.clamp(
            replicate(torch.sum(m)), min=1.0)
    return replicate(torch.mean(nll))


# ---------------------------------------------------------------- remat
_MATMULS = {"dots": ("mm", "addmm", "bmm", "baddbmm"),
            "dots_no_batch": ("mm", "addmm")}


def _saving(ops) -> Callable:
    """A selective-checkpoint context that keeps the outputs of ``ops`` (aten
    names) and recomputes the rest in the backward pass."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    save = {getattr(torch.ops.aten, name).default for name in ops}

    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func in save
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return lambda: create_selective_checkpoint_contexts(policy)


def maybe_remat(fn: Callable, policy_name: str) -> Callable:
    """``"full"`` recomputes ``fn`` in the backward pass (JAX's
    ``nothing_saveable``); ``"none"`` keeps its activations; ``"dots"``
    keeps the matmuls' outputs (``checkpoint_dots``) and ``"dots_no_batch"``
    those of products with no batch dimension, ``mm`` and ``addmm``
    (``checkpoint_dots_with_no_batch_dims``), recomputing the rest.  A
    kernel's output is recomputed, as JAX recomputes a ``pallas_call``,
    which is no dot."""
    if policy_name == "none":
        return fn
    if policy_name == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy_name in _MATMULS:
        context_fn = _saving(_MATMULS[policy_name])
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=context_fn)
    raise ValueError(f"unknown remat policy {policy_name!r}")
