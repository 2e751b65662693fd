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
    """Token-mean CE in fp32: logsumexp minus the gold logit, masked."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------- remat
def maybe_remat(fn: Callable, policy_name: str) -> Callable:
    """``"full"`` recomputes ``fn`` in the backward pass (JAX's
    ``nothing_saveable``); ``"none"`` keeps its activations."""
    if policy_name == "none":
        return fn
    if policy_name == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy_name in ("dots", "dots_no_batch"):
        raise NotImplementedError(
            f"remat policy {policy_name!r} is not ported yet; see ROADMAP "
            "Queue 1 item 4 (dense model and loss)")
    raise ValueError(f"unknown remat policy {policy_name!r}")
