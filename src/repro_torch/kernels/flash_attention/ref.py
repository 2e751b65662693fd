"""Plain PyTorch oracle for flash attention (causal + sliding window + GQA):
the line-for-line port of ``repro.kernels.flash_attention.ref``."""

from __future__ import annotations

import math
from typing import Optional

import torch


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D); materializes SxT (oracle)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D)
    s = torch.einsum("bsgnd,btgd->bgnst", qg.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (qi >= ki)
    if window:
        ok = ok & (qi - ki < window)
    s = s.masked_fill(~ok, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bgnst,btgd->bsgnd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
