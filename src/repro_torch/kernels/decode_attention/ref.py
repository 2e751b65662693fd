"""Plain PyTorch version of single-token decode attention.

A straightforward port of ``repro.kernels.decode_attention.ref`` (and, beside
it, the partial over one slice of a cache split over keys): it is what
the wrapper runs for tensors on the CPU, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card.
"""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, *, pos: int, window: int = 0
                         ) -> torch.Tensor:
    """q (B,H,D); caches (B,T,Hkv,D) -> (B,H,D).

    Valid cache entries: idx <= pos (full cache) or the ring-buffer rule
    idx < min(pos+1, T) for window caches.
    """
    B, H, D = q.shape
    T, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bgnd,btgd->bgnt", qg, cache_k.float())
    s = s / math.sqrt(D)
    idx = torch.arange(T, device=q.device)
    limit = min(pos + 1, T) if window else pos + 1
    s = s.masked_fill(idx >= limit, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bgnt,btgd->bgnd", p, cache_v.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_partial_ref(q: torch.Tensor, k_slice: torch.Tensor,
                                 v_slice: torch.Tensor, *, limit: int):
    """q (B,H,D); a slice of the caches (B,T_loc,Hkv,D), its first ``limit``
    keys valid -> (out (B,H,D) in q's dtype, lse (B,H) fp32), in fp32: the
    slice's attention and the log-sum-exp of its scaled scores.  With no
    valid key, zeros and ``-inf``."""
    B, H, D = q.shape
    Hkv = k_slice.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bgnd,btgd->bgnt", qg, k_slice[:, :limit].float())
    s = s / math.sqrt(D)
    lse = torch.logsumexp(s, dim=-1)                  # -inf over no key
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bgnt,btgd->bgnd", p, v_slice[:, :limit].float())
    return out.reshape(B, H, D).to(q.dtype), lse.reshape(B, H)
