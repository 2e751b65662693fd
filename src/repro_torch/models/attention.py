"""GQA/MQA attention for single-token decode (PyTorch port of
``repro.models.attention``: ``gqa_specs``, ``gqa_qkv``, ``gqa_decode``).

Two impls of the attention over the cache:

* ``kernel`` (default) — ``kernels.decode_attention``: the hand-written
  Hopper kernel on a CUDA device, its plain version on the CPU;
* ``torch`` — plain ops, mirroring the JAX package's ``xla`` branch.

Local (sliding-window) layers keep a ring-buffer cache of size ``window``.
The training and prefill paths and MLA come in later slices.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention

from .layers import apply_rope
from .param import ParamSpec

NEG_INF = -1e30


# ------------------------------------------------------------------ specs
def gqa_specs(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, ParamSpec]:
    ax = (None,) * len(stack)
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec(stack + (d, H, hd), ax + ("fsdp", "model", None),
                        dtype=cfg.dtype, fan_in=d),
        "wk": ParamSpec(stack + (d, Hkv, hd), ax + ("fsdp", "model", None),
                        dtype=cfg.dtype, fan_in=d),
        "wv": ParamSpec(stack + (d, Hkv, hd), ax + ("fsdp", "model", None),
                        dtype=cfg.dtype, fan_in=d),
        "wo": ParamSpec(stack + (H, hd, d), ax + ("model", None, "fsdp"),
                        dtype=cfg.dtype, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec(stack + (H, hd), ax + ("model", None), init="zeros",
                                dtype=cfg.dtype)
        specs["bk"] = ParamSpec(stack + (Hkv, hd), ax + ("model", None), init="zeros",
                                dtype=cfg.dtype)
        specs["bv"] = ParamSpec(stack + (Hkv, hd), ax + ("model", None), init="zeros",
                                dtype=cfg.dtype)
    return specs


# ------------------------------------------------------- qkv projections
def gqa_qkv(params, x, positions, cfg):
    """x (B,S,d), positions (B,S) -> q (B,S,H,D), k and v (B,S,Hkv,D)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend_torch(q, cache_k, cache_v, pos: int, slot: int, window: int):
    """The JAX ``xla`` branch in plain ops: q (B,1,H,D) -> (B,1,H,D)."""
    B, _, H, D = q.shape
    T, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bgnd,btgd->bgnt", qg, cache_k).float()
    s = s / math.sqrt(D)
    idx = torch.arange(T, device=q.device)
    if window:
        valid = (idx != slot) & (idx < min(pos, window))
        valid = valid | (idx == slot)
    else:
        valid = idx <= pos
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgnt,btgd->bgnd", p.to(cache_v.dtype), cache_v)
    return out.reshape(B, 1, H, D)


def gqa_decode(params, x, cache_k, cache_v, pos: int, cfg, *, window: int = 0,
               impl: str = "kernel"):
    """One-token decode. x (B,1,d); caches (B,T,Hkv,D); pos a host int.

    Writes this token's K and V into the caches IN PLACE, at slot
    ``pos % window`` for a ring buffer and ``pos`` otherwise, and returns them
    too, as the JAX function returns its updated caches (there the caller
    donates the old ones, so XLA updates them in place as well).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = gqa_qkv(params, x, positions, cfg)
    slot = (pos % window) if window else pos
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    if impl == "kernel":
        out = decode_attention(q[:, 0].contiguous(), cache_k, cache_v, pos=pos,
                               window=window)[:, None]
    elif impl == "torch":
        out = _attend_torch(q, cache_k, cache_v, pos, slot, window)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    proj = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["wo"])
    return proj, cache_k, cache_v
