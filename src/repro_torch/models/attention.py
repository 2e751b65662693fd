"""GQA/MQA attention for training and single-token decode (PyTorch port of
``repro.models.attention``: ``gqa_specs``, ``gqa_qkv``, ``blockwise_attention``,
``gqa_attend``, ``gqa_train``, ``gqa_decode``).

Two impls of each attention:

* ``kernel`` (default) — the hand-written Hopper kernels on a CUDA device
  (``kernels.flash_attention`` for training, ``kernels.decode_attention`` for
  decode), their plain versions on the CPU;
* ``torch`` — plain ops, mirroring the JAX package's ``xla`` branch
  (``blockwise_attention`` for training).

Local (sliding-window) layers keep a ring-buffer cache of size ``window``.
Prefill, the ``pairs`` schedule of ``blockwise_attention`` and MLA come in
later slices.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

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


# -------------------------------------------------- blockwise plain attention
def _block_mask(q_pos, k_pos, window: int):
    """(qc, kc) additive mask for causal (+ optional sliding window)."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = diff >= 0
    if window:
        ok = ok & (diff < window)
    return torch.where(ok, 0.0, NEG_INF)


def _online_block(acc, m, l, q, k, v, mask, scale):
    """One (q-block x kv-block) online-softmax update. fp32 stats."""
    s = torch.einsum("bqgnd,bkgd->bgnqk", q, k).float() * scale
    s = s + mask[None, None, None, :, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bgnqk,bkgd->bgnqd", p.to(v.dtype), v).float()
    return acc_new, m_new, l_new


def blockwise_attention(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, q_block: int = 512,
                        kv_block: int = 512) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D); never materializes SxT.

    Every (q block, kv block) pair is computed, as in the JAX ``xla`` path.
    """
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q_block = min(q_block, S)
    kv_block = min(kv_block, T)
    if S % q_block or T % kv_block:
        # pad to block multiples; padded keys sit at positions >= T so the
        # causal mask hides them, padded query rows are sliced off below
        S_pad = -(-S // q_block) * q_block
        T_pad = -(-T // kv_block) * kv_block
        q_p = F.pad(q, (0, 0, 0, 0, 0, S_pad - S))
        k_p = F.pad(k, (0, 0, 0, 0, 0, T_pad - T))
        v_p = F.pad(v, (0, 0, 0, 0, 0, T_pad - T))
        out = blockwise_attention(q_p, k_p, v_p, scale=scale, causal=True,
                                  window=window, q_block=q_block,
                                  kv_block=kv_block)
        return out[:, :S]
    nq, nk = S // q_block, T // kv_block
    qg = q.reshape(B, nq, q_block, Hkv, G, D)
    kg = k.reshape(B, nk, kv_block, Hkv, D)
    vg = v.reshape(B, nk, kv_block, Hkv, D)
    q_pos_all = torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    outs = []
    for qi in range(nq):
        q_pos = q_pos_all[qi * q_block:(qi + 1) * q_block]
        acc = torch.zeros((B, Hkv, G, q_block, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, Hkv, G, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_block), dtype=torch.float32,
                        device=q.device)
        for ki in range(nk):
            kp = k_pos[ki * kv_block:(ki + 1) * kv_block]
            mask = _block_mask(q_pos, kp, window) if (causal or window) else \
                torch.zeros((q_block, kv_block), device=q.device)
            acc, m, l = _online_block(acc, m, l, qg[:, qi], kg[:, ki],
                                      vg[:, ki], mask, scale)
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    # nq x (B, Hkv, G, q_block, D) -> (B, S, H, D)
    out = torch.stack(outs, dim=1)                     # (B, nq, Hkv, G, qb, D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, Hkv * G, D)
    return out.to(q.dtype)


# ------------------------------------------------------------ public paths
def gqa_attend(q, k, v, cfg, *, window: int = 0,
               impl: str = "kernel") -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "kernel":
        return flash_attention(q, k, v, causal=True, window=window,
                               scale=scale)
    if impl == "torch":
        return blockwise_attention(q, k, v, scale=scale, causal=True,
                                   window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


def gqa_train(params, x, positions, cfg, *, window: int = 0,
              impl: str = "kernel") -> torch.Tensor:
    q, k, v = gqa_qkv(params, x, positions, cfg)
    out = gqa_attend(q, k, v, cfg, window=window, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


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
