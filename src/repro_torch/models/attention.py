"""GQA/MQA and DeepSeek-style MLA attention for training, prefill and
single-token decode (PyTorch port of ``repro.models.attention``:
``gqa_specs``, ``gqa_qkv``, ``blockwise_attention`` with its ``pairs``
schedule, ``gqa_attend``, ``gqa_train``, ``gqa_prefill``, ``gqa_decode``,
``mla_specs``, ``mla_project_q``, ``mla_latents``, ``mla_train``,
``mla_prefill``, ``mla_decode``).

Three impls of each attention (``IMPLS``):

* ``kernel`` (default) — the hand-written Hopper kernels on a CUDA device
  (``kernels.flash_attention`` for training and prefill,
  ``kernels.decode_attention`` for decode), their plain versions on the CPU;
* ``torch`` — plain ops, mirroring the JAX package's ``xla`` branch
  (``blockwise_attention`` over every block pair);
* ``torch_pairs`` — the JAX ``xla_pairs`` branch: ``blockwise_attention``
  over the lower-triangular block pairs only.  Decode has one plain path,
  which both plain impls take.

Local (sliding-window) layers keep a ring-buffer cache of size ``window``
(slot ``pos % window``).  A windowed prefill cache is the last ``window``
keys in order, as JAX keeps it, so decode continues from it at the right
slots only when the prompt is at most ``window`` long or a multiple of it.

Under a mesh the operands are DTensors.  JAX leaves the partitioning of its
Pallas calls to GSPMD; the port runs each kernel, and the plain impls too,
on every rank's shards (``distributed.sharding.local_call``: the batch and
the query heads split, the rest whole), with the same result, because no
(batch, head) row of attention needs another's.  Where the KV heads do not
divide the model axis they stay whole, and each rank gives the kernel only
the KV heads its query heads use.  Where the rules split a decode cache
over its keys (``--seq-shard``), each rank attends over its own slice and
the ranks merge their partials by log-sum-exp
(``distributed.sharding.split_call``), so that no cache is gathered.

MLA runs no kernel, as in JAX: training and prefill expand K/V from the
latents and run the plain ``blockwise_attention`` under every impl (on each
rank's shards under a mesh, through ``local_call``, as a kernel); decode is
the absorbed form in plain ops over a cache of the latents only.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (distribute, is_dtensor,
                                              local_call, split_call,
                                              split_dims, write_slot)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_partial,
                                                  decode_attention_partial_ref)
from repro_torch.kernels.flash_attention import flash_attention

from .layers import apply_rope
from .param import ParamSpec

NEG_INF = -1e30
IMPLS = ("kernel", "torch", "torch_pairs")


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


def mla_specs(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, ParamSpec]:
    ax = (None,) * len(stack)
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.nope_head_dim
    return {
        "w_dq": ParamSpec(stack + (d, m.q_lora_rank), ax + ("fsdp", None),
                          dtype=cfg.dtype),
        "q_norm": ParamSpec(stack + (m.q_lora_rank,), ax + (None,),
                            init="ones", dtype="float32"),
        "w_uq": ParamSpec(stack + (m.q_lora_rank, H, qk + m.rope_head_dim),
                          ax + (None, "model", None), dtype=cfg.dtype,
                          fan_in=m.q_lora_rank),
        "w_dkv": ParamSpec(stack + (d, m.kv_lora_rank), ax + ("fsdp", None),
                           dtype=cfg.dtype),
        "kv_norm": ParamSpec(stack + (m.kv_lora_rank,), ax + (None,),
                             init="ones", dtype="float32"),
        "w_uk": ParamSpec(stack + (m.kv_lora_rank, H, qk),
                          ax + (None, "model", None), dtype=cfg.dtype,
                          fan_in=m.kv_lora_rank),
        "w_uv": ParamSpec(stack + (m.kv_lora_rank, H, m.v_head_dim),
                          ax + (None, "model", None), dtype=cfg.dtype,
                          fan_in=m.kv_lora_rank),
        "w_kr": ParamSpec(stack + (d, m.rope_head_dim), ax + ("fsdp", None),
                          dtype=cfg.dtype),
        "wo": ParamSpec(stack + (H, m.v_head_dim, d),
                        ax + ("model", None, "fsdp"), dtype=cfg.dtype,
                        fan_in=H * m.v_head_dim),
    }


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
                        kv_block: int = 512, pairs: bool = False,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D); never materializes SxT.

    Queries sit at positions ``arange(S) + q_offset``, keys at ``arange(T)``.
    Every (q block, kv block) pair is computed, as in the JAX ``xla`` path,
    unless ``pairs``: then, when also ``causal``, ``S == T`` and the blocks
    are equal, only the lower-triangular pairs are (JAX's ``xla_pairs``),
    and ``q_offset`` is ignored there, as JAX ignores it.
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
                                  kv_block=kv_block, pairs=pairs,
                                  q_offset=q_offset)
        return out[:, :S]
    nq, nk = S // q_block, T // kv_block
    qg = q.reshape(B, nq, q_block, Hkv, G, D)
    kg = k.reshape(B, nk, kv_block, Hkv, D)
    vg = v.reshape(B, nk, kv_block, Hkv, D)
    if pairs and causal and S == T and q_block == kv_block:
        return _pairs_attention(qg, kg, vg, scale, window, q_block, nq)
    q_pos_all = torch.arange(S, device=q.device) + q_offset
    k_pos = torch.arange(T, device=q.device)
    outs = []
    for qi in range(nq):
        q_pos = q_pos_all[qi * q_block:(qi + 1) * q_block]
        acc, m, l = _initial_state(B, Hkv, G, q_block, D, q.device)
        for ki in range(nk):
            kp = k_pos[ki * kv_block:(ki + 1) * kv_block]
            mask = _block_mask(q_pos, kp, window) if (causal or window) else \
                torch.zeros((q_block, kv_block), device=q.device)
            acc, m, l = _online_block(acc, m, l, qg[:, qi], kg[:, ki],
                                      vg[:, ki], mask, scale)
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    return _assemble(outs, q.dtype)


def _initial_state(B, Hkv, G, blk, D, device):
    """The online softmax's (acc, m, l) before a q block's first kv block."""
    return (torch.zeros((B, Hkv, G, blk, D), dtype=torch.float32,
                        device=device),
            torch.full((B, Hkv, G, blk), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, Hkv, G, blk), dtype=torch.float32, device=device))


def _assemble(outs, dtype):
    """nq x (B, Hkv, G, blk, D) -> (B, S, H, D) in ``dtype``."""
    out = torch.stack(outs, dim=1)                     # (B, nq, Hkv, G, blk, D)
    B, nq, Hkv, G, blk, D = out.shape
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * blk, Hkv * G, D)
    return out.to(dtype)


def _pairs_attention(qg, kg, vg, scale, window, blk, nb):
    """The causal path over the lower-triangular block pairs only (JAX's
    ``_pairs_attention``): pairs in row-major order (qi ascending, ki
    ascending within qi), the online-softmax state carried for every q
    block, each finalized before the next row starts.  The states are a
    list, one entry a q block, so that autograd sees no in-place write."""
    B, Hkv, G, D = qg.shape[0], qg.shape[3], qg.shape[4], qg.shape[5]
    pos = torch.arange(nb * blk, device=qg.device)
    state = [_initial_state(B, Hkv, G, blk, D, qg.device) for _ in range(nb)]
    for qi, ki in [(qi, ki) for qi in range(nb) for ki in range(qi + 1)]:
        mask = _block_mask(pos[qi * blk:(qi + 1) * blk],
                           pos[ki * blk:(ki + 1) * blk], window)
        state[qi] = _online_block(*state[qi], qg[:, qi], kg[:, ki], vg[:, ki],
                                  mask, scale)
    return _assemble([acc / torch.clamp(l[..., None], min=1e-30)
                      for acc, _, l in state], qg.dtype)


# ------------------------------------------------------------ public paths
def gqa_attend(q, k, v, cfg, *, window: int = 0, impl: str = "kernel",
               q_offset: int = 0) -> torch.Tensor:
    """Causal attention by ``impl``; the kernel ignores ``q_offset``, as
    JAX's pallas branch does."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "kernel":
        return local_call(
            lambda q, k, v: flash_attention(q, k, v, causal=True,
                                            window=window, scale=scale),
            q, (k, v), q_dim=2, group_dim=2)
    if impl in ("torch", "torch_pairs"):
        # on each rank's (batch, head) shards, as the kernel runs: the
        # reshape of q's heads into (Hkv, G) would split a dim sharded
        # unevenly, and DTensor's einsum would merge a data-split batch dim
        # with a model-split head dim, which it places only by reading values
        return local_call(
            lambda q, k, v: blockwise_attention(
                q, k, v, scale=scale, causal=True, window=window,
                pairs=(impl == "torch_pairs"), q_offset=q_offset),
            q, (k, v), q_dim=2, group_dim=2)
    raise ValueError(f"unknown attention impl {impl!r}")


def gqa_train(params, x, positions, cfg, *, window: int = 0,
              impl: str = "kernel") -> torch.Tensor:
    q, k, v = gqa_qkv(params, x, positions, cfg)
    out = gqa_attend(q, k, v, cfg, window=window, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def gqa_prefill(params, x, positions, cfg, *, window: int = 0,
                impl: str = "kernel"):
    """Forward and the K/V cache this segment produces: (B,S,Hkv,D) each,
    or, with a window, the last ``window`` keys in order (``k[:, -window:]``,
    as JAX keeps them; not the ring buffer's slots ``p % window``)."""
    q, k, v = gqa_qkv(params, x, positions, cfg)
    out = gqa_attend(q, k, v, cfg, window=window, impl=impl)
    if window:
        k, v = k[:, -window:], v[:, -window:]
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)


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

    On a cache whose keys a mesh splits, each rank attends over its slice
    (the first ``min(pos + 1, T)`` keys of the whole are valid, under both
    cache rules) by the partial entry of the kernel, or under a plain impl
    by its plain version, and the slices merge by log-sum-exp.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = gqa_qkv(params, x, positions, cfg)
    slot = (pos % window) if window else pos
    write_slot(cache_k, slot, k[:, 0])
    write_slot(cache_v, slot, v[:, 0])
    if split_dims(cache_k, 1):
        partial = decode_attention_partial if impl == "kernel" else \
            decode_attention_partial_ref
        out = split_call(
            lambda q, k, v, limit: partial(q.contiguous(), k, v, limit=limit),
            q[:, 0], (cache_k, cache_v), limit=min(pos + 1, cache_k.shape[1]),
            q_dim=1, group_dim=2, key_dim=1)[:, None]
    elif impl == "kernel":
        out = local_call(
            lambda q, k, v: decode_attention(q.contiguous(), k, v, pos=pos,
                                             window=window),
            q[:, 0], (cache_k, cache_v), q_dim=1, group_dim=2)[:, None]
    else:
        out = local_call(
            lambda q, k, v: _attend_torch(q, k, v, pos, slot, window),
            q, (cache_k, cache_v), q_dim=2, group_dim=2)
    proj = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["wo"])
    return proj, cache_k, cache_v


# ------------------------------------------------------------------- MLA
def _mla_rms(scale, x, eps=1e-6):
    """MLA's own RMS norm of a latent: the square and mean in fp32, times
    the fp32 ``scale``, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def mla_project_q(params, x, positions, cfg):
    """x (B,S,d) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope), the latter
    rotated."""
    m = cfg.mla
    cq = _mla_rms(params["q_norm"], x @ params["w_dq"])
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"])
    q_nope = q[..., : m.nope_head_dim]
    q_rope = apply_rope(q[..., m.nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_latents(params, x, positions, cfg):
    """x (B,S,d) -> c_kv (B,S,r) normed, k_rope (B,S,rd) rotated (one rope
    key shared by every head)."""
    c_kv = _mla_rms(params["kv_norm"], x @ params["w_dkv"])
    k_rope = (x @ params["w_kr"])[:, :, None, :]                 # (B,S,1,rd)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_train(params, x, positions, cfg, *, impl: str = "kernel"
              ) -> torch.Tensor:
    """Training path: K/V expanded from the latents, then the plain
    ``blockwise_attention`` under every impl, as JAX runs it (no flash
    kernel at MLA's head dims), over the lower-triangular block pairs only
    under ``torch_pairs``.  V is padded up to the QK head dim so that one
    attention call serves both, and the output sliced back."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    m = cfg.mla
    q_nope, q_rope = mla_project_q(params, x, positions, cfg)
    c_kv, k_rope = mla_latents(params, x, positions, cfg)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])
    k_rope_h = k_rope[:, :, None, :].expand(
        k_rope.shape[:2] + (cfg.num_heads, m.rope_head_dim))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    # on each rank's (batch, head) shards, as the kernels run: DTensor's
    # einsum would merge a data-split batch dim with a model-split head dim
    # into one strided-shard dim, whose bmm it can place only by reading
    # values (which a fake tensor has not); V padded there too, as
    # DTensor's pad fails on some torch versions
    out = local_call(
        lambda q, k, v: blockwise_attention(
            q, k, F.pad(v, (0, q.shape[-1] - v.shape[-1])), scale=scale,
            causal=True, pairs=(impl == "torch_pairs")),
        q, (k, v), q_dim=2, group_dim=2)
    out = out[..., : m.v_head_dim]
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def mla_prefill(params, x, positions, cfg, *, impl: str = "kernel"):
    """Forward and the latent cache: (c_kv (B,S,r), k_rope (B,S,rd))."""
    out = mla_train(params, x, positions, cfg, impl=impl)
    return out, mla_latents(params, x, positions, cfg)


def mla_decode_partial(q_abs, q_rope, ckv, kr, limit: int, scale: float):
    """The absorbed attention over a slice of the latent caches, its first
    ``limit`` keys valid: q_abs (B,H,r), q_rope (B,H,rd), ckv (B,T_loc,r),
    kr (B,T_loc,rd) -> (ctx (B,H,r) in ``ckv``'s dtype, lse (B,H) fp32),
    the scores fp32 as ``mla_decode``'s.  With no valid key, zeros and
    ``-inf``."""
    ckv, kr = ckv[:, :limit], kr[:, :limit]
    s = torch.einsum("bhr,btr->bht", q_abs, ckv).float()
    s = s + torch.einsum("bhk,btk->bht", q_rope, kr).float()
    s = s * scale
    lse = torch.logsumexp(s, dim=-1)                  # -inf over no key
    p = torch.exp(s - lse[..., None])
    ctx = torch.einsum("bht,btr->bhr", p.to(ckv.dtype), ckv)
    return ctx, lse


def mla_decode(params, x, cache_ckv, cache_kr, pos: int, cfg):
    """Absorbed single-token MLA decode: attend in the latent space.

    x (B,1,d); caches (B,T,r) and (B,T,rd), which hold only the latents and
    the rope key; ``pos`` a host int.  Writes this token's latents into the
    caches IN PLACE at ``pos``, as ``gqa_decode`` writes its K and V, and
    returns them too.  ``W_uk`` is folded into the query and the context
    taken in the latent space, then projected through ``W_uv``; the scores
    and softmax are fp32.

    On caches whose keys a mesh splits, each rank runs
    :func:`mla_decode_partial` on its slice (the first ``pos + 1`` keys of
    the whole valid), and the slices' contexts merge by log-sum-exp
    (``split_call``) before ``W_uv`` and ``wo``: no latent and no score is
    made whole along the keys.

    Otherwise the scores are JAX's, but for where one sum is taken: a
    query projection whose contraction a mesh splits (x's d split over
    "model") leaves the rope query a pending sum, which is reduced on the
    (B, H, rd) query, onto ``q_abs``'s head split, and not on the (B, H, T)
    scores it would otherwise make pending.  ``decode_step`` hands the
    layer x whole over "model", so there it has no sum to reduce.
    """
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = mla_project_q(params, x, positions, cfg)   # (B,1,H,*)
    c_kv, k_rope = mla_latents(params, x, positions, cfg)   # (B,1,r), (B,1,rd)
    write_slot(cache_ckv, pos, c_kv[:, 0])
    write_slot(cache_kr, pos, k_rope[:, 0])
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["w_uk"])
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    if split_dims(cache_ckv, 1):
        r = q_abs.shape[-1]
        # one query operand (B,H,r+rd); the caches as one group head each
        ctx = split_call(
            lambda q, ckv, kr, limit: mla_decode_partial(
                q[..., :r], q[..., r:], ckv[:, :, 0], kr[:, :, 0], limit,
                scale),
            torch.cat([q_abs, q_rope[:, 0].to(q_abs.dtype)], dim=-1),
            (cache_ckv[:, :, None], cache_kr[:, :, None]),
            limit=min(pos + 1, cache_ckv.shape[1]), q_dim=1, group_dim=2,
            key_dim=1).to(cache_ckv.dtype)
    else:
        q_rope = q_rope[:, 0]
        if is_dtensor(q_rope):
            # with x's d split over "model" the rope query is a pending
            # sum; reduced onto q_abs's head split here, on (B, H, rd),
            # its scores are not reduce-scattered (B, H, T)
            q_rope = distribute(q_rope, q_abs.device_mesh, q_abs.placements)
        s = torch.einsum("bhr,btr->bht", q_abs, cache_ckv).float()
        s = s + torch.einsum("bhk,btk->bht", q_rope, cache_kr).float()
        s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
        T = cache_ckv.shape[1]
        s = s.masked_fill(torch.arange(T, device=x.device) > pos, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bht,btr->bhr", p.to(cache_ckv.dtype), cache_ckv)
    out = torch.einsum("bhr,rhk->bhk", ctx, params["w_uv"])       # (B,H,vd)
    proj = torch.einsum("bhk,hkd->bd", out.to(x.dtype), params["wo"])[:, None]
    return proj, cache_ckv, cache_kr
