"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch (PyTorch
port of ``repro.models.moe``).

Tokens are sorted by expert id (a stable sort), placed into a compact (E, C,
d) buffer, computed with one batched product per FFN matrix, and combined
back with the top-k router weights.  Every shape comes from the input's
static shape, and nothing reads a device value back to the host: the
queue starts come from ``searchsorted`` on the sorted ids, where
``bincount`` would read its input's largest value first.

Two departures from the JAX package's order of operations, each with the
same result:

* assignments dropped at capacity go to one spare row past the (E, C)
  slots, which is cut away, where JAX adds them as zeros into slot C-1 of
  their expert; a plain index copy then never has two kept rows on one
  slot, whatever order the device writes in;
* the combine takes each token's k expert outputs back through the sort's
  inverse permutation and adds them in ascending expert id, starting from
  the lowest: the order in which JAX's scatter-add meets them, since the
  sort is stable by expert.  An atomic scatter-add would add them in an
  order that changes from run to run, and so would its bf16 rounding.

Routers: ``softmax`` (granite) and ``sigmoid`` (DeepSeek-V3: sigmoid
affinities, top-k, weights renormalised over the selected set).  The aux
load-balance loss is Switch's, on the top-1 choice.  ``torch.topk`` does
not promise which of two equal scores comes first, where ``jax.lax.top_k``
takes the lower index; the router's logits are fp32, so a tie is as rare
as two equal fp32 products.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import whole_call

from .param import ParamSpec


def moe_specs(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, ParamSpec]:
    ax = (None,) * len(stack)
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_expert
    specs = {
        "router": ParamSpec(stack + (d, E), ax + (None, None), dtype="float32"),
        "wi": ParamSpec(stack + (E, d, f), ax + ("expert", "fsdp", None),
                        dtype=cfg.dtype),
        "wg": ParamSpec(stack + (E, d, f), ax + ("expert", "fsdp", None),
                        dtype=cfg.dtype),
        "wo": ParamSpec(stack + (E, f, d), ax + ("expert", None, "fsdp"),
                        dtype=cfg.dtype),
    }
    if m.num_shared:
        fs = f * m.num_shared
        specs["shared_wi"] = ParamSpec(stack + (d, fs), ax + ("fsdp", "model"),
                                       dtype=cfg.dtype)
        specs["shared_wg"] = ParamSpec(stack + (d, fs), ax + ("fsdp", "model"),
                                       dtype=cfg.dtype)
        specs["shared_wo"] = ParamSpec(stack + (fs, d), ax + ("model", "fsdp"),
                                       dtype=cfg.dtype)
    return specs


def _route(params, x2d: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (top-k expert ids (T,k), fp32 weights (T,k), aux loss)."""
    m = cfg.moe
    logits = x2d.float() @ params["router"].float()
    if m.router == "sigmoid":                     # DeepSeek-V3
        scores = torch.sigmoid(logits)
        w, idx = torch.topk(scores, m.top_k, dim=-1)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, m.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load balance: E * sum_e mean_tokens(frac_e) * mean(prob_e)
    E = m.num_experts
    experts = torch.arange(E, device=x2d.device)
    frac = (idx[:, :1] == experts).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return idx, w, aux


def capacity(tokens: int, cfg) -> int:
    """Slots per expert: ``capacity_factor`` times an even share of the
    assignments, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int((tokens * m.top_k / m.num_experts) * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def dispatch(idx: torch.Tensor, cap: int, num_experts: int):
    """The sort-based dispatch plan of top-k ids ``idx`` (T, k), made on
    ``idx``'s device without a host sync.

    Returns ``order`` (the stable sort of the T*k assignments by expert),
    ``se`` (their expert ids in that order), ``pos`` (each sorted
    assignment's place in its expert's queue) and ``keep`` (``pos < cap``).
    """
    T, k = idx.shape
    flat_e = idx.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e.index_select(0, order)
    experts = torch.arange(num_experts, device=idx.device, dtype=se.dtype)
    starts = torch.searchsorted(se, experts)       # first slot of each expert
    pos = torch.arange(T * k, device=idx.device) - starts.index_select(0, se)
    return order, se, pos, pos < cap


def moe_apply(params, x: torch.Tensor, cfg,
              shard=lambda x, axes=None: x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar).

    ``shard`` pins the intermediates at the JAX function's sites: the tokens
    on the batch axis, the (E, C, d) buffers and the expert FFN on the
    expert axis.  Under a mesh the dispatch plan and the row gathers around
    the buffer (``searchsorted``, ``index_copy``, ``index_select``, which
    DTensor has no rules for) run on the whole token table on every rank
    (``whole_call``), where JAX shards the expert-sorted table (``se``,
    ``st``, ``sw``, ``pos``, the gathered rows and ``y``) on the expert
    axis: the same values, and each rank then keeps its experts' rows.
    """
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = m.top_k, m.num_experts
    x2d = shard(x.reshape(T, d), ("batch", None))
    idx, w, aux = _route(params, x2d, cfg)
    cap = capacity(T, cfg)

    def into_buffer(x2d, idx, w):
        order, se, pos, keep = dispatch(idx, cap, E)
        st = order // k                            # token of each assignment
        sw = w.reshape(T * k).index_select(0, order)
        # kept assignments to their slot, dropped ones to the spare row E*cap
        slot = torch.where(keep, se * cap + pos, E * cap)
        buf = x2d.new_zeros((E * cap + 1, d)).index_copy(
            0, slot, x2d.index_select(0, st))
        return buf[:E * cap].view(E, cap, d), order, se, pos, keep, sw

    def combine(out_buf, idx, order, se, pos, keep, sw):
        out_buf = out_buf.reshape(E * cap, d)
        pos_c = torch.clamp(pos, max=cap - 1)
        y = out_buf.index_select(0, se * cap + pos_c) * \
            (keep.to(x.dtype) * sw.to(x.dtype))[:, None]
        # each token's k rows in ascending expert id: the sorted position of
        # assignment t*k + j is inv[t*k + j], and argsort(idx) orders j by id
        inv = torch.empty_like(order).index_copy_(
            0, order, torch.arange(T * k, device=order.device))
        by_id = torch.argsort(idx, dim=-1) + \
            torch.arange(0, T * k, k, device=order.device)[:, None]
        y = y.index_select(0, inv.index_select(0, by_id.reshape(T * k)))
        y = y.view(T, k, d)
        out = y[:, 0]
        for j in range(1, k):
            out = out + y[:, j]
        return out

    buf, *plan = whole_call(into_buffer, x2d, idx, w)
    buf = shard(buf, ("expert", None, None))
    h = torch.bmm(buf, params["wi"])
    g = torch.bmm(buf, params["wg"])
    h = shard(F.silu(g) * h, ("expert", None, None))
    out_buf = shard(torch.bmm(h, params["wo"]), ("expert", None, None))
    out = shard(whole_call(combine, out_buf, idx, *plan), ("batch", None))

    if m.num_shared:
        sh = x2d @ params["shared_wi"]
        sg = x2d @ params["shared_wg"]
        out = out + (F.silu(sg) * sh) @ params["shared_wo"]
    return out.reshape(B, S, d), aux
