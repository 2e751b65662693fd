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

from repro_torch.distributed.sharding import (distribute, gather_over,
                                              is_dtensor, reduce_over,
                                              sum_over)

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


def _top_k(router: torch.Tensor, x2d: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (top-k expert ids (T,k), fp32 weights (T,k), fp32 probs (T,E))."""
    m = cfg.moe
    logits = x2d.float() @ router.float()
    if m.router == "sigmoid":                     # DeepSeek-V3
        scores = torch.sigmoid(logits)
        w, idx = torch.topk(scores, m.top_k, dim=-1)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, m.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return idx, w, probs


def _route(params, x2d: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (top-k expert ids (T,k), fp32 weights (T,k), aux loss)."""
    idx, w, probs = _top_k(params["router"], x2d, cfg)
    # Switch-style load balance: E * sum_e mean_tokens(frac_e) * mean(prob_e)
    E = cfg.moe.num_experts
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


def _experts(buf: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """The expert FFN on a (E, C, d) buffer: one batched product a matrix."""
    h = torch.bmm(buf, wi)
    g = torch.bmm(buf, wg)
    return torch.bmm(F.silu(g) * h, wo)


def _combine(rows, idx, order, keep, sw, dtype):
    """Each token's k expert rows (in the sort's order), weighted, added in
    ascending expert id."""
    T, k = idx.shape
    y = rows * (keep.to(dtype) * sw.to(dtype))[:, None]
    # each token's k rows in ascending expert id: the sorted position of
    # assignment t*k + j is inv[t*k + j], and argsort(idx) orders j by id
    inv = torch.empty_like(order).index_copy_(
        0, order, torch.arange(T * k, device=order.device))
    by_id = torch.argsort(idx, dim=-1) + \
        torch.arange(0, T * k, k, device=order.device)[:, None]
    y = y.index_select(0, inv.index_select(0, by_id.reshape(T * k)))
    y = y.view(T, k, -1)
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out


def moe_apply(params, x: torch.Tensor, cfg,
              shard=lambda x, axes=None: x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar).

    ``shard`` pins the tokens on the batch axis, at the JAX function's site.
    On DTensors the dispatch runs on each rank's shards
    (:func:`_on_shards`): a rank holds its own tokens' (T/data * k, d) rows
    and its experts' (E/model, C, d) buffer, JAX's ("expert", None, None)
    shard, and never the whole token table or buffer.
    """
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = m.top_k, m.num_experts
    x2d = shard(x.reshape(T, d), ("batch", None))
    cap = capacity(T, cfg)
    if is_dtensor(x2d):
        out, aux = _on_shards(params, x2d, cap, cfg)
        out = shard(out, ("batch", None))
    else:
        idx, w, aux = _route(params, x2d, cfg)
        order, se, pos, keep = dispatch(idx, cap, E)
        sw = w.reshape(T * k).index_select(0, order)
        # kept assignments to their slot, dropped ones to the spare row E*cap
        slot = torch.where(keep, se * cap + pos, E * cap)
        buf = x2d.new_zeros((E * cap + 1, d)).index_copy(
            0, slot, x2d.index_select(0, order // k))
        out_buf = _experts(buf[:E * cap].view(E, cap, d), params["wi"],
                           params["wg"], params["wo"]).reshape(E * cap, d)
        rows = out_buf.index_select(
            0, se * cap + torch.clamp(pos, max=cap - 1))
        out = _combine(rows, idx, order, keep, sw, x.dtype)

    if m.num_shared:
        sh = x2d @ params["shared_wi"]
        sg = x2d @ params["shared_wg"]
        out = out + (F.silu(sg) * sh) @ params["shared_wo"]
    return out.reshape(B, S, d), aux


def _on_shards(params, x2d, cap: int, cfg
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing, dispatch, expert FFN and combine of DTensor tokens
    ``x2d`` (T, d), each rank on its shards -> (the (T, d) DTensor output,
    the aux loss, whole on every rank).

    The mesh dims that split the experts' weights on their expert dim hold
    the experts; those that split the tokens (and not the experts) hold the
    batch, in data order.  Each rank routes its own tokens (the aux loss's
    token means are sums over the batch dims) and sorts its assignments
    stably by expert; the per-expert counts, all-gathered over the batch
    dims (E integers a rank), give by an exclusive prefix over the ranks
    before it each assignment's place in its expert's global queue: JAX's
    ``argsort`` order over all T*k assignments, and so the same drops.
    Each rank writes its tokens' rows for its own experts at their global
    slots of a zero (E/model, C, d) buffer, summed over the batch dims; the
    expert products run on that shard.  Each rank then takes its tokens'
    rows from its experts' output; a sum over the expert dims brings each
    token all its k rows (one rank holds each, the others add zeros), and
    they are weighted and added in ascending expert id, as with no mesh.
    Nothing is read back to the host.
    """
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    m = cfg.moe
    k, E = m.top_k, m.num_experts
    T, d = x2d.shape
    mesh = x2d.device_mesh
    dims = range(mesh.ndim)
    wi = params["wi"]
    held = wi.placements if is_dtensor(wi) else [Replicate()] * mesh.ndim
    experts = [i for i in dims if held[i] == Shard(0)]
    batch = [i for i in dims if x2d.placements[i] == Shard(0)
             and i not in experts]
    rep = [Replicate()] * mesh.ndim
    tok = [Shard(0) if i in batch else Replicate() for i in dims]
    ex = [Shard(0) if i in experts else Replicate() for i in dims]
    # the gradient of a weight comes in part from each rank's tokens, and
    # that of a token's dispatched row in part from each rank of experts
    part = lambda pl, over: [Partial() if i in over else p
                             for i, p in enumerate(pl)]
    x2d = distribute(x2d, mesh, tok)
    x_route = x2d.to_local(grad_placements=tok)
    x_rows = x2d.to_local(grad_placements=part(tok, experts))
    router = distribute(params["router"], mesh, rep).to_local(
        grad_placements=part(rep, batch))
    wi, wg, wo = (distribute(params[n], mesh, ex).to_local(
        grad_placements=part(ex, batch)) for n in ("wi", "wg", "wo"))
    E_loc = wi.shape[0]
    with unset_fake_temporarily():
        e0 = compute_local_shape_and_global_offset(
            params["wi"].shape, mesh, ex)[1][0]

    idx, w, probs = _top_k(router, x_route, cfg)
    ids = torch.arange(E, device=idx.device)
    frac = reduce_over((idx[:, :1] == ids).float().sum(dim=0), "sum", mesh,
                       batch)
    aux = E * torch.sum((frac / T) * (sum_over(probs.sum(dim=0), mesh,
                                               batch) / T))

    T_loc = idx.shape[0]
    order, se, pos, keep = dispatch(idx, cap, E)
    if batch:
        counts = torch.searchsorted(se, ids, right=True) - \
            torch.searchsorted(se, ids)
        rank = 0                    # this rank's place in the data order
        for i in batch:
            rank = rank * mesh.shape[i] + mesh.get_coordinate()[i]
        before = gather_over(counts, mesh, batch)[:rank].sum(dim=0)
        pos = pos + before.index_select(0, se)
        keep = pos < cap
    sw = w.reshape(T_loc * k).index_select(0, order)
    mine = keep & (se >= e0) & (se < e0 + E_loc)
    # this rank's experts' kept assignments to their slot, the rest to the
    # spare row E_loc*cap
    slot = torch.where(mine, (se - e0) * cap + pos, E_loc * cap)
    buf = x_rows.new_zeros((E_loc * cap + 1, d)).index_copy(
        0, slot, x_rows.index_select(0, order // k))
    buf = sum_over(buf[:E_loc * cap], mesh, batch).view(E_loc, cap, d)
    out_buf = _experts(buf, wi, wg, wo).reshape(E_loc * cap, d)
    rows = out_buf.index_select(0, torch.where(mine, slot, 0))
    rows = sum_over(torch.where(mine[:, None], rows, 0), mesh, experts)
    out = _combine(rows, idx, order, keep, sw, x2d.dtype)
    return (DTensor.from_local(out, mesh, tok, run_check=False,
                               shape=x2d.shape, stride=x2d.stride()),
            DTensor.from_local(aux, mesh, rep, run_check=False))
