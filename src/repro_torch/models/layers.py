"""Shared neural layers: norms, rotary embeddings, GLU MLPs, embedding,
the loss and rematerialisation.

PyTorch port of ``repro.models.layers``: every layer is ``fn(params, x, ...)``
over plain tensors, with the JAX package's numerics (fp32 norm statistics,
fp32 rotary angles, tanh-approximated GELU, fp32 cross entropy).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (_local_range, distribute,
                                              is_dtensor, reduce_over)

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
    """``table[tokens]``.  A DTensor table is looked up by each rank on its
    own shard for its own tokens, with or without a gradient: made whole
    along d first where a mesh dim splits it there (the all-gather of the
    rank's vocab shard that its fsdp spec implies; ``Model.compute_params``
    has made it already), then, where a mesh dim splits the vocab, an id
    outside the rank's shard gives zeros and the rows are a pending sum
    (``Partial``) over those dims, reduced where they are next used (each
    row comes from the one rank that holds it): the masked partial sum
    DTensor's embedding makes, built here on local tensors.  The table's
    gradient is each rank's rows summed over the mesh dims that split the
    tokens.  DTensor's own lookup moves a vocab-split table to a split
    along d (an all-to-all of the whole table, every call), and on torch
    2.11 places its backward (an ``index_put`` with split indices) neither
    with a whole table nor with a vocab-split one where a batch dim is
    split.  Tokens split on a mesh dim that splits the vocab, which no rule
    makes, raise."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    tok = list(tokens.placements) if is_dtensor(tokens) else \
        [Replicate()] * mesh.ndim
    vocab = [p == Shard(0) for p in table.placements]
    if any(v and not t.is_replicate() for v, t in zip(vocab, tok)):
        raise ValueError(f"tokens placed {tok} on a mesh dim that splits the "
                         f"vocab of a table placed {list(table.placements)}")
    table = distribute(table, mesh, [p if v else Replicate() for v, p in
                                     zip(vocab, table.placements)])
    grad = [p if v else Partial() if t.is_shard() else Replicate()
            for v, p, t in zip(vocab, table.placements, tok)]
    local = table.to_local(grad_placements=grad)
    ids = tokens.to_local() if is_dtensor(tokens) else tokens
    if any(vocab):
        start, size = _local_range(table, 0)
        ids = ids - start
        inside = ((ids >= 0) & (ids < size))[..., None]
        rows = torch.where(inside, local[ids.clamp(0, size - 1)],
                           torch.zeros((), dtype=local.dtype,
                                       device=local.device))
    else:
        rows = local[ids]
    return DTensor.from_local(rows, mesh, [Partial() if v else t for v, t
                                           in zip(vocab, tok)],
                              run_check=False)


# ------------------------------------------------------------------- loss
def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE in fp32: logsumexp minus the gold logit, masked.

    On DTensors the loss is vocab-parallel (:func:`_vocab_parallel`): each
    rank works on its own shard of the logits, split over the batch and,
    where the rules split the vocabulary, over it, and the shards meet only
    in all-reduces of per-token and scalar values, as GSPMD inserts the
    cross-shard max/sum reductions.  No rank holds the whole batch's logits
    or a whole vocabulary, forward or backward.  The loss is whole on every
    rank.
    """
    if is_dtensor(logits) or is_dtensor(targets):
        return _vocab_parallel(logits, targets, mask)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


class _VocabParallelCE(torch.autograd.Function):
    """The CE of one rank's shard ``x`` (..., V_local) of fp32 logits, whose
    vocabulary starts at ``v0``: the max, the sum of exponentials and the
    gold logit all-reduced over the mesh dims ``vocab_dims`` that split the
    vocabulary, the masked sums over ``batch_dims``.  The backward,
    (softmax - onehot) * mask / count, is made on the shard from the saved
    logsumexp, with no exchange."""

    @staticmethod
    def forward(ctx, x, targets, mask, v0, count, mesh, vocab_dims,
                batch_dims):
        mx = reduce_over(torch.amax(x, dim=-1), "max", mesh, vocab_dims)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        sumexp = torch.sub(x, mx[..., None]).exp_().sum(dim=-1)
        lse = torch.log(reduce_over(sumexp, "sum", mesh, vocab_dims)) + mx
        local = targets.long() - v0
        held = (local >= 0) & (local < x.shape[-1])
        local = torch.where(held, local, 0)
        gold = torch.gather(x, -1, local[..., None])[..., 0]
        gold = reduce_over(torch.where(held, gold, 0.0), "sum", mesh,
                           vocab_dims)
        nll = lse - gold
        if mask is None:
            total = torch.sum(nll)
            m = None
        else:
            m = mask.float()
            total = torch.sum(nll * m)
            count = torch.sum(m)
        total = reduce_over(total, "sum", mesh, batch_dims)
        if m is not None:
            count = torch.clamp(reduce_over(count, "sum", mesh, batch_dims),
                                min=1.0)
        ctx.save_for_backward(x, lse, local, held, m, count)
        return total / count

    @staticmethod
    def backward(ctx, g):
        x, lse, local, held, m, count = ctx.saved_tensors
        grad = torch.sub(x, lse[..., None]).exp_()
        grad.scatter_add_(-1, local[..., None], -held.float()[..., None])
        scale = g / count
        grad.mul_(scale if m is None else (m * scale)[..., None])
        return grad, None, None, None, None, None, None, None


def _vocab_parallel(logits, targets, mask):
    """:func:`softmax_cross_entropy` on DTensors: each mesh dim splits the
    logits over a batch dim or over the vocabulary, or holds them whole (a
    pending sum is reduced first); the targets and mask are split as the
    logits' batch dims are."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = (logits if is_dtensor(logits) else targets).device_mesh
    n = logits.ndim
    given = logits.placements if is_dtensor(logits) else \
        [Replicate()] * mesh.ndim
    pl = [Shard(p.dim % n) if p.is_shard() else Replicate() for p in given]
    vocab_dims = [i for i, p in enumerate(pl) if p == Shard(n - 1)]
    batch_dims = [i for i, p in enumerate(pl) if p.is_shard() and
                  p.dim < n - 1]
    tpl = [p if i in batch_dims else Replicate() for i, p in enumerate(pl)]
    x = distribute(logits.float(), mesh, pl).to_local(grad_placements=pl)
    t = distribute(targets, mesh, tpl).to_local()
    m = None if mask is None else distribute(mask, mesh, tpl).to_local()
    with unset_fake_temporarily():
        v0 = compute_local_shape_and_global_offset(
            logits.shape, mesh, pl)[1][-1]
    count = torch.tensor(float(math.prod(logits.shape[:-1])),
                         device=x.device)
    loss = _VocabParallelCE.apply(x, t, m, v0, count, mesh, vocab_dims,
                                  batch_dims)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


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
