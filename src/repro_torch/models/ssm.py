"""Mamba2 layer via SSD (state-space duality, arXiv:2405.21060): the PyTorch
port of ``repro.models.ssm``.

Recurrence (per head h, scalar decay a_t = exp(dt_t * A_h)):

    H_t = a_t * H_{t-1} + dt_t * B_t ⊗ x_t          H ∈ R^{N×P}
    y_t = C_t · H_t + D_h * x_t

Training uses the chunked SSD decomposition: the sequence is split into
chunks of Q tokens; within a chunk the recurrence is a (Q×Q) masked-decay
matmul, across chunks a length-S/Q scan carries the (N×P) state.  Two impls of
the layer's scan:

* ``kernel`` (default) — ``kernels.ssd_scan.ssd``: the hand-written Hopper
  kernel on a CUDA device, ``ssd_chunked`` on the CPU;
* ``torch`` — ``ssd_chunked`` in plain ops, the JAX package's ``xla`` branch.

Each product has the dtype JAX's promotion gives it: ``torch.einsum`` takes
one dtype, so mixed bf16 x fp32 operands are cast to fp32 first, as
``jnp.einsum`` promotes them.

Decode is the O(1) recurrence step on a carried (nh, N, P) state plus a
(K-1)-deep causal-conv cache.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (batch_call, distribute,
                                              is_dtensor, local_call,
                                              reduce_pending, unshard)

from .param import ParamSpec


# ------------------------------------------------------------------- specs
def ssm_specs(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, ParamSpec]:
    ax = (None,) * len(stack)
    s = cfg.ssm
    d = cfg.d_model
    d_in = cfg.expand_dim
    nh = cfg.ssm_heads
    G, N = s.n_groups, s.d_state
    conv_dim = d_in + 2 * G * N
    proj_out = 2 * d_in + 2 * G * N + nh   # z, x, B, C, dt
    return {
        "in_proj": ParamSpec(stack + (d, proj_out), ax + ("fsdp", "model"),
                             dtype=cfg.dtype),
        "conv_w": ParamSpec(stack + (s.conv_kernel, conv_dim),
                            ax + (None, "model"), init="normal", dtype=cfg.dtype),
        "conv_b": ParamSpec(stack + (conv_dim,), ax + ("model",), init="zeros",
                            dtype=cfg.dtype),
        "A_log": ParamSpec(stack + (nh,), ax + ("model",), init="ssm_a",
                           dtype="float32"),
        "D": ParamSpec(stack + (nh,), ax + ("model",), init="ones", dtype="float32"),
        "dt_bias": ParamSpec(stack + (nh,), ax + ("model",), init="ssm_dt",
                             dtype="float32"),
        "norm": ParamSpec(stack + (d_in,), ax + ("model",), init="ones",
                          dtype="float32"),
        "out_proj": ParamSpec(stack + (d_in, d), ax + ("model", "fsdp"),
                              dtype=cfg.dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg):
    """z, x, B, C and dt from the input projection.  Under a mesh the
    projection is first made whole along its last dim, as slicing a dim
    split over the model axis would make it implicitly (the pieces' bounds
    are not the shards'); explicit, its gradient is a plain split, where
    DTensor's implicit one left a strided split that it places only by
    reading values (a fake tensor has none)."""
    s = cfg.ssm
    d_in, G, N = cfg.expand_dim, s.n_groups, s.d_state
    zxbcdt = unshard(zxbcdt, -1)
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    Bm = zxbcdt[..., 2 * d_in:2 * d_in + G * N]
    Cm = zxbcdt[..., 2 * d_in + G * N:2 * d_in + 2 * G * N]
    dt = zxbcdt[..., 2 * d_in + 2 * G * N:]
    return z, x, Bm, Cm, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifts (kernel K small). xbc (B,S,C).
    Under a mesh it runs on each rank's batch shard with the weights whole
    (``batch_call``): DTensor's ``pad`` fails on some torch versions."""
    return batch_call(_conv_shifts, xbc, w, b)


def _conv_shifts(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    K = w.shape[0]
    out = xbc * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[K - 1 - i]
    return F.silu(out + b)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    out_dtype = z.dtype  # z comes straight from the (bf16) projection
    yf = y.float() * F.silu(z.float())
    # under a mesh y is split over "model" along the mean's dim; reduced
    # here, the pending sum is not reduce-scattered over the sequence
    var = reduce_pending(torch.sum(torch.square(yf), dim=-1, keepdim=True)
                         ) / yf.shape[-1]
    return (yf * torch.rsqrt(var + eps) * scale).to(out_dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < m <= i} a_m for i >= j else -inf.  a (..., Q).

    Masked with -inf before the caller's ``exp``: the differences above the
    diagonal are large and positive, and an ``exp`` of them overflows to inf,
    whose gradient through a later mask is inf * 0 = NaN.
    """
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # (..., i, j): sum (j, i]
    ii = torch.arange(Q, device=a.device)
    mask = ii[:, None] >= ii[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def _chunk_len(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk "
                         f"{Q}")
    return Q


# ---------------------------------------------------------------- SSD core
def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """SSD over chunks.

    x  (B, S, nh, P)    dt (B, S, nh) fp32    A (nh,) negative, fp32
    Bm (B, S, G, N)     Cm (B, S, G, N)
    -> y (B, S, nh, P) in x.dtype, final_state (B, nh, N, P) fp32
    """
    Bsz, S, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = _chunk_len(S, chunk)
    nc = S // Q
    hg = nh // G                                        # heads per group
    xc = x.reshape(Bsz, nc, Q, nh, P)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bc = Bm.reshape(Bsz, nc, Q, G, N)
    Cc = Cm.reshape(Bsz, nc, Q, G, N)

    a = dtc * A                                          # (B,nc,Q,nh) decay logs (<=0)
    a_h = a.movedim(-1, 2)                               # (B,nc,nh,Q)
    L = torch.exp(_segsum(a_h))                          # (B,nc,nh,Q,Q)

    # intra-chunk (the quadratic-but-tiny part)
    scores_g = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)  # (B,nc,G,Q,Q)
    scores = scores_g.repeat_interleave(hg, dim=2)         # (B,nc,nh,Q,Q)
    M = scores * L * dtc.movedim(-1, 2)[:, :, :, None, :]  # fp32
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xc.to(M.dtype))

    # per-chunk summarized state:  states[c] = Σ_j exp(a_sum - cumsum_j) dt_j B_j ⊗ x_j
    a_cum = torch.cumsum(a_h, dim=-1)                     # (B,nc,nh,Q)
    a_tot = a_cum[..., -1]                                # (B,nc,nh)
    decay_out = torch.exp(a_tot[..., None] - a_cum)       # (B,nc,nh,Q)
    wts = decay_out * dtc.movedim(-1, 2)                  # (B,nc,nh,Q)
    Bh = Bc.repeat_interleave(hg, dim=3)                  # (B,nc,Q,nh,N)
    states = torch.einsum("bchj,bcjhn,bcjhp->bchnp", wts, Bh.to(wts.dtype),
                          xc.to(wts.dtype))

    # inter-chunk state scan; it emits the state BEFORE each chunk
    h = (torch.zeros((Bsz, nh, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(a_tot[:, c])[..., None, None] + states[:, c].float()
    h_prev = torch.stack(h_prevs, dim=1)                  # (B,nc,nh,N,P)

    # inter-chunk contribution:  y_inter[i] = exp(a_cum_i) * C_i · h_prev
    decay_in = torch.exp(a_cum)                           # (B,nc,nh,Q)
    Ch = Cc.repeat_interleave(hg, dim=3)                  # (B,nc,Q,nh,N)
    y_inter = torch.einsum("bcihn,bchnp,bchi->bcihp", Ch,
                           h_prev.to(Ch.dtype), decay_in.to(Ch.dtype))
    y = (y_intra + y_inter).reshape(Bsz, S, nh, P)
    return y.to(x.dtype), h


def ssd_reference(x, dt, A, Bm, Cm, init_state=None):
    """Naive per-token scan oracle (tests compare chunked + kernel to this)."""
    Bsz, S, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hg = nh // G
    Bh = Bm.repeat_interleave(hg, dim=2)
    Ch = Cm.repeat_interleave(hg, dim=2)
    h = (torch.zeros((Bsz, nh, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        xt, dtt, bt, ct = x[:, t], dt[:, t], Bh[:, t], Ch[:, t]
        decay = torch.exp(dtt * A)                         # (B,nh)
        h = h * decay[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhnp", bt.to(dtt.dtype), xt.to(dtt.dtype), dtt)
        ys.append(torch.einsum("bhn,bhnp->bhp", ct, h.to(ct.dtype)))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_per_shard(fn, x, dt, A, Bm, Cm):
    """``fn(x, dt, A, Bm, Cm)``, an SSD scan -> (y, final state), on each
    rank's shards under a mesh: the batch and the heads split, each rank's
    heads with the B/C groups they read (the scan needs no exchange).  x
    comes out of the convolution whole along its channels; its heads are
    split over the mesh dims that split A's (``A_log``'s spec puts them on
    "model"), so that each rank scans its own heads and not all of them.
    As DTensor ops, the scan's einsums would merge the data-split batch and
    the model-split heads into one strided-split dim, whose product DTensor
    places only by reading values (a fake tensor has none)."""
    if is_dtensor(x) and is_dtensor(A):
        from torch.distributed.tensor import Shard
        x = distribute(x, x.device_mesh, [
            Shard(2) if p.is_replicate() and a == Shard(0) else p
            for p, a in zip(x.placements, A.placements)])
    return local_call(lambda x, Bm, Cm, dt, A: fn(x, dt, A, Bm, Cm),
                      x, (Bm, Cm), ((dt, 2), (A, 0)), q_dim=2, group_dim=2,
                      outs=((0, None), (0, 1)))


# ------------------------------------------------------------- layer fwd
def mamba2_forward(params, u: torch.Tensor, cfg, *, impl: str = "kernel",
                   init_state=None, return_state: bool = False):
    """Full Mamba2 layer: in_proj -> conv -> SSD -> gated norm -> out_proj.

    ``impl="kernel"`` takes no ``init_state`` (nor does the JAX package's
    kernel path): passing one raises rather than dropping it.
    """
    s = cfg.ssm
    zxbcdt = u @ params["in_proj"]
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    d_in = cfg.expand_dim
    G, N, nh = s.n_groups, s.d_state, cfg.ssm_heads
    B, S = u.shape[:2]
    x = xbc[..., :d_in].reshape(B, S, nh, s.head_dim)
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if impl == "kernel":
        if init_state is not None:
            raise ValueError("the ssd kernel takes no initial state; use "
                             "impl='torch'")
        from repro_torch.kernels.ssd_scan import ssd
        y, h_final = ssd_per_shard(
            lambda x, dt, A, Bm, Cm: ssd(x, dt, A, Bm, Cm,
                                         chunk=s.chunk_size),
            x, dt, A, Bm, Cm)
    elif impl == "torch":
        y, h_final = ssd_chunked(x, dt, A, Bm, Cm, chunk=s.chunk_size,
                                 init_state=init_state)
    else:
        raise ValueError(f"unknown ssm impl {impl!r}")
    y = y + x * params["D"][:, None].to(x.dtype)
    y = y.reshape(B, S, d_in)
    y = _gated_norm(params["norm"], y, z, cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, h_final
    return out


def mamba2_decode_step(params, u: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor, cfg):
    """One-token decode. u (B,1,d); ssm_state (B,nh,N,P);
    conv_state (B,K-1,conv_dim). Returns (out, new_ssm_state, new_conv_state)."""
    s = cfg.ssm
    zxbcdt = u @ params["in_proj"]
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([x, Bm, Cm], dim=-1)                   # (B,1,conv_dim)
    window = torch.cat([conv_state, xbc], dim=1)           # (B,K,conv_dim)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"]) \
        + params["conv_b"]
    conv_out = F.silu(conv_out)[:, None]                   # (B,1,conv_dim)
    new_conv_state = window[:, 1:]
    d_in, G, N, nh = cfg.expand_dim, s.n_groups, s.d_state, cfg.ssm_heads
    xt = conv_out[..., :d_in].reshape(-1, nh, s.head_dim)
    Bt = conv_out[..., d_in:d_in + G * N].reshape(-1, G, N)
    Ct = conv_out[..., d_in + G * N:].reshape(-1, G, N)
    hg = nh // G
    Bt = Bt.repeat_interleave(hg, dim=1)
    Ct = Ct.repeat_interleave(hg, dim=1)
    dtt = F.softplus(dt.float() + params["dt_bias"])[:, 0]
    A = -torch.exp(params["A_log"])

    def recur(xt, state, Bt, Ct, dtt, A):
        decay = torch.exp(dtt * A)                          # (B,nh)
        new_state = state * decay[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhnp", Bt, xt, dtt.to(xt.dtype)).to(state.dtype)
        return (torch.einsum("bhn,bhnp->bhp", Ct, new_state.to(Ct.dtype)),
                new_state)
    # on each rank's (batch, head) shards under a mesh, as ssd_per_shard
    y, new_state = local_call(
        recur, xt, (), ((ssm_state, 1), (Bt, 1), (Ct, 1), (dtt, 1), (A, 0)),
        q_dim=1, group_dim=1, outs=((0, None), (0, 1)))
    y = y + xt * params["D"][:, None].to(xt.dtype)
    y = y.reshape(-1, 1, d_in)
    y = _gated_norm(params["norm"], y, z, cfg.norm_eps)
    return y @ params["out_proj"], new_state, new_conv_state
