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

from repro_torch.distributed.sharding import (_groups_of, _local_range,
                                              distribute, gather_over,
                                              is_dtensor, reduce_pending,
                                              share_sum)

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


def _conv_shifts(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifts (kernel K small). xbc (B,S,C)."""
    K = w.shape[0]
    out = xbc * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[K - 1 - i]
    return F.silu(out + b)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                eps: float, total=reduce_pending, width: int = 0
                ) -> torch.Tensor:
    """RMS norm of y * silu(z) over its last dim, of ``width`` channels
    (y's own, by default): ``total`` makes the sum of squares whole (on
    DTensors, whose y a mesh splits over "model" along the mean's dim, a
    pending sum is reduced here and not reduce-scattered over the
    sequence; on one rank's channels, the sum over the ranks that hold the
    others)."""
    out_dtype = z.dtype  # z comes straight from the (bf16) projection
    yf = y.float() * F.silu(z.float())
    var = total(torch.sum(torch.square(yf), dim=-1, keepdim=True)
                ) / (width or yf.shape[-1])
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


def _on_heads(p, zxbcdt, cfg, scan, h0: int, H: int, total=lambda s: s):
    """The layer from its input projection's output ``zxbcdt`` (B, S, ...)
    to its output projection, for the heads ``[h0, h0 + H)``, on plain
    tensors -> (out (B, S, d), their final state (B, H, N, P), the
    convolution's input xBC (B, S, conv_dim), a view of ``zxbcdt``).

    ``p``'s per-head leaves (``A_log``, ``D``, ``dt_bias``, ``norm`` and
    ``out_proj``'s rows) hold those heads only; ``conv_w`` and ``conv_b``
    every channel.  The convolution, depthwise, runs on the heads' x
    channels and every B/C channel; ``scan(x, dt, A, Bm, Cm)`` is handed
    the B/C groups the heads read.  ``total`` makes the gated norm's sum of
    squares whole over the ranks that hold the other heads; ``out`` is then
    this rank's share of the output projection's sum."""
    s = cfg.ssm
    d_in, G, N, P, nh = (cfg.expand_dim, s.n_groups, s.d_state, s.head_dim,
                         cfg.ssm_heads)
    B, S = zxbcdt.shape[:2]
    c0, c1, w = h0 * P, (h0 + H) * P, H * P
    xbc_raw = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    z = zxbcdt[..., c0:c1]
    dt = zxbcdt[..., 2 * d_in + 2 * G * N + h0:2 * d_in + 2 * G * N + h0 + H]
    mine = (lambda t: t) if H == nh else \
        (lambda t: torch.cat([t[..., c0:c1], t[..., d_in:]], dim=-1))
    xbc = _conv_shifts(mine(xbc_raw), mine(p["conv_w"]), mine(p["conv_b"]))
    x = xbc[..., :w].reshape(B, S, H, P)
    Bm, Cm = (_groups_of(xbc[..., w + i * G * N:w + (i + 1) * G * N]
                         .reshape(B, S, G, N), 2, h0, H, nh // G)
              for i in (0, 1))
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_final = scan(x, dt, A, Bm, Cm)
    y = y + x * p["D"][:, None].to(x.dtype)
    y = _gated_norm(p["norm"], y.reshape(B, S, w), z, cfg.norm_eps, total,
                    d_in)
    return y @ p["out_proj"], h_final, xbc_raw


def _heads_of(A_log, mesh, nh: int):
    """(the mesh dims that split the heads, as they split ``A_log``; the
    first of this rank's heads; how many it holds)."""
    from torch.distributed.tensor import Shard
    heads = [i for i in range(mesh.ndim)
             if is_dtensor(A_log) and A_log.placements[i] == Shard(0)]
    split, index = 1, 0
    for i in heads:
        split *= mesh.shape[i]
        index = index * mesh.shape[i] + mesh.get_coordinate()[i]
    H = nh // split
    return heads, index * H, H


def ssd_per_shard(scan, p, zxbcdt, cfg):
    """The layer from ``zxbcdt``, its input projection's output, to its
    output projection, each rank on its own heads -> (out, the final state
    (B, nh, N, P), the convolution's input xBC): :func:`_on_heads`, which
    calls ``scan(x, dt, A, Bm, Cm)``, an SSD scan -> (y, final state).

    Under a mesh each rank holds ``zxbcdt`` whole along its channels for
    its own batch shard (the all-gather of the projection's model split)
    and works on the heads the mesh dims that split ``A_log`` give it, on
    plain tensors: the depthwise convolution on its heads' x channels and
    every B/C channel, its heads' scan with the B/C groups they read, the
    gated norm (its sum of squares all-reduced over those dims, forward
    and backward) and its rows of the output projection, whose output is
    left a pending sum over them.  dx, dz and d(dt) stay on the rank that
    owns their heads, and each rank's dB and dC are its own heads' share:
    the gradient of ``zxbcdt`` is a pending sum (each rank's heads'
    channels, zeros elsewhere, and its shares of B and C), which the
    all-gather's backward reduce-scatters onto the projection's split,
    summing dB and dC on the way.  No other tensor of the layer is
    exchanged, forward or backward: DTensor's own placement of these ops
    all-reduced the whole xBC gradient (B/data, S, conv_dim) each layer,
    and split and re-gathered the norm's and the gate's gradients."""
    nh = cfg.ssm_heads
    if not is_dtensor(zxbcdt):
        return _on_heads(p, zxbcdt, cfg, scan, 0, nh)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = zxbcdt.device_mesh
    dims = range(mesh.ndim)
    heads, h0, H = _heads_of(p["A_log"], mesh, nh)
    batch = [i for i in dims if zxbcdt.placements[i] == Shard(0)]

    def local(t, held, grad, rows=False):
        """t's shard: per mesh dim, ``held`` on a heads dim, on a batch dim
        split as the batch where its dim 0 is the batch (``rows``), whole
        elsewhere; its gradient ``grad`` on a heads dim, on a batch dim
        split as the batch or a pending sum."""
        pl = [held if i in heads else Shard(0) if rows and i in batch
              else Replicate() for i in dims]
        gr = [grad if i in heads else (Shard(0) if rows else Partial())
              if i in batch else Replicate() for i in dims]
        return distribute(t, mesh, pl).to_local(grad_placements=gr)
    # the batch's rows whole along the channels; the parameters split as
    # the heads, but for the convolution's, whole
    zx = local(zxbcdt, Replicate(), Partial(), rows=True)
    lp = {k: local(p[k], Shard(0), Shard(0))
          for k in ("A_log", "D", "dt_bias", "norm", "out_proj")}
    for k in ("conv_w", "conv_b"):
        lp[k] = local(p[k], Replicate(), Partial())
    out, state, xbc = _on_heads(
        lp, zx, cfg, scan, h0, H,
        lambda s: share_sum(s, mesh, heads))
    place = lambda held: [held if i in heads else Shard(0) if i in batch
                          else Replicate() for i in dims]
    return (DTensor.from_local(out, mesh, place(Partial()), run_check=False),
            DTensor.from_local(state, mesh, place(Shard(1)), run_check=False),
            DTensor.from_local(xbc, mesh, place(Replicate()),
                               run_check=False))


# ------------------------------------------------------------- layer fwd
def mamba2_forward(params, u: torch.Tensor, cfg, *, impl: str = "kernel",
                   init_state=None, return_state: bool = False):
    """Full Mamba2 layer: in_proj -> conv -> SSD -> gated norm -> out_proj.

    ``impl="kernel"`` takes no ``init_state`` (nor does the JAX package's
    kernel path): passing one raises rather than dropping it.
    """
    chunk = cfg.ssm.chunk_size
    if impl == "kernel":
        if init_state is not None:
            raise ValueError("the ssd kernel takes no initial state; use "
                             "impl='torch'")
        from repro_torch.kernels.ssd_scan import ssd
        scan = lambda x, dt, A, Bm, Cm: ssd(x, dt, A, Bm, Cm, chunk=chunk)
    elif impl == "torch":
        scan = lambda x, dt, A, Bm, Cm: ssd_chunked(
            x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
    else:
        raise ValueError(f"unknown ssm impl {impl!r}")
    out, h_final, _ = ssd_per_shard(scan, params, u @ params["in_proj"], cfg)
    if return_state:
        return out, h_final
    return out


def _step_on_heads(p, zx, state, conv, cfg, h0: int, H: int, c0: int = 0,
                   gather=lambda c: c, total=lambda s: s) -> torch.Tensor:
    """One token's step of the layer from its input projection's output
    ``zx`` (B, 1, ...), whole along its channels, to its output projection,
    for the heads ``[h0, h0 + H)``, on plain tensors -> out (B, 1, d).

    ``state`` (B, H, N, P) holds those heads' SSM state and ``conv`` (B,
    K-1, C) the conv cache's channels ``[c0, c0 + C)``; both are updated in
    place.  ``p``'s per-head leaves (``A_log``, ``D``, ``dt_bias``,
    ``norm`` and ``out_proj``'s rows) hold the heads, ``conv_w`` and
    ``conv_b`` the conv cache's channels.  ``gather`` makes the
    convolution's output on those channels (B, C) whole (B, conv_dim);
    ``total`` makes the gated norm's sum of squares whole over the ranks
    that hold the other heads, and ``out`` is then this rank's share of the
    output projection's sum.  With every head and channel it computes
    JAX's step, op for op."""
    s = cfg.ssm
    d_in, G, N, P, nh = (cfg.expand_dim, s.n_groups, s.d_state, s.head_dim,
                         cfg.ssm_heads)
    xbc = zx[..., d_in:2 * d_in + 2 * G * N]               # (B,1,conv_dim)
    window = torch.cat([conv, xbc[..., c0:c0 + conv.shape[-1]]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv.copy_(window[:, 1:])
    conv_out = gather(F.silu(conv_out))[:, None]           # (B,1,conv_dim)
    xt = conv_out[..., h0 * P:(h0 + H) * P].reshape(-1, H, P)
    Bt, Ct = (_groups_of(conv_out[..., d_in + i * G * N:d_in + (i + 1) * G * N]
                         .reshape(-1, G, N), 1, h0, H, nh // G)
              for i in (0, 1))
    Bt = Bt.repeat_interleave(H // Bt.shape[1], dim=1)
    Ct = Ct.repeat_interleave(H // Ct.shape[1], dim=1)
    dt = zx[..., 2 * d_in + 2 * G * N + h0:2 * d_in + 2 * G * N + h0 + H]
    dtt = F.softplus(dt.float() + p["dt_bias"])[:, 0]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtt * A)                              # (B,H)
    new_state = state * decay[..., None, None] + torch.einsum(
        "bhn,bhp,bh->bhnp", Bt, xt, dtt.to(xt.dtype)).to(state.dtype)
    y = torch.einsum("bhn,bhnp->bhp", Ct, new_state.to(Ct.dtype))
    state.copy_(new_state)
    y = y + xt * p["D"][:, None].to(xt.dtype)
    y = y.reshape(-1, 1, H * P)
    y = _gated_norm(p["norm"], y, zx[..., h0 * P:(h0 + H) * P], cfg.norm_eps,
                    total, d_in)
    return y @ p["out_proj"]


def mamba2_decode_step(params, u: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor, cfg):
    """One-token decode. u (B,1,d); ssm_state (B,nh,N,P);
    conv_state (B,K-1,conv_dim). Returns (out, ssm_state, conv_state), the
    two caches updated in place.

    Under a mesh each rank works on the caches' shards it holds, on plain
    tensors (:func:`_step_on_heads`): the projection's row made whole along
    its channels for the rank's batch rows (one all-gather over the model
    split); the convolution on the conv cache's own channel shard (JAX's
    layout, split over "model" where the mesh divides conv_dim), whose
    output row is all-gathered (no collective where the cache is whole);
    the recurrence of the heads that the mesh dims splitting ``A_log`` give
    it, on its own shard of the state, which is never gathered; the gated
    norm's sum of squares all-reduced over those dims; its rows of the
    output projection, whose output is left a pending sum over them."""
    nh = cfg.ssm_heads
    zxbcdt = u @ params["in_proj"]
    if not is_dtensor(zxbcdt):
        return (_step_on_heads(params, zxbcdt, ssm_state, conv_state, cfg, 0,
                               nh), ssm_state, conv_state)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = zxbcdt.device_mesh
    dims = range(mesh.ndim)
    heads, h0, H = _heads_of(params["A_log"], mesh, nh)
    batch = [i for i in dims if ssm_state.placements[i] == Shard(0)]
    chans = [i for i in dims if conv_state.placements[i] == Shard(2)]
    want = [Shard(1) if i in heads else Shard(0) if i in batch
            else Replicate() for i in dims]
    if list(ssm_state.placements) != want or any(
            (conv_state.placements[i] == Shard(0)) != (i in batch)
            for i in dims):
        raise ValueError(f"the SSM state placed {ssm_state.placements} and "
                         f"the conv cache {conv_state.placements}: the state "
                         f"must split its heads as A_log does, and both "
                         f"their batch alike")
    local = lambda t, split, d: distribute(t, mesh, [
        Shard(d) if i in split else Replicate() for i in dims]).to_local()
    zx = local(zxbcdt, batch, 0)      # the batch's rows, every channel
    lp = {k: local(params[k], heads, 0)
          for k in ("A_log", "D", "dt_bias", "norm", "out_proj")}
    lp["conv_w"] = local(params["conv_w"], chans, 1)
    lp["conv_b"] = local(params["conv_b"], chans, 0)
    c0 = _local_range(conv_state, 2)[0]

    def gather(c):
        if not chans:
            return c
        return gather_over(c, mesh, chans).movedim(0, 1).reshape(
            c.shape[0], -1)
    out = _step_on_heads(lp, zx, ssm_state.to_local(), conv_state.to_local(),
                         cfg, h0, H, c0, gather,
                         lambda s: share_sum(s, mesh, heads))
    place = [Partial() if i in heads else Shard(0) if i in batch
             else Replicate() for i in dims]
    return (DTensor.from_local(out, mesh, place, run_check=False), ssm_state,
            conv_state)
