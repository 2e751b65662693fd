"""Logical-axis -> mesh sharding rules, with divisibility safeguards (port of
``repro.distributed.sharding``).

Rules map logical axis names ("batch", "fsdp", "model", "heads", "vocab",
"ff", "expert", "seq") to mesh axes.  ``fit_spec`` drops a mesh axis when a
dimension does not divide it (e.g. starcoder2's 24 heads on a 16-wide model
axis, granite's 49155 vocab) — GQA KV replication and unsharded odd vocabs
are standard practice.

Per-cell rule selection, as in JAX:
* train/prefill/decode default: batch+fsdp -> ("pod","data"), tensor axes ->
  "model", seq unsharded;
* long_500k (global_batch=1): batch unshardable -> the KV/latent cache's
  *sequence* axis takes ("pod","data") instead (sequence-parallel decode).

A partition spec is a tuple of ``None | name | tuple of names`` per
dimension (see :mod:`repro_torch.models.param`).  Every function here reads
only a mesh's axis names and sizes, so the same rules serve a torch
``DeviceMesh`` and a mesh description (``launch.mesh.MeshDesc``) of a
production slice that no process group here could build.  ``placements_for``
turns a spec into DTensor placements: mesh dim ``i`` gets ``Shard(d)`` when
dimension ``d`` names its axis, ``Replicate()`` otherwise; a tuple entry
shards one dimension over several mesh dims, which DTensor splits left to
right, the first (major) mesh dim first: JAX's layout for the same entry.

The dependency-free partitioners at the top (``shard_groups``, ``shard_of``)
are reused by the lake's ``ScanPipeline.stream_sharded`` and serving tier to
assign chunk groups to workers; the model's parameter module is imported
inside the functions that need it, so that the lake does not load the
models.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# dependency-free work partitioners

def shard_groups(n_items: int, n_shards: int) -> List[List[int]]:
    """Partition ``range(n_items)`` across ``n_shards`` workers round-robin
    in item order: shard ``w`` owns items ``w, w + n_shards, ...``.

    Round-robin (rather than contiguous blocks) keeps the *earliest* items
    at the head of every shard's list, so when items are chunk groups in
    plan order each worker starts on the group the consumer needs soonest —
    the serving tier's ordered re-merge then never waits on a worker that
    is busy with far-future groups.  Empty shards are dropped.
    """
    if n_items < 0 or n_shards <= 0:
        raise ValueError(f"invalid partition: {n_items} items, "
                         f"{n_shards} shards")
    shards = [list(range(w, n_items, n_shards)) for w in range(n_shards)]
    return [s for s in shards if s]


def shard_of(item: int, n_shards: int) -> int:
    """Inverse of :func:`shard_groups`: which shard owns ``item``."""
    if n_shards <= 0:
        raise ValueError(f"invalid shard count {n_shards}")
    return item % n_shards


# ---------------------------------------------------------------------------
# mesh sharding rules

def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a mesh description (an object
    with ``axis_names`` and a ``shape`` mapping, as ``jax.sharding.Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def make_rules(kind: str = "train", *, long_context: bool = False,
               fsdp: bool = True, seq_shard=None) -> Dict[str, Any]:
    """``seq_shard``: None | mesh-axis name for the cache sequence dim.
    Decode with batch on (pod, data) can hand "model" to the cache sequence
    (keeps 32k caches sharded when kv_heads < model axis)."""
    from repro_torch.models.param import DEFAULT_RULES
    rules = dict(DEFAULT_RULES)
    if not fsdp:
        rules["fsdp"] = None
    if long_context:
        # batch=1: hand the data axes to the sequence dimension instead
        rules["batch"] = None
        rules["seq"] = ("pod", "data")
    elif seq_shard:
        rules["seq"] = "data" if seq_shard is True else seq_shard
    else:
        rules["seq"] = None
    return rules


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or a mesh description."""
    names = mesh_axis_names(mesh)
    if getattr(mesh, "mesh_dim_names", None) is not None:   # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in names}


def axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    sizes = mesh_sizes(mesh)
    size = 1
    for a in axes:
        if a in sizes:
            size *= sizes[a]
    return size


def fit_spec(shape: Tuple[int, ...], spec, mesh) -> Tuple[Any, ...]:
    """Drop mesh axes from dims they don't divide (the GSPMD-safe fallback)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        size = axis_size(mesh, entry)
        out.append(entry if size and dim % size == 0 else None)
    return tuple(out)


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             mesh, rules: Dict[str, Any]) -> Tuple[Any, ...]:
    from repro_torch.models.param import logical_to_spec
    return fit_spec(shape, logical_to_spec(axes, rules, mesh), mesh)


def placements_for(spec, mesh) -> Tuple[Any, ...]:
    """A partition spec as DTensor placements, one per mesh dim.  A mesh dim
    of size 1 is ``Replicate()`` whatever the spec names there: the same
    layout, and DTensor's view rules refuse a split of one piece."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    sizes = mesh_sizes(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a) for a in
                (entry if isinstance(entry, (tuple, list)) else (entry,))]
        if dims != sorted(dims):
            # DTensor splits a dimension over its mesh dims in mesh order
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in dims:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def sharding_for_specs(specs, mesh, rules: Dict[str, Any]):
    """ParamSpec tree -> tree of DTensor placements (divisibility-safe)."""
    from repro_torch.models.param import tree_map_specs
    return tree_map_specs(
        lambda s: placements_for(spec_for(s.shape, s.axes, mesh, rules), mesh),
        specs)


def pspec_for_specs(specs, mesh, rules: Dict[str, Any]):
    from repro_torch.models.param import tree_map_specs
    return tree_map_specs(
        lambda s: spec_for(s.shape, s.axes, mesh, rules), specs)


def distribute(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A tensor that every rank holds whole -> a DTensor of ``placements``;
    each rank keeps its own slice, and nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == tuple(placements) else \
            x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def sharded(make, shape: Tuple[int, ...], dtype: torch.dtype, mesh,
            placements, device=None) -> torch.Tensor:
    """A DTensor of global ``shape`` and ``placements`` on ``mesh`` whose
    shard on this rank ``make`` (``torch.zeros``, ``torch.empty``, ...)
    makes: no rank ever holds the whole tensor."""
    from torch.distributed.tensor import DTensor
    local = make(_local_box(shape, mesh, placements)[0], dtype=dtype,
                 device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, as torch gives them
    (a dimension of size 0 counts as 1), with no tensor made."""
    stride, step = [], 1
    for n in reversed(shape):
        stride.append(step)
        step *= max(n, 1)
    return tuple(reversed(stride))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with dimensions ``dims`` whole on every rank (an all-gather over
    the mesh dims that split them); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % x.ndim for d in dims}
    placements = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
                  for p in x.placements]
    return distribute(x, x.device_mesh, placements)


def gather_axes(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` whole over the mesh axes named in ``axes`` (one name, a tuple
    of names, or None), split as before over the others; a plain tensor as
    it is."""
    if not is_dtensor(x) or not axes:
        return x
    from torch.distributed.tensor import Replicate
    axes = axes if isinstance(axes, (tuple, list)) else (axes,)
    names = mesh_axis_names(x.device_mesh)
    placements = [Replicate() if names[i] in axes else p
                  for i, p in enumerate(x.placements)]
    return distribute(x, x.device_mesh, placements)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank: a pending sum is reduced; a plain tensor as
    it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return distribute(x, x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def reduce_pending(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending sums reduced (an all-reduce over each mesh dim
    where it is ``Partial``) and its splits kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return distribute(x, x.device_mesh, [Replicate() if p.is_partial() else p
                                         for p in x.placements])


def reduce_over(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """A plain tensor reduced by ``op`` ("sum", "max") over the mesh dims
    ``dims`` (an all-reduce over each); no autograd."""
    from torch.distributed import _functional_collectives as funcol
    for i in dims:
        x = funcol.all_reduce(x, op, (mesh, i))
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


def gather_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """Each rank's ``x`` stacked on a new leading dim over the mesh dims
    ``dims``, in rank order (the first mesh dim major, as DTensor splits a
    dimension over several); no autograd."""
    from torch.distributed import _functional_collectives as funcol
    # all_gather_tensor's new name, where torch has it
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    x = x.contiguous()[None]          # some torch versions gather no view
    for i in reversed(tuple(dims)):
        x = gather(x, 0, (mesh, i))
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


class _SumOver(torch.autograd.Function):
    """The all-reduce of :func:`sum_over`, whose backward hands each rank
    its own gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return reduce_over(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """Each rank's plain ``x`` summed over the mesh dims ``dims``; its
    backward hands each rank its own gradient, unsent.

    Exact where every rank is handed the whole gradient of the sum, or
    where each rank's share of the sum and its gradient lie in rows that no
    other rank writes or reads (the MoE buffer: a token's rows come from,
    and send their gradient to, the rank that holds the token)."""
    return _SumOver.apply(x, mesh, tuple(dims)) if dims else x


class _ShareSum(torch.autograd.Function):
    """The all-reduce of :func:`share_sum`, whose backward sums the
    gradient over the same ranks."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return reduce_over(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return reduce_over(g.contiguous(), "sum", ctx.mesh, ctx.dims), None, \
            None


def share_sum(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """Each rank's plain share ``x`` of a sum, summed over the mesh dims
    ``dims``, for a sum that each rank then uses on its own part of the
    work: the gradient of a share is the sum of every rank's gradient of
    the whole, so the backward all-reduces it too."""
    return _ShareSum.apply(x, mesh, tuple(dims)) if dims else x


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a kernel's backward
    may hand back a strided gradient, and DTensor's dispatch of the
    ``view`` in an ``einsum`` backward would refuse it as a local shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def batch_call(fn, x, *weights):
    """``fn(x, *weights)`` on each rank's shard of ``x``'s batch (dim 0),
    with every other dim of ``x`` and every weight whole on every rank: for
    per-row work whose DTensor dispatch some torch versions get wrong
    (torch 2.11 places ``F.pad`` of a DTensor with a list of placements one
    short).  The result is split as ``x``'s batch and whole elsewhere; a
    weight's gradient is summed over the ranks that split the batch.  With
    no DTensor ``x``, ``fn`` runs on the inputs as they are."""
    if not is_dtensor(x):
        return fn(x, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    batch = [p == Shard(0) for p in x.placements]
    pl = [Shard(0) if b else Replicate() for b in batch]
    grad = [Partial() if b else Replicate() for b in batch]
    local_x = distribute(x, mesh, pl).to_local()
    local_w = [distribute(w, mesh, [Replicate()] * mesh.ndim)
               .to_local(grad_placements=grad) if is_dtensor(w) else w
               for w in weights]
    return DTensor.from_local(fn(local_x, *local_w), mesh, pl,
                              run_check=False)


def local_call(fn, q, groups=(), per_head=(), *, q_dim: int, group_dim: int,
               outs=((0, None),), keep: Optional[int] = None):
    """``fn`` on each rank's shards, for a function whose work splits over
    the batch (dim 0) and over heads, with no exchange between the pieces:
    the kernels' wrappers, which launch on ``data_ptr()`` and so must never
    be handed a DTensor.

    ``q`` splits its heads on ``q_dim``; each of ``groups`` is grouped-query
    shaped (batch dim 0, ``H // Hk`` of ``q``'s heads share one of its heads
    on ``group_dim``); each of ``per_head`` is a pair (tensor, its heads
    dim), split over heads as ``q`` is, and over the batch only when its
    heads dim is not 0.  ``fn(q, *groups, *per_head)`` returns one tensor or
    a tuple, described by ``outs``: per output, (its batch dim, its heads dim
    or None for ``q_dim``).  With no DTensor among the inputs, ``fn`` runs on
    them as they are.

    ``q`` keeps its batch and heads split and is made whole along every
    other dim.  A group operand is split as ``q`` when its heads divide the
    mesh dims that split ``q``'s heads; otherwise it stays whole there, as
    ``fit_spec`` leaves it, and each rank hands ``fn`` the group heads its
    query heads ``[h0, h0 + H_loc)`` read, ``G = H / Hk`` query heads a
    group: the one group ``h0 // G`` where they all read it (``G % H_loc ==
    0``), the slice of whole groups from ``h0 // G`` where they read whole
    ones (``h0 % G == 0`` and ``H_loc % G == 0``), and only where they
    straddle part of a group (H=12, Hk=3 on 4 ranks), for each query head
    ``h`` a copy of the group head it uses (``h // G``), so that the local
    grouping is one to one.  A group's gradient sums, over the ranks whose
    heads read it, into its head (the copies' first into theirs).  A group
    operand's dim ``keep``, if given, stays split where it is split
    (``split_call``'s keys).
    """
    tensors = (q,) + tuple(groups) + tuple(t for t, _ in per_head)
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = next(t for t in tensors if is_dtensor(t)).device_mesh
    role = []                           # per mesh dim: batch | heads | rep
    for p in (q.placements if is_dtensor(q) else [Replicate()] * mesh.ndim):
        role.append("batch" if p == Shard(0) else
                    "heads" if p == Shard(q_dim) else "rep")
    H = q.shape[q_dim]
    coord = mesh.get_coordinate()
    sizes = mesh.shape
    split = 1
    index = 0                           # this rank's block of q's heads
    for i, r in enumerate(role):
        if r == "heads":
            split *= sizes[i]
            index = index * sizes[i] + coord[i]

    def target(batch_dim, heads_dim, heads_split=True):
        pl, grad = [], []
        for r in role:
            if r == "batch" and batch_dim is not None:
                pl.append(Shard(batch_dim))
                grad.append(Shard(batch_dim))
            elif r == "heads" and heads_split:
                pl.append(Shard(heads_dim))
                grad.append(Shard(heads_dim))
            else:
                pl.append(Replicate())
                # a whole operand some of whose work another rank did
                grad.append(Partial() if r != "rep" else Replicate())
        return pl, grad

    def local(t, pl, grad):
        return _ContiguousGrad.apply(
            distribute(t, mesh, pl).to_local(grad_placements=grad))

    pl, grad = target(0, q_dim)
    local_q = local(q, pl, grad)
    H_loc = local_q.shape[q_dim]
    h0 = index * H_loc
    local_groups = []
    for t in groups:
        Hk = t.shape[group_dim]
        G = H // Hk
        aligned = Hk % split == 0
        pl, grad = target(0, group_dim, heads_split=aligned)
        if keep is not None and is_dtensor(t):
            for i, p in enumerate(t.placements):
                if p == Shard(keep):
                    pl[i] = grad[i] = p
        lt = local(t, pl, grad)
        if not aligned:
            lt = _groups_of(lt, group_dim, h0, H_loc, G)
        local_groups.append(lt)
    local_rest = []
    for t, d in per_head:
        pl, grad = target(0 if d != 0 else None, d)
        local_rest.append(local(t, pl, grad))
    out = fn(local_q, *local_groups, *local_rest)
    single = not isinstance(out, tuple)
    wrapped = []
    for o, (bd, hd) in zip((out,) if single else out, outs):
        pl, _ = target(bd, q_dim if hd is None else hd)
        wrapped.append(DTensor.from_local(o, mesh, pl, run_check=False))
    return wrapped[0] if single else tuple(wrapped)


def _groups_of(t: torch.Tensor, dim: int, h0: int, n: int, G: int
               ) -> torch.Tensor:
    """The group heads (dim ``dim`` of ``t``, every group head) that the
    query heads ``[h0, h0 + n)`` read, ``G`` query heads a group: those
    groups, when the heads read whole groups or all one group (a copy of
    the slice, for a kernel that takes contiguous operands; no copy when it
    is all of ``t``); else a copy for each query head of its group head."""
    if G % n == 0 or (h0 % G == 0 and n % G == 0):
        first, count = h0 // G, max(n // G, 1)
        if count == t.shape[dim]:
            return t
        return t.narrow(dim, first, count).contiguous()
    idx = torch.arange(h0, h0 + n, device=t.device) // G
    return t.index_select(dim, idx)


def split_dims(x: torch.Tensor, dim: int) -> Tuple[int, ...]:
    """The mesh dims that split dimension ``dim`` of ``x``: () for a plain
    tensor."""
    if not is_dtensor(x):
        return ()
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == dim % x.ndim)


def _local_box(shape, mesh, placements):
    """(shape, global offset) of this rank's shard of a DTensor of global
    ``shape`` and ``placements``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():      # it reads index tensors' values
        return compute_local_shape_and_global_offset(shape, mesh, placements)


def _local_range(x: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(offset, size) of this rank's shard of DTensor ``x`` along ``dim``."""
    shape, offset = _local_box(x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def write_slot(cache: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``cache[:, slot] = value`` in place, for a cache (B, T, ...) and a
    value (B, ...).  Where a mesh splits T, only the rank whose shard holds
    ``slot`` writes, into its own shard (DTensor would gather the cache
    along T to select the slot, and write into the gathered copy)."""
    value = value.to(cache.dtype)
    if not split_dims(cache, 1):
        cache[:, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    # the value split as the cache is, but for its missing T dim
    pl = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1
          else Replicate() for p in cache.placements]
    local = distribute(value, cache.device_mesh, pl).to_local()
    start, size = _local_range(cache, 1)
    if start <= slot < start + size:
        cache.to_local()[:, slot - start] = local


def merge_partials(out: torch.Tensor, lse: torch.Tensor,
                   reduce=None) -> torch.Tensor:
    """Attention over disjoint slices of the keys, merged by log-sum-exp:
    each slice's normalised ``out`` (..., D) weighted by ``exp(lse - M)``,
    ``M`` the largest ``lse`` (...), summed and divided by the weights' sum
    -> fp32.  ``reduce(x, op)`` ("max", "sum") reduces over the slices: by
    default over dim 0 of stacked ones; across ranks, an all-reduce.  A
    slice with no key (``lse`` -inf, ``out`` zeros) weighs nothing."""
    if reduce is None:
        reduce = lambda x, op: x.amax(0) if op == "max" else x.sum(0)
    w = torch.exp(lse - reduce(lse, "max"))[..., None]
    both = reduce(torch.cat([out.float() * w, w], dim=-1), "sum")
    return both[..., :-1] / both[..., -1:]


def slice_limit(limit: int, start: int, size: int) -> int:
    """The valid keys of the slice ``[start, start + size)`` of keys whose
    first ``limit`` are valid: ``clamp(limit - start, 0, size)``."""
    return min(max(limit - start, 0), size)


def split_call(partial, q, groups, *, limit: int, q_dim: int, group_dim: int,
               key_dim: int):
    """Attention over grouped-query operands whose keys (``key_dim``) a mesh
    splits, by ``partial(q, *groups, limit) -> (out, lse)`` on each rank's
    slice, ``limit`` keys of the whole valid (the first ones), merged by
    :func:`merge_partials` over the mesh dims that split the keys.

    ``q`` is made whole along those dims (its batch and heads, a few hundred
    KB), the groups keep their key split and are otherwise made local as
    :func:`local_call` makes them; each rank's slice holds
    :func:`slice_limit` valid keys; the merge is an
    all-reduce of the max of ``lse``, then one of the weighted outputs and
    the weights together.  The result is placed as ``q`` was."""
    from torch.distributed.tensor import Replicate
    first = groups[0]
    mesh, dims = first.device_mesh, split_dims(first, key_dim)
    mine = slice_limit(limit, *_local_range(first, key_dim))
    # a pending sum of q (its projection's contraction split) is reduced
    placed = [Replicate() if p.is_partial() else p for p in q.placements] \
        if is_dtensor(q) else [Replicate()] * mesh.ndim
    whole = distribute(q, mesh, [Replicate() if i in dims else p
                                 for i, p in enumerate(placed)])

    def fn(q, *groups):
        out, lse = partial(q, *groups, mine)
        return merge_partials(
            out, lse, lambda x, op: reduce_over(x, op, mesh, dims)
        ).to(q.dtype)
    out = local_call(fn, whole, groups, q_dim=q_dim, group_dim=group_dim,
                     keep=key_dim)
    return distribute(out, mesh, placed)


def place_tree(tree, placements, mesh):
    """:func:`distribute` over matching leaves of two nested dicts."""
    if isinstance(tree, dict):
        return {k: place_tree(tree[k], placements[k], mesh) for k in tree}
    return distribute(tree, mesh, placements)


def make_shard_fn(mesh, rules: Dict[str, Any]) -> Callable:
    """Activation-sharding callback threaded through the models: the
    ``with_sharding_constraint`` of JAX as a DTensor redistribution (a plain
    tensor, which every rank holds whole, is split without sending)."""
    if mesh is None:
        return lambda x, axes=None: x

    def shard(x, axes=None):
        if axes is None:
            return x
        spec = spec_for(tuple(x.shape), tuple(axes), mesh, rules)
        return distribute(x, mesh, placements_for(spec, mesh))

    shard.mesh = mesh
    shard.rules = rules
    return shard


def batch_specs(cfg, shape_cfg, mesh, rules: Dict[str, Any]):
    """(meta-tensor dict, placements dict) for a train/prefill batch of the
    given architecture and shape point."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    specs: Dict[str, torch.Tensor] = {}
    ax: Dict[str, Tuple[Optional[str], ...]] = {}
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    if cfg.num_codebooks:
        specs["tokens"] = meta((B, cfg.num_codebooks, S), torch.int32)
        ax["tokens"] = ("batch", None, None)
    else:
        specs["tokens"] = meta((B, S), torch.int32)
        ax["tokens"] = ("batch", None)
    if shape_cfg.kind == "train":
        specs["targets"] = specs["tokens"]
        ax["targets"] = ax["tokens"]
        specs["loss_mask"] = meta((B, S), torch.float32)
        ax["loss_mask"] = ("batch", None)
    if cfg.num_image_tokens:
        specs["image_embeds"] = meta((B, cfg.num_image_tokens, 1024),
                                     torch.float32)
        ax["image_embeds"] = ("batch", None, None)
    placements = {k: placements_for(spec_for(tuple(v.shape), ax[k], mesh,
                                             rules), mesh)
                  for k, v in specs.items()}
    return specs, placements
