"""Per-device costs of one step, counted op by op as it is dispatched (the
counterpart of the JAX package's ``launch/hlo_analysis.py``).

JAX lowers a step to HLO and parses it; the port runs its step once, eagerly,
under :class:`OpCounter`, a ``TorchDispatchMode``, usually on fake tensors
(``launch/steps.py::trace_cell``), and counts what reaches the dispatcher.
Under a mesh the counter declines every DTensor op, so that DTensor hands it
the op on each rank's local shards: what it counts is one device's work.
Eager dispatch visits every iteration of every loop, so no trip count has to
be multiplied in, as ``hlo_analysis`` must for a scan.

* ``flops`` - the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions, SDPA) by ``torch.utils.flop_counter``'s formulas, and each
  kernel call by its own bound's count (``kernels/_fake.py``); elementwise
  ops count none, as in ``hlo_analysis``.  ``flops_by_dtype`` splits them by
  the dtype of the first operand.
* ``hbm_bytes`` - every op's tensor operands read and results written once:
  eager PyTorch fuses nothing.  Views, allocations and metadata ops are
  free; a kernel call counts its bound's bytes.
* ``collective_bytes``, ``collective_by_kind``, ``collective_count`` - the
  ``_c10d_functional`` collectives and DTensor's ``_dtensor``
  ``shard_dim_alltoall``, each by the bytes of its result, as
  ``hlo_analysis`` counts a collective's result shape; the bytes of those
  whose group spans more than one node of ``node_size`` ranks are also in
  ``collective_bytes_across_nodes``; ``largest_collective``, the bytes of
  the largest one (a tensor no rank should send whole, such as an
  embedding table, shows here); ``scoped``, the collectives sent inside
  a function wrapped by ``OpCounter.scope``, by kind and by count, under
  its name.  A shard-to-shard redistribution is
  one all-to-all, as DTensor sends it on a "cuda" mesh: on a "cpu" mesh
  (the dry run's), where DTensor would send an all-gather of the group's
  size times the bytes and keep a chunk, the counter hands DTensor's
  ``shard_dim_alltoall`` the op the "cuda" mesh dispatches, so that both
  count the same.
* ``peak_bytes`` - the most bytes of storage alive at once: the tensors held
  when the counter starts (``hold``), then every storage an op returns,
  until it is freed; a tensor on the "meta" device holds none, and the
  result of a collective's wait (a new storage on fake tensors, the same
  one on real ones) is the collective's.
* ``largest_bytes`` - the largest of those storages: a tensor that no
  rank should hold whole (the global logits, a global token table) shows
  here when the peak hides it.
* ``kernel_calls`` - the kernel wrappers' calls, by name.

The fake tensors that DTensor makes to propagate a sharding (global shapes,
no part of any rank's work) are not counted.
"""

from __future__ import annotations

import itertools
import weakref
from collections import Counter, defaultdict
from dataclasses import asdict, dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _fake

aten = torch.ops.aten

# ops that move no bytes: allocations, metadata, and a view that its schema
# does not mark as one
FREE = {aten.empty.memory_format, aten.empty_strided.default,
        aten.empty_like.default, aten.new_empty.default,
        aten.new_empty_strided.default, aten._unsafe_view.default,
        aten._local_scalar_dense.default, aten.lift_fresh.default,
        torch.ops.prim.device.default}

# the functional collectives by JAX's names for them; the waits and autograd
# wrappers around them move nothing
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}
NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's ``shard_dim_alltoall`` as it runs on a "cuda" mesh, on any
    mesh: the one ``_dtensor`` op, where a "cpu" mesh would all-gather."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def _alltoall_sites():
    """The modules of DTensor that call ``shard_dim_alltoall`` by name."""
    import importlib
    for name in ("_collective_utils", "placement_types"):
        mod = importlib.import_module(f"torch.distributed.tensor.{name}")
        if hasattr(mod, "shard_dim_alltoall"):
            yield mod


@dataclass
class Costs:
    flops: float = 0.0
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    collective_bytes_across_nodes: float = 0.0
    largest_collective: int = 0
    scoped: Dict[str, dict] = field(default_factory=dict)
    peak_bytes: int = 0
    largest_bytes: int = 0
    kernel_calls: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return asdict(self)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _plain(types) -> bool:
    """Whether every tensor type of an op is a plain or a fake tensor."""
    return all(t is torch.Tensor or issubclass(t, _fake.FakeTensor)
               for t in types)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active into ``self.costs``."""

    def __init__(self, node_size: int = 8):
        super().__init__()
        self.costs = Costs()
        self.node_size = node_size
        self._entry: Dict[int, int] = {}     # live storage key -> entry
        self._live: Dict[int, list] = {}     # entry -> [bytes, storages]
        self._entries = itertools.count()
        self._live_bytes = 0
        self._depth = 0                      # entries, as in a decomposition
        self._quiet = 0
        self._flops = defaultdict(float)
        self._groups: Dict[str, bool] = {}   # group name -> across nodes
        self._counts: Counter = Counter()
        self._by_kind = defaultdict(float)
        self._calls: Counter = Counter()
        self._scope = None                   # the name ``scope`` runs under

    # ------------------------------------------------------------ storages
    def hold(self, tensors) -> None:
        """Count ``tensors`` (plain, fake or DTensors: their local shards) as
        alive from now until they are freed."""
        from torch.distributed.tensor import DTensor
        for t in tensors:
            self._track(t._local_tensor if isinstance(t, DTensor) else t)

    def _track(self, t: torch.Tensor, same_as=None) -> None:
        """Count ``t``'s storage as alive until it is freed; with
        ``same_as``, a tensor whose bytes ``t``'s storage stands for until
        the last of them is freed."""
        if t.device.type == "meta":     # shapes only: no device holds them
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._entry:
            return
        entry = None if same_as is None else \
            self._entry.get(same_as.untyped_storage()._cdata)
        if entry is None:
            entry = next(self._entries)
            n = st.nbytes()
            self._live[entry] = [n, 0]
            self._live_bytes += n
            self.costs.peak_bytes = max(self.costs.peak_bytes,
                                        self._live_bytes)
            self.costs.largest_bytes = max(self.costs.largest_bytes, n)
        self._live[entry][1] += 1
        self._entry[key] = entry
        weakref.finalize(st, self._free, key, entry)

    def _free(self, key: int, entry: int) -> None:
        if self._entry.get(key) == entry:
            del self._entry[key]
        held = self._live[entry]
        held[1] -= 1
        if held[1] == 0:
            self._live_bytes -= held[0]
            del self._live[entry]

    # ------------------------------------------------------------- kernels
    def kernel_call(self, name: str, flops: float, nbytes: float,
                    dtype: torch.dtype) -> None:
        self._calls[name] += 1
        self._flops[_dtype_name(dtype)] += flops
        self.costs.hbm_bytes += nbytes

    def scope(self, name: str, fn):
        """``fn``, whose collectives are also counted under ``name`` in
        ``costs.scoped``: {"by_kind": bytes, "count": calls}."""
        def run(*args, **kwargs):
            outer, self._scope = self._scope, name
            try:
                return fn(*args, **kwargs)
            finally:
                self._scope = outer
        return run

    # ------------------------------------------------------------ dispatch
    def __enter__(self):
        # entered again for each op it decomposes: set up the first time
        self._depth += 1
        if self._depth == 1:
            from torch.distributed.tensor import DTensor
            prop = DTensor._op_dispatcher.sharding_propagator
            inner = prop._propagate_tensor_meta_non_cached

            def quiet(op_schema):
                self._quiet += 1
                try:
                    return inner(op_schema)
                finally:
                    self._quiet -= 1
            prop._propagate_tensor_meta_non_cached = quiet
            self._prop = prop
            self._alltoall = [(m, m.shard_dim_alltoall)
                              for m in _alltoall_sites()]
            if not self._alltoall:
                raise RuntimeError("no module of DTensor calls "
                                   "shard_dim_alltoall by name: a shard-to-"
                                   "shard move would count as an all-gather")
            for m, _ in self._alltoall:
                m.shard_dim_alltoall = _shard_dim_alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            del self._prop._propagate_tensor_meta_non_cached
            for m, fn in self._alltoall:
                m.shard_dim_alltoall = fn
            c = self.costs
            c.flops_by_dtype = dict(self._flops)
            c.flops = sum(self._flops.values())
            c.collective_by_kind = dict(self._by_kind)
            c.collective_count = dict(self._counts)
            c.collective_bytes = sum(self._by_kind.values())
            c.kernel_calls = dict(self._calls)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _plain(types):
            return NotImplemented       # DTensor: its local ops come back
        if func.namespace == "aten" and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd"):
            # as in inference mode, where such ops (matmul, einsum, ...)
            # arrive whole: their parts come back to this mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        ns, name = func.namespace, func._opname
        # a collective's wait and autograd wrapper hand back its result,
        # which a fake tensor cannot alias
        same_as = args[0] if ns == "_c10d_functional" and \
            name in NOT_COLLECTIVES else None
        for o in outs:
            self._track(o, same_as)
        if func in FREE or func.is_view:
            return out
        if ns == "_dtensor" and name == "shard_dim_alltoall":
            self._collective(COLLECTIVES[name], func, args, kwargs, outs)
            return out
        if ns == "_c10d_functional":
            if name not in NOT_COLLECTIVES:
                if name not in COLLECTIVES:
                    raise NotImplementedError(f"no count for {func}")
                self._collective(COLLECTIVES[name], func, args, kwargs, outs)
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        self.costs.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes,
                                                                 outs))
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self._flops[_dtype_name(ins[0].dtype)] += formula(
                *args, **kwargs, out_val=out)
        return out

    def _collective(self, kind: str, func, args, kwargs, outs) -> None:
        nbytes = sum(map(_nbytes, outs))
        self.costs.largest_collective = max(self.costs.largest_collective,
                                            nbytes)
        self._counts[kind] += 1
        self._by_kind[kind] += nbytes
        if self._scope is not None:
            s = self.costs.scoped.setdefault(self._scope,
                                             {"by_kind": {}, "count": {}})
            s["by_kind"][kind] = s["by_kind"].get(kind, 0) + nbytes
            s["count"][kind] = s["count"].get(kind, 0) + 1
        named = dict(zip((a.name for a in func._schema.arguments), args))
        group = {**named, **kwargs}["group_name"]
        if self._across_nodes(group):
            self.costs.collective_bytes_across_nodes += nbytes

    def _across_nodes(self, group) -> bool:
        """Whether ``group`` (its name, or the group) spans nodes."""
        across = self._groups.get(group)
        if across is None:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            pg = _resolve_process_group(group) if isinstance(group, str) \
                else group
            ranks = dist.get_process_group_ranks(pg)
            across = self._groups[group] = \
                len({r // self.node_size for r in ranks}) > 1
        return across
