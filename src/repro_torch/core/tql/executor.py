"""TQL execution (§4.3): streaming chunk-group evaluation on the scan
pipeline.

The parsed query becomes a computational graph of tensor operations
evaluated over a dataset view, in the unified pipeline order **plan →
schedule → prefetch → stream-decode** (:mod:`repro.core.pipeline`):

1. **plan** — :func:`~.planner.plan_where` classifies chunk groups
   prune/sure/verify from scan statistics (manifest-first: on a committed
   dataset this costs zero tensor binds and zero storage requests);
2. **schedule** — the verify tail becomes a :class:`ScanPipeline` chunk-
   group schedule in verdict order;
3. **prefetch** — while group ``k`` decodes, the pipeline hands group
   ``k+1``'s chunks to :meth:`FetchEngine.prefetch`, byte-bounded so the
   scan never evicts its own staged blobs;
4. **stream-decode** — the WHERE predicate evaluates per chunk group as
   blobs arrive, instead of stacking whole columns first: peak memory is
   one chunk group, not one column set, and fetch overlaps evaluation.

Two evaluation engines per group:

* **vectorized** — when every referenced tensor is fixed-shape, the
  group's columns are stacked and the whole expression evaluates as array
  math.  With ``engine="torch"`` the expression graph runs as torch
  operations on a device, the card by default (:mod:`repro_torch.tql_engine`)
  — the paper's "execution of the query can be delegated to external tensor
  computation frameworks" (§4.3).
* **row-wise** — always-correct fallback (ragged tensors, UDFs without a
  batched form, CONTAINS over text, ...).

Both paths, and the streaming vs. whole-view execution modes, produce
byte-identical result sets (predicates are row-local; ``RANDOM()``
disables streaming because it draws from a view-wide stream).

``ORDER BY key LIMIT k [OFFSET m]`` runs as a **top-k scan** on the same
pipeline (:meth:`Executor._order_limit_topk`): chunk groups are ordered by
their best achievable key bound (planner intervals over the chunk
statistics), streamed best-bound-first with the prefetch window following
that priority, and the stream terminates as soon as no remaining group's
bound can beat or tie the running (m+k)-th-element cutoff — the last
whole-column stacking in the read path is gone.  Skipped groups are never
fetched; results stay byte-identical to the legacy sort (``stream=False``).

``GROUP BY`` (and ungrouped all-aggregate selects) run as a **streaming
aggregation** on the same pipeline (:meth:`Executor._aggregate`): each
chunk group folds per-group *partial* aggregates (count / sum / min /
max / mean-as-sum+count, NaN-skipping) into a bounded hash of group
states, so peak memory is one chunk group plus the group-state table —
never a whole column.  Chunk groups that fully cover their chunks and
have exact statistics are answered straight from :class:`ChunkStats`
(the ``sum``/``lo``/``hi``/element-count fields) with **zero payload
fetches** — the soundness gates live in :mod:`repro.core.chunks`; the
rest fall back to fetch+fold.  ``stream=False`` keeps a whole-view fold
for A/B equivalence (float sums may differ in the last ulp from the
streamed fold's per-group accumulation order; COUNT/MIN/MAX are exact
either way).

Clause order matches the paper's example: WHERE → GROUP BY aggregation →
ORDER BY → ARRANGE BY (stable regroup) → SAMPLE BY → LIMIT/OFFSET →
SELECT projections.
"""

from __future__ import annotations

import math
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import telemetry
from ..chunks import _hi_bound, _lo_bound
from ..pipeline import ScanPipeline
from ..views import DatasetView
from .ast_nodes import (Aggregate, BinOp, Call, Index, ListExpr, Literal,
                        Node, Query, SelectItem, SliceSpec, TensorRef,
                        UnaryOp)
from .functions import get_function
from .parser import parse
from .planner import (ScanPlan, _referenced, group_key_intervals, plan_where)


class Unvectorizable(Exception):
    pass


class _NonScalarKeys(Exception):
    """Sharded top-k found non-scalar sort keys mid-stream: abort the
    pushdown and let the legacy whole-view sort run."""


def _truthy(x: Any) -> bool:
    a = np.asarray(x)
    if a.size == 0:
        return False
    return bool(np.all(a))


def _query_seed(text: str) -> int:
    return zlib.crc32(text.encode()) & 0xFFFFFFFF


# --------------------------------------------------------------------- row
class RowContext:
    def __init__(self, view: DatasetView, executor: "Executor") -> None:
        self.view = view
        self.executor = executor
        self.i = -1
        self._cache: Dict[str, Any] = {}

    def bind(self, i: int) -> "RowContext":
        self.i = i
        self._cache.clear()
        return self

    def get(self, name: str) -> Any:
        if name not in self._cache:
            if name in self.view.derived:
                self._cache[name] = self.view.derived[name][self.i]
            else:
                self._cache[name] = self.view._base_tensor(name).read(
                    int(self.view.indices[self.i]))
        return self._cache[name]

    def has_tensor(self, name: str) -> bool:
        return name in self.view.derived or name in self.view.tensor_names


def eval_row(node: Node, ctx: RowContext) -> Any:
    if isinstance(node, Literal):
        return node.value
    if isinstance(node, TensorRef):
        return ctx.get(node.name)
    if isinstance(node, ListExpr):
        return np.asarray([eval_row(e, ctx) for e in node.items])
    if isinstance(node, UnaryOp):
        v = eval_row(node.operand, ctx)
        return (not _truthy(v)) if node.op == "not" else -np.asarray(v)
    if isinstance(node, BinOp):
        if node.op == "and":
            return _truthy(eval_row(node.left, ctx)) and _truthy(eval_row(node.right, ctx))
        if node.op == "or":
            return _truthy(eval_row(node.left, ctx)) or _truthy(eval_row(node.right, ctx))
        l, r = eval_row(node.left, ctx), eval_row(node.right, ctx)
        if node.op == "in":
            return bool(np.isin(np.asarray(l), np.asarray(r)).all())
        return _APPLY[node.op](np.asarray(l), np.asarray(r))
    if isinstance(node, Index):
        base = np.asarray(eval_row(node.base, ctx))
        return base[tuple(_subscript(p, ctx) for p in node.parts)]
    if isinstance(node, Call):
        if node.name == "RANDOM":
            return float(ctx.executor.rng.random())
        spec = get_function(node.name)
        args = []
        for a in node.args:
            v = eval_row(a, ctx)
            # the paper's Fig-4 passes tensor paths as string literals:
            # IOU(boxes, "training/boxes") — resolve to the row's value.
            if isinstance(v, str) and isinstance(a, Literal) and ctx.has_tensor(v):
                v = ctx.get(v)
            args.append(v)
        return spec.row(*args)
    raise TypeError(f"cannot evaluate {node!r}")


def _subscript(p: SliceSpec, ctx: RowContext):
    if p.is_slice:
        f = lambda e: None if e is None else int(np.asarray(eval_row(e, ctx)))
        return slice(f(p.start), f(p.stop), f(p.step))
    return int(np.asarray(eval_row(p.start, ctx)))


_APPLY = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
    "/": lambda a, b: a / b, "%": lambda a, b: a % b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
}


# ---------------------------------------------------------------- vectorized
class VectorEval:
    """Batched evaluation over stacked columns; raises Unvectorizable to
    signal fallback.  ``xp`` is numpy or a torch namespace on ``device``."""

    def __init__(self, view: DatasetView, seed: int, engine: str = "numpy",
                 device: Any = None) -> None:
        self.view = view
        self.engine = engine
        self.seed = seed
        self._cols: Dict[str, np.ndarray] = {}
        if engine == "torch":
            from repro_torch.tql_engine import TorchNamespace  # deferred
            self.xp = TorchNamespace(device)
        else:
            self.xp = np

    def column(self, name: str) -> np.ndarray:
        if name not in self._cols:
            if name in self.view.derived:
                vals = self.view.derived[name]
                shapes = {np.asarray(v).shape for v in vals}
                if len(shapes) > 1:
                    raise Unvectorizable(name)
                self._cols[name] = np.stack([np.asarray(v) for v in vals]) \
                    if vals else np.zeros((0,))
            else:
                t = self.view._base_tensor(name)
                if any(d is None for d in t.shape[1:]):
                    raise Unvectorizable(f"ragged tensor {name}")
                # batched fetch: one coalesced request per chunk (§3.5)
                vals = t.read_batch(self.view.indices)
                self._cols[name] = (np.stack(vals) if vals
                                    else np.zeros((0,) + tuple(t.shape[1:]),
                                                  dtype=t.meta.dtype))
        return self._cols[name]

    def eval(self, node: Node) -> np.ndarray:
        cols = {r.name: self.column(r.name) for r in node.walk()
                if isinstance(r, TensorRef)}
        if self.engine == "torch":
            xp = self.xp
            return xp.to_numpy(self._eval(
                node, {k: xp.asarray(v) for k, v in cols.items()}, xp))
        return np.asarray(self._eval(node, cols, np))

    def _eval(self, node: Node, cols: Dict[str, Any], xp) -> Any:
        if isinstance(node, Literal):
            if isinstance(node.value, str):
                raise Unvectorizable("string literal")
            return node.value
        if isinstance(node, TensorRef):
            return cols[node.name]
        if isinstance(node, ListExpr):
            vals = [self._eval(e, cols, xp) for e in node.items]
            if any(hasattr(v, "ndim") and getattr(v, "ndim", 0) > 0 for v in vals):
                raise Unvectorizable("list of arrays")
            return xp.asarray(vals)
        if isinstance(node, UnaryOp):
            v = self._eval(node.operand, cols, xp)
            return xp.logical_not(v) if node.op == "not" else -v
        if isinstance(node, BinOp):
            l = self._eval(node.left, cols, xp)
            r = self._eval(node.right, cols, xp)
            if node.op == "and":
                return xp.logical_and(l, r)
            if node.op == "or":
                return xp.logical_or(l, r)
            if node.op == "in":
                raise Unvectorizable("IN")
            return _APPLY[node.op](l, r)
        if isinstance(node, Index):
            base = self._eval(node.base, cols, xp)
            has_batch = isinstance(node.base, (TensorRef, Index, Call))
            subs: List[Any] = [slice(None)] if has_batch else []
            for p in node.parts:
                subs.append(self._subscript(p, cols, xp))
            return base[tuple(subs)]
        if isinstance(node, Call):
            if node.name == "RANDOM":
                n = len(self.view.indices)
                return xp.asarray(np.random.default_rng(self.seed).random(n))
            spec = get_function(node.name)
            if spec.batched is None:
                raise Unvectorizable(node.name)
            args = [self._eval(a, cols, xp) for a in node.args]
            return spec.batched(*args, xp=xp)
        raise Unvectorizable(str(node))

    def _subscript(self, p: SliceSpec, cols, xp):
        def const(e):
            if e is None:
                return None
            v = self._eval(e, cols, xp)
            if hasattr(v, "ndim") and getattr(v, "ndim", 0) > 0:
                raise Unvectorizable("non-scalar subscript")
            return int(v)
        if p.is_slice:
            return slice(const(p.start), const(p.stop), const(p.step))
        return const(p.start)


# ----------------------------------------------------------------- top-k plan
class _GroupBound:
    """Best achievable ORDER BY rank of one chunk group, from the planner's
    key interval.  The legacy comparator sorts ascending by (key, position)
    with NaN last, then fully reverses for DESC — so NaN-capable (or
    unknown) groups rank *first* under DESC, and 'beats or ties the cutoff'
    reduces to a one-sided bound test against the interval edge, widened by
    :func:`_lo_bound`/:func:`_hi_bound` so float rounding of an int64
    cutoff can never skip a group that could still tie."""

    __slots__ = ("desc", "nan_best", "val")

    def __init__(self, iv, desc: bool) -> None:
        self.desc = desc
        known_vals = iv.known and iv.has_values
        if desc:
            self.nan_best = (not iv.known) or iv.has_nan
            self.val = float(iv.hi) if known_vals else (
                -math.inf if iv.known else math.inf)
        else:
            self.nan_best = False
            self.val = float(iv.lo) if known_vals else (
                math.inf if iv.known else -math.inf)

    @property
    def sort_key(self) -> Tuple[int, float]:
        if self.desc:
            return (0 if self.nan_best else 1, -self.val)
        return (0, self.val)

    def can_beat(self, cutoff) -> bool:
        """May some row of this group rank at or above the k-th candidate?
        Ties count: an equal key at another position can displace it."""
        try:
            cut_nan = math.isnan(float(cutoff))
        except (TypeError, OverflowError):
            cut_nan = False
        if self.desc:
            if self.nan_best:
                return True     # NaN keys rank first under DESC
            if cut_nan:
                return False    # ...and numeric keys never reach them
            return self.val >= _lo_bound(cutoff)
        if cut_nan:
            return True         # any numeric key beats a NaN cutoff (ASC)
        return self.val <= _hi_bound(cutoff)


def _topk_select(keys: np.ndarray, pos: np.ndarray, k: int,
                 desc: bool) -> Tuple[np.ndarray, np.ndarray]:
    """First ``k`` (key, position) pairs under the legacy ORDER BY
    comparator, returned in final result order.  Restricting the comparator
    to any candidate subset preserves relative order, so merging per-group
    winners is exact: positions are re-sorted ascending first, making the
    stable argsort's tiebreak identical to the whole-view sort's."""
    po = np.argsort(pos, kind="stable")
    keys, pos = keys[po], pos[po]
    o = np.argsort(keys, kind="stable")
    if desc:
        o = o[::-1]
    o = o[:k]
    return keys[o], pos[o]


# ------------------------------------------------------------------ executor
def _substitute(node: Node, aliases: Dict[str, Node]) -> Node:
    """SQL alias support: replace TensorRef(alias) with its SELECT expr."""
    if isinstance(node, TensorRef) and node.name in aliases:
        return aliases[node.name]
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, Node):
            setattr(node, f, _substitute(v, aliases))
        elif isinstance(v, list):
            setattr(node, f, [_substitute(x, aliases) if isinstance(x, Node)
                              else x for x in v])
    return node


# -------------------------------------------------------------- aggregation
#: canonical grouping key for a NaN key value: one shared float object so
#: every NaN row lands in the same hash bucket (dict lookups hit on
#: identity before equality, and NaN != NaN would otherwise split groups)
_NAN_KEY = float("nan")

#: |lo|/|hi| bounds beyond this are unusable as MIN/MAX *values*: the
#: outward widening of ``_lo_bound``/``_hi_bound`` (sound for pruning)
#: may make them unequal to any element (see chunks.py soundness rules)
_EXACT_FLOAT_INT = float(2 ** 53)


def _canon_key(v) -> Any:
    """Hashable canonical form of one row's grouping-key value: 1-D uint8
    samples decode to the text htype's string (matching the str sketch
    domain), scalars become Python scalars (NaN canonicalized), anything
    larger becomes a tuple of its elements."""
    a = np.asarray(v)
    if a.dtype == np.uint8 and a.ndim == 1:
        return a.tobytes().decode(errors="replace")
    if a.size == 1:
        x = a.reshape(()).item()
        if isinstance(x, float) and math.isnan(x):
            return _NAN_KEY
        return x
    return tuple(a.ravel().tolist())


def _new_agg_state() -> dict:
    """Partial-aggregate state of one (group, aggregate) pair: mergeable
    across chunk groups and with stats-answered contributions.  ``sum``
    stays a Python number (exact int accumulation for integer tensors,
    float64 for floats); ``n`` counts non-NaN elements (AVG denominator);
    ``min``/``max`` are float64, None until a value is seen."""
    return {"rows": 0, "sum": 0, "n": 0, "min": None, "max": None}


def _flat_elements(vals, sel: np.ndarray) -> np.ndarray:
    """All elements of rows ``sel`` of a per-row value column, flattened
    (object columns hold ragged samples)."""
    if isinstance(vals, np.ndarray) and vals.dtype != object:
        return np.asarray(vals)[sel].reshape(-1)
    parts = [np.asarray(vals[int(i)]).ravel() for i in sel]
    if not parts:
        return np.empty(0)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _fold_flat(st: dict, flat: np.ndarray) -> None:
    """Fold a flat element array into a partial-aggregate state
    (NaN-skipping, like the stats accumulator)."""
    if flat.size == 0:
        return
    kind = flat.dtype.kind
    if kind == "f":
        flat = flat[~np.isnan(flat)]
        if flat.size == 0:
            return
        st["sum"] += float(np.sum(flat, dtype=np.float64))
    elif kind in "biu":
        st["sum"] += int(flat.sum(dtype=np.uint64 if kind == "u"
                                  else np.int64))
    else:
        raise TypeError(f"cannot aggregate values of dtype {flat.dtype}")
    st["n"] += int(flat.size)
    mn, mx = float(flat.min()), float(flat.max())
    st["min"] = mn if st["min"] is None else min(st["min"], mn)
    st["max"] = mx if st["max"] is None else max(st["max"], mx)


def _agg_result(func: str, st: dict):
    """Final value of one aggregate from its merged partial state, with
    the empty-input identities of :mod:`.functions`: COUNT/SUM of nothing
    are 0, MIN/MAX/AVG of nothing are NaN."""
    if func == "COUNT":
        return int(st["rows"])
    if func == "SUM":
        return st["sum"]
    if func == "AVG":
        return st["sum"] / st["n"] if st["n"] else float("nan")
    v = st["min"] if func == "MIN" else st["max"]
    return float("nan") if v is None else v


class Executor:
    """One query execution.

    **Sharded scan mode** (``shards`` > 1): the per-chunk-group WHERE and
    top-k loops are pure maps over chunk groups, so they run on
    :meth:`ScanPipeline.stream_sharded` — a worker-thread pool with
    groups assigned round-robin in plan order and results re-merged *in
    plan order*, which keeps masks and top-k selections byte-identical
    to the serial scan (scattering a mask is order-independent; the
    top-k merge applies the exact legacy comparator to a candidate set
    that only ever gains strictly-worse extras).  Top-k shards share one
    cutoff: each worker consults the freshest merged cutoff right before
    evaluating a group and skips it when its bound strictly cannot beat
    the cutoff — the shared cutoff only tightens as the merge advances,
    so a sharded skip is always a group the serial scan would also have
    skipped, and early termination still fires at the exact group the
    serial scan terminates on.  ``tenant`` tags the pipeline's
    prefetches for the engine's fair multi-tenant scheduler;
    ``scan_plan_hint`` (the serving tier's plan cache) skips
    ``plan_where`` entirely on a repeat query of an immutable version.
    """

    def __init__(self, query: Query, engine: str = "auto",
                 use_stats: bool = True,
                 stream: Optional[bool] = None,
                 shards: Optional[int] = None,
                 tenant: Optional[str] = None,
                 scan_plan_hint: Optional[ScanPlan] = None,
                 device: Any = None) -> None:
        self.query = query
        if engine == "jax":
            raise ValueError("engine='jax' is the JAX package's; the port's "
                             "tensor engine is engine='torch'")
        self.engine = engine
        #: where engine="torch" evaluates: ``device``, else the CUDA device
        self.device = None
        if engine == "torch":
            from repro_torch.tql_engine import engine_device  # deferred
            self.device = engine_device(device)
        self.use_stats = use_stats
        #: WHERE execution mode: None = auto (stream when the view spans
        #: multiple chunk groups), False = whole-view column stack (the
        #: pre-pipeline path, kept for A/B equivalence), True = force
        self.stream = stream
        self.shards = shards
        self.tenant = tenant
        self.scan_plan_hint = scan_plan_hint
        self.scan_plan: Optional[ScanPlan] = None  # set by run() when planned
        self.topk_plan: Optional[dict] = None      # set when top-k pushed down
        self.agg_plan: Optional[dict] = None       # set when aggregation ran
        self.seed = _query_seed(repr(query))
        self.rng = np.random.default_rng(self.seed)
        # Aggregate-valued aliases never substitute: an aggregate has no
        # per-row value, so referencing one from WHERE/ORDER/... is an
        # unknown-tensor error, not a silent HAVING.
        aliases = {it.alias: it.expr for it in query.items
                   if it.alias and not it.is_star
                   and not isinstance(it.expr, Aggregate)}
        if aliases:
            for attr in ("where", "order_by", "arrange_by", "sample_by"):
                node = getattr(query, attr)
                if node is not None:
                    setattr(query, attr, _substitute(node, aliases))
            if query.group_by is not None:
                query.group_by = [_substitute(k, aliases)
                                  for k in query.group_by]

    # evaluate an expression for every row of `view`, preferring vector path
    def eval_all(self, view: DatasetView, node: Node) -> np.ndarray:
        if self.engine in ("auto", "numpy", "torch"):
            try:
                ve = VectorEval(view, self.seed,
                                "torch" if self.engine == "torch" else "numpy",
                                self.device)
                out = ve.eval(node)
                if out.ndim == 0:
                    out = np.broadcast_to(out, (len(view),))
                if len(out) == len(view):
                    return out
            except Unvectorizable:
                pass
            except Exception:
                if self.engine == "torch":
                    raise
        ctx = RowContext(view, self)
        vals = [eval_row(node, ctx.bind(i)) for i in range(len(view))]
        try:
            return np.asarray(vals)
        except ValueError:  # ragged per-row results (e.g. WHERE rag > 0)
            out = np.empty(len(vals), dtype=object)
            out[:] = vals
            return out

    def _where_mask(self, view: DatasetView, node: Node) -> np.ndarray:
        """Per-row WHERE mask, streamed per chunk group on the scan
        pipeline: group ``k+1``'s chunks prefetch while group ``k``
        evaluates, and only one group's columns are resident at a time.
        Falls back to the whole-view evaluation (:meth:`_mask_of`) when
        streaming is disabled, meaningless (single group, no base
        tensors) or unsound (``RANDOM()`` draws from a view-wide
        stream).  Both modes return byte-identical masks."""
        if self.stream is False or node.calls("RANDOM") or not len(view):
            return self._mask_of(view, node)
        names = [n for n in _referenced(node)
                 if n not in view.derived and n in view.tensor_names]
        if not names:
            return self._mask_of(view, node)
        pipe = ScanPipeline.for_query(view, names, owner=self,
                                      tenant=self.tenant)
        if pipe is None or (self.stream is None and pipe.n_groups <= 1):
            if pipe is not None:
                pipe.close()
            return self._mask_of(view, node)
        mask = np.zeros(len(view), dtype=bool)
        if self.shards is not None and self.shards > 1 and pipe.n_groups > 1:
            # sharded map: each group's sub-mask scatters into disjoint
            # positions, so evaluation order cannot change the result
            for _gi, positions, res in pipe.stream_sharded(
                    lambda pos, sub: self._mask_of(sub, node),
                    shards=self.shards):
                mask[positions] = res
        else:
            for positions, sub in pipe.stream():
                mask[positions] = self._mask_of(sub, node)
        return mask

    def _mask_of(self, view: DatasetView, node: Node) -> np.ndarray:
        """Per-row boolean mask under `_truthy` semantics (all elements true,
        empty is False) — the vectorized path must agree with the row path."""
        mask = self.eval_all(view, node)
        if mask.dtype == object:
            return np.asarray([_truthy(m)
                               for m in np.asarray(mask, dtype=object)])
        mask = mask.astype(bool)
        if mask.ndim > 1:
            if 0 in mask.shape[1:]:
                return np.zeros(len(mask), dtype=bool)
            mask = mask.all(axis=tuple(range(1, mask.ndim)))
        return mask

    # ------------------------------------------------------- ORDER BY / top-k
    def _order_keys(self, view: DatasetView, node: Node) -> np.ndarray:
        """Sort keys of ``view`` under ``node``.  Integer (and bool/float)
        keys keep their native dtype — casting to float64 mis-orders int64
        values above 2**53; only non-numeric results fall back to the
        legacy float64 coercion."""
        keys = np.asarray(self.eval_all(view, node))
        if keys.dtype == object or keys.dtype.kind not in "biuf":
            keys = keys.astype(np.float64)
        return keys

    def _order_limit_topk(self, view: DatasetView,
                          q: Query) -> Optional[DatasetView]:
        """``ORDER BY key LIMIT k [OFFSET m]`` as a top-k scan: chunk groups
        stream best-bound-first (bounds from :func:`group_key_intervals`)
        while a running (offset+limit)-th-element cutoff terminates the
        stream as soon as no remaining group's bound can beat or tie it.

        Returns the fully ordered-and-sliced view, or None when the legacy
        whole-column sort must run instead (no LIMIT, ARRANGE/SAMPLE BY
        downstream, ``stream=False``/``use_stats=False``, RANDOM() anywhere
        in the query — its stream is order-dependent — derived-only keys,
        or a single chunk group).  Selection is byte-identical to the
        legacy path: candidates merge under the exact comparator the legacy
        sort applies — stable ascending argsort by (key, position), fully
        reversed for DESC, NaN keys last ascending — and a group is skipped
        only when its bound is *strictly* worse than the cutoff, so ties
        (which can displace by position) are always streamed."""
        if (q.limit is None or q.arrange_by is not None
                or q.sample_by is not None or self.stream is False
                or not self.use_stats):
            return None
        k = int(q.limit) + int(q.offset)
        if k <= 0:
            return view[np.empty(0, dtype=np.int64)]
        if k >= len(view):
            return None  # every row ranks: nothing to skip
        if any(c.name.upper() == "RANDOM" for c in self.query.find(Call)):
            return None
        names = [n for n in _referenced(q.order_by)
                 if n not in view.derived and n in view.tensor_names]
        if not names:
            return None
        pipe = ScanPipeline.for_query(view, names, owner=self,
                                      tenant=self.tenant)
        if pipe is None or pipe.n_groups <= 1:
            if pipe is not None:
                pipe.close()
            return None
        desc = bool(q.order_desc)
        bounds = [_GroupBound(iv, desc)
                  for iv in group_key_intervals(view, pipe, q.order_by)]
        order = sorted(range(len(bounds)), key=lambda g: bounds[g].sort_key)
        pipe.reorder(order)  # prefetch window now follows bound priority
        bounds = [bounds[g] for g in order]
        if self.shards is not None and self.shards > 1:
            return self._topk_sharded(view, q, pipe, bounds, k, desc, names)
        k_keys: Optional[np.ndarray] = None
        k_pos = np.empty(0, dtype=np.int64)
        cutoff = None
        scanned = 0
        terminated = False
        it = pipe.stream()
        try:
            for gi, (positions, sub) in enumerate(it):
                if cutoff is not None and not bounds[gi].can_beat(cutoff):
                    terminated = True
                    break
                keys_g = self._order_keys(sub, q.order_by)
                if keys_g.ndim != 1 or len(keys_g) != len(positions):
                    return None  # non-scalar keys: legacy whole-view sort
                scanned += 1
                ck = keys_g if k_keys is None \
                    else np.concatenate([k_keys, keys_g])
                cp = np.concatenate([k_pos, positions])
                k_keys, k_pos = _topk_select(ck, cp, k, desc)
                if len(k_pos) >= k:
                    cutoff = k_keys[-1]
        finally:
            it.close()
        self.topk_plan = {
            "groups": pipe.n_groups, "groups_scanned": scanned,
            "groups_skipped": pipe.n_groups - scanned,
            "terminated_early": int(terminated),
            "k": k, "order_desc": int(desc), "tensors": list(names)}
        return view[k_pos[q.offset:]]

    def _topk_sharded(self, view: DatasetView, q: Query, pipe: ScanPipeline,
                      bounds: List[_GroupBound], k: int, desc: bool,
                      names: List[str]) -> Optional[DatasetView]:
        """Shard-parallel tail of :meth:`_order_limit_topk`: workers
        evaluate group sort keys concurrently under one shared cutoff
        (checked freshest-first via ``skip``), while this thread merges
        candidates in plan order with the exact serial comparator —
        see the class docstring for the byte-parity argument."""
        lock = threading.Lock()
        shared = {"cutoff": None}

        def skip(gi: int) -> bool:
            with lock:
                c = shared["cutoff"]
            return c is not None and not bounds[gi].can_beat(c)

        def eval_keys(positions: np.ndarray, sub: DatasetView) -> np.ndarray:
            keys_g = self._order_keys(sub, q.order_by)
            if keys_g.ndim != 1 or len(keys_g) != len(positions):
                raise _NonScalarKeys()  # legacy whole-view sort takes over
            return keys_g

        k_keys: Optional[np.ndarray] = None
        k_pos = np.empty(0, dtype=np.int64)
        cutoff = None
        scanned = 0
        terminated = False
        it = pipe.stream_sharded(eval_keys, shards=self.shards, skip=skip)
        try:
            for gi, positions, keys_g in it:
                # a worker-side skip means the group's bound could not beat
                # an *earlier* (looser) cutoff — the serial scan, whose
                # cutoff here is at least as tight, terminates too
                if keys_g is None or (cutoff is not None
                                      and not bounds[gi].can_beat(cutoff)):
                    terminated = True
                    break
                scanned += 1
                ck = keys_g if k_keys is None \
                    else np.concatenate([k_keys, keys_g])
                cp = np.concatenate([k_pos, positions])
                k_keys, k_pos = _topk_select(ck, cp, k, desc)
                if len(k_pos) >= k:
                    cutoff = k_keys[-1]
                    with lock:
                        shared["cutoff"] = cutoff
        except _NonScalarKeys:
            return None
        finally:
            it.close()
        self.topk_plan = {
            "groups": pipe.n_groups, "groups_scanned": scanned,
            "groups_skipped": pipe.n_groups - scanned,
            "terminated_early": int(terminated), "shards": int(self.shards),
            "k": k, "order_desc": int(desc), "tensors": list(names)}
        return view[k_pos[q.offset:]]

    # --------------------------------------------------------- aggregation
    def _agg_output_items(self, q: Query) -> Tuple[
            List[Tuple[str, Tuple[str, int]]], List[Aggregate]]:
        """Resolve SELECT items of an aggregation query into output specs:
        ``(column_name, ("key", key_index) | ("agg", agg_index))`` plus the
        ordered aggregate list.  The parser validated shapes already; key
        matching mirrors its rules (structural repr, or alias/name against
        a TensorRef key)."""
        keys = q.group_by or []
        key_reprs = [repr(k) for k in keys]
        aggs: List[Aggregate] = []
        specs: List[Tuple[str, Tuple[str, int]]] = []
        used: set = set()
        for k, it in enumerate(q.items):
            if isinstance(it.expr, Aggregate):
                name = it.alias or it.expr.func.lower()
                spec = ("agg", len(aggs))
                aggs.append(it.expr)
            else:
                j = None
                r = repr(it.expr)
                if r in key_reprs:
                    j = key_reprs.index(r)
                else:
                    for kj, kn in enumerate(keys):
                        if isinstance(kn, TensorRef) and kn.name in (
                                it.alias, getattr(it.expr, "name", None)):
                            j = kj
                            break
                if j is None:  # unreachable post-parse; stay defensive
                    raise ValueError(
                        f"SELECT item {it!r} matches no GROUP BY key")
                name = it.alias or (it.expr.name
                                    if isinstance(it.expr, TensorRef)
                                    else f"col_{k}")
                spec = ("key", j)
            if name in used:
                name = f"col_{k}"
            used.add(name)
            specs.append((name, spec))
        return specs, aggs

    def _agg_group_from_stats(self, keys: List[Node], aggs: List[Aggregate],
                              recs: Dict[str, Any]) -> Optional[tuple]:
        """Key tuple of a chunk group answerable from statistics alone, or
        None when any gate fails (see the soundness rules in chunks.py).
        The caller already checked every record exists, is exact, and is
        fully covered by the group's rows."""
        for a in aggs:
            if a.func == "COUNT":
                continue
            if not isinstance(a.arg, TensorRef):
                return None
            rec = recs.get(a.arg.name)
            if rec is None:
                return None
            if a.func in ("SUM", "AVG") and rec.sum is None:
                return None
            if a.func in ("MIN", "MAX") and rec.lo is not None and (
                    abs(rec.lo) >= _EXACT_FLOAT_INT
                    or abs(rec.hi) >= _EXACT_FLOAT_INT):
                return None
        if not keys:
            return ()
        if len(keys) != 1 or not isinstance(keys[0], TensorRef):
            return None
        kr = recs.get(keys[0].name)
        if kr is None or not (kr.sketched and kr.dct is not None
                              and len(kr.dct) == 1 and kr.min_elems >= 1):
            return None  # key chunk not provably single-valued
        if kr.dom == "int":
            # scalar samples only: a multi-element sample would make the
            # row key a tuple, not the dictionary's one value
            if not (kr.min_elems == 1 and kr.n_elements == kr.count
                    and kr.nan_count == 0):
                return None
            return (int(kr.dct[0]),)
        if kr.dom == "str":  # text htype: one whole-sample string per row
            return (str(kr.dct[0]),)
        return None

    def _agg_apply_stats(self, states: List[dict], aggs: List[Aggregate],
                         recs: Dict[str, Any], nrows: int) -> None:
        """Merge one stats-answered chunk group into the group states."""
        for a, st in zip(aggs, states):
            st["rows"] += nrows
            if a.func == "COUNT":
                continue
            rec = recs[a.arg.name]
            if rec.lo is not None:
                st["min"] = rec.lo if st["min"] is None \
                    else min(st["min"], rec.lo)
                st["max"] = rec.hi if st["max"] is None \
                    else max(st["max"], rec.hi)
            nvalid = rec.n_elements - rec.nan_count
            if rec.sum is not None and nvalid > 0:
                st["sum"] += rec.sum
                st["n"] += nvalid

    def _agg_fold(self, sub: DatasetView, orig_positions: np.ndarray,
                  keys: List[Node], aggs: List[Aggregate],
                  states: Dict[tuple, List[dict]],
                  firsts: Dict[tuple, int]) -> None:
        """Fetch+fold one chunk group (or the whole view in legacy mode)
        into the group states.  Only ``sub``'s columns are resident."""
        n = len(sub)
        if not n:
            return
        if keys:
            cols = [self.eval_all(sub, kx) for kx in keys]
            bykey: Dict[tuple, List[int]] = {}
            for i in range(n):
                kt = tuple(_canon_key(c[i]) for c in cols)
                bykey.setdefault(kt, []).append(i)
        else:
            bykey = {(): list(range(n))}
        argcols: Dict[str, Any] = {}
        for a in aggs:
            if a.arg is not None and repr(a.arg) not in argcols:
                argcols[repr(a.arg)] = self.eval_all(sub, a.arg)
        for kt, rows in bykey.items():
            sel = np.asarray(rows, dtype=np.int64)
            sts = states.get(kt)
            if sts is None:
                sts = states[kt] = [_new_agg_state() for _ in aggs]
            fp = int(orig_positions[sel].min())
            if kt not in firsts or fp < firsts[kt]:
                firsts[kt] = fp
            for a, st in zip(aggs, sts):
                st["rows"] += len(sel)
                if a.func != "COUNT":
                    _fold_flat(st, _flat_elements(argcols[repr(a.arg)], sel))

    def _aggregate(self, view: DatasetView, q: Query) -> DatasetView:
        """GROUP BY / ungrouped aggregation over ``view``: stats-answered
        chunk groups contribute partials with zero payload fetches, the
        rest stream through the scan pipeline one chunk group at a time
        (module docstring).  Returns a derived-only view, one row per
        group in first-appearance (view) order — a single identity row
        for an ungrouped aggregate over an empty view."""
        specs, aggs = self._agg_output_items(q)
        keys = q.group_by or []
        names = []
        for node in list(keys) + [a.arg for a in aggs if a.arg is not None]:
            for nm in _referenced(node):
                if nm not in names and nm not in view.derived \
                        and nm in view.tensor_names:
                    names.append(nm)
        rand = any(c.name.upper() == "RANDOM" for c in q.find(Call))
        streamable = self.stream is not False and not rand
        unique_rows = len(np.unique(view.indices)) == len(view.indices)
        states: Dict[tuple, List[dict]] = {}
        firsts: Dict[tuple, int] = {}
        total_groups = answered = 0
        pipe = ScanPipeline.for_query(view, names, owner=self,
                                      tenant=self.tenant) \
            if streamable and names and len(view) else None
        fold_positions = np.arange(len(view), dtype=np.int64)
        if pipe is not None:
            total_groups = pipe.n_groups
            fold_parts: List[np.ndarray] = []
            if self.use_stats and unique_rows:
                srcs = {nm: view.scan_source(nm) for nm in pipe.names}
                for g in range(pipe.n_groups):
                    positions = pipe.group_positions(g)
                    recs: Dict[str, Any] = {}
                    for nm, o in zip(pipe.names, pipe.group_ords(g)):
                        rec = srcs[nm].stats_of(int(o))
                        # full coverage: every row of the chunk, exactly
                        # once (rows are globally unique) — partial
                        # coverage means the stats describe excluded rows
                        if rec is None or not rec.exact \
                                or rec.count != len(positions):
                            recs = {}
                            break
                        recs[nm] = rec
                    kt = self._agg_group_from_stats(keys, aggs, recs) \
                        if recs else None
                    if kt is None:
                        fold_parts.append(positions)
                        continue
                    answered += 1
                    sts = states.get(kt)
                    if sts is None:
                        sts = states[kt] = [_new_agg_state() for _ in aggs]
                    fp = int(positions.min())
                    if kt not in firsts or fp < firsts[kt]:
                        firsts[kt] = fp
                    self._agg_apply_stats(sts, aggs, recs, len(positions))
                pipe.close()
                fold_positions = np.sort(np.concatenate(fold_parts)) \
                    if fold_parts else np.empty(0, dtype=np.int64)
            else:
                pipe.close()
        # fetch+fold the remainder, streamed one chunk group at a time
        if len(fold_positions):
            sub = view[fold_positions] if len(fold_positions) != len(view) \
                else view
            fold_pipe = ScanPipeline.for_query(sub, names, owner=self,
                                               tenant=self.tenant) \
                if streamable and names else None
            if fold_pipe is not None and (self.stream or
                                          fold_pipe.n_groups > 1):
                if not total_groups:
                    total_groups = fold_pipe.n_groups
                for positions, gsub in fold_pipe.stream():
                    self._agg_fold(gsub, fold_positions[positions], keys,
                                   aggs, states, firsts)
            else:
                if fold_pipe is not None:
                    fold_pipe.close()
                if not total_groups:
                    total_groups = 1 if len(sub) else 0
                self._agg_fold(sub, fold_positions, keys, aggs, states,
                               firsts)
        if not keys and not states:  # empty input: one identity row
            states[()] = [_new_agg_state() for _ in aggs]
            firsts[()] = 0
        out_keys = sorted(states, key=lambda kt: firsts[kt])
        derived: Dict[str, List[Any]] = {}
        for name, (kind, j) in specs:
            if kind == "key":
                derived[name] = [kt[j] for kt in out_keys]
            else:
                derived[name] = [_agg_result(aggs[j].func, states[kt][j])
                                 for kt in out_keys]
        self.agg_plan = {
            "agg_rows": int(len(view)),
            "agg_groups": int(total_groups),
            "agg_groups_stats_answered": int(answered),
            "agg_groups_folded": int(total_groups - answered),
            "agg_out_groups": int(len(out_keys)),
            "grouped": int(bool(keys))}
        if self.scan_plan is not None:
            self.scan_plan.agg_groups_stats_answered = answered
        telemetry.registry().counter("tql.aggregates").inc()
        return DatasetView(view.dataset,
                           np.arange(len(out_keys), dtype=np.int64),
                           view.node_id, tensors=[], derived=derived)

    def run(self, base: DatasetView) -> DatasetView:
        q = self.query
        view = base
        # WHERE ------------------------------------------------------------
        if q.where is not None:
            if len(view):
                with telemetry.span("query.plan") as plan_sp:
                    # a cached plan (serving tier, immutable committed
                    # version) makes the repeat query pay zero planner work
                    if self.scan_plan_hint is not None and self.use_stats:
                        plan = self.scan_plan_hint
                    else:
                        plan = plan_where(view, q.where) if self.use_stats \
                            else None
                    self.scan_plan = plan
                    if plan is not None:
                        plan_sp.set(effective=int(plan.effective),
                                    **{k: v for k, v in plan.report().items()
                                       if isinstance(v, (int, float))})
                with telemetry.span("query.where"):
                    if plan is not None and plan.effective:
                        # stats pushdown: pruned chunks are never fetched;
                        # only 'verify' rows pay predicate evaluation,
                        # streamed per chunk group in verdict order on the
                        # scan pipeline
                        parts = [plan.sure]
                        if len(plan.verify):
                            sub = view[plan.verify]
                            keep = self._where_mask(sub, q.where)
                            parts.append(plan.verify[np.nonzero(keep)[0]])
                        view = view[np.sort(
                            np.concatenate(parts)).astype(np.int64)]
                    else:
                        keep = self._where_mask(view, q.where)
                        view = view[np.nonzero(keep)[0]]
        # GROUP BY / aggregation ---------------------------------------------
        if q.is_aggregate:
            with telemetry.span("query.aggregate") as agg_sp:
                out = self._aggregate(view, q)
                if self.agg_plan:
                    agg_sp.set(**{k: v for k, v in self.agg_plan.items()
                                  if isinstance(v, (int, float))})
            # LIMIT/OFFSET slice the aggregated group rows; ORDER/ARRANGE/
            # SAMPLE were rejected at parse time, projection already done
            if q.offset:
                out = out[q.offset:]
            if q.limit is not None:
                out = out[: q.limit]
            report = self.scan_plan.report() if self.scan_plan is not None \
                else {}
            report.update(self.agg_plan or {})
            out.scan_plan = report
            return out
        # ORDER BY ----------------------------------------------------------
        if q.order_by is not None and len(view):
            with telemetry.span("query.topk") as topk_sp:
                topk = self._order_limit_topk(view, q)
                if self.topk_plan is not None:
                    topk_sp.set(**{k: v for k, v in self.topk_plan.items()
                                   if isinstance(v, (int, float))})
            if topk is not None:
                # ORDER BY + LIMIT/OFFSET fully applied by the top-k plan
                view = topk
                q = Query(**{**q.__dict__, "limit": None, "offset": 0})
            else:
                keys = self._order_keys(view, q.order_by)
                order = np.argsort(keys, kind="stable")
                if q.order_desc:
                    order = order[::-1]
                view = view[order]
        # ARRANGE BY (stable regroup; §4.3 example) ---------------------------
        if q.arrange_by is not None and len(view):
            keys = self.eval_all(view, q.arrange_by)
            try:
                karr = np.asarray(keys, dtype=np.float64)
            except (TypeError, ValueError):
                karr = np.asarray([str(k) for k in keys])
            view = view[np.argsort(karr, kind="stable")]
        # SAMPLE BY (weighted; deeplake-style) -------------------------------
        if q.sample_by is not None and len(view):
            w = np.clip(np.asarray(self.eval_all(view, q.sample_by),
                                   dtype=np.float64), 0, None)
            w = np.nan_to_num(w)
            n = q.limit if q.limit is not None else len(view)
            if w.sum() <= 0:
                w = np.ones(len(view))
            idx = self.rng.choice(len(view), size=n, replace=q.sample_replace,
                                  p=w / w.sum())
            view = view[idx]
            q = Query(**{**q.__dict__, "limit": None, "offset": 0})
        # LIMIT/OFFSET --------------------------------------------------------
        if q.offset:
            view = view[q.offset:]
        if q.limit is not None:
            view = view[: q.limit]
        # SELECT ---------------------------------------------------------------
        out = self._project(view)
        if self.scan_plan is not None:
            out.scan_plan = self.scan_plan.report()
        if self.topk_plan is not None:
            out.topk_plan = dict(self.topk_plan)
        return out

    def _project(self, view: DatasetView) -> DatasetView:
        items = self.query.items
        if len(items) == 1 and items[0].is_star:
            return view
        keep_raw: List[str] = []
        derived: Dict[str, List[Any]] = {}
        for k, item in enumerate(items):
            if item.is_star:
                keep_raw = list(view.tensor_names)
                continue
            if isinstance(item.expr, TensorRef) and item.alias in (None,
                                                                   item.expr.name):
                keep_raw.append(item.expr.name)
                continue
            name = item.alias or f"col_{k}"
            if len(view):
                vals = self.eval_all(view, item.expr)
                derived[name] = ([v for v in vals] if vals.dtype != object
                                 else list(vals))
            else:
                derived[name] = []
        merged = dict(view.derived)
        merged.update(derived)
        return DatasetView(view.dataset, view.indices, view.node_id,
                           tensors=keep_raw, derived=merged)


def execute_query(source: Union["Dataset", DatasetView], text: str,
                  engine: str = "auto", use_stats: bool = True,
                  stream: Optional[bool] = None,
                  shards: Optional[int] = None,
                  tenant: Optional[str] = None,
                  device: Any = None) -> DatasetView:
    q = parse(text)
    if isinstance(source, DatasetView):
        if q.version:
            raise ValueError("VERSION not allowed when querying a view")
        base = source
    else:
        node_id = source.vc.resolve_ref(q.version) if q.version else None
        base = DatasetView.full(source, node_id=node_id)
    aliases = {it.alias for it in q.items if it.alias}
    missing = [t for t in q.referenced_tensors()
               if t not in base.tensor_names and t not in aliases]
    if missing:
        raise KeyError(f"query references unknown tensors: {missing}")
    return Executor(q, engine=engine, use_stats=use_stats, stream=stream,
                    shards=shards, tenant=tenant, device=device).run(base)
