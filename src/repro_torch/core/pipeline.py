"""Unified scan pipeline: plan → schedule → prefetch → stream-decode.

The paper's performance story (§3.5, §4.3–4.5) is that the query planner,
the streaming loader, and the fetch layer behave as ONE pipeline that keeps
the training step — never I/O — the bottleneck.  This module is that
pipeline's spine: a :class:`ScanPlan`-shaped chunk-group schedule owned by
:class:`ScanPipeline`, consumed by every layer of the read path:

* **plan** — :func:`repro.core.tql.planner.plan_where` classifies chunk
  groups from :class:`ScanSource` statistics.  Sources resolve
  manifest-first (:meth:`DatasetView.scan_source
  <repro.core.views.DatasetView.scan_source>`): on a committed dataset the
  chunk-boundary table and per-chunk stats ride in the manifest's
  column-statistics section, so planning costs **zero tensor binds and
  zero storage requests** beyond the cold open itself.
* **schedule** — the pipeline partitions a view's row positions into
  chunk groups (TQL streaming) or fetch units (the loader's order plan),
  with ``unit_size`` / ``prefetch_units`` derived from the fetch engine's
  latency/bandwidth model via :meth:`CostModel.derive_unit_size
  <repro.core.scheduler.CostModel.derive_unit_size>` instead of fixed
  defaults.
* **prefetch** — a rolling, byte-bounded window of whole-chunk prefetches
  runs ahead of consumption, across unit boundaries: while chunk group
  ``k`` decodes, group ``k+1``'s blobs are already in flight on
  :meth:`FetchEngine.prefetch <repro.core.fetch.FetchEngine.prefetch>`.
  The window never queues more than half the destination buffer, so a
  deep scan cannot evict its own staged blobs; teardown cancels only this
  pipeline's still-queued fetches.
* **stream-decode** — :meth:`ScanPipeline.stream` yields one chunk group
  at a time; the TQL executor evaluates WHERE per group as blobs arrive
  instead of stacking whole columns first.

One pipeline instance serves one scan; engines (and their resident
stores) stay shared per provider, so concurrent pipelines dedup in-flight
chunks against each other.
"""

from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from . import fetch as fetchlib
from . import telemetry
from .chunks import ChunkStats
from .manifest import ColumnStats
from .scheduler import CostModel


# --------------------------------------------------------------- scan sources
class ScanSource:
    """Read-only view of one tensor's chunk layout + statistics, enough
    for planning and scheduling without touching payloads."""

    name: str

    def ords_of(self, indices) -> np.ndarray:          # pragma: no cover
        raise NotImplementedError

    def stats_of(self, chunk_ord: int) -> Optional[ChunkStats]:
        raise NotImplementedError                       # pragma: no cover


class TensorScanSource(ScanSource):
    """Source backed by a bound :class:`~repro.core.tensor.Tensor`
    (sees live open-chunk state on a dirty head)."""

    def __init__(self, tensor) -> None:
        self.tensor = tensor
        self.name = tensor.name

    def ords_of(self, indices) -> np.ndarray:
        return self.tensor.encoder.ords_of(indices)

    def stats_of(self, chunk_ord: int) -> Optional[ChunkStats]:
        return self.tensor.chunk_stats_of(chunk_ord)


class ManifestScanSource(ScanSource):
    """Source served from the manifest's column-statistics section —
    no tensor bind, no storage request (plan-at-open)."""

    def __init__(self, name: str, column_stats: ColumnStats) -> None:
        self.name = name
        self.cs = column_stats

    def ords_of(self, indices) -> np.ndarray:
        return self.cs.ords_of(indices)

    def stats_of(self, chunk_ord: int) -> Optional[ChunkStats]:
        return self.cs.stats_of(chunk_ord)


# ------------------------------------------------------------ prefetch window
class _PrefetchWindow:
    """Rolling byte-bounded whole-chunk prefetch over an ordered key plan.

    ``plan[i]`` holds the ``(key, est_bytes)`` pairs first needed at step
    ``i`` (a chunk group or a fetch unit), deduplicated to their first
    step.  ``top_up`` queues steps in order while outstanding bytes stay
    under the budget (half the destination buffer — LRU tier or the
    engine's resident store), so staged-but-unconsumed blobs are never
    evicted by the window's own later prefetches; ``release`` returns a
    completed step's bytes to the budget.  One step is always admitted
    when the window is empty, so a single oversized step still streams.
    """

    def __init__(self, engine: "fetchlib.FetchEngine",
                 plan: List[List[Tuple[str, int]]], owner: object,
                 on_fetched: Optional[Callable[[int], None]] = None,
                 tenant: Optional[str] = None) -> None:
        self.engine = engine
        self.plan = plan
        self.owner = owner
        self.on_fetched = on_fetched
        self.tenant = tenant
        self.budget = (engine.cache_above or engine.resident_bytes) // 2
        self._step_bytes = [sum(b for _, b in step) for step in plan]
        self._next = 0                      # first step not yet queued
        self._released = [False] * len(plan)
        self.outstanding = 0
        #: prefetches that failed permanently (retry budget exhausted);
        #: the consumer's direct fetch covers them, but the count must be
        #: visible — a hostile store should never fail silently
        self.failed = 0
        # the loader's worker pool drives top_up/release concurrently;
        # pointer + byte accounting must move atomically
        self._lock = threading.Lock()

    def _note_result(self, fut) -> None:
        if not fut.cancelled() and fut.exception() is not None:
            with self._lock:
                self.failed += 1

    def top_up(self, upto_step: int) -> None:
        """Queue prefetches for steps ``[next, upto_step]`` while the byte
        budget allows (cross-step: the pointer runs ahead of consumption).
        Steps already consumed on demand (workers outran the window) are
        skipped, never prefetched after the fact."""
        upto = min(upto_step, len(self.plan) - 1)
        while True:
            with self._lock:
                if self._next > upto:
                    return
                step = self._next
                if self._released[step]:    # consumed on demand: skip
                    self._next += 1
                    continue
                nb = self._step_bytes[step]
                if self.outstanding and self.outstanding + nb > self.budget:
                    return  # the rest is fetched (coalesced) on demand
                self.outstanding += nb
                self._next += 1
            for key, est in self.plan[step]:
                fut = self.engine.prefetch(key, owner=self.owner,
                                           on_fetched=self.on_fetched,
                                           tenant=self.tenant,
                                           est_bytes=est)
                fut.add_done_callback(self._note_result)

    def release(self, step: int) -> None:
        """Step ``step`` was consumed: return its bytes to the budget (a
        step consumed before it was ever queued is only marked, so
        ``top_up`` skips it)."""
        with self._lock:
            if self._released[step]:
                return
            self._released[step] = True
            if step < self._next:           # was queued: bytes outstanding
                self.outstanding = max(0, self.outstanding
                                       - self._step_bytes[step])

    def cancel(self) -> int:
        return self.engine.cancel_pending(owner=self.owner)


# -------------------------------------------------------------- scan pipeline
class ScanPipeline:
    """Chunk-group schedule of one scan over a :class:`DatasetView`.

    Two entry points, one schedule currency:

    * :meth:`for_query` — chunk-group streaming for the TQL executor:
      :meth:`stream` yields ``(positions, subview)`` per group, with the
      next group's chunks prefetched while the current one decodes.
    * :meth:`for_units` — the loader's order plan: fetch units register
      here and :meth:`on_unit_start` keeps a ``prefetch_units``-deep
      window of upcoming units' chunks in flight **across unit
      boundaries** (the old per-epoch one-shot warmup only covered the
      leading units).

    Prefetch is active only against cost-bearing (remote) providers with
    coalescing enabled — on local/memory storage prefetch threads cost
    more than they save; scheduling and streaming still apply.

    **Failure semantics.**  The pipeline survives a hostile store with
    byte-identical results: the engine retries transient faults and hedges
    stragglers; a prefetch that exhausts its retry budget is counted
    (:attr:`prefetch_failures`) and the consuming read falls back to a
    direct fetch with a fresh budget.  Only a *permanent* failure of that
    direct fetch propagates to the consumer.
    """

    def __init__(self, view, tensors: Sequence[str], *,
                 owner: object = None,
                 on_fetched: Optional[Callable[[int], None]] = None,
                 tenant: Optional[str] = None) -> None:
        self.view = view
        self.names = [n for n in tensors
                      if n not in view.derived and n in view.tensor_names]
        self.owner = owner if owner is not None else self
        self.on_fetched = on_fetched
        self.tenant = tenant
        self.engine = fetchlib.engine_for(view.dataset.storage)
        self.active = (fetchlib.coalescing_enabled()
                       and fetchlib.provider_cost_params(
                           view.dataset.storage) is not None)
        self._window: Optional[_PrefetchWindow] = None
        self._groups: List[np.ndarray] = []
        self._ord_cols: List[np.ndarray] = []
        self._horizon = 0

    # ------------------------------------------------------------ query mode
    @classmethod
    def for_query(cls, view, tensors: Sequence[str],
                  owner: object = None,
                  tenant: Optional[str] = None) -> Optional["ScanPipeline"]:
        """Pipeline over the chunk groups of ``view`` (rows grouped by the
        tuple of chunks they live in across ``tensors``, in first-
        appearance order).  None when no base tensor is scannable."""
        pipe = cls(view, tensors, owner=owner, tenant=tenant)
        if not pipe.names or not len(view):
            return None
        ord_cols = []
        for n in pipe.names:
            src = view.scan_source(n)
            try:
                ord_cols.append(src.ords_of(view.indices))
            except IndexError:
                return None
        key_matrix = np.stack(ord_cols, axis=1)        # (rows, tensors)
        _uniq, inverse = np.unique(key_matrix, axis=0, return_inverse=True)
        order_rows = np.argsort(inverse, kind="stable")
        bounds = np.flatnonzero(np.diff(inverse[order_rows])) + 1
        parts = np.split(order_rows, bounds)           # parts[g]: positions
        firsts = np.full(len(parts), len(view), dtype=np.int64)
        np.minimum.at(firsts, inverse, np.arange(len(view)))
        pipe._groups = [parts[g] for g in np.argsort(firsts, kind="stable")]
        pipe._ord_cols = ord_cols
        return pipe

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    def group_positions(self, g: int) -> np.ndarray:
        """View positions of chunk group ``g`` (current stream order)."""
        return self._groups[g]

    def group_ords(self, g: int) -> List[int]:
        """Chunk ord per planned tensor for group ``g`` — the key the
        planner uses to look up that group's statistics records."""
        first = int(self._groups[g][0])
        return [int(col[first]) for col in self._ord_cols]

    def reorder(self, order: Sequence[int]) -> None:
        """Permute the chunk-group schedule before :meth:`stream` — the
        top-k executor orders groups best-bound-first so the prefetch
        window (whose key plan is derived from the group order at stream
        start) carries the planner's priorities, and early termination
        cuts the stream as soon as no remaining group can matter."""
        if self._window is not None:
            raise RuntimeError("cannot reorder a streaming pipeline")
        self._groups = [self._groups[i] for i in order]

    def _query_keyplan(self) -> List[List[Tuple[str, int]]]:
        """Per-group (chunk key, est bytes), dedup'd to first need."""
        seen: set = set()
        plan: List[List[Tuple[str, int]]] = []
        tensors = [self.view._base_tensor(n) for n in self.names]
        for positions in self._groups:
            step: List[Tuple[str, int]] = []
            for t, ords in zip(tensors, self._ord_cols):
                o = int(ords[positions[0]])  # one ord tuple per group
                key, est = _chunk_key_est(t, o)
                if key is not None and key not in seen:
                    seen.add(key)
                    step.append((key, est))
            plan.append(step)
        return plan

    def stream(self) -> Iterator[Tuple[np.ndarray, Any]]:
        """Yield ``(positions, subview)`` per chunk group, prefetching the
        window of upcoming groups while the current one decodes.  The
        caller evaluates each subview and scatters results back by
        position; teardown (exhaustion or ``close``) cancels the
        pipeline's still-queued prefetches."""
        if self.active and self._window is None:
            self._window = _PrefetchWindow(self.engine, self._query_keyplan(),
                                           self.owner, self.on_fetched,
                                           self.tenant)
        try:
            for gi, positions in enumerate(self._groups):
                if self._window is not None:
                    with telemetry.gspan(gi + 1, "prefetch"):
                        self._window.top_up(gi + 1)  # k decodes, k+1 flies
                # the deliver span covers the consumer's evaluation of the
                # yielded group (decode + predicate work happen there)
                with telemetry.gspan(gi, "deliver", rows=len(positions)):
                    yield positions, self.view[positions]
                if self._window is not None:
                    self._window.release(gi)
        finally:
            self.close()

    #: sharded-stream backpressure: a worker may run at most this many
    #: groups (x shards) ahead of the consumer before parking
    _SHARD_LEAD = 4

    def stream_sharded(self, eval_fn: Callable[[np.ndarray, Any], Any], *,
                       shards: int, skip=None
                       ) -> Iterator[Tuple[int, np.ndarray, Any]]:
        """Parallel chunk-group scan: evaluate ``eval_fn(positions,
        subview)`` per group on ``shards`` worker threads, yielding
        ``(group_index, positions, result)`` **in plan order** — results
        are byte-identical to a serial :meth:`stream` + scatter because
        the group partition of the view's rows (and the consumer's
        plan-order merge) is independent of evaluation order.

        Groups are assigned worker-round-robin in plan order
        (:func:`repro.distributed.sharding.shard_groups`), so every worker
        starts near the head of the schedule and the ordered re-merge
        never waits on a worker busy with far-future groups.  ``skip(gi)``
        — checked immediately before a group is evaluated, i.e. against
        the *freshest* shared state — lets the top-k executor drop groups
        whose bound can no longer beat the shared cutoff; skipped groups
        yield ``result=None``.  Workers are dedicated threads, never the
        engine's work pool: group evaluation itself blocks on that pool
        (``read_batch`` lookahead), and nesting would deadlock it.
        Closing the generator early (top-k termination) stops workers at
        their next group boundary and cancels this pipeline's remaining
        prefetches.
        """
        from ..distributed.sharding import shard_groups

        n = self.n_groups
        shards = max(1, min(int(shards), n))
        if self.active and self._window is None:
            self._window = _PrefetchWindow(self.engine, self._query_keyplan(),
                                           self.owner, self.on_fetched,
                                           self.tenant)
        results: Dict[int, Any] = {}
        errors: List[BaseException] = []
        stop = threading.Event()
        cond = threading.Condition()
        emitted = [0]                      # groups the consumer has taken

        def worker(w: int, my_groups: List[int]) -> None:
            with telemetry.span(f"serve.shard[{w}]", groups=len(my_groups)):
                for gi in my_groups:
                    with cond:
                        # bounded run-ahead; the next-needed group's worker
                        # always passes (its gi IS the emit floor)
                        cond.wait_for(lambda: stop.is_set() or gi < emitted[0]
                                      + self._SHARD_LEAD * shards)
                    if stop.is_set():
                        return
                    if self._window is not None:
                        self._window.top_up(gi + shards)
                    positions = self._groups[gi]
                    try:
                        if skip is not None and skip(gi):
                            out = None
                        else:
                            with telemetry.gspan(gi, "deliver",
                                                 rows=len(positions)):
                                out = eval_fn(positions, self.view[positions])
                    except BaseException as e:  # noqa: BLE001 - relayed
                        with cond:
                            errors.append(e)
                            cond.notify_all()
                        return
                    if self._window is not None:
                        self._window.release(gi)
                    with cond:
                        results[gi] = out
                        cond.notify_all()

        threads = [threading.Thread(target=worker, args=(w, grp),
                                    name=f"scan-shard-{w}", daemon=True)
                   for w, grp in enumerate(shard_groups(n, shards))]
        for t in threads:
            t.start()
        try:
            for gi in range(n):
                with cond:
                    cond.wait_for(lambda: gi in results or errors)
                    if errors:
                        raise errors[0]
                    out = results.pop(gi)
                    emitted[0] = gi + 1
                    cond.notify_all()
                yield gi, self._groups[gi], out
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join()
            self.close()

    # ----------------------------------------------------------- loader mode
    @classmethod
    def for_units(cls, view, tensors: Sequence[str],
                  units: Sequence[Sequence[int]], *, prefetch_units: int,
                  owner: object = None,
                  on_fetched: Optional[Callable[[int], None]] = None
                  ) -> "ScanPipeline":
        """Pipeline over the loader's fetch units (``units[i]`` = view
        positions of unit ``i``, in plan order)."""
        pipe = cls(view, tensors, owner=owner, on_fetched=on_fetched)
        pipe._horizon = max(0, int(prefetch_units))
        if not pipe.active or not pipe.names or not units:
            return pipe
        bound = [view._base_tensor(n) for n in pipe.names]
        ord_cols = [t.encoder.ords_of(view.indices) for t in bound]
        seen: set = set()
        plan: List[List[Tuple[str, int]]] = []
        for unit in units:
            step: List[Tuple[str, int]] = []
            for t, ords in zip(bound, ord_cols):
                for p in unit:
                    o = int(ords[p])
                    key, est = _chunk_key_est(t, o)
                    if key is not None and key not in seen:
                        seen.add(key)
                        step.append((key, est))
            plan.append(step)
        pipe._window = _PrefetchWindow(pipe.engine, plan, pipe.owner,
                                       on_fetched)
        return pipe

    def on_unit_start(self, unit_index: int) -> None:
        """A worker began unit ``unit_index``: keep the next
        ``prefetch_units`` units' chunks in flight (cross-unit: the
        window pointer runs ahead of the worker pool)."""
        if self._window is not None:
            self._window.top_up(unit_index + self._horizon)

    def on_unit_done(self, unit_index: int) -> None:
        """Unit consumed: return its chunk bytes to the window budget and
        immediately extend the horizon with the freed headroom."""
        if self._window is not None:
            self._window.release(unit_index)
            self._window.top_up(unit_index + self._horizon)

    @property
    def prefetch_failures(self) -> int:
        """Prefetches that failed permanently (consumers fell back to
        direct fetches); 0 when prefetch is inactive."""
        return self._window.failed if self._window is not None else 0

    # -------------------------------------------------------------- teardown
    def close(self) -> int:
        """Cancel this pipeline's queued-but-not-started prefetches
        (running fetches complete and park for other consumers)."""
        if self._window is not None:
            return self._window.cancel()
        return 0


def _chunk_key_est(tensor, chunk_ord: int) -> Tuple[Optional[str], int]:
    """(storage key, estimated bytes) of one chunk; (None, 0) for the open
    chunk (never prefetched: its bytes live in the builder)."""
    name = tensor.encoder.name_of(chunk_ord)
    if tensor._builder is not None and name == tensor._open_name:
        return None, 0
    st = tensor.stats.get(name)
    est = st.nbytes if st is not None and st.nbytes \
        else tensor.meta.max_chunk_size
    return tensor._chunk_key(name), int(est)


# ------------------------------------------------------------ schedule sizing
def derive_schedule_params(engine: "fetchlib.FetchEngine",
                           cost_model: CostModel, sample_bytes: int,
                           memory_budget_bytes: int) -> Tuple[int, int]:
    """(unit_size, prefetch_units) from the engine's latency/bandwidth
    estimates (provider-seeded or EWMA-learned) + the cost model's
    observed per-unit decode times — the adaptive replacement for the old
    fixed ``unit_size=16`` / ``prefetch_units=8`` defaults."""
    est = engine.est
    unit_size = cost_model.derive_unit_size(est.latency_s, est.bandwidth_bps,
                                            sample_bytes)
    prefetch_units = cost_model.derive_prefetch_units(
        est.latency_s, est.bandwidth_bps, unit_size * max(sample_bytes, 1),
        memory_budget_bytes)
    return unit_size, prefetch_units
