"""Sharded query serving: admission control, multi-tenant fairness, and a
versioned result/plan cache over one shared :class:`~.fetch.FetchEngine`.

:class:`QueryService` is the concurrent front door for TQL: N clients
submit queries against one dataset and one fetch engine, and the service
keeps them from trampling each other without changing any result bytes.

Admission / fairness contract
-----------------------------
* At most ``max_concurrent`` queries execute at once; excess callers
  block on the admission semaphore.  The whole handling of a query runs
  under a ``serve.admit`` span; time spent blocked on admission is
  measured separately by a ``serve.queue`` span (and a
  ``serve.queue_wait_s`` histogram), so a trace distinguishes "slow
  query" from "queued behind other tenants".
* Each query is tagged with a ``tenant``.  Tenants registered via
  :meth:`QueryService.register_tenant` get a byte budget on the engine's
  staging buffer; the engine schedules tenant prefetches with
  deficit-round-robin (see ``fetch.FetchEngine.register_tenant``), so one
  tenant's scan cannot monopolise staging memory or the prefetch queue.
  Per-tenant throttle/stall counters surface in :meth:`stats`.
* When ``shards`` > 1, WHERE and top-k scans run shard-parallel on the
  executor (``Executor(shards=...)``) — results stay byte-identical to
  the serial scan (see the executor docstring for the parity argument).

Cache-key contract
------------------
Plans and small results are cached under the key::

    (version token, node token, repr(parse(text)), seed, engine, use_stats)

* **version token** — ``(manifest.generation, newest segment key)`` when
  a manifest is published; otherwise the head commit node id.  Every
  commit publishes a new segment at ``segments[0]`` (or reopens a fresh
  head node), so *any* commit naturally rolls the key: no explicit
  invalidation, stale entries simply stop being reachable and age out of
  the LRU.
* **node token** — the resolved ``VERSION`` ref, else ``"HEAD"``.
* **normalized query** — ``repr(parse(text))``: whitespace, keyword case
  and comment differences normalise away; two spellings of the same
  query share one entry.  ``seed`` is the executor's deterministic
  sampling seed derived from the same normal form, so ``SAMPLE BY``
  results are reproducible and therefore cacheable.
* Queries against a **dirty head** (uncommitted changes, no pinned
  ``VERSION``) are never cached — correctness first.

A cache hit reconstructs the result view from stored indices with zero
planner work and zero storage requests (asserted by
``benchmarks/bench_serving.py`` via the ``tql.plans`` counter and
provider request deltas).  Identical concurrent misses are collapsed by
single-flight: one leader executes, followers wait and serve the freshly
cached result, so an N-client storm of one query costs ~one execution.
Oversized results only cache their :class:`~.tql.planner.ScanPlan`
(``serve.plan_cache`` counters), which still removes replanning cost.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import telemetry
from .fetch import engine_for
from .views import DatasetView

__all__ = ["QueryService", "CachedResult"]


class CachedResult:
    """Frozen materialisation of a small query result (row indices plus
    any SELECT-derived columns); enough to rebuild the result view
    without touching the planner, the executor, or storage."""

    __slots__ = ("indices", "node_id", "tensors", "derived",
                 "scan_report", "topk_report", "nbytes")

    def __init__(self, view: DatasetView) -> None:
        self.indices = np.array(view.indices, dtype=np.int64, copy=True)
        self.node_id = view.node_id
        tn = view._tensor_names
        self.tensors = list(tn) if tn is not None else None
        self.derived = {k: list(v) for k, v in view.derived.items()}
        self.scan_report = dict(view.scan_plan) if view.scan_plan else None
        self.topk_report = dict(view.topk_plan) if view.topk_plan else None
        self.nbytes = int(self.indices.nbytes) + _derived_nbytes(self.derived)

    def rebuild(self, dataset) -> DatasetView:
        v = DatasetView(dataset, self.indices.copy(), self.node_id,
                        tensors=self.tensors,
                        derived={k: list(vs)
                                 for k, vs in self.derived.items()})
        if self.scan_report is not None:
            v.scan_plan = dict(self.scan_report)
        if self.topk_report is not None:
            v.topk_plan = dict(self.topk_report)
        return v


def _derived_nbytes(derived: Dict[str, List[Any]]) -> int:
    total = 0
    for vals in derived.values():
        for v in vals:
            if isinstance(v, np.ndarray):
                total += int(v.nbytes)
            elif isinstance(v, (bytes, str)):
                total += len(v)
            else:
                total += 16
    return total


class QueryService:
    """Concurrent TQL query front end over one dataset + fetch engine.

    See the module docstring for the admission / fairness / cache-key
    contract.  Thread-safe; one instance serves many client threads.
    """

    #: per-entry byte ceiling for caching a materialised result; larger
    #: results cache only their scan plan
    RESULT_BYTES_MAX = 4 << 20

    def __init__(self, dataset, *, max_concurrent: int = 8,
                 shards: Optional[int] = None,
                 cache_entries: int = 256,
                 result_bytes_max: Optional[int] = None) -> None:
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.dataset = dataset
        self.engine = engine_for(dataset.storage)
        self.shards = shards
        self.cache_entries = int(cache_entries)
        self.result_bytes_max = (self.RESULT_BYTES_MAX
                                 if result_bytes_max is None
                                 else int(result_bytes_max))
        self._admit = threading.Semaphore(max_concurrent)
        self._lock = threading.Lock()
        # LRU caches: cache key -> CachedResult / ScanPlan
        self._results: "OrderedDict[Tuple, CachedResult]" = OrderedDict()
        self._plans: "OrderedDict[Tuple, Any]" = OrderedDict()
        # single-flight: cache key -> Event set when the leader finishes
        self._flights: Dict[Tuple, threading.Event] = {}
        self._counts = {"queries": 0, "cache_hits": 0, "cache_misses": 0,
                        "flight_waits": 0, "plan_hits": 0, "queue_waits": 0,
                        "uncacheable": 0}

    # ------------------------------------------------------------ tenants
    def register_tenant(self, tenant: str,
                        byte_budget: Optional[int] = None) -> None:
        """Give ``tenant`` a staging-byte budget on the shared engine."""
        self.engine.register_tenant(tenant, byte_budget)

    # ------------------------------------------------------------ serving
    def query(self, text: str, *, tenant: str = "default",
              engine: str = "auto", use_stats: bool = True,
              stream: Optional[bool] = None) -> DatasetView:
        """Run ``text`` on behalf of ``tenant`` and return the result view
        (byte-identical to ``dataset.query(text)``)."""
        from .tql.parser import parse

        reg = telemetry.registry()
        with telemetry.span("serve.admit", tenant=tenant) as sp:
            with self._lock:
                self._counts["queries"] += 1
            reg.counter(f"serve.tenant.{tenant}.queries").inc()
            q = parse(text)
            norm = repr(q)
            key = self._cache_key(q, norm, engine, use_stats)
            if key is None:
                with self._lock:
                    self._counts["uncacheable"] += 1
                sp.set(cache="uncacheable")
                return self._execute(q, key, tenant, engine, use_stats,
                                     stream)
            hit = self._result_get(key)
            if hit is not None:
                self._count_hit(reg, tenant, sp)
                return hit.rebuild(self.dataset)
            # single-flight: collapse identical concurrent misses
            leader, ev = self._flight_join(key)
            if not leader:
                with self._lock:
                    self._counts["flight_waits"] += 1
                with telemetry.span("serve.flight_wait", tenant=tenant):
                    ev.wait()
                hit = self._result_get(key)
                if hit is not None:
                    self._count_hit(reg, tenant, sp)
                    return hit.rebuild(self.dataset)
                # leader failed or result was too big to cache: run it
                return self._execute(q, key, tenant, engine, use_stats,
                                     stream)
            with self._lock:
                self._counts["cache_misses"] += 1
            reg.counter("serve.cache.misses").inc()
            sp.set(cache="miss")
            try:
                out = self._execute(q, key, tenant, engine, use_stats,
                                    stream)
                ent = CachedResult(out)
                if ent.nbytes <= self.result_bytes_max:
                    self._lru_put(self._results, key, ent)
                return out
            finally:
                self._flight_done(key, ev)

    # ------------------------------------------------------------ internals
    def _execute(self, q, key, tenant: str, engine: str, use_stats: bool,
                 stream: Optional[bool]) -> DatasetView:
        from .tql.executor import Executor

        reg = telemetry.registry()
        if not self._admit.acquire(blocking=False):
            with self._lock:
                self._counts["queue_waits"] += 1
            reg.counter(f"serve.tenant.{tenant}.queue_waits").inc()
            with telemetry.span("serve.queue", tenant=tenant) as qs:
                t0 = time.perf_counter()
                self._admit.acquire()
                wait = time.perf_counter() - t0
                qs.set(wait_s=wait)
            reg.histogram("serve.queue_wait_s").observe(wait)
        try:
            node_id = (self.dataset.vc.resolve_ref(q.version)
                       if q.version else None)
            base = DatasetView.full(self.dataset, node_id=node_id)
            aliases = {it.alias for it in q.items if it.alias}
            missing = [t for t in q.referenced_tensors()
                       if t not in base.tensor_names and t not in aliases]
            if missing:
                raise KeyError(
                    f"query references unknown tensors: {missing}")
            hint = self._plan_get(key) if use_stats else None
            if hint is not None:
                with self._lock:
                    self._counts["plan_hits"] += 1
                reg.counter("serve.plan_cache.hits").inc()
            ex = Executor(q, engine=engine, use_stats=use_stats,
                          stream=stream, shards=self.shards, tenant=tenant,
                          scan_plan_hint=hint)
            out = ex.run(base)
            if (key is not None and hint is None
                    and ex.scan_plan is not None):
                self._lru_put(self._plans, key, ex.scan_plan)
            return out
        finally:
            self._admit.release()

    def _cache_key(self, q, norm: str, engine: str,
                   use_stats: bool) -> Optional[Tuple]:
        """Versioned cache key, or None when the query is uncacheable
        (dirty head with no pinned VERSION)."""
        from .tql.executor import _query_seed

        vc = self.dataset.vc
        if q.version:
            node = vc.resolve_ref(q.version)
        elif vc.has_uncommitted_changes():
            return None
        else:
            node = "HEAD"
        m = self.dataset.manifest
        if m is not None and m.segments:
            version_token: Tuple = (int(m.generation), m.segments[0])
        else:
            version_token = ("node", vc.current.id)
        return (version_token, node, norm, _query_seed(norm),
                engine, bool(use_stats))

    def _count_hit(self, reg, tenant: str, sp) -> None:
        with self._lock:
            self._counts["cache_hits"] += 1
        reg.counter("serve.cache.hits").inc()
        reg.counter(f"serve.tenant.{tenant}.cache_hits").inc()
        sp.set(cache="hit")

    def _result_get(self, key) -> Optional[CachedResult]:
        with self._lock:
            ent = self._results.get(key)
            if ent is not None:
                self._results.move_to_end(key)
            return ent

    def _plan_get(self, key) -> Optional[Any]:
        if key is None:
            return None
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
            return plan

    def _lru_put(self, cache: OrderedDict, key, value) -> None:
        with self._lock:
            cache[key] = value
            cache.move_to_end(key)
            while len(cache) > self.cache_entries:
                cache.popitem(last=False)

    def _flight_join(self, key) -> Tuple[bool, threading.Event]:
        with self._lock:
            ev = self._flights.get(key)
            if ev is not None:
                return False, ev
            ev = threading.Event()
            self._flights[key] = ev
            return True, ev

    def _flight_done(self, key, ev: threading.Event) -> None:
        with self._lock:
            self._flights.pop(key, None)
        ev.set()

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        """Service counters plus the per-tenant engine fairness split."""
        with self._lock:
            out: Dict[str, Any] = dict(self._counts)
            out["result_entries"] = len(self._results)
            out["plan_entries"] = len(self._plans)
        out["tenants"] = self.engine.tenants_snapshot()
        return out

    def clear_cache(self) -> None:
        with self._lock:
            self._results.clear()
            self._plans.clear()
