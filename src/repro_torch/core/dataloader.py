"""Streaming dataloader (§4.5) on the unified scan pipeline: **plan →
schedule → prefetch → stream-decode**, designed so the *training step*, not
the pipeline, is the bottleneck.

Per epoch:

 1. **Plan** — view positions, shuffled chunk-group-wise: samples are
    grouped by the chunk (of the largest "primary" tensor) they live in; chunk
    groups are visited in random order, samples shuffled within group.
    Within each :data:`~DeepLakeLoader.WARM_WINDOW`-sized window of that
    order, groups whose chunks are already resident or in flight on the
    fetch engine are visited first (pipeline-aware shuffle; stats-neutral
    ``has_blob`` probe) — the epoch-level sample distribution is unchanged
    and a cold engine reduces to the exact seeded order.  Each
    chunk is therefore fetched ~once per epoch while the emission stream is
    still well mixed — the paper's "shuffled stream access ... without a
    separate shuffle cluster" (§3.5), with the sample-level shuffle buffer
    providing the final decorrelation.  A query view arrives with its TQL
    scan plan already applied: pruned chunks were dropped before the loader
    ever saw them.
 2. **Schedule** — contiguous runs of planned positions become fetch units
    on the :class:`SmartScheduler`.  ``unit_size`` and ``prefetch_units``
    default to values derived from the fetch engine's latency/bandwidth
    estimates via :meth:`CostModel.derive_unit_size` /
    :meth:`~repro.core.scheduler.CostModel.derive_prefetch_units` (the old
    fixed defaults remain the local-storage fallback and can be pinned
    explicitly).
 3. **Prefetch** — the whole order plan registers with a
    :class:`~repro.core.pipeline.ScanPipeline`; as workers start and finish
    units, the pipeline keeps a ``prefetch_units``-deep, byte-bounded
    window of upcoming units' chunks in flight on the shared
    :class:`~repro.core.fetch.FetchEngine` — **across unit boundaries**, so
    the fetch horizon always runs ahead of the worker pool instead of only
    warming the first units of the epoch.  Teardown cancels only this
    loader's queued prefetches.
 4. **Stream-decode** — a pool of threads (the C++-worker analogue:
    numpy/zlib decode releases the GIL) fetches each needed chunk ONCE per
    unit — as a single coalesced request via :meth:`Tensor.read_batch`
    (resident prefetched blobs are sliced for free), full GET vs. ranged
    reads decided by the engine's cost model — decodes only the needed
    samples, applies the user transform, and deposits samples under a
    :class:`MemoryBudget` gate.  Shuffle mode then draws uniformly from
    the ready buffer; sequential mode emits in exact plan order via a
    reorder buffer; samples are collated (stack / list) into batch dicts.

The loader is re-iterable; every epoch reshuffles with ``seed + epoch``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import fetch as fetchlib
from . import telemetry
from .pipeline import ScanPipeline, derive_schedule_params
from .scheduler import CostModel, MemoryBudget, SmartScheduler
from .views import DatasetView

#: fixed fallbacks for cost-free (local/memory) providers, where adaptive
#: sizing has no latency signal to work from
DEFAULT_UNIT_SIZE = 16
DEFAULT_PREFETCH_UNITS = 8


@dataclass
class LoaderStats:
    samples: int = 0
    batches: int = 0
    bytes_fetched: int = 0
    io_requests: int = 0        # physical (coalesced) storage requests
    fetch_seconds: float = 0.0
    decode_seconds: float = 0.0
    wait_seconds: float = 0.0   # consumer blocked on pipeline
    # wait_seconds partitioned by what the workers were doing when the
    # consumer blocked (fetch | decode | buffer_full): values always sum
    # exactly to wait_seconds (same timing measurement, one cause each)
    stall_by_cause: Dict[str, float] = field(default_factory=dict)
    wall_seconds: float = 0.0
    # data-skipping accounting, inherited from the view's TQL scan plan:
    # rows/chunks the planner proved dead, so this loader never fetches them
    rows_pruned: int = 0
    chunks_pruned: int = 0
    stats_groups_decided: int = 0
    # aggregation pushdown: chunk groups whose partial aggregates were
    # answered from ChunkStats alone (zero payload fetches)
    agg_groups_stats_answered: int = 0
    # ORDER BY + LIMIT top-k accounting (view's topk plan): chunk groups the
    # bound cutoff proved irrelevant, terminated before fetch or decode
    topk_groups_skipped: int = 0

    def throughput(self) -> float:
        return self.samples / self.wall_seconds if self.wall_seconds else 0.0

    def utilization(self, step_seconds_per_batch: float) -> float:
        """Fraction of wall time the consumer would be busy given a fixed
        per-batch compute time — the Fig-7 'GPU utilization' analogue."""
        busy = self.batches * step_seconds_per_batch
        total = busy + self.wait_seconds
        return busy / total if total else 0.0


class _Unit:
    __slots__ = ("positions", "needed_at", "index")

    def __init__(self, positions: List[int], needed_at: float,
                 index: int) -> None:
        self.positions = positions
        self.needed_at = needed_at
        self.index = index      # plan-order rank; the pipeline's step key


class DeepLakeLoader:
    def __init__(
        self,
        view: DatasetView,
        *,
        batch_size: int = 32,
        shuffle: bool = False,
        shuffle_buffer: int = 1024,
        num_workers: int = 8,
        tensors: Optional[Sequence[str]] = None,
        transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
        collate: str = "stack",            # stack | list | callable
        drop_last: bool = False,
        seed: int = 0,
        prefetch_units: Optional[int] = None,
        unit_size: Optional[int] = None,
        memory_budget_bytes: int = 512 << 20,
        ranged_reads: Optional[bool] = None,
    ) -> None:
        self.view = view
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shuffle_buffer = max(1, shuffle_buffer)
        self.num_workers = max(1, num_workers)
        self.tensor_names = list(tensors) if tensors else list(view.tensor_names)
        self.transform = transform
        self.collate = collate
        self.drop_last = drop_last
        self.seed = seed
        # None = adaptive: re-derived every epoch from the fetch engine's
        # latency/bandwidth EWMA + observed per-unit decode times
        self.prefetch_units = None if prefetch_units is None \
            else max(1, prefetch_units)
        self.unit_size = None if unit_size is None else max(1, unit_size)
        self.memory = MemoryBudget(memory_budget_bytes)
        self.ranged_reads = ranged_reads
        self.costs = CostModel()
        self.stats = LoaderStats()
        self._engine = fetchlib.engine_for(view.dataset.storage)
        self._epoch = 0
        # live worker-phase occupancy, sampled when the consumer blocks to
        # attribute that stall to a cause (fetch | decode | buffer_full)
        self._phase_lock = threading.Lock()
        self._phases = {"fetch": 0, "decode": 0, "buffer_full": 0}
        for t in self.tensor_names:
            if t not in view.tensor_names:
                raise KeyError(f"loader tensor {t!r} not in view")
        # a query view arrives with its scan plan: dead chunks were already
        # dropped from view.indices, so the order plan below never visits
        # them — here we only account for the work the planner saved.
        plan = getattr(view, "scan_plan", None)
        if plan:
            self.stats.rows_pruned = plan.get("rows_pruned", 0)
            self.stats.chunks_pruned = plan.get("chunks_pruned", 0)
            self.stats.stats_groups_decided = plan.get("groups_decided", 0)
            self.stats.agg_groups_stats_answered = plan.get(
                "agg_groups_stats_answered", 0)
            self.costs.note("chunks_pruned", self.stats.chunks_pruned)
            self.costs.note("rows_pruned", self.stats.rows_pruned)
        topk = getattr(view, "topk_plan", None)
        if topk:
            self.stats.topk_groups_skipped = topk.get("groups_skipped", 0)
            self.costs.note("topk_groups_skipped",
                            self.stats.topk_groups_skipped)

    # ------------------------------------------------------------- planning
    def _primary_tensor(self) -> Optional[str]:
        best, best_bytes = None, -1
        for name in self.tensor_names:
            if name in self.view.derived:
                continue
            t = self.view._base_tensor(name)
            if t.meta.max_shape is None:
                continue
            nb = int(np.prod(t.meta.max_shape)) * np.dtype(t.meta.dtype).itemsize
            if nb > best_bytes:
                best, best_bytes = name, nb
        return best

    def _plan(self, rng: np.random.Generator) -> List[int]:
        n = len(self.view)
        if not self.shuffle:
            return list(range(n))
        primary = self._primary_tensor()
        if primary is None:
            order = np.arange(n)
            rng.shuffle(order)
            return order.tolist()
        enc = self.view._base_tensor(primary).encoder
        groups: Dict[int, List[int]] = defaultdict(list)
        for pos in range(n):
            groups[enc.chunk_ord_of(int(self.view.indices[pos]))].append(pos)
        keys = list(groups)
        rng.shuffle(keys)
        keys = self._warm_first(keys, primary)
        plan: List[int] = []
        for k in keys:
            g = groups[k]
            rng.shuffle(g)
            plan.extend(g)
        return plan

    #: shuffle unit: chunk groups are reordered warm-first only within
    #: windows of this many groups, so the visit order stays a local
    #: permutation of the seeded shuffle
    WARM_WINDOW = 8

    def _warm_first(self, keys: List[int], primary: str) -> List[int]:
        """Pipeline-aware shuffle: within each :data:`WARM_WINDOW`-sized
        window of the seeded group order, visit chunk groups whose blobs
        are already resident or in flight on the engine before cold ones
        (stats-neutral :meth:`FetchEngine.has_blob` probe).  The epoch
        still covers exactly the same groups and samples — only the order
        *within* each window changes — and on a cold engine every probe
        misses, so the reorder is the identity and the plan is exactly the
        seeded ``seed + epoch`` shuffle (determinism baseline)."""
        if len(keys) <= 1:
            return keys
        tensor = self.view._base_tensor(primary)
        enc = tensor.encoder
        out: List[int] = []
        for i in range(0, len(keys), self.WARM_WINDOW):
            window = keys[i: i + self.WARM_WINDOW]
            # stable partition: warm groups first, seeded order preserved
            # inside each class
            out.extend(sorted(
                window,
                key=lambda k: not self._engine.has_blob(
                    tensor._chunk_key(enc.name_of(k)))))
        return out

    # ------------------------------------------------------------ scheduling
    def _schedule_params(self) -> tuple:
        """(unit_size, prefetch_units) for this epoch: explicit values win;
        otherwise derived from the engine's latency/bandwidth estimates
        (cost-bearing providers) or the fixed local defaults."""
        unit_size, pf_units = self.unit_size, self.prefetch_units
        if unit_size is not None and pf_units is not None:
            return unit_size, pf_units
        if fetchlib.provider_cost_params(self.view.dataset.storage) is None:
            d_us, d_pf = DEFAULT_UNIT_SIZE, DEFAULT_PREFETCH_UNITS
        else:
            d_us, d_pf = derive_schedule_params(
                self._engine, self.costs, self._estimate_sample_bytes(),
                self.memory.max_bytes)
        return (unit_size if unit_size is not None else d_us,
                pf_units if pf_units is not None else d_pf)

    @contextmanager
    def _phase(self, name: str) -> Iterator[None]:
        with self._phase_lock:
            self._phases[name] += 1
        try:
            yield
        finally:
            with self._phase_lock:
                self._phases[name] -= 1

    def _stall_cause(self) -> str:
        """What the worker pool is doing right now — the cause charged to a
        consumer stall that starts at this instant.  Priority: a worker
        blocked on the memory budget dominates (the buffer, not I/O, is the
        ceiling); otherwise decoding only counts when nothing is fetching;
        the default is ``fetch`` (workers idle-waiting on I/O or the
        scheduler)."""
        with self._phase_lock:
            if self._phases["buffer_full"]:
                return "buffer_full"
            if self._phases["decode"] and not self._phases["fetch"]:
                return "decode"
            return "fetch"

    def _account_prefetch(self, nbytes: int) -> None:
        """Physical fetches the pipeline's prefetch window caused are
        attributed to this loader's stats (never dedup'd re-requests)."""
        self.stats.bytes_fetched += nbytes
        self.stats.io_requests += 1
        self.costs.note("io_requests", 1)

    def _estimate_sample_bytes(self) -> int:
        total = 0
        for name in self.tensor_names:
            if name in self.view.derived:
                continue
            t = self.view._base_tensor(name)
            if t.meta.max_shape:
                total += int(np.prod(t.meta.max_shape)) * np.dtype(t.meta.dtype).itemsize
        return max(total, 1024)

    def _fetch_unit(self, unit: _Unit) -> List[tuple]:
        """Fetch+decode all samples of a unit. Returns [(pos, sample_dict)].

        All storage I/O goes through :meth:`Tensor.read_batch`: one
        coalesced request per chunk (full GET vs. ranged reads decided by
        the fetch engine's cost model, replacing the old ``len(rows) <= 2``
        heuristic), with chunk ``k+1``'s fetch overlapping chunk ``k``'s
        decode on the engine pool.
        """
        out: Dict[int, Dict[str, Any]] = {p: {} for p in unit.positions}
        io: Dict[str, Any] = {"io_s": 0.0, "cpu_s": 0.0, "bytes": 0,
                              "requests": 0}
        faults_before = self._engine.fault_events()
        gidxs = [int(self.view.indices[p]) for p in unit.positions]
        with self._phase("fetch"), \
                telemetry.gspan(unit.index, "fetch", rows=len(unit.positions)):
            for name in self.tensor_names:
                if name in self.view.derived:
                    for p in unit.positions:
                        out[p][name] = self.view.derived[name][p]
                    continue
                tensor = self.view._base_tensor(name)
                vals = tensor.read_batch(gidxs, ranged=self.ranged_reads,
                                         io_stats=io)
                for p, v in zip(unit.positions, vals):
                    out[p][name] = v
        t2 = time.perf_counter()
        result = []
        with self._phase("decode"), telemetry.gspan(unit.index, "decode"):
            for p in unit.positions:
                sample = out[p]
                if self.transform is not None:
                    sample = self.transform(sample)
                result.append((p, sample))
        t_io = io["io_s"]
        t_cpu = io["cpu_s"] + time.perf_counter() - t2
        # a unit whose reads hit injected faults / retries / hedges carries
        # backoff + duplicate-request time: keep it out of the unit EWMA
        # that sizes next epoch's units and prefetch depth
        self.costs.observe("unit", t_io, t_cpu,
                           clean=self._engine.fault_events() == faults_before)
        if io["requests"]:
            self.costs.note("io_requests", io["requests"])
        self.stats.fetch_seconds += t_io
        self.stats.decode_seconds += t_cpu
        self.stats.bytes_fetched += io["bytes"]
        self.stats.io_requests += io["requests"]
        return result

    # -------------------------------------------------------------- iterate
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        plan = self._plan(rng)
        n = len(plan)
        if n == 0:
            return
        unit_size, prefetch_units = self._schedule_params()
        units = [
            _Unit(plan[i: i + unit_size], needed_at=float(i),
                  index=i // unit_size)
            for i in range(0, n, unit_size)
        ]
        sched = SmartScheduler(self.costs)
        ready: "queue.Queue[Optional[List[tuple]]]" = queue.Queue()
        est_bytes = self._estimate_sample_bytes()
        inflight = threading.Semaphore(prefetch_units)
        stop = threading.Event()

        for u in units:
            sched.submit(u, u.needed_at, "unit")
        sched.close()
        # the whole order plan registers with the scan pipeline: the
        # prefetch window follows the workers across unit boundaries
        pipe = ScanPipeline.for_units(
            self.view, [t for t in self.tensor_names
                        if t not in self.view.derived],
            [u.positions for u in units], prefetch_units=prefetch_units,
            owner=self, on_fetched=self._account_prefetch)
        pipe.on_unit_start(0)  # warm the leading window before workers spin

        def worker() -> None:
            while not stop.is_set():
                u = sched.take(timeout=0.1)
                if u is None:
                    break
                pipe.on_unit_start(u.index)
                inflight.acquire()
                if stop.is_set():
                    inflight.release()
                    break
                with self._phase("buffer_full"):
                    got = self.memory.acquire(est_bytes * len(u.positions),
                                              timeout=30)
                if not got:
                    # budget still saturated after the timeout: hand the
                    # unit back to the scheduler so it is retried, never
                    # dropped (a lost unit hangs sequential iteration on
                    # the reorder buffer forever)
                    inflight.release()
                    sched.submit(u, u.needed_at, "unit")
                    continue
                try:
                    result = self._fetch_unit(u)
                    # unit decoded: its chunks leave the prefetch window,
                    # freeing budget for the next units' chunks
                    pipe.on_unit_done(u.index)
                    ready.put(result)
                except Exception as e:  # surface worker errors to consumer
                    ready.put(e)  # type: ignore[arg-type]

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()

        emitted = 0
        batch: List[Dict[str, Any]] = []
        buffer: List[Dict[str, Any]] = []          # shuffle mode
        reorder: Dict[int, Dict[str, Any]] = {}    # sequential mode
        next_pos_i = 0
        plan_rank = {p: i for i, p in enumerate(plan)}

        def drain_one(block: bool) -> bool:
            """Move one completed unit into the emission buffers."""
            nonlocal emitted
            # sample the worker pool's phase BEFORE blocking: that is the
            # cause this stall is charged to (exactly one per wait, so
            # stall_by_cause always sums to wait_seconds)
            cause = self._stall_cause()
            sp = telemetry.span("loader.stall", cause=cause) if block \
                else telemetry.null_span()
            try:
                with sp:
                    t0 = time.perf_counter()
                    item = ready.get(timeout=60 if block else 0.001)
                waited = time.perf_counter() - t0
                self.stats.wait_seconds += waited
                self.stats.stall_by_cause[cause] = \
                    self.stats.stall_by_cause.get(cause, 0.0) + waited
            except queue.Empty:
                return False
            if isinstance(item, Exception):
                stop.set()
                raise item
            inflight.release()
            self.memory.release(est_bytes * len(item))
            for pos, sample in item:
                if self.shuffle:
                    buffer.append(sample)
                else:
                    reorder[plan_rank[pos]] = sample
            return True

        try:
            while emitted < n:
                if self.shuffle:
                    target = min(self.shuffle_buffer, n - emitted)
                    while len(buffer) < target and emitted + len(buffer) < n:
                        if not drain_one(block=True):
                            break
                    while not drain_one(block=False):
                        break
                    if not buffer:
                        continue
                    j = int(rng.integers(len(buffer)))
                    buffer[j], buffer[-1] = buffer[-1], buffer[j]
                    sample = buffer.pop()
                else:
                    while next_pos_i not in reorder:
                        drain_one(block=True)
                    sample = reorder.pop(next_pos_i)
                    next_pos_i += 1
                emitted += 1
                self.stats.samples += 1
                batch.append(sample)
                if len(batch) == self.batch_size:
                    self.stats.batches += 1
                    yield self._collate(batch)
                    batch = []
            if batch and not self.drop_last:
                self.stats.batches += 1
                yield self._collate(batch)
        finally:
            stop.set()
            sched.close()
            pipe.close()  # drop OUR queued prefetches (owner-scoped)
            # unblock any workers stuck on inflight/memory gates
            for _ in threads:
                inflight.release()
            while not ready.empty():
                try:
                    item = ready.get_nowait()
                    if not isinstance(item, Exception):
                        self.memory.release(est_bytes * len(item))
                except queue.Empty:
                    break
            for t in threads:
                t.join(timeout=2)
            self.stats.wall_seconds += time.perf_counter() - t_start

    # --------------------------------------------------------------- collate
    def _collate(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        if callable(self.collate):
            return self.collate(samples)
        out: Dict[str, Any] = {}
        keys = samples[0].keys()
        for k in keys:
            vals = [s[k] for s in samples]
            if self.collate == "stack":
                shapes = {np.asarray(v).shape for v in vals}
                out[k] = (np.stack([np.asarray(v) for v in vals])
                          if len(shapes) == 1 else vals)
            else:
                out[k] = vals
        return out

    def __len__(self) -> int:
        n = len(self.view)
        return n // self.batch_size if self.drop_last \
            else (n + self.batch_size - 1) // self.batch_size
