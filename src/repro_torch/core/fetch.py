"""Coalesced batch I/O engine: one ranged request per chunk (§3.5, §4.5).

On object storage, request *count* — not bytes — dominates latency and cost,
so every hot read path routes through a :class:`FetchEngine` that turns
per-sample reads into per-chunk batched requests.

Contract
--------

**Coalescing rule.**  Sample byte-ranges inside one chunk are sorted and
merged whenever the gap between two ranges costs less to download than a
fresh request round-trip: ``gap_bytes / bandwidth < latency``, i.e. the gap
threshold is ``latency_s * bandwidth_bps``.  The threshold is never
hardcoded — it comes from a :class:`CostEstimator` that seeds itself from
the provider chain when a cost-bearing provider exposes
``latency_s``/``bandwidth_bps`` (:class:`~repro.core.storage
.SimulatedS3Provider`), and otherwise learns both parameters from observed
request wall times through the scheduler's
:class:`~repro.core.scheduler.CostModel` EWMA.  The same estimator decides
full-GET vs. coalesced ranges per chunk:
``cost(full) = latency + object_bytes/bandwidth`` against
``cost(ranged) = n_spans * latency + needed_bytes/bandwidth`` (+ one header
round-trip when the chunk header is not yet cached).  When an LRU cache
tier sits above the cost-bearing provider and the object fits comfortably,
the full GET wins outright — the cache absorbs the object and later units
read it for free.

**In-flight dedup.**  :meth:`FetchEngine.prefetch` dedups on chunk key:
concurrent prefetches of the same key share one :class:`Future`, and a
completed prefetch parks its blob in a byte-bounded *resident* LRU that
``Tensor.read_batch`` / ``Tensor._payload_of`` consult before touching
storage, so a prefetched chunk is charged exactly one request no matter how
many consumers race for it.  Residency is skipped when an LRU cache tier
above the provider already absorbs full objects (no double caching).
Writers must invalidate: any path that rewrites or deletes a chunk key
(the open chunk is re-flushed under the SAME key as it grows) calls
:meth:`FetchEngine.discard` — ``Tensor._discard_cached`` covers every
such site — or readers sharing the engine would see stale bytes.

**Multi-object batching.**  :meth:`fetch_many` (tile fan-outs, manifest
segment prefetch) issues ONE ``provider.get_many`` round for all missing
keys instead of a request per object — a 16-tile sample costs one
round-trip, not 16.  The batched round is a single attempt: any transient
falls back to the existing per-key retry loop, so the convergence
guarantee (a transient on key N never forces re-reads of keys 1..N-1)
is unchanged, at the cost of at most one wasted round per batch.
``coalescing_disabled()`` also disables batching so benchmarks can
record the per-object "before" datapoint.

**Cancellation.**  Futures are owned by the issuing calls: ``read_batch``
cancels its own lookahead future if decoding raises, and every
:meth:`FetchEngine.prefetch` carries an *owner* token —
``DeepLakeLoader`` teardown calls ``cancel_pending(owner=loader)``,
cancelling only its own queued-but-not-started prefetches and never a
concurrent consumer's (engines are shared per provider).  A key wanted by
several owners records ALL of them: dedup adds the caller's owner to the
in-flight entry, and an owner-scoped cancel only cancels a future once
*every* owner that asked for it has cancelled — one pipeline's teardown
can never drop a blob another tenant's scan is waiting on.  A cancelled
or failed in-flight future is never trusted by readers — they fall back
to a direct synchronous fetch — so cancellation is always safe, merely
wasteful.

**Multi-tenant fairness.**  The serving tier admits many concurrent
queries over one shared engine.  :meth:`register_tenant` gives each
tenant an optional byte budget on the staging buffer; tenant-tagged
prefetches (``prefetch(..., tenant=..., est_bytes=...)``) enter a
per-tenant FIFO drained by a deficit-round-robin scheduler
(:data:`DRR_QUANTUM` bytes of credit per tenant per cycle): a heavy
scan's backlog queues behind its own budget while a selective query's
one-group prefetch dispatches on the next cycle, so the heavy tenant can
never starve the light one.  Staged bytes are charged at dispatch and
released when the blob is consumed, evicted, or discarded; a tenant's
in-flight + unconsumed staged bytes never exceed its budget (one
oversized blob is always admitted so a budget below the chunk size
cannot deadlock).  Untagged prefetches bypass the scheduler entirely —
single-consumer paths (the loader) behave exactly as before.
:meth:`tenant_stats` splits the prefetch-plane counters per tenant
(dispatches, bytes, hits, throttle events, staged peak).

**Failure handling.**  Every physical fetch the engine issues runs under a
:class:`RetryPolicy`: :class:`~repro.core.storage.TransientStorageError`
(timeouts, 5xx, torn reads) retries with capped exponential backoff +
jitter, and exhaustion raises :class:`~repro.core.storage.RetryExhausted`
(a ``StorageError``) — counted in ``stats["errors_transient"]`` /
``stats["retries"]`` / ``stats["errors_permanent"]``.  Permanent errors
propagate immediately.  The retry budget is *adaptive*: an EWMA over
attempt outcomes tracks the observed transient-fault rate, and the
effective attempt count scales with it — one attempt fewer on a quiet
store (rate ≤ 1%), two extra under heavy faults (rate ≥ 25%) — with the
starting backoff stretched proportionally so a loaded store sees fewer,
later retries.  Downward adaptation is clamped at the provider chain's
``FaultPolicy.max_consecutive_per_key + 1`` so the deterministic
convergence guarantee (any single logical fetch eventually succeeds)
survives adaptation — though an explicitly configured budget below that
cap is honored as-is; ``stats["adaptive_attempts"]`` exposes the current
effective budget.  Prefetches AND blocking demand fetches
(:meth:`fetch_full` / the coalesced path of :meth:`fetch_ranges`) *hedge*:
clean fetch wall times feed a
:class:`~repro.distributed.fault_tolerance.StragglerDetector`
EWMA, and a fetch outliving ``hedge_multiplier ×`` that baseline fires
a duplicate request — first responder wins, the loser's retries are
cancelled, exactly one result is consumed (``stats["hedges"]`` /
``stats["hedge_wins"]`` / ``stats["stragglers"]``).  Readers racing an
in-flight prefetch (:meth:`FetchEngine.resident` /
:meth:`FetchEngine.wait_inflight`) treat ONLY storage errors as a fallback
to direct I/O (``stats["inflight_fallbacks"]``); any other exception (a
decode bug, a programming error) re-raises — a failed prefetch must never
masquerade as a cache miss.  Fault-polluted timings (retried or hedged
requests) never feed the latency/bandwidth EWMA, so one straggler cannot
distort ``gap_threshold`` / ``derive_unit_size`` for the rest of the epoch.

Benchmarks can bracket a run with :func:`coalescing_disabled` to measure
the per-range "before" datapoint against the coalesced "after".
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..distributed.fault_tolerance import StragglerDetector
from . import telemetry
from .scheduler import CostModel
from .storage import (LRUCacheProvider, Range, RetryExhausted, StorageError,
                      StorageProvider, TransientStorageError, coalesce_ranges,
                      slice_spans)

# Conservative prior for providers that expose no cost parameters (POSIX /
# in-memory): sub-millisecond "requests", fast local bandwidth.  The EWMA
# refines both from observed wall times.
_DEFAULT_LATENCY_S = 1e-4
_DEFAULT_BANDWIDTH_BPS = 500e6

_coalescing_on = True
_toggle_lock = threading.Lock()


def coalescing_enabled() -> bool:
    return _coalescing_on


@contextmanager
def coalescing_disabled():
    """Force one physical request per range (the pre-batching behavior).

    Used by benchmarks to record the "before" datapoint of a before/after
    pair and by equivalence tests; never used on production paths.
    Re-entrant: the previous state is restored on exit, so nesting keeps
    the outer context's measurement honest.
    """
    global _coalescing_on
    with _toggle_lock:
        prev, _coalescing_on = _coalescing_on, False
    try:
        yield
    finally:
        with _toggle_lock:
            _coalescing_on = prev


def provider_cost_params(provider) -> Optional[Tuple[float, float]]:
    """(latency_s, bandwidth_bps) of the first cost-bearing provider in the
    chain, walking ``.base`` links top-down; None when the chain is free
    (pure memory / POSIX)."""
    p = provider
    while isinstance(p, StorageProvider):
        lat = getattr(p, "latency_s", None)
        bw = getattr(p, "bandwidth_bps", None)
        if lat is not None and bw is not None:
            return float(lat), float(bw)
        p = getattr(p, "base", None)
    return None


def fault_streak_cap(provider) -> int:
    """Largest ``FaultPolicy.max_consecutive_per_key`` of any provider in
    the chain (0 when no tier injects faults).  The adaptive retry budget
    is floored at cap + 1 so a full fault streak can never exhaust it."""
    cap = 0
    p = provider
    while isinstance(p, StorageProvider):
        fp = getattr(p, "fault_policy", None)
        if fp is not None:
            cap = max(cap, int(getattr(fp, "max_consecutive_per_key", 0)))
        p = getattr(p, "base", None)
    return cap


def cache_capacity_above(provider) -> int:
    """Bytes of LRU cache sitting *above* the first cost-bearing provider
    (0 when there is no such cache, or no cost-bearing tier at all)."""
    cap = 0
    p = provider
    while isinstance(p, StorageProvider):
        if getattr(p, "latency_s", None) is not None:
            return cap
        if isinstance(p, LRUCacheProvider):
            cap += p.capacity_bytes
        p = getattr(p, "base", None)
    return 0


class CostEstimator:
    """Latency/bandwidth model behind the coalescing threshold.

    Seeds from the provider chain when possible; otherwise starts from a
    conservative local prior and EWMA-learns both parameters from observed
    request wall times via :class:`~repro.core.scheduler.CostModel`.
    """

    def __init__(self, provider, cost_model: Optional[CostModel] = None
                 ) -> None:
        self.costs = cost_model or CostModel()
        params = provider_cost_params(provider)
        self.seeded = params is not None
        if params is not None:
            self.latency_s, self.bandwidth_bps = params
        else:
            self.latency_s = _DEFAULT_LATENCY_S
            self.bandwidth_bps = _DEFAULT_BANDWIDTH_BPS
        self.costs.observe("fetch_request", self.latency_s, 0.0)

    def observe_request(self, nbytes: int, seconds: float) -> None:
        """Fold one observed request into the EWMA (no-op when seeded from
        exact provider parameters)."""
        if self.seeded or seconds <= 0:
            return
        transfer = nbytes / self.bandwidth_bps
        self.costs.observe("fetch_request", max(seconds - transfer, 1e-7), 0.0)
        self.latency_s, _ = self.costs.estimate("fetch_request")
        if nbytes and seconds > self.latency_s:
            bw = nbytes / max(seconds - self.latency_s, 1e-9)
            a = self.costs.alpha
            self.bandwidth_bps = (1 - a) * self.bandwidth_bps + a * bw

    def gap_threshold(self) -> int:
        """Bytes of gap cheaper to download than a fresh round-trip."""
        return max(0, int(self.latency_s * self.bandwidth_bps))

    def request_cost(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_bps

    def full_get_is_cheaper(self, n_spans: int, needed_bytes: int,
                            object_bytes: int, extra_requests: int = 0,
                            amortization: float = 1.0) -> bool:
        """Model cost of one whole-object GET vs. ``n_spans`` coalesced
        ranged requests (+ ``extra_requests`` round-trips the ranged plan
        needs first, e.g. an uncached header).  ``amortization`` > 1
        tolerates a costlier full GET when later reads of the object will
        be served from a cache it fills."""
        cost_full = self.request_cost(object_bytes)
        cost_ranged = ((n_spans + extra_requests) * self.latency_s
                       + needed_bytes / self.bandwidth_bps)
        return cost_full <= amortization * cost_ranged


@dataclass(frozen=True)
class RetryPolicy:
    """Retry + hedging knobs for one :class:`FetchEngine`.

    ``max_attempts`` is the *baseline* try budget per physical request
    (first + retries); the engine adapts the effective budget around it
    from the observed transient-fault rate (see the module docstring),
    never below the provider chain's fault-streak cap + 1.  Backoff
    doubles from ``backoff_base_s`` (stretched by the observed fault
    rate) up to ``backoff_cap_s``, with up to ``jitter ×`` extra
    randomization per sleep.  A fetch — prefetch or blocking demand
    read — is hedged (duplicated) once it outlives ``hedge_multiplier ×``
    the straggler detector's clean-fetch EWMA, floored at ``hedge_min_s``
    so micro-variance on fast stores can never trigger a duplicate;
    ``hedge_multiplier <= 0`` disables hedging outright.
    """

    max_attempts: int = 4
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 0.25
    jitter: float = 0.5
    hedge_multiplier: float = 3.0
    hedge_min_s: float = 0.05


class _TenantState:
    """Per-tenant fair-scheduling state (all fields guarded by the
    engine lock)."""

    __slots__ = ("budget", "staged", "staged_peak", "deficit", "queue",
                 "stats")

    def __init__(self, budget: Optional[int]) -> None:
        self.budget = budget          # staging-byte budget; None = unlimited
        self.staged = 0               # in-flight + unconsumed staged bytes
        self.staged_peak = 0
        self.deficit = 0.0            # DRR credit (bytes)
        # queued prefetches: (key, owner, on_fetched, est_bytes, proxy)
        self.queue: deque = deque()
        self.stats = {"prefetch_requests": 0, "prefetch_dispatched": 0,
                      "prefetch_hits": 0, "bytes_fetched": 0,
                      "throttle_events": 0, "queued_peak": 0}


class FetchEngine:
    """Batched fetch front-end shared by TQL, tensor reads, and the loader.

    See the module docstring for the coalescing / dedup / cancellation /
    failure-handling contract.  One engine exists per storage provider
    (``engine_for``); all tensors and loaders bound to that provider share
    its resident store, in-flight table, thread pool, retry policy, and
    straggler detector.
    """

    def __init__(self, provider: StorageProvider, *,
                 cost_model: Optional[CostModel] = None,
                 max_workers: int = 8,
                 resident_bytes: int = 64 << 20,
                 retry: Optional[RetryPolicy] = None) -> None:
        # weak ref: the engine registry must not keep providers (and with
        # them engines, blobs, pools) alive after their last external user
        self._provider_ref = weakref.ref(provider)
        self.est = CostEstimator(provider, cost_model)
        self.cache_above = cache_capacity_above(provider)
        self.resident_bytes = int(resident_bytes)
        self.max_workers = max(1, int(max_workers))
        self.retry = retry if retry is not None else RetryPolicy()
        # the distributed-training straggler detector doubles as the hedge
        # trigger: clean fetch walls feed its EWMA, a fired hedge is the
        # mitigation (patience=1: every straggler hedges immediately)
        self.detector = StragglerDetector(
            threshold=max(self.retry.hedge_multiplier, 1.0), patience=1)
        # adaptive retry budget: EWMA of per-attempt transient-fault
        # outcomes; floor keeps the streak-cap convergence guarantee
        self._fault_rate = 0.0
        self._fault_alpha = 0.05
        self._attempts_floor = fault_streak_cap(provider) + 1
        self._backoff_rng = random.Random(0xFE7C)
        self._op_seq = 0
        # two pools so a work task (which may block on a prefetch future)
        # can never starve the prefetch that would unblock it
        self._work_pool: Optional[ThreadPoolExecutor] = None
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.RLock()
        # key -> (future, set of owners that asked for it): owner-scoped
        # cancel only cancels once every requesting owner has cancelled
        self._inflight: Dict[str, Tuple[Future, set]] = {}
        # fair multi-tenant prefetch scheduling (see module docstring)
        self._tenants: Dict[str, _TenantState] = {}
        self._key_tenant: Dict[str, Tuple[str, int]] = {}  # key -> (tenant, est)
        self._dispatching = False
        self._drr_rerun = False
        self._resident: "OrderedDict[str, bytes]" = OrderedDict()
        self._resident_size = 0
        # prefetch-efficacy bookkeeping: resident blobs not yet consumed
        # (key -> nbytes) and in-flight fetches already consumed by a waiter
        self._unconsumed: Dict[str, int] = {}
        self._inflight_consumed: set = set()
        self.stats = {"requests": 0, "ranges": 0, "bytes": 0, "hits": 0,
                      "prefetch_hits": 0, "prefetch_wasted_bytes": 0,
                      "retries": 0, "errors_transient": 0,
                      "errors_permanent": 0, "hedges": 0, "hedge_wins": 0,
                      "stragglers": 0, "prefetch_failures": 0,
                      "inflight_fallbacks": 0,
                      "adaptive_attempts": max(1, self.retry.max_attempts)}

    @property
    def provider(self) -> StorageProvider:
        p = self._provider_ref()
        if p is None:  # unreachable while any caller can still reach us
            raise RuntimeError("storage provider was garbage-collected")
        return p

    def stats_snapshot(self) -> Dict[str, int]:
        """Consistent point-in-time copy of :attr:`stats`.

        Every mutation of the stats dict happens under ``self._lock``, so
        copying under the same lock can never observe a torn multi-key
        update (e.g. ``requests`` incremented but ``bytes`` not yet) the
        way iterating the live dict from another thread could.
        """
        with self._lock:
            return dict(self.stats)

    # ------------------------------------------------------- resident blobs
    def has_blob(self, key: str) -> bool:
        """Stats-neutral warmth probe: True when ``key`` is resident, in
        flight, or tracked as unconsumed in an LRU tier above.  The
        loader's pipeline-aware shuffle consults it to visit warm chunk
        groups before cold ones; it never mutates LRU order or counters."""
        with self._lock:
            return (key in self._resident or key in self._inflight
                    or key in self._unconsumed)

    def resident(self, key: str) -> Optional[bytes]:
        """Fully-fetched blob for ``key`` if one is parked here (no I/O).
        Also resolves an in-flight prefetch that already completed."""
        with self._lock:
            data = self._resident.get(key)
            if data is not None:
                self._resident.move_to_end(key)
                self.stats["hits"] += 1
                self._mark_consumed(key)
                return data
            entry = self._inflight.get(key)
        if entry is not None and entry[0].done():
            try:
                blob = entry[0].result()
            except CancelledError:
                return None            # cancelled: caller fetches directly
            except StorageError:
                # the prefetch burned its whole retry budget; the caller's
                # direct fetch gets a fresh one (counted, never silent)
                with self._lock:
                    self.stats["inflight_fallbacks"] += 1
                return None
            # anything else (decode bug, KeyError, ...) re-raises: a failed
            # prefetch must never masquerade as a cache miss
            with self._lock:
                self._mark_inflight_consumed(key)
            return blob
        return None

    def _mark_consumed(self, key: str) -> None:
        """A resident prefetched blob was read (lock held): first
        consumption counts as a prefetch hit."""
        if self._unconsumed.pop(key, None) is not None:
            self.stats["prefetch_hits"] += 1
        self._tenant_release(key)

    def _mark_inflight_consumed(self, key: str) -> None:
        """An in-flight prefetch's result was consumed before admission
        (lock held)."""
        if key not in self._inflight_consumed:
            self._inflight_consumed.add(key)
            self.stats["prefetch_hits"] += 1

    def _waste(self, key: str, nbytes: int) -> None:
        """A prefetched blob leaves the engine unconsumed (lock held)."""
        if self._unconsumed.pop(key, None) is not None:
            self.stats["prefetch_wasted_bytes"] += nbytes
        self._tenant_release(key)

    #: bound on consumption-tracking keys when an LRU tier holds the blobs
    _TRACK_KEYS_MAX = 4096

    def _admit(self, key: str, data: bytes, consumed: bool = False) -> None:
        if consumed:  # consumed before admission: staged charge is over
            with self._lock:
                self._tenant_release(key)
        # an LRU tier above the charged provider already holds full objects;
        # track the KEY (no blob) so a later engine read of it still counts
        # as a prefetch hit — eviction there is invisible, so such entries
        # can only hit, never count as wasted
        if self.cache_above:
            if not consumed:
                with self._lock:
                    self._unconsumed[key] = 0
                    while len(self._unconsumed) > self._TRACK_KEYS_MAX:
                        self._unconsumed.pop(next(iter(self._unconsumed)))
            return
        if len(data) > self.resident_bytes:
            if not consumed:  # fetched, never held, never read: pure waste
                with self._lock:
                    self.stats["prefetch_wasted_bytes"] += len(data)
                    self._tenant_release(key)
            return
        with self._lock:
            old = self._resident.pop(key, None)
            if old is not None:
                self._resident_size -= len(old)
                self._waste(key, len(old))
            self._resident[key] = data
            self._resident_size += len(data)
            if not consumed:
                self._unconsumed[key] = len(data)
            while self._resident_size > self.resident_bytes and self._resident:
                # evict already-consumed blobs first (LRU among them): a
                # staged, never-read prefetch is the one blob eviction
                # would turn into pure waste
                victim = next((k for k in self._resident
                               if k not in self._unconsumed), None)
                if victim is not None:
                    self._resident_size -= len(self._resident.pop(victim))
                    continue
                k, v = self._resident.popitem(last=False)
                self._resident_size -= len(v)
                self._waste(k, len(v))

    def discard(self, key: str) -> None:
        """Writer invalidation: drop the resident blob AND abandon any
        in-flight prefetch of the key, so a fetch that raced the rewrite
        can neither be served to readers nor re-admit stale bytes when it
        completes (its done-callback only admits while still current)."""
        with self._lock:
            v = self._resident.pop(key, None)
            if v is not None:
                self._resident_size -= len(v)
                self._waste(key, len(v))
            else:
                self._unconsumed.pop(key, None)  # key-only tracking entry
            self._inflight_consumed.discard(key)
            self._tenant_release(key)
            entry = self._inflight.pop(key, None)
        if entry is not None:
            entry[0].cancel()  # best effort; a running fetch is abandoned

    # -------------------------------------------------------- sync fetching
    def _observe(self, n_requests: int, n_ranges: int, nbytes: int,
                 seconds: float, clean: bool = True) -> None:
        """Account one logical fetch.  ``clean=False`` (the timing includes
        injected faults, retry backoff, or a hedge race) still counts the
        request but NEVER feeds the latency/bandwidth EWMA — one straggler
        must not distort the coalescing threshold or unit sizing."""
        with self._lock:
            self.stats["requests"] += n_requests
            self.stats["ranges"] += n_ranges
            self.stats["bytes"] += nbytes
        if n_requests and clean:
            self.est.observe_request(nbytes // n_requests,
                                     seconds / n_requests)

    def _note_attempt(self, faulted: bool) -> None:
        """Fold one physical attempt outcome into the fault-rate EWMA
        (lock held by callers via _issue)."""
        a = self._fault_alpha
        self._fault_rate = (1 - a) * self._fault_rate + a * (1.0 if faulted
                                                             else 0.0)

    def _adaptive_attempts(self) -> int:
        """Effective attempt budget for the next physical request: one
        fewer than ``max_attempts`` on a quiet store (observed transient
        rate ≤ 1%), two extra under heavy faults (≥ 25%), the baseline in
        between.  Downward adaptation never crosses the provider chain's
        fault-streak cap + 1 (so the deterministic convergence guarantee
        survives), but an explicitly configured budget *below* that cap is
        honored as-is — adaptation only shrinks what the policy granted,
        it never overrides it."""
        base = max(1, self.retry.max_attempts)
        rate = self._fault_rate
        if rate <= 0.01:
            att = max(2, base - 1)
        elif rate >= 0.25:
            att = base + 2
        else:
            att = base
        return max(att, min(self._attempts_floor, base))

    def _issue(self, fn, key: str = "",
               cancelled: Optional[threading.Event] = None):
        """Run one physical fetch closure under the (adaptive) retry
        policy.

        Transients retry with capped exponential backoff + jitter;
        exhaustion raises :class:`RetryExhausted` chained on the last
        transient.  ``cancelled`` (hedging) aborts between attempts.
        Returns ``(result, first_try)`` — ``first_try`` is False whenever
        a retry happened, i.e. the caller's wall time is fault-polluted.
        """
        policy = self.retry
        with self._lock:
            attempts = self._adaptive_attempts()
            self.stats["adaptive_attempts"] = attempts
            # loaded store → start backoff later (fewer, gentler probes)
            delay = policy.backoff_base_s * (1.0 + 4.0 * self._fault_rate)
        last: Optional[TransientStorageError] = None
        for i in range(attempts):
            if cancelled is not None and cancelled.is_set():
                raise CancelledError()
            try:
                if i == 0:
                    out = fn()
                else:
                    # retried attempts get their own span and IO cause so
                    # their sim charges land in the "retry" stall bucket
                    with telemetry.span("fetch.retry", key=key, attempt=i), \
                            telemetry.io_cause("retry"):
                        out = fn()
                with self._lock:
                    self._note_attempt(False)
                return out, i == 0
            except TransientStorageError as e:
                last = e
                with self._lock:
                    self._note_attempt(True)
                    self.stats["errors_transient"] += 1
                    if i + 1 < attempts:
                        self.stats["retries"] += 1
                    u = self._backoff_rng.random()
                if i + 1 >= attempts:
                    break
                time.sleep(delay * (1.0 + policy.jitter * u))
                delay = min(delay * 2.0, policy.backoff_cap_s)
        with self._lock:
            self.stats["errors_permanent"] += 1
        raise RetryExhausted(
            f"fetch retries exhausted after {attempts} attempts: {key!r}"
        ) from last

    def _note_clean_wall(self, seconds: float) -> None:
        """Feed one clean (unretried, unhedged) fetch wall time to the
        straggler detector's baseline EWMA."""
        with self._lock:
            self._op_seq += 1
            seq = self._op_seq
        self.detector.observe(seq, seconds)

    def fault_events(self) -> int:
        """Monotone count of fault-path events (transient errors + hedges).
        Consumers bracket a timed section with it to decide whether that
        timing is clean enough for their own EWMAs (the loader's per-unit
        cost model does)."""
        with self._lock:
            s = self.stats
            return s["errors_transient"] + s["errors_permanent"] + s["hedges"]

    def wait_inflight(self, key: str) -> Optional[bytes]:
        """Result of an in-flight prefetch of ``key``, waiting for it to
        finish; None when nothing is in flight or it was cancelled or
        failed with a *storage* error (the caller then falls back to
        direct I/O, which retries with a fresh budget).  Non-storage
        exceptions re-raise — they are bugs, not cache misses."""
        with self._lock:
            entry = self._inflight.get(key)
        if entry is None:
            return None
        try:
            blob = entry[0].result()
        except CancelledError:
            return None
        except StorageError:
            with self._lock:
                self.stats["inflight_fallbacks"] += 1
            return None
        with self._lock:
            self._mark_inflight_consumed(key)
        return blob

    def fetch_full(self, key: str) -> bytes:
        """Whole-object read, resident/in-flight aware.

        Deliberately does NOT park the blob in the resident store: caching
        fetched objects is the job of an :class:`LRUCacheProvider` tier;
        residency is reserved for :meth:`prefetch` handoff (the paper's
        "buffer of fetched and unutilized data" belongs to the consumer,
        not the cache).
        """
        blob = self.resident(key)
        if blob is None:
            blob = self.wait_inflight(key)
        if blob is not None:
            return blob
        t0 = time.perf_counter()
        # demand reads hedge too: a blocking consumer is exactly who a
        # straggling request hurts most
        data, first_try = self._hedged(lambda: self.provider.get(key), key)
        wall = time.perf_counter() - t0
        self._observe(1, 0, len(data), wall, clean=first_try)
        if first_try:
            self._note_clean_wall(wall)
        with self._lock:  # prefetched into an LRU tier above: still a hit
            self._mark_consumed(key)
        return data

    def fetch_ranges(self, key: str, ranges: Sequence[Range],
                     counters: Optional[Dict[str, int]] = None
                     ) -> List[bytes]:
        """Batched ranged read: payload ``i`` equals
        ``provider.get_range(key, *ranges[i])``, issued as coalesced spans
        (or served free from a resident blob).  ``counters``, when given,
        receives the physical ``requests`` and new ``bytes`` this call
        actually issued (both 0 on a resident hit)."""
        ranges = [(int(s), int(e)) for s, e in ranges]
        if counters is not None:
            counters.setdefault("requests", 0)
            counters.setdefault("bytes", 0)
        if not ranges:
            return []
        blob = self.resident(key)
        if blob is not None:
            return [blob[s:max(s, e)] for s, e in ranges]
        if not coalescing_enabled():
            t0 = time.perf_counter()
            out, first_try = self._issue(
                lambda: [self.provider.get_range(key, s, e)
                         for s, e in ranges], key=key)
            nbytes = sum(len(p) for p in out)
            self._observe(len(ranges), len(ranges), nbytes,
                          time.perf_counter() - t0, clean=first_try)
            if counters is not None:
                counters["requests"] += len(ranges)
                counters["bytes"] += nbytes
            return out
        spans, assign = coalesce_ranges(ranges, self.est.gap_threshold())
        t0 = time.perf_counter()
        with self._lock:  # prefetched into an LRU tier above: still a hit
            self._mark_consumed(key)
        payloads, first_try = self._hedged(
            lambda: self.provider.get_ranges(key, spans), key)
        nbytes = sum(len(p) for p in payloads)
        wall = time.perf_counter() - t0
        self._observe(len(spans), len(ranges), nbytes, wall, clean=first_try)
        if first_try:
            self._note_clean_wall(wall / max(1, len(spans)))
        if counters is not None:
            counters["requests"] += len(spans)
            counters["bytes"] += nbytes
        return slice_spans(ranges, spans, assign, payloads)

    def fetch_many(self, keys: Sequence[str],
                   counters: Optional[Dict[str, int]] = None
                   ) -> Dict[str, bytes]:
        """Batched whole-object reads (tile fan-out, manifest segment
        prefetch on ``Dataset`` open), resident aware.  ``counters``, when
        given, accumulates the physical ``requests``/``bytes`` issued —
        the cold-open budget accounting reads them.

        All missing keys go out as ONE ``provider.get_many`` round (a
        batching provider charges one round-trip for the lot).  The batch
        is a single attempt: a transient anywhere in it falls back to the
        per-key retry loop — a transient on key N must never force
        re-reads of keys 1..N-1 (a whole-batch retry could outlive any
        budget once per-key fault streaks stack up), so convergence costs
        at most one wasted round.  ``coalescing_disabled()`` forces the
        per-object path for "before" benchmarks."""
        if counters is not None:
            counters.setdefault("requests", 0)
            counters.setdefault("bytes", 0)
        out: Dict[str, bytes] = {}
        missing: List[str] = []
        for k in keys:
            if k in out or k in missing:
                continue
            blob = self.resident(k)
            if blob is not None:
                out[k] = blob
            else:
                missing.append(k)
        if missing:
            t0 = time.perf_counter()
            with self._lock:  # LRU-tier prefetch consumption
                for k in missing:
                    self._mark_consumed(k)
            fetched: Dict[str, bytes] = {}
            n_requests = 0
            all_clean = True
            if coalescing_enabled() and len(missing) > 1:
                try:
                    fetched = dict(self.provider.get_many(missing))
                    n_requests = 1
                except TransientStorageError:
                    with self._lock:
                        self.stats["errors_transient"] += 1
                    fetched = {}
                    all_clean = False
            if not fetched:
                for k in missing:
                    blob, first_try = self._issue(
                        lambda k=k: self.provider.get(k), key=k)
                    fetched[k] = blob
                    all_clean = all_clean and first_try
                n_requests += len(fetched)
            nbytes = sum(len(v) for v in fetched.values())
            self._observe(n_requests, 0, nbytes,
                          time.perf_counter() - t0, clean=all_clean)
            if counters is not None:
                counters["requests"] += n_requests
                counters["bytes"] += nbytes
            out.update(fetched)
        return out

    #: with an LRU tier above the remote, a full GET fills the cache and
    #: later reads of the chunk are free — worth paying up to this factor
    #: over the one-shot ranged cost (but never an unconditional win: a
    #: sparse one-shot read of a huge chunk must stay ranged)
    CACHE_AMORTIZATION = 4.0

    # --------------------------------------------------------- chunk planning
    def plan_full_get(self, *, n_spans: int, needed_bytes: int,
                      object_bytes: int, header_cached: bool) -> bool:
        """True → fetch the whole chunk in one GET; False → coalesced
        ranges.  With coalescing disabled the answer is always ranged, so
        the "before" benchmark measures the per-range request pattern."""
        if not coalescing_enabled():
            return False
        cacheable = self.cache_above and object_bytes <= self.cache_above // 4
        return self.est.full_get_is_cheaper(
            n_spans, needed_bytes, object_bytes,
            extra_requests=0 if header_cached else 1,
            amortization=self.CACHE_AMORTIZATION if cacheable else 1.0)

    # ------------------------------------------------------------- prefetch
    def _ensure_pool(self, attr: str, prefix: str) -> ThreadPoolExecutor:
        with self._lock:
            pool = getattr(self, attr)
            if pool is None:
                pool = ThreadPoolExecutor(max_workers=self.max_workers,
                                          thread_name_prefix=prefix)
                setattr(self, attr, pool)
            return pool

    def submit(self, fn, *args) -> Future:
        """Run ``fn(*args)`` on the engine work pool (fetch/decode
        overlap).  Work tasks may wait on prefetch futures — those run on
        a separate pool, so the wait always makes progress."""
        return self._ensure_pool("_work_pool", "fetch-work").submit(fn, *args)

    #: DRR scheduling quantum: bytes of dispatch credit each tenant earns
    #: per scheduler cycle (roughly one chunk-group's worth)
    DRR_QUANTUM = 1 << 20

    def register_tenant(self, tenant: str,
                        byte_budget: Optional[int] = None) -> None:
        """Declare (or re-budget) a tenant for fair prefetch scheduling.
        ``byte_budget`` bounds the tenant's staged bytes (in-flight +
        unconsumed resident); None = unlimited (fair ordering only)."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                self._tenants[tenant] = _TenantState(byte_budget)
            else:
                st.budget = byte_budget
        self._kick()

    def tenant_stats(self, tenant: str) -> Dict[str, int]:
        """Point-in-time copy of one tenant's prefetch-plane split
        (``engine_*`` counters scoped to the tenant) plus live staging
        state."""
        with self._lock:
            st = self._tenants[tenant]
            out = dict(st.stats)
            out["staged_bytes"] = st.staged
            out["staged_peak_bytes"] = st.staged_peak
            out["queued"] = len(st.queue)
            return out

    def tenants_snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            names = list(self._tenants)
        return {t: self.tenant_stats(t) for t in names}

    def _tenant_release(self, key: str) -> None:
        """Release a key's staged-byte charge (lock held) and let the
        scheduler re-fill the freed headroom."""
        ent = self._key_tenant.pop(key, None)
        if ent is None:
            return
        name, est = ent
        st = self._tenants.get(name)
        if st is not None:
            st.staged = max(0, st.staged - est)
            if st.queue:
                self._kick()

    def _drr_collect(self) -> List[tuple]:
        """One deficit-round-robin sweep (lock held): pop every queued
        prefetch that fits its tenant's credit and budget, cycling until
        a full round makes no progress."""
        todo: List[tuple] = []
        progress = True
        while progress:
            progress = False
            for name, st in list(self._tenants.items()):
                if not st.queue:
                    st.deficit = 0.0
                    continue
                st.deficit = min(st.deficit + self.DRR_QUANTUM,
                                 8.0 * self.DRR_QUANTUM)
                while st.queue:
                    key, owner, on_fetched, est, proxy = st.queue[0]
                    if proxy.cancelled():
                        st.queue.popleft()
                        continue
                    # budget gate: always admit one item into an empty
                    # stage so a budget below the chunk size can't deadlock
                    if (st.budget is not None and st.staged > 0
                            and st.staged + est > st.budget):
                        break
                    if st.deficit < est:
                        break
                    st.queue.popleft()
                    st.deficit -= est
                    st.staged += est
                    st.staged_peak = max(st.staged_peak, st.staged)
                    todo.append((name, key, owner, on_fetched, est, proxy))
                    progress = True
        return todo

    def _kick(self) -> None:
        """Drain dispatchable tenant queues.  Re-entrant-safe: a nested
        call (e.g. a dispatch consuming a resident blob) only flags a
        re-run for the outer loop."""
        with self._lock:
            if self._dispatching:
                self._drr_rerun = True
                return
            self._dispatching = True
        try:
            while True:
                with self._lock:
                    self._drr_rerun = False
                    todo = self._drr_collect()
                for item in todo:
                    self._dispatch_one(*item)
                with self._lock:
                    if not todo and not self._drr_rerun:
                        return
        finally:
            with self._lock:
                self._dispatching = False

    def _dispatch_one(self, tenant: str, key: str, owner: object,
                      on_fetched, est: int, proxy: Future) -> None:
        """Issue one scheduled tenant prefetch and tie its outcome to the
        proxy future handed out at enqueue time."""
        st = self._tenants[tenant]

        def counted(nbytes: int) -> None:
            with self._lock:
                st.stats["bytes_fetched"] += nbytes
            if on_fetched is not None:
                on_fetched(nbytes)

        with self._lock:
            st.stats["prefetch_dispatched"] += 1
            # charge the staged bytes against the key so consumption /
            # eviction / discard releases them; a key already charged to
            # another tenant is not double-charged
            if key in self._key_tenant:
                st.staged = max(0, st.staged - est)
            else:
                self._key_tenant[key] = (tenant, est)
        real = self._prefetch_now(key, owner, counted)

        def _copy(f: Future) -> None:
            if f.cancelled():
                with self._lock:
                    self._tenant_release(key)
                proxy.cancel()
            elif f.exception() is not None:
                with self._lock:
                    self._tenant_release(key)
                if not proxy.cancelled():
                    proxy.set_exception(f.exception())
            else:
                if not proxy.cancelled():
                    proxy.set_result(f.result())

        real.add_done_callback(_copy)
        # dedup against an already-consumed resident blob: nothing will
        # ever release the charge, so drop it now
        with self._lock:
            if key not in self._inflight and key not in self._unconsumed:
                self._tenant_release(key)

    def prefetch(self, key: str, owner: object = None, on_fetched=None, *,
                 tenant: Optional[str] = None, est_bytes: int = 0) -> Future:
        """Schedule a whole-chunk fetch; dedups in-flight keys.

        The completed blob is parked in the resident store (unless an LRU
        tier above already caches it), where readers pick it up for free.
        ``owner`` scopes cancellation: :meth:`cancel_pending` with the
        same owner cancels only that owner's still-queued futures, so one
        consumer's teardown never drops another's prefetches.  A key
        already in flight gains the caller's owner as an additional owner
        — the future is only cancellable once every owner has cancelled.
        ``on_fetched(nbytes)`` fires only when THIS call causes a physical
        fetch (never on resident/in-flight dedup), so issuers can
        attribute the I/O to their own accounting.

        ``tenant`` (registered via :meth:`register_tenant`) routes the
        request through the fair deficit-round-robin scheduler under the
        tenant's staging-byte budget; ``est_bytes`` is the charge
        (estimated blob size).  Untagged calls dispatch immediately.
        """
        if tenant is not None:
            with self._lock:
                st = self._tenants.get(tenant)
                if st is None:
                    st = self._tenants[tenant] = _TenantState(None)
                st.stats["prefetch_requests"] += 1
                # dedup before queuing: an in-flight or resident key needs
                # no scheduling (and no staged-byte charge)
                entry = self._inflight.get(key)
                if entry is not None:
                    entry[1].add(owner)
                    st.stats["prefetch_hits"] += 1
                    return entry[0]
                data = self._resident.get(key)
                if data is not None:
                    st.stats["prefetch_hits"] += 1
                    done: Future = Future()
                    done.set_result(data)
                    return done
                if (st.budget is not None and st.staged > 0
                        and st.staged + max(0, est_bytes) > st.budget):
                    st.stats["throttle_events"] += 1
                proxy: Future = Future()
                st.queue.append((key, owner, on_fetched,
                                 max(0, int(est_bytes)), proxy))
                st.stats["queued_peak"] = max(st.stats["queued_peak"],
                                              len(st.queue))
            self._kick()
            return proxy
        return self._prefetch_now(key, owner, on_fetched)

    def _prefetch_now(self, key: str, owner: object = None,
                      on_fetched=None) -> Future:
        """Unscheduled prefetch dispatch (the pre-serving behavior)."""
        with self._lock:
            entry = self._inflight.get(key)
            if entry is not None:
                entry[1].add(owner)
                return entry[0]
            data = self._resident.get(key)
        if data is not None:
            done: Future = Future()
            done.set_result(data)
            return done
        pool = self._ensure_pool("_prefetch_pool", "fetch-prefetch")

        def work() -> bytes:
            t0 = time.perf_counter()
            # tag the pool thread so provider charges (and any non-hedged
            # _issue attempts) land in the "prefetch" stall bucket
            with telemetry.io_cause("prefetch"):
                blob, clean = self._hedged_get(key)
            wall = time.perf_counter() - t0
            self._observe(1, 0, len(blob), wall, clean=clean)
            if clean:
                self._note_clean_wall(wall)
            if on_fetched is not None:
                on_fetched(len(blob))
            return blob

        with self._lock:
            entry = self._inflight.get(key)
            if entry is not None:
                entry[1].add(owner)
                return entry[0]
            fut = pool.submit(work)
            self._inflight[key] = (fut, {owner})

        def _done(f: Future, key: str = key) -> None:
            with self._lock:
                cur = self._inflight.get(key)
                current = cur is not None and cur[0] is f
                if current:
                    del self._inflight[key]
                consumed = key in self._inflight_consumed
                self._inflight_consumed.discard(key)
                if current and (f.cancelled() or f.exception() is not None):
                    self._tenant_release(key)
            # admit only while still current: a discard() (writer rewrote
            # the key) or supersession while in flight abandons the result
            if not current or f.cancelled():
                return
            if f.exception() is None:
                self._admit(key, f.result(), consumed=consumed)
            else:
                # the failure stays on the future for waiters to see; it
                # must also be visible when nobody ever waits
                with self._lock:
                    self.stats["prefetch_failures"] += 1

        fut.add_done_callback(_done)
        return fut

    def _hedged_get(self, key: str) -> Tuple[bytes, bool]:
        """Whole-object GET with straggler hedging (the prefetch pool's
        physical fetch)."""
        return self._hedged(lambda: self.provider.get(key), key)

    def _hedged(self, fn, key: str):
        """Run one physical fetch closure with straggler hedging.

        The primary request runs under the retry policy on its own thread;
        once it outlives ``hedge_multiplier ×`` the straggler detector's
        clean-fetch baseline (floored at ``hedge_min_s``), a duplicate
        request fires and the first responder wins — the loser's remaining
        retries are cancelled and its payload discarded, so exactly one
        result is consumed.  No hedge before a baseline exists (the first
        fetch has nothing to straggle against).  Used by prefetch AND the
        blocking demand paths (:meth:`fetch_full`, the coalesced branch of
        :meth:`fetch_ranges`) — ``fn`` must be re-runnable and
        side-effect-free.  Returns ``(result, clean)`` where ``clean``
        means first attempt, no hedge.
        """
        policy = self.retry
        base = self.detector.baseline
        if policy.hedge_multiplier <= 0 or base is None:
            return self._issue(fn, key=key)
        deadline = max(policy.hedge_min_s, self.detector.threshold * base)
        cond = threading.Condition()
        cancel = threading.Event()
        state = {"winner": None, "blob": None, "first_try": False,
                 "done": 0, "errors": []}
        # the IO cause is thread-local and the arms run on fresh threads,
        # so capture the caller's cause here and re-tag explicitly: the
        # primary arm keeps it, the hedge arm charges the "hedge" bucket
        caller_cause = telemetry.current_io_cause()

        def arm(tag: str) -> None:
            try:
                cause = "hedge" if tag == "hedge" else caller_cause
                with telemetry.io_cause(cause):
                    blob, first_try = self._issue(fn, key=key,
                                                  cancelled=cancel)
            except BaseException as e:  # noqa: BLE001 - relayed to waiter
                with cond:
                    state["done"] += 1
                    state["errors"].append(e)
                    cond.notify_all()
                return
            with cond:
                state["done"] += 1
                if state["winner"] is None:
                    state["winner"] = tag
                    state["blob"] = blob
                    state["first_try"] = first_try
                cond.notify_all()
            cancel.set()  # first responder wins: stop the other arm

        threading.Thread(target=arm, args=("primary",), daemon=True,
                         name="fetch-hedge-primary").start()
        arms = 1
        with cond:
            cond.wait_for(lambda: state["done"] >= 1, timeout=deadline)
            straggling = state["done"] == 0
        if straggling:
            with self._lock:
                self.stats["hedges"] += 1
                self.stats["stragglers"] += 1
                self._op_seq += 1
                seq = self._op_seq
            # record the straggler with the detector (patience=1: the
            # fired hedge IS the mitigation); the elapsed time is clamped
            # above the flag threshold so the floor can't hide it
            self.detector.observe(
                seq, max(deadline, self.detector.threshold * base * 1.01))
            arms = 2
            threading.Thread(target=arm, args=("hedge",), daemon=True,
                             name="fetch-hedge-dup").start()
        hedge_span = telemetry.span("fetch.hedge", key=key) if arms == 2 \
            else telemetry.null_span()
        with hedge_span, cond:
            cond.wait_for(lambda: state["winner"] is not None
                          or state["done"] >= arms)
        if state["winner"] is None:
            raise state["errors"][0]
        if state["winner"] == "hedge":
            with self._lock:
                self.stats["hedge_wins"] += 1
        return state["blob"], bool(arms == 1 and state["first_try"])

    def cancel_pending(self, owner: object = None) -> int:
        """Cancel queued-but-not-started prefetches; running fetches
        complete and park normally.  ``owner`` restricts cancellation to
        futures issued with that owner (None cancels everything — only
        for full engine shutdown) — and an in-flight key wanted by OTHER
        owners too is left alone: the owner is merely removed from the
        entry, and the future is cancelled only when no owner remains,
        so one pipeline's teardown never drops a blob a concurrent
        consumer is waiting on.  Returns #cancelled."""
        futs: List[Future] = []
        with self._lock:
            for f, owners in self._inflight.values():
                if owner is None:
                    futs.append(f)
                    continue
                owners.discard(owner)
                if not owners:
                    futs.append(f)
            # still-queued tenant prefetches by this owner are dequeued
            # outright (their proxy futures cancel; nothing was staged yet)
            for st in self._tenants.values():
                kept = deque()
                for item in st.queue:
                    if owner is None or item[1] is owner:
                        futs.append(item[4])
                    else:
                        kept.append(item)
                st.queue = kept
        return sum(1 for f in futs if f.cancel())

    def close(self) -> None:
        self.cancel_pending()
        with self._lock:
            pools = (self._work_pool, self._prefetch_pool)
            self._work_pool = self._prefetch_pool = None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=False)


_engines: "weakref.WeakKeyDictionary[StorageProvider, FetchEngine]" = \
    weakref.WeakKeyDictionary()
_engines_lock = threading.Lock()


def engine_for(provider: StorageProvider) -> FetchEngine:
    """The shared :class:`FetchEngine` of a storage provider (one per
    provider instance, created on first use, garbage-collected with it)."""
    with _engines_lock:
        eng = _engines.get(provider)
        if eng is None:
            eng = FetchEngine(provider)
            _engines[provider] = eng
        return eng


def engine_stats_for(provider: StorageProvider) -> Dict[str, int]:
    """Summed stats of every live engine whose provider chain contains
    ``provider`` (walking ``.base`` links).  Benchmarks snapshot the
    cost-bearing provider at the bottom of a cache chain while the engine
    is keyed on the chain's top — this bridges the two so prefetch-efficacy
    counters (``prefetch_hits``, ``prefetch_wasted_bytes``) land in
    ``BENCH_io.json`` next to the provider's request counters."""
    out: Dict[str, int] = {}
    with _engines_lock:
        items = [(p, e) for p, e in _engines.items()]
    for top, eng in items:
        p: Optional[StorageProvider] = top
        while isinstance(p, StorageProvider):
            if p is provider:
                # locked snapshot, not the live dict: worker/prefetch
                # threads mutate stats concurrently
                for k, v in eng.stats_snapshot().items():
                    out[k] = out.get(k, 0) + int(v)
                break
            p = getattr(p, "base", None)
    return out
