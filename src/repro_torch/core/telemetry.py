"""End-to-end telemetry: span tracing, unified metrics, stall attribution.

This module is the single observability layer for the lakehouse. It has
three parts, all designed to be compiled out by default: when tracing is
disabled (the default) a span call returns a shared no-op context manager
and allocates nothing, and metric counters are plain lock-guarded adds.

Span naming scheme
------------------
Spans are dot-separated, lowercase, with the subsystem first. Per-group
spans embed the group/unit index in brackets. The wired-in names:

    query.plan                      TQL stats planning (plan_where)
    query.where                     streamed WHERE mask evaluation
    query.topk                      ORDER BY + LIMIT top-k stream
                                    (args include ``terminated_early``)
    scan.group[k].prefetch          ScanPipeline window top-up for group k
    scan.group[k].deliver           consumer processing of group k's rows
    scan.group[k].fetch             loader worker blob wait/read for unit k
    scan.group[k].decode            loader worker transform/collate for unit k
    fetch.retry                     one retry attempt inside FetchEngine._issue
                                    (args: key, attempt)
    fetch.hedge                     hedged duplicate in flight inside
                                    FetchEngine._hedged (args: key)
    commit.publish                  one CAS publish attempt in VersionControl
    commit.rebase                   rebase-and-retry after a lost CAS race
                                    (args: shape=adopt|relocate)
    loader.stall                    consumer blocked waiting for a ready unit
                                    (args: cause=fetch|decode|buffer_full)
    serve.admit                     whole handling of one QueryService query
                                    (args: tenant, cache=hit|miss|uncacheable)
    serve.queue                     time blocked on the admission semaphore
                                    (args: tenant, wait_s)
    serve.flight_wait               follower waiting on a single-flight leader
    serve.shard[k]                  one shard worker of a parallel chunk-group
                                    scan (args: groups)

``Tracer.report()`` aggregates by name with bracketed indices normalised
to ``[*]`` so per-query/per-epoch reports stay compact.

Chrome trace JSON schema
------------------------
``Tracer.export_chrome()`` returns (and ``write_chrome(path)`` dumps) the
standard Chrome ``trace_event`` envelope, loadable in chrome://tracing or
Perfetto:

    {"traceEvents": [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "repro-lakehouse"}},
        {"ph": "X", "pid": 1, "tid": <thread-id>, "name": "scan.group[3].fetch",
         "cat": "scan", "ts": <start, microseconds>, "dur": <microseconds>,
         "args": {..., "depth": <nesting depth>, "parent": <parent span name>}},
        ...
    ]}

All complete spans use phase ``"X"`` (duration events); ``cat`` is the
name's first dot-component; ``ts`` is relative to the tracer epoch.

Metrics registry
----------------
``registry()`` returns the process-wide :class:`MetricsRegistry`. Metric
names are dot-separated (``commit.rebases``, ``storage.wasted_upload_bytes``,
``tql.plans``, ``serve.cache.hits`` / ``serve.cache.misses`` /
``serve.plan_cache.hits``, per-tenant ``serve.tenant.<t>.*``);
``snapshot()`` flattens them to underscore keys (``commit_rebases``) so they
can be recorded as ``BENCH_io.json`` leaves. ``provider_snapshot(provider)``
is the one snapshot API the benches share: numeric provider stats merged
with ``engine_*``-prefixed :func:`repro.core.fetch.engine_stats_for` stats
(old key names preserved).

Stall attribution
-----------------
Storage charges are bucketed by the issuing thread's *IO cause*
(``io_cause()`` / ``current_io_cause()``): ``demand`` (default),
``prefetch``, ``retry``, ``hedge``, ``fault`` (injected-fault surcharge),
``write``, ``meta``. ``SimulatedS3Provider`` keeps one ``sim_s_<cause>``
stats key per bucket with the partition invariant
``sum(sim_s_*) == sim_seconds``. :func:`attribute_stall` folds those
buckets into the fig6 stall decomposition — ``retry_hedge_s``,
``demand_fetch_s``, ``decode_s``, ``prefetch_eviction_s``,
``unattributed_s`` — which by construction sums exactly to ``total_s``.
"""

from __future__ import annotations

import json
import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Tracer",
    "SpanRecord",
    "get_tracer",
    "enabled",
    "span",
    "gspan",
    "null_span",
    "tracing",
    "io_cause",
    "current_io_cause",
    "IO_CAUSES",
    "MetricsRegistry",
    "registry",
    "provider_snapshot",
    "sim_cause_partition",
    "attribute_stall",
    "SIM_CAUSE_PREFIX",
    "STALL_CAUSE_KEYS",
]

# --------------------------------------------------------------------------
# Span tracing
# --------------------------------------------------------------------------

_INDEX_RE = re.compile(r"\[\d+\]")


class SpanRecord:
    """One finished span: immutable record appended to the tracer buffer."""

    __slots__ = ("name", "cat", "ts", "dur", "tid", "depth", "parent", "args")

    def __init__(self, name: str, cat: str, ts: float, dur: float, tid: int,
                 depth: int, parent: Optional[str], args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.ts = ts          # seconds since tracer epoch
        self.dur = dur        # seconds
        self.tid = tid
        self.depth = depth
        self.parent = parent
        self.args = args

    def to_chrome(self, pid: int = 1) -> Dict[str, Any]:
        args = dict(self.args)
        args["depth"] = self.depth
        if self.parent is not None:
            args["parent"] = self.parent
        return {
            "ph": "X",
            "pid": pid,
            "tid": self.tid,
            "name": self.name,
            "cat": self.cat,
            "ts": self.ts * 1e6,
            "dur": self.dur * 1e6,
            "args": args,
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpanRecord({self.name!r}, ts={self.ts:.6f}, dur={self.dur:.6f})"


class _NullSpan:
    """Shared no-op context manager returned whenever tracing is disabled.

    A single module-level instance is reused for every call so the disabled
    path allocates no span objects at all.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **args: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span; records itself into the tracer buffer on exit."""

    __slots__ = ("tracer", "name", "args", "t0", "depth", "parent")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.depth = 0
        self.parent: Optional[str] = None

    def set(self, **args: Any) -> "_Span":
        """Attach extra args; must be called before the span exits."""
        self.args.update(args)
        return self

    def __enter__(self) -> "_Span":
        tls = self.tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self.parent = stack[-1].name if stack else None
        self.depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, etype: Any, evalue: Any, tb: Any) -> bool:
        dur = time.perf_counter() - self.t0
        stack = getattr(self.tracer._tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if etype is not None:
            self.args.setdefault("error", getattr(etype, "__name__", str(etype)))
        self.tracer._record(self, dur)
        return False


class Tracer:
    """Thread-safe span collector. Disabled by default; ~zero cost when off."""

    MAX_EVENTS = 1_000_000

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._events: List[SpanRecord] = []
        self.dropped = 0
        self._epoch = time.perf_counter()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.enabled = True

    def stop(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0
            self._epoch = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args: Any):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def _record(self, sp: _Span, dur: float) -> None:
        name = sp.name
        dot = name.find(".")
        rec = SpanRecord(
            name=name,
            cat=name[:dot] if dot > 0 else name,
            ts=sp.t0 - self._epoch,
            dur=dur,
            tid=threading.get_ident(),
            depth=sp.depth,
            parent=sp.parent,
            args=sp.args,
        )
        with self._lock:
            if len(self._events) >= self.MAX_EVENTS:
                self.dropped += 1
                return
            self._events.append(rec)

    # -- inspection --------------------------------------------------------

    def events(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._events)

    def find(self, prefix: str) -> List[SpanRecord]:
        return [e for e in self.events() if e.name.startswith(prefix)]

    def count(self, prefix: str) -> int:
        return len(self.find(prefix))

    def report(self) -> Dict[str, Dict[str, float]]:
        """Compact per-name aggregate; bracketed indices collapse to ``[*]``."""
        out: Dict[str, Dict[str, float]] = {}
        for e in self.events():
            key = _INDEX_RE.sub("[*]", e.name)
            agg = out.setdefault(key, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += e.dur
            agg["max_s"] = max(agg["max_s"], e.dur)
        return out

    # -- export ------------------------------------------------------------

    def export_chrome(self, pid: int = 1) -> Dict[str, Any]:
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "name": "process_name",
             "args": {"name": "repro-lakehouse"}},
        ]
        events.extend(e.to_chrome(pid) for e in self.events())
        return {"traceEvents": events}

    def write_chrome(self, path: str, pid: int = 1) -> None:
        doc = self.export_chrome(pid)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **args: Any):
    """Open a span on the global tracer; no-op (shared object) when disabled."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    return _Span(_TRACER, name, args)


def gspan(index: int, phase: str, **args: Any):
    """``scan.group[<index>].<phase>`` span; the name string is only built
    when tracing is enabled, keeping the disabled hot path allocation-free."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    return _Span(_TRACER, f"scan.group[{index}].{phase}", args)


def null_span() -> _NullSpan:
    """The shared no-op span, for call sites that conditionally trace."""
    return _NULL_SPAN


@contextmanager
def tracing(clear: bool = True) -> Iterator[Tracer]:
    """Enable the global tracer for the duration of the block."""
    prev = _TRACER.enabled
    if clear and not prev:
        _TRACER.clear()
    _TRACER.enabled = True
    try:
        yield _TRACER
    finally:
        _TRACER.enabled = prev


# --------------------------------------------------------------------------
# IO cause tagging (always on; feeds the sim_s_* stall buckets)
# --------------------------------------------------------------------------

IO_CAUSES = ("demand", "prefetch", "retry", "hedge", "fault", "write", "meta")

_cause_tls = threading.local()


def current_io_cause() -> str:
    """The active IO cause for this thread; ``demand`` if untagged.

    Thread-local: a cause does NOT propagate into threads spawned inside
    the tagged block (hedge/primary arms must re-tag explicitly).
    """
    return getattr(_cause_tls, "cause", "demand")


@contextmanager
def io_cause(cause: str) -> Iterator[None]:
    """Tag storage charges issued by this thread with ``cause``."""
    prev = getattr(_cause_tls, "cause", "demand")
    _cause_tls.cause = cause
    try:
        yield
    finally:
        _cause_tls.cause = prev


# --------------------------------------------------------------------------
# Metrics registry
# --------------------------------------------------------------------------


class Counter:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Cheap streaming histogram: count/sum/min/max (no buckets)."""

    __slots__ = ("_lock", "count", "total", "min", "max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0}
            return {"count": self.count, "sum": self.total,
                    "min": self.min, "max": self.max}


class MetricsRegistry:
    """One process-wide registry of named counters/gauges/histograms.

    Names are dot-separated; ``snapshot()`` flattens to underscore keys so
    values drop straight into ``BENCH_io.json`` leaves.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls: type) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, float] = {}
        for name, m in items:
            key = name.replace(".", "_")
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{key}_{k}"] = v
            else:
                out[key] = m.value
        return out

    def delta(self, base: Dict[str, float]) -> Dict[str, float]:
        """Snapshot minus an earlier snapshot (missing base keys read as 0).

        Gauges and histogram min/max are point-in-time, so a delta is only
        meaningful for counter-backed keys; use accordingly.
        """
        now = self.snapshot()
        return {k: v - base.get(k, 0) for k, v in now.items()}

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def provider_snapshot(provider: Any) -> Dict[str, float]:
    """Unified numeric snapshot: provider stats + ``engine_*`` engine stats.

    This is the single snapshot API the benches share (it replaced the
    ad-hoc provider/engine dict-merging that each bench used to do by
    hand). Key names match the historical ``BENCH_io.json`` layout:
    provider keys verbatim (including ``faults_*`` and ``sim_s_*``),
    engine keys prefixed ``engine_``.
    """
    out: Dict[str, float] = {}
    for k, v in getattr(provider, "stats", {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = v
    from .fetch import engine_stats_for  # local import: fetch imports telemetry

    for k, v in engine_stats_for(provider).items():
        out[f"engine_{k}"] = v
    return out


# --------------------------------------------------------------------------
# Stall attribution
# --------------------------------------------------------------------------

SIM_CAUSE_PREFIX = "sim_s_"

# Output keys of attribute_stall, in allocation priority order. Pure
# overhead (injected faults, retries, hedges) is charged to the stall
# first; prefetch traffic is the most compute-overlappable so it absorbs
# stall last.
STALL_CAUSE_KEYS = (
    "retry_hedge_s",
    "demand_fetch_s",
    "decode_s",
    "prefetch_eviction_s",
    "unattributed_s",
)

_CAUSE_TO_KEY = {
    "fault": "retry_hedge_s",
    "retry": "retry_hedge_s",
    "hedge": "retry_hedge_s",
    "demand": "demand_fetch_s",
    "write": "demand_fetch_s",
    "meta": "demand_fetch_s",
    "decode": "decode_s",
    "prefetch": "prefetch_eviction_s",
}


def sim_cause_partition(stats: Dict[str, Any]) -> Dict[str, float]:
    """Extract the per-cause simulated-seconds buckets from provider stats.

    The provider maintains the partition invariant
    ``sum(sim_cause_partition(stats).values()) == stats["sim_seconds"]``.
    """
    n = len(SIM_CAUSE_PREFIX)
    return {k[n:]: float(v) for k, v in stats.items()
            if k.startswith(SIM_CAUSE_PREFIX)}


def attribute_stall(sim_by_cause: Dict[str, float], compute_s: float,
                    parallelism: float = 1.0,
                    decode_s: float = 0.0) -> Dict[str, float]:
    """Decompose stall-seconds into exhaustive, non-overlapping causes.

    ``sim_by_cause`` is the provider's cause partition (raw simulated
    seconds; divided by ``parallelism`` to model concurrent connections).
    ``decode_s`` is effective (already per-worker) decode time to fold in.
    Stall is ``max(0, effective_io - compute_s)`` and is allocated across
    :data:`STALL_CAUSE_KEYS` in priority order, so the returned causes sum
    to ``total_s`` exactly; anything the named buckets cannot absorb lands
    in ``unattributed_s``.
    """
    par = max(float(parallelism), 1e-9)
    grouped: Dict[str, float] = {k: 0.0 for k in STALL_CAUSE_KEYS}
    for cause, sec in sim_by_cause.items():
        key = _CAUSE_TO_KEY.get(cause, "unattributed_s")
        grouped[key] += float(sec) / par
    grouped["decode_s"] += float(decode_s)

    total_io = sum(grouped.values())
    stall = max(0.0, total_io - float(compute_s))
    out: Dict[str, float] = {}
    remaining = stall
    for key in STALL_CAUSE_KEYS[:-1]:
        take = min(grouped[key], remaining)
        out[key] = take
        remaining -= take
    out["unattributed_s"] = remaining  # exact remainder: causes sum to total
    out["total_s"] = stall
    return out
