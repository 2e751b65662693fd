"""Storage providers for the Deep Lake format.

The paper (§3.6) requires pluggable storage: object stores (S3/GCS), POSIX file
systems, and in-memory stores, composable behind an LRU cache chain.  In this
container there is no network, so remote object storage is modeled by
:class:`SimulatedS3Provider`, which wraps any base provider with a calibrated
latency + bandwidth cost model (per-request latency, per-byte transfer time,
bounded connection concurrency).  Benchmarks use it to reproduce the paper's
Fig 5d / Fig 6 remote-vs-local experiments.

All providers speak the same byte-level protocol:

    get(key) -> bytes                  full object read
    get_range(key, start, end)         ranged read (the format's streaming
                                       primitive; §3.5 "range-based requests")
    get_ranges(key, ranges)            batched ranged read: one payload per
                                       requested range, issued as few physical
                                       requests as the provider can manage
    get_many(keys) -> {key: bytes}     batched full reads
    put(key, data)                     atomic object write
    cas(key, data, expected) -> bool   compare-and-swap (optimistic concurrency)
    delete(key), exists(key), list_keys(prefix), num_bytes(key)

``cas`` is the primitive behind the dataset manifest pointer (§4.1 ACID
ingestion): the write succeeds only when the object's current bytes equal
``expected`` (``None`` = the key must not exist yet), so concurrent
committers race on the pointer and exactly one wins — losers reload and
retry or surface a conflict.

Keys are '/'-separated strings (object-store semantics, no directories).

Failure model
-------------

Real object stores time out, throttle (503 SlowDown), straggle, and tear
reads; the contract below is what every consumer of this module may assume:

* **Error taxonomy.**  :class:`StorageError` (a ``KeyError``) means the key
  is missing or the operation permanently failed.  :class:`TransientStorageError`
  — deliberately *not* a ``StorageError`` subclass — means the request failed
  but a retry may succeed (timeout, 5xx, short read); ``except StorageError``
  handlers therefore can never mistake a throttled request for a missing key.
  :class:`RetryExhausted` *is* a ``StorageError``: it is raised once the retry
  budget is spent, at which point the failure is permanent for the caller.
* **Retry semantics.**  Data-plane reads routed through
  :class:`~repro.core.fetch.FetchEngine` retry transients with capped
  exponential backoff + jitter (see ``RetryPolicy``); control-plane reads
  (manifest pointer, version-control state) go through
  :func:`retry_transient` / :meth:`StorageProvider.get_or_none`.  Prefetches
  additionally *hedge*: a request straggling past a multiple of the latency
  EWMA gets a duplicate request, first responder wins.
* **Write semantics.**  ``put`` is *not* assumed atomic on the simulated
  object store: an upload may fail with a 5xx (nothing durable) or **tear**
  — the call reports success but only a prefix of the object landed
  (interrupted multipart upload, lost trailing packets).  Durable writers
  therefore go through :meth:`StorageProvider.put_verified`, which re-reads
  the object's length after the upload (modeling the ETag/Content-MD5 check
  that rides a real PUT response), raises :class:`TornWriteError` on a
  mismatch, and retries transients via :func:`retry_transient`.  Providers
  whose ``put`` is genuinely atomic (memory, POSIX tmp+rename) inherit a
  ``put_verified`` that only adds the transient retry.  ``cas`` may raise a
  transient 5xx *before* applying (the conditional put never became
  durable); callers wrap it in :func:`retry_transient` and treat a
  ``False`` return as contention, never as a fault.
* **Fault injection.**  :class:`SimulatedS3Provider` takes an optional
  seeded :class:`FaultPolicy` that injects timeouts / 5xx transients /
  stragglers / torn reads on data-plane reads (``get``/``get_range``/
  ``get_ranges``), and — via the write-plane rates — 5xx / torn uploads on
  ``put`` plus 5xx on ``cas``.  Metadata probes (``exists``/``num_bytes``/
  ``list_keys``) are never faulted.  Injected faults charge realistic
  latency (wasted upload bytes are tallied in
  ``stats["wasted_upload_bytes"]``) and are capped per key
  (``max_consecutive_per_key``, write plane capped independently of reads)
  so a bounded retry budget always converges; every fault is counted in
  ``stats["faults_*"]``.
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from . import telemetry

try:  # POSIX-only; LocalProvider.cas falls back to a process lock without it
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX platforms
    fcntl = None  # type: ignore[assignment]

Range = Tuple[int, int]


def coalesce_ranges(ranges: Sequence[Range], gap: int
                    ) -> Tuple[List[Range], List[int]]:
    """Merge byte ranges whose inter-range gap is at most ``gap`` bytes.

    Returns ``(spans, assign)``: ``spans`` is the sorted list of merged
    ``[start, end)`` spans and ``assign[i]`` is the span index serving
    ``ranges[i]``.  Inverted ranges (``end < start``) are treated as
    zero-length at ``start``; overlapping and adjacent ranges always merge.
    The caller picks ``gap`` from its cost model: a gap is worth downloading
    when ``gap_bytes / bandwidth < per_request_latency``.
    """
    norm = [(int(s), max(int(s), int(e))) for s, e in ranges]
    order = sorted(range(len(norm)), key=lambda i: norm[i])
    spans: List[List[int]] = []
    assign = [0] * len(norm)
    for i in order:
        s, e = norm[i]
        if spans and s - spans[-1][1] <= gap:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
        assign[i] = len(spans) - 1
    return [(s, e) for s, e in spans], assign


def slice_spans(ranges: Sequence[Range], spans: Sequence[Range],
                assign: Sequence[int],
                payloads: Sequence[bytes]) -> List[bytes]:
    """Reassemble per-range payloads from fetched coalesced spans.

    Inverse of :func:`coalesce_ranges`: ``payloads[j]`` holds the bytes of
    ``spans[j]`` (possibly tail-clamped by the object length); the result
    is byte-identical to fetching each of ``ranges`` individually.
    """
    out: List[bytes] = []
    for i, (s, e) in enumerate(ranges):
        span_start = spans[assign[i]][0]
        data = payloads[assign[i]]
        out.append(data[s - span_start: max(s, e) - span_start])
    return out


class StorageError(KeyError):
    """Raised when a key is missing or a provider operation fails."""


class TransientStorageError(Exception):
    """A request failed in a way a retry may fix (timeout, 5xx, short read).

    Deliberately NOT a :class:`StorageError` subclass: ``except
    StorageError`` handlers (``get_or_none`` and friends) must never treat
    a throttled or timed-out request as a missing key.
    """


class StorageTimeout(TransientStorageError):
    """The request exceeded its deadline (connect or read timeout)."""


class TornReadError(TransientStorageError):
    """The payload came back shorter than the object/range length claimed
    (interrupted transfer); detected client-side, always retriable."""


class TornWriteError(TransientStorageError):
    """An upload "succeeded" but the durable object is shorter than what was
    sent (interrupted multipart upload).  Detected by the post-put
    verification in :meth:`StorageProvider.put_verified`; always retriable —
    re-putting the same bytes is idempotent."""


class RetryExhausted(StorageError):
    """Transient faults persisted past the retry budget — permanent for the
    caller.  A :class:`StorageError` on purpose: exhaustion is surfaced, not
    retried again."""


#: module-level jitter source for backoff sleeps; retry *correctness* never
#: depends on it, so a shared unseeded stream is fine
_backoff_rng = random.Random(0x5EED)


def retry_transient(fn: Callable[[], "bytes"], *, attempts: int = 4,
                    base_s: float = 0.01, cap_s: float = 0.25,
                    jitter: float = 0.5, what: str = ""):
    """Call ``fn()``, retrying :class:`TransientStorageError` with capped
    exponential backoff + jitter.  Permanent errors propagate untouched;
    exhaustion raises :class:`RetryExhausted` chained on the last transient.

    This is the control-plane retry helper (manifest pointer, VC state);
    the data plane retries inside :class:`~repro.core.fetch.FetchEngine`
    where attempts also feed the engine's stats counters.
    """
    delay = base_s
    last: Optional[TransientStorageError] = None
    for i in range(max(1, attempts)):
        try:
            return fn()
        except TransientStorageError as e:
            last = e
            if i + 1 >= max(1, attempts):
                break
            time.sleep(delay * (1.0 + jitter * _backoff_rng.random()))
            delay = min(delay * 2.0, cap_s)
    raise RetryExhausted(
        f"storage retries exhausted after {max(1, attempts)} attempts"
        f"{': ' + what if what else ''}") from last


class StorageProvider:
    """Abstract provider. Subclasses implement the five byte-level primitives."""

    #: human-readable provider kind, used by the scheduler's cost model
    kind: str = "abstract"

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def get_range(self, key: str, start: int, end: int) -> bytes:
        """Return ``obj[start:end]``.

        Contract (all providers, asserted by tests/test_storage_range.py):
        ``end`` is exclusive and may exceed the object length (the read
        clamps to the tail); ``start`` at or past the object length, or
        ``end <= start``, yields ``b""`` — zero-length reads are legal and
        must not raise on an existing key.
        """
        raise NotImplementedError

    def get_ranges(self, key: str, ranges: Sequence[Range]) -> List[bytes]:
        """Batched :meth:`get_range`: one payload per requested range.

        Contract: payload ``i`` is byte-identical to
        ``get_range(key, *ranges[i])``; a missing key raises
        :class:`StorageError` whenever ``ranges`` is non-empty (even if
        every range is zero-length); an empty ``ranges`` returns ``[]``
        without touching storage.  Providers override the default per-range
        loop to batch the physical I/O (single open + ordered seeks on
        POSIX, coalesced ranged requests on object storage).
        """
        return [self.get_range(key, s, e) for s, e in ranges]

    def get_many(self, keys: Sequence[str]) -> Dict[str, bytes]:
        """Batched :meth:`get`: ``{key: bytes}`` with duplicates deduped.

        Any missing key raises :class:`StorageError`.
        """
        return {k: self.get(k) for k in keys}

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def put_verified(self, key: str, data: bytes) -> None:
        """Durable upload: ``put`` + integrity verification + transient retry.

        Every write whose loss or truncation would corrupt committed state
        (chunks, manifest segments, version-control state) goes through this
        instead of raw ``put``.  The default adds only the
        :func:`retry_transient` loop — correct for providers whose ``put``
        is atomic (memory dict swap, POSIX tmp+rename).  Providers that can
        tear an upload override it to verify the durable object (length /
        digest, modeling the ETag check on a real PUT response) and raise
        :class:`TornWriteError` so the retry loop re-puts.
        """
        data = bytes(data)
        retry_transient(lambda: self.put(key, data), what=key)

    def cas(self, key: str, data: bytes, expected: Optional[bytes]) -> bool:
        """Atomic compare-and-swap: write ``data`` only if the object's
        current bytes equal ``expected`` (``None`` = key must not exist).
        Returns True on success, False when the comparison failed — the
        caller then reloads and retries or raises a conflict error.
        """
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def num_bytes(self, key: str) -> int:
        return len(self.get(key))

    def clear(self) -> None:
        for key in list(self.list_keys()):
            self.delete(key)

    # -- convenience -------------------------------------------------------
    def get_or_none(self, key: str) -> Optional[bytes]:
        """``get`` that maps a *missing key* to None.  Transient faults are
        retried, and exhaustion raises — a flaky store must never read as
        an empty one (that is how control-plane state silently vanishes)."""
        try:
            return retry_transient(lambda: self.get(key), what=key)
        except RetryExhausted:
            raise
        except StorageError:
            return None

    def __contains__(self, key: str) -> bool:
        return self.exists(key)


class MemoryProvider(StorageProvider):
    """Dict-backed provider; thread-safe. Used for tests and as cache tier."""

    kind = "memory"

    def __init__(self) -> None:
        self._store: Dict[str, bytes] = {}
        self._lock = threading.RLock()

    def get(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._store[key]
            except KeyError:
                raise StorageError(key) from None

    def get_range(self, key: str, start: int, end: int) -> bytes:
        return self.get(key)[start:end]

    def get_ranges(self, key: str, ranges: Sequence[Range]) -> List[bytes]:
        if not ranges:
            return []
        data = self.get(key)  # one lookup serves every range
        return [data[s:max(s, e)] for s, e in ranges]

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._store[key] = bytes(data)

    def cas(self, key: str, data: bytes, expected: Optional[bytes]) -> bool:
        with self._lock:
            if self._store.get(key) != expected:
                return False
            self._store[key] = bytes(data)
            return True

    def delete(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def list_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._store if k.startswith(prefix))

    def num_bytes(self, key: str) -> int:
        with self._lock:
            try:
                return len(self._store[key])
            except KeyError:
                raise StorageError(key) from None

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._store.values())


class LocalProvider(StorageProvider):
    """POSIX filesystem provider. Keys map to paths under ``root``.

    :meth:`cas` serializes committers across *processes* with an
    ``fcntl.flock`` on a per-key sidecar lockfile under ``.cas-locks/``
    (a reserved prefix, hidden from :meth:`list_keys`); flock also contends
    between distinct opens within one process, so in-process threads
    serialize through the same lock.  Platforms without ``fcntl`` fall back
    to a process-local lock (the pre-flock behavior).
    """

    kind = "local"

    #: reserved sidecar directory for cas lockfiles (never listed as keys)
    _LOCK_DIR = ".cas-locks"

    #: fallback when fcntl is unavailable: process-local serialization only
    _cas_fallback_lock = threading.Lock()

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.normpath(os.path.join(self.root, key))
        if not path.startswith(self.root):
            raise StorageError(f"key escapes root: {key}")
        return path

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise StorageError(key) from None

    def get_range(self, key: str, start: int, end: int) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                f.seek(start)
                return f.read(max(0, end - start))
        except FileNotFoundError:
            raise StorageError(key) from None

    def get_ranges(self, key: str, ranges: Sequence[Range]) -> List[bytes]:
        """Single open + seeks in ascending byte order (one disk pass)."""
        if not ranges:
            return []
        try:
            with open(self._path(key), "rb") as f:
                out: List[bytes] = [b""] * len(ranges)
                order = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
                for i in order:
                    s, e = ranges[i]
                    f.seek(s)
                    out[i] = f.read(max(0, e - s))
                return out
        except FileNotFoundError:
            raise StorageError(key) from None

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic on POSIX

    def _lockfile(self, key: str) -> str:
        lock_dir = os.path.join(self.root, self._LOCK_DIR)
        os.makedirs(lock_dir, exist_ok=True)
        digest = hashlib.sha1(key.encode("utf-8")).hexdigest()
        return os.path.join(lock_dir, digest + ".lock")

    def _cas_under_lock(self, key: str, data: bytes,
                        expected: Optional[bytes]) -> bool:
        try:
            with open(self._path(key), "rb") as f:
                current: Optional[bytes] = f.read()
        except FileNotFoundError:
            current = None
        if current != expected:
            return False
        self.put(key, data)
        return True

    def cas(self, key: str, data: bytes, expected: Optional[bytes]) -> bool:
        if fcntl is None:  # pragma: no cover - non-POSIX platforms
            with self._cas_fallback_lock:
                return self._cas_under_lock(key, data, expected)
        with open(self._lockfile(key), "ab") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                return self._cas_under_lock(key, data, expected)
            finally:
                fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def list_keys(self, prefix: str = "") -> List[str]:
        keys = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(self._LOCK_DIR + "/"):
                    continue  # cas lockfile sidecars are not objects
                if rel.startswith(prefix):
                    keys.append(rel)
        return sorted(keys)

    def num_bytes(self, key: str) -> int:
        try:
            return os.path.getsize(self._path(key))
        except FileNotFoundError:
            raise StorageError(key) from None


@dataclass
class FaultPolicy:
    """Seeded, deterministic fault injection for :class:`SimulatedS3Provider`.

    Each data-plane read (one ``get``/``get_range`` call, or one physical
    span inside ``get_ranges``) draws once from a seeded stream; at most one
    fault is injected per draw, picked by cumulative rate:

    * ``timeout``  — request aborts after ``timeout_factor ×`` latency
      (:class:`StorageTimeout`);
    * ``5xx``      — throttle/SlowDown after one latency round-trip
      (:class:`TransientStorageError`);
    * ``torn``     — transfer truncates; the client detects the short
      payload and raises :class:`TornReadError` after one round-trip;
    * ``straggle`` — the request *succeeds* but is charged
      ``straggle_factor ×`` latency in simulated time and stalls
      ``straggle_sleep_s`` real seconds (drives hedging even at
      ``time_scale=0``).

    The write plane draws from the same stream with its own rates:

    * ``put_error_rate`` — the upload 5xx-fails after charging the bytes;
      nothing becomes durable (:class:`TransientStorageError`);
    * ``put_torn_rate`` — the upload *reports success* but only a prefix of
      the object lands; only post-put verification
      (:meth:`StorageProvider.put_verified`) can catch it;
    * ``cas_error_rate`` — the conditional put 5xx-fails *before* applying
      (nothing durable, retriable); a clean ``cas`` that loses the
      compare is contention, not a fault, and is counted separately in
      ``stats["cas_conflicts"]``.

    Hard faults (timeout/5xx/torn) are capped at ``max_consecutive_per_key``
    in a row for any one key — mirroring real stores, where per-key
    brown-outs are short — so any retry budget of more than
    ``max_consecutive_per_key`` attempts deterministically converges.  Write
    faults keep their own per-key streaks (``"w:"``-prefixed), so a read
    brown-out never masks a write one or vice versa.

    Determinism: one provider, one stream.  A single-threaded op sequence
    replays exactly under the same seed; multi-threaded request order may
    permute which op draws which fault, but results must be byte-identical
    regardless (the chaos bench's parity gate).
    """

    seed: int = 0
    timeout_rate: float = 0.0
    error_rate: float = 0.0      # 5xx / throttle
    straggle_rate: float = 0.0
    torn_rate: float = 0.0
    put_error_rate: float = 0.0  # upload 5xx: nothing durable
    put_torn_rate: float = 0.0   # upload "succeeds", only a prefix lands
    cas_error_rate: float = 0.0  # conditional put 5xx before applying
    timeout_factor: float = 10.0   # sim latency multiple burned by a timeout
    straggle_factor: float = 8.0   # sim latency multiple charged by a straggle
    straggle_sleep_s: float = 0.0  # REAL stall of a straggling request
    max_consecutive_per_key: int = 2

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._streak: Dict[str, int] = {}
        self._lock = threading.Lock()

    def draw(self, key: str) -> Optional[str]:
        """Fault kind for the next read of ``key`` (None = healthy)."""
        with self._lock:
            u = self._rng.random()
            kind: Optional[str] = None
            edge = self.timeout_rate
            if u < edge:
                kind = "timeout"
            elif u < (edge := edge + self.error_rate):
                kind = "5xx"
            elif u < (edge := edge + self.torn_rate):
                kind = "torn"
            elif u < edge + self.straggle_rate:
                kind = "straggle"
            hard = kind in ("timeout", "5xx", "torn")
            if hard:
                streak = self._streak.get(key, 0)
                if streak >= self.max_consecutive_per_key:
                    kind = None  # liveness cap: this key has suffered enough
                    hard = False
                else:
                    self._streak[key] = streak + 1
            if not hard:
                self._streak.pop(key, None)
            return kind

    def _draw_write(self, streak_key: str,
                    rates: Sequence[Tuple[str, float]]) -> Optional[str]:
        """One seeded draw over the write-plane ``(kind, rate)`` ladder.
        All write faults are hard, so every pick is subject to the per-key
        liveness cap; a clean draw clears the streak."""
        with self._lock:
            u = self._rng.random()
            kind: Optional[str] = None
            edge = 0.0
            for k, r in rates:
                edge += r
                if u < edge:
                    kind = k
                    break
            if kind is not None:
                streak = self._streak.get(streak_key, 0)
                if streak >= self.max_consecutive_per_key:
                    kind = None
                else:
                    self._streak[streak_key] = streak + 1
            if kind is None:
                self._streak.pop(streak_key, None)
            return kind

    def draw_put(self, key: str) -> Optional[str]:
        """Fault kind for the next upload of ``key``: ``"5xx"`` (nothing
        durable), ``"torn"`` (prefix lands, call reports success), or None."""
        return self._draw_write(
            "w:" + key,
            (("5xx", self.put_error_rate), ("torn", self.put_torn_rate)))

    def draw_cas(self, key: str) -> Optional[str]:
        """Fault kind for the next conditional put of ``key``: ``"5xx"``
        (fails before applying) or None."""
        return self._draw_write("w:" + key,
                                (("5xx", self.cas_error_rate),))


class SimulatedS3Provider(StorageProvider):
    """Object-storage cost model over a base provider.

    Models the three effects that matter for the paper's experiments:

    * per-request latency (TTFB): ``latency_s`` seconds per GET/PUT, i.e. why
      iterating many small files is slow (§2.3);
    * bandwidth: ``bandwidth_bps`` bytes/sec per connection for the payload;
    * bounded concurrency: at most ``max_connections`` in-flight requests —
      more threads than connections queue up.

    ``time_scale`` compresses simulated seconds into real sleep so benchmarks
    finish quickly while preserving ratios; accounting (``stats``) always
    records *unscaled* simulated seconds.  With ``time_scale=0`` no real sleep
    happens at all (pure accounting), which is what unit tests use.
    """

    kind = "s3"

    def __init__(
        self,
        base: Optional[StorageProvider] = None,
        *,
        latency_s: float = 0.015,
        bandwidth_bps: float = 95e6,
        max_connections: int = 64,
        time_scale: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
        fault_policy: Optional[FaultPolicy] = None,
    ) -> None:
        self.base = base if base is not None else MemoryProvider()
        self.latency_s = float(latency_s)
        self.bandwidth_bps = float(bandwidth_bps)
        self.time_scale = float(time_scale)
        self.fault_policy = fault_policy
        self._sem = threading.BoundedSemaphore(max_connections)
        self._lock = threading.Lock()
        self._clock = clock or time.monotonic
        self.stats = {
            "requests": 0,            # every charged round-trip (incl. meta)
            "ranged_requests": 0,     # round-trips that carried a byte range
            "coalesced_requests": 0,  # physical spans issued by get_ranges
            "batched_ranges": 0,      # logical ranges served by get_ranges
            "batched_objects": 0,     # whole objects served by get_many
            "meta_requests": 0,       # exists/num_bytes/list_keys round-trips
            "put_requests": 0,        # upload round-trips (incl. faulted)
            "cas_requests": 0,        # conditional-put round-trips (manifest)
            "cas_conflicts": 0,       # clean cas that lost the compare
            "bytes_down": 0,
            "bytes_up": 0,
            "wasted_upload_bytes": 0,  # bytes charged by faulted uploads
            "sim_seconds": 0.0,
            # per-cause partition of sim_seconds (stall attribution):
            # invariant sum(sim_s_*) == sim_seconds.  The read cause comes
            # from the issuing thread's telemetry.io_cause() tag; uploads
            # default to "write", metadata probes to "meta", and injected-
            # fault surcharges (wasted round-trips, straggle overtime) land
            # in "fault" regardless of the ambient cause.
            "sim_s_demand": 0.0,
            "sim_s_prefetch": 0.0,
            "sim_s_retry": 0.0,
            "sim_s_hedge": 0.0,
            "sim_s_fault": 0.0,
            "sim_s_write": 0.0,
            "sim_s_meta": 0.0,
            "faults_injected": 0,     # total injected faults (all kinds)
            "faults_timeout": 0,
            "faults_5xx": 0,
            "faults_straggle": 0,
            "faults_torn": 0,
            "faults_put_5xx": 0,      # upload failed, nothing durable
            "faults_put_torn": 0,     # upload "succeeded", prefix landed
            "faults_cas_5xx": 0,      # conditional put failed before applying
        }

    # -- cost model --------------------------------------------------------
    def _charge(self, nbytes: int, *, upload: bool = False,
                extra_sim: float = 0.0, fault_sim: float = 0.0,
                cause: Optional[str] = None) -> None:
        """Charge one round-trip.  ``extra_sim`` rides the main cause bucket;
        ``fault_sim`` (straggle overtime) is booked to the ``fault`` bucket
        so sum(sim_s_*) stays an exact partition of sim_seconds."""
        sim = self.latency_s + nbytes / self.bandwidth_bps + extra_sim \
            + fault_sim
        if cause is None:
            cause = "write" if upload else telemetry.current_io_cause()
        bucket = "sim_s_" + cause
        with self._lock:
            self.stats["requests"] += 1
            self.stats["bytes_up" if upload else "bytes_down"] += nbytes
            self.stats["sim_seconds"] += sim
            self.stats[bucket] = self.stats.get(bucket, 0.0) + (sim - fault_sim)
            if fault_sim:
                self.stats["sim_s_fault"] += fault_sim
        if self.time_scale > 0:
            time.sleep(sim * self.time_scale)

    def _maybe_fault(self, key: str) -> float:
        """Fault-injection gate ahead of one data-plane read.  Returns
        extra simulated seconds to charge (straggle); raises the typed
        transient on hard faults, after charging the wasted round-trip."""
        fp = self.fault_policy
        if fp is None:
            return 0.0
        kind = fp.draw(key)
        if kind is None:
            return 0.0
        with self._lock:
            self.stats["faults_injected"] += 1
            self.stats["faults_" + kind] += 1
        if kind == "straggle":
            if fp.straggle_sleep_s > 0:
                time.sleep(fp.straggle_sleep_s)
            return self.latency_s * max(0.0, fp.straggle_factor - 1.0)
        # hard fault: the aborted round-trip is still a charged request
        wasted = self.latency_s * (fp.timeout_factor if kind == "timeout"
                                   else 1.0)
        self._charge(0, extra_sim=wasted - self.latency_s, cause="fault")
        if kind == "timeout":
            raise StorageTimeout(f"injected timeout reading {key!r}")
        if kind == "torn":
            raise TornReadError(f"injected short read of {key!r}")
        raise TransientStorageError(f"injected 503 SlowDown for {key!r}")

    def reset_stats(self) -> None:
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0.0 if k.startswith("sim_") else 0

    # -- protocol ----------------------------------------------------------
    def get(self, key: str) -> bytes:
        with self._sem:
            extra = self._maybe_fault(key)
            data = self.base.get(key)
            self._charge(len(data), fault_sim=extra)
            return data

    def get_range(self, key: str, start: int, end: int) -> bytes:
        with self._sem:
            extra = self._maybe_fault(key)
            data = self.base.get_range(key, start, end)
            self._charge(len(data), fault_sim=extra)
            with self._lock:
                self.stats["ranged_requests"] += 1
            return data

    def gap_threshold(self) -> int:
        """Gap (bytes) worth downloading to avoid one extra round-trip:
        ``gap / bandwidth < latency  <=>  gap < latency * bandwidth``."""
        return int(self.latency_s * self.bandwidth_bps)

    def get_ranges(self, key: str, ranges: Sequence[Range]) -> List[bytes]:
        """Coalescing ranged read: requested ranges are merged whenever the
        gap between them costs less than a request round-trip, and ONE
        latency charge is paid per merged span — the batched counterpart of
        the paper's "range-based requests" (§3.5)."""
        if not ranges:
            return []
        spans, assign = coalesce_ranges(ranges, self.gap_threshold())
        payloads: List[bytes] = []
        with self._sem:
            for s, e in spans:
                extra = self._maybe_fault(key)  # per physical span
                data = self.base.get_range(key, s, e)
                self._charge(len(data), fault_sim=extra)
                with self._lock:
                    self.stats["ranged_requests"] += 1
                    self.stats["coalesced_requests"] += 1
                payloads.append(data)
        with self._lock:
            self.stats["batched_ranges"] += len(ranges)
        return slice_spans(ranges, spans, assign, payloads)

    def get_many(self, keys: Sequence[str]) -> Dict[str, bytes]:
        """Multi-object batch read: ONE latency charge for the whole
        fan-out plus the summed transfer bytes — the batched counterpart
        of :meth:`get_ranges` for whole objects (tile fan-outs, manifest
        segment prefetch).  Faults draw per key; the first hard fault
        aborts the round after charging the wasted round-trip (partial
        results are discarded — the caller retries per key), and straggle
        overtime accumulates into the fault bucket."""
        out: Dict[str, bytes] = {}
        with self._sem:
            fault_extra = 0.0
            for k in keys:
                if k in out:
                    continue
                fault_extra += self._maybe_fault(k)
                out[k] = self.base.get(k)
            self._charge(sum(len(v) for v in out.values()),
                         fault_sim=fault_extra)
            with self._lock:
                self.stats["batched_objects"] += len(out)
        return out

    def put(self, key: str, data: bytes) -> None:
        with self._sem:
            fp = self.fault_policy
            # a tear needs at least 2 bytes to lose anything
            kind = fp.draw_put(key) if fp is not None and len(data) >= 2 \
                else None
            self._charge(len(data), upload=True)
            with self._lock:
                self.stats["put_requests"] += 1
            if kind is None:
                self.base.put(key, data)
                return
            with self._lock:
                self.stats["faults_injected"] += 1
                self.stats["faults_put_" + kind] += 1
                self.stats["wasted_upload_bytes"] += len(data)
            telemetry.registry().counter(
                "storage.wasted_upload_bytes").inc(len(data))
            if kind == "5xx":
                raise TransientStorageError(
                    f"injected 503 SlowDown uploading {key!r}")
            # torn: a prefix becomes durable and the call reports success —
            # only post-put verification (put_verified) can catch this
            self.base.put(key, bytes(data)[: len(data) // 2])

    def put_verified(self, key: str, data: bytes) -> None:
        data = bytes(data)

        def attempt() -> None:
            self.put(key, data)
            # the length check models the ETag/Content-MD5 riding the PUT
            # response: it probes the backing store directly and charges no
            # extra round-trip
            if self.base.num_bytes(key) != len(data):
                raise TornWriteError(
                    f"verification failed: {key!r} is shorter than the "
                    f"{len(data)} bytes uploaded")

        retry_transient(attempt, what=key)

    def cas(self, key: str, data: bytes, expected: Optional[bytes]) -> bool:
        # conditional PUT (If-Match): one round-trip whether it wins or loses
        with self._sem:
            fp = self.fault_policy
            kind = fp.draw_cas(key) if fp is not None else None
            self._charge(len(data), upload=True)
            with self._lock:
                self.stats["cas_requests"] += 1
            if kind is not None:
                # the conditional put dies before applying: nothing durable,
                # the caller's retry re-issues the same compare
                with self._lock:
                    self.stats["faults_injected"] += 1
                    self.stats["faults_cas_5xx"] += 1
                    self.stats["wasted_upload_bytes"] += len(data)
                telemetry.registry().counter(
                    "storage.wasted_upload_bytes").inc(len(data))
                raise TransientStorageError(
                    f"injected 503 on conditional put of {key!r}")
            ok = self.base.cas(key, data, expected)
            if not ok:
                with self._lock:
                    self.stats["cas_conflicts"] += 1
            return ok

    def delete(self, key: str) -> None:
        with self._sem:
            self._charge(0, cause="meta")
            self.base.delete(key)

    def exists(self, key: str) -> bool:
        # HEAD-style metadata probe: zero payload, full round-trip latency
        with self._sem:
            self._charge(0, cause="meta")
            with self._lock:
                self.stats["meta_requests"] += 1
            return self.base.exists(key)

    def list_keys(self, prefix: str = "") -> List[str]:
        with self._sem:
            self._charge(0, cause="meta")
            with self._lock:
                self.stats["meta_requests"] += 1
            return self.base.list_keys(prefix)

    def num_bytes(self, key: str) -> int:
        with self._sem:
            self._charge(0, cause="meta")
            with self._lock:
                self.stats["meta_requests"] += 1
            return self.base.num_bytes(key)


class LRUCacheProvider(StorageProvider):
    """LRU cache chained in front of a slower provider (§3.6).

    Reads fill the cache; writes go through to the base (write-through) so the
    base is always authoritative.  ``capacity_bytes`` bounds resident bytes.
    Range reads are served from a cached full object when present; otherwise
    they pass through *without* filling (streaming reads should not evict the
    working set — matches the paper's "buffer of fetched and unutilized data"
    being managed by the loader, not the cache).
    """

    kind = "lru"

    def __init__(self, base: StorageProvider, capacity_bytes: int = 256 << 20,
                 cache: Optional[StorageProvider] = None) -> None:
        self.base = base
        self.capacity_bytes = int(capacity_bytes)
        self._cache: Dict[str, bytes] = {}
        self._order: Dict[str, int] = {}  # key -> tick (monotone)
        self._tick = 0
        self._size = 0
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    # -- cache mechanics ----------------------------------------------------
    def _touch(self, key: str) -> None:
        self._tick += 1
        self._order[key] = self._tick

    def _admit(self, key: str, data: bytes) -> None:
        if len(data) > self.capacity_bytes:
            return
        with self._lock:
            if key in self._cache:
                self._size -= len(self._cache[key])
            self._cache[key] = data
            self._size += len(data)
            self._touch(key)
            while self._size > self.capacity_bytes and self._cache:
                victim = min(self._order, key=self._order.get)
                self._size -= len(self._cache.pop(victim))
                del self._order[victim]

    def _evict(self, key: str) -> None:
        with self._lock:
            if key in self._cache:
                self._size -= len(self._cache.pop(key))
                self._order.pop(key, None)

    # -- protocol ----------------------------------------------------------
    def get(self, key: str) -> bytes:
        with self._lock:
            if key in self._cache:
                self.hits += 1
                self._touch(key)
                return self._cache[key]
            self.misses += 1
        data = self.base.get(key)
        self._admit(key, data)
        return data

    def get_range(self, key: str, start: int, end: int) -> bytes:
        with self._lock:
            if key in self._cache:
                self.hits += 1
                self._touch(key)
                return self._cache[key][start:end]
            self.misses += 1
        return self.base.get_range(key, start, end)

    def get_ranges(self, key: str, ranges: Sequence[Range]) -> List[bytes]:
        """Every range served from a cached full object (one hit); misses
        pass through batched without filling, like :meth:`get_range`."""
        if not ranges:
            return []
        with self._lock:
            if key in self._cache:
                self.hits += 1
                self._touch(key)
                data = self._cache[key]
                return [data[s:max(s, e)] for s, e in ranges]
            self.misses += 1
        return self.base.get_ranges(key, ranges)

    def get_many(self, keys: Sequence[str]) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        missing: List[str] = []
        with self._lock:
            for k in keys:
                if k in self._cache:
                    self.hits += 1
                    self._touch(k)
                    out[k] = self._cache[k]
                elif k not in out and k not in missing:
                    self.misses += 1
                    missing.append(k)
        if missing:
            fetched = self.base.get_many(missing)
            for k, v in fetched.items():
                self._admit(k, v)
            out.update(fetched)
        return out

    def put(self, key: str, data: bytes) -> None:
        self.base.put(key, data)
        self._admit(key, bytes(data))

    def put_verified(self, key: str, data: bytes) -> None:
        # the base owns verification + retry; admit only the verified bytes
        data = bytes(data)
        self.base.put_verified(key, data)
        self._admit(key, data)

    def cas(self, key: str, data: bytes, expected: Optional[bytes]) -> bool:
        ok = self.base.cas(key, data, expected)
        if ok:
            self._admit(key, bytes(data))
        else:
            self._evict(key)  # the cached copy lost the race: drop it
        return ok

    def delete(self, key: str) -> None:
        self._evict(key)
        self.base.delete(key)

    def exists(self, key: str) -> bool:
        with self._lock:
            if key in self._cache:
                return True
        return self.base.exists(key)

    def list_keys(self, prefix: str = "") -> List[str]:
        return self.base.list_keys(prefix)

    def num_bytes(self, key: str) -> int:
        with self._lock:
            if key in self._cache:
                return len(self._cache[key])
        return self.base.num_bytes(key)


def chain(*providers: StorageProvider, capacity_bytes: int = 256 << 20) -> StorageProvider:
    """Chain providers into a cache hierarchy, fastest first.

    ``chain(mem, s3)`` returns an LRU over ``s3``; mirrors the paper's
    "LRU cache of remote S3 storage with local in-memory data".
    """
    if not providers:
        raise ValueError("need at least one provider")
    if len(providers) == 1:
        return providers[0]
    out = providers[-1]
    for _faster in reversed(providers[:-1]):
        out = LRUCacheProvider(out, capacity_bytes=capacity_bytes)
    return out


def storage_from_path(path: str, **kwargs) -> StorageProvider:
    """URL-ish constructor: ``mem://``, ``s3sim://``, or a filesystem path."""
    if path.startswith("mem://"):
        return MemoryProvider()
    if path.startswith("s3sim://"):
        return SimulatedS3Provider(MemoryProvider(), **kwargs)
    if path.startswith("file://"):
        path = path[len("file://"):]
    return LocalProvider(path)
