"""Smart scheduler + memory estimator for the streaming loader (§4.5).

Two of the paper's three loader properties live here:

* *Smart Scheduler* — "dynamically differentiating between CPU-intensive jobs
  prioritization over less-intensive": pending fetch/decode jobs are ordered by
  (when the consumer will need them, then longest-estimated-CPU first) so long
  decode poles start early and never stall emission.  Job cost estimates are
  EWMA-updated from observed fetch/decode times, so the schedule adapts to the
  actual storage + codec behavior.

* *Efficient Resource Allocation* — "predicting memory consumption to avoid
  breaking the training process": a byte-budgeted gate sized from an EWMA of
  decoded sample sizes blocks fetch workers before RAM would overfill.
"""

from __future__ import annotations

import heapq
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple


class MemoryBudget:
    """Blocking byte budget for decoded-but-unconsumed samples."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._used = 0
        self._cv = threading.Condition()
        self.peak = 0
        self.block_events = 0

    def acquire(self, nbytes: int, timeout: Optional[float] = None) -> bool:
        nbytes = min(int(nbytes), self.max_bytes)  # single huge item still admits
        with self._cv:
            if self._used + nbytes > self.max_bytes:
                self.block_events += 1
            ok = self._cv.wait_for(
                lambda: self._used + nbytes <= self.max_bytes, timeout=timeout)
            if not ok:
                return False
            self._used += nbytes
            self.peak = max(self.peak, self._used)
            return True

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._used = max(0, self._used - min(int(nbytes), self.max_bytes))
            self._cv.notify_all()

    @property
    def used(self) -> int:
        with self._cv:
            return self._used


class CostModel:
    """EWMA per-class cost estimates (seconds) for io and cpu phases.

    Also carries free-form event counters (``note``) so upstream layers can
    record work that was *avoided* — e.g. chunks the TQL scan planner pruned
    — next to the costs of work actually done.
    """

    def __init__(self, alpha: float = 0.2) -> None:
        self.alpha = alpha
        self._io: Dict[str, float] = {}
        self._cpu: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def note(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def observe(self, klass: str, io_s: float, cpu_s: float,
                clean: bool = True) -> None:
        """Fold one timing into the EWMA.  ``clean=False`` marks a timing
        polluted by injected faults / retries / hedges: it is counted
        (``tainted_<klass>``) but NEVER folded, so one straggler cannot
        distort the estimates that size fetch units and prefetch depth."""
        if not clean:
            self.note(f"tainted_{klass}")
            return
        with self._lock:
            for table, v in ((self._io, io_s), (self._cpu, cpu_s)):
                old = table.get(klass)
                table[klass] = v if old is None else (1 - self.alpha) * old + self.alpha * v

    def estimate(self, klass: str) -> Tuple[float, float]:
        with self._lock:
            return self._io.get(klass, 1e-3), self._cpu.get(klass, 1e-4)

    def has_estimate(self, klass: str) -> bool:
        with self._lock:
            return klass in self._io or klass in self._cpu

    # ------------------------------------------------- adaptive scan sizing
    #: bounds for derived fetch-unit sizes / prefetch depths (samples, units)
    UNIT_SIZE_BOUNDS = (8, 256)
    PREFETCH_UNIT_BOUNDS = (2, 32)

    def derive_unit_size(self, latency_s: float, bandwidth_bps: float,
                         sample_bytes: int) -> int:
        """Fetch-unit size (samples) from the storage cost model.

        A unit's useful payload should at least match the provider's
        latency-bandwidth product (the bytes one round-trip could have
        carried): smaller units pay proportionally more request overhead
        per sample, larger ones only add buffering.  Clamped to
        :data:`UNIT_SIZE_BOUNDS`.
        """
        target_bytes = max(1.0, latency_s * bandwidth_bps)
        lo, hi = self.UNIT_SIZE_BOUNDS
        return int(min(hi, max(lo, round(target_bytes / max(sample_bytes, 1)))))

    def derive_prefetch_units(self, latency_s: float, bandwidth_bps: float,
                              unit_bytes: int,
                              memory_budget_bytes: Optional[int] = None
                              ) -> int:
        """Prefetch depth (units in flight) from the cost model + EWMA.

        Classic pipeline sizing: depth ≈ unit fetch time over unit
        consume time, so the consumer never drains the window faster than
        fetches refill it.  Fetch time comes from the latency/bandwidth
        model; consume time from the observed ``"unit"`` CPU EWMA once
        iterations have fed it (a conservative prior before that).
        Optionally bounded so the whole window fits in half the loader's
        memory budget.  Clamped to :data:`PREFETCH_UNIT_BOUNDS`.
        """
        fetch_s = latency_s + unit_bytes / max(bandwidth_bps, 1.0)
        _io, cpu_s = self.estimate("unit")
        if not self.has_estimate("unit"):
            cpu_s = 1e-2  # prior: ~10ms of decode+transform per unit
        depth = int(math.ceil(fetch_s / max(cpu_s, 1e-4))) + 1
        lo, hi = self.PREFETCH_UNIT_BOUNDS
        if memory_budget_bytes:
            hi = max(lo, min(hi, memory_budget_bytes // (2 * max(unit_bytes, 1))))
        return int(min(hi, max(lo, depth)))


@dataclass(order=True)
class _Job:
    priority: Tuple[float, float]
    seq: int
    payload: Any = field(compare=False)


class SmartScheduler:
    """Priority queue of fetch units consumed by the loader's worker pool.

    Priority = (needed_at, -cpu_estimate): earliest-needed first; among jobs
    needed at the same time, the CPU-heaviest first (§4.5).
    """

    def __init__(self, cost_model: Optional[CostModel] = None) -> None:
        self.costs = cost_model or CostModel()
        self._heap: list = []
        self._cv = threading.Condition()
        self._seq = 0
        self._closed = False

    def submit(self, payload: Any, needed_at: float, klass: str = "default") -> None:
        _io, cpu = self.costs.estimate(klass)
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, _Job((needed_at, -cpu), self._seq, payload))
            self._cv.notify()

    def take(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._cv:
            ok = self._cv.wait_for(lambda: self._heap or self._closed, timeout=timeout)
            if not ok or (not self._heap and self._closed):
                return None
            if not self._heap:
                return None
            return heapq.heappop(self._heap).payload

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._heap)
