"""Fault tolerance + straggler mitigation for long training runs.

* :class:`StragglerDetector` — per-step wall times, EWMA baseline; a step
  (or in multi-host deployments, a host heartbeat) slower than
  ``threshold ×`` baseline is flagged; repeated flags trigger the mitigation
  callback (on real fleets: demote/replace the host; here: logged + counted,
  and the training driver rebuilds its data pipeline, the most common
  CPU-side straggler cause).
* :class:`FailureInjector` — deterministic fault injection for tests/examples
  (raise at step N, or with probability p).
* :func:`run_resilient` — the restart loop: run the training driver; on a
  (simulated or real) failure, restore the latest checkpoint — possibly onto
  a *smaller* mesh (elastic rescale) — and continue.  Guarantees progress:
  at most ``checkpoint_every`` steps are ever recomputed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class HostFailure(RuntimeError):
    """Stands in for a lost host / SIGTERM'd worker."""


@dataclass
class StragglerDetector:
    """Also serves as the hedge trigger of the storage prefetch pool
    (:class:`~repro.core.fetch.FetchEngine`): clean fetch wall times feed
    the baseline, and a request outliving ``threshold ×`` baseline is a
    straggler the engine duplicates.  ``observe`` is therefore thread-safe
    — training drivers call it from one thread, the prefetch pool from
    many."""

    threshold: float = 2.0
    alpha: float = 0.2
    patience: int = 3
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _ewma: Optional[float] = None
    _strikes: int = 0
    flagged_steps: List[int] = field(default_factory=list)
    mitigations: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @property
    def baseline(self) -> Optional[float]:
        """Current healthy-step EWMA (None until the first observation)."""
        with self._lock:
            return self._ewma

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True when mitigation fired at this step."""
        with self._lock:
            if self._ewma is None:
                self._ewma = seconds
                return False
            slow = seconds > self.threshold * self._ewma
            if slow:
                self._strikes += 1
                self.flagged_steps.append(step)
            else:
                self._strikes = 0
                # only fold healthy steps into the baseline
                self._ewma = ((1 - self.alpha) * self._ewma
                              + self.alpha * seconds)
            fire = self._strikes >= self.patience
            if fire:
                self.mitigations += 1
                self._strikes = 0
            ewma = self._ewma
        if fire:
            if self.on_straggler:
                self.on_straggler(step, seconds, ewma)
            return True
        return False


@dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    seen: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.seen:
            self.seen.add(step)
            raise HostFailure(f"injected host failure at step {step}")


def run_resilient(
    make_runner: Callable[[Optional[int]], Callable[[], int]],
    *,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> Dict[str, Any]:
    """``make_runner(restore_step)`` builds a driver callable that trains to
    completion and returns the final step; on HostFailure we rebuild (restore
    from checkpoint, maybe re-mesh) and resume."""
    restarts = 0
    restore_step: Optional[int] = None
    while True:
        runner = make_runner(restore_step)
        try:
            final_step = runner()
            return {"final_step": final_step, "restarts": restarts}
        except HostFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(restarts, e)
            restore_step = None  # runner restores from latest itself
