"""Straggler mitigation and heartbeat monitoring (host-side control plane):
the port of ``repro/distributed/fault_tolerance.py``, pure Python, kept as
the port's own copy.

The watchdog measures each step's wall time against a rolling median; a
step slower than ``threshold`` x the median is a straggler, and
``patience`` consecutive stragglers fire a policy callback.  The serving
router gives each replica its own watchdog over one fleet-wide baseline
(``StragglerWatchdog.shared_baseline``) and quarantines on the callback.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional


@dataclass
class StepStats:
    step: int
    seconds: float
    straggler: bool


class StragglerWatchdog:
    """Rolling-median deadline: a step slower than ``threshold`` x median is
    flagged; ``on_straggler`` fires after ``patience`` consecutive flags.

    ``baseline`` optionally shares the healthy-step deque across watchdog
    instances — the serving router gives each replica its own watchdog (its
    own consecutive-flag state and callback) over one *fleet-wide* baseline,
    so a replica that is slow from its very first batch is still flagged
    against its healthy peers' median rather than its own history.
    """

    def __init__(
        self,
        threshold: float = 2.0,
        window: int = 20,
        patience: int = 3,
        on_straggler: Optional[Callable[[StepStats], None]] = None,
        baseline: Optional[Deque[float]] = None,
    ):
        self.threshold = threshold
        self.window: Deque[float] = (
            baseline if baseline is not None
            else collections.deque(maxlen=window)
        )
        self.patience = patience
        self.on_straggler = on_straggler
        self.consecutive = 0
        self.history: List[StepStats] = []

    @staticmethod
    def shared_baseline(window: int = 20) -> Deque[float]:
        """A healthy-step deque to pass as ``baseline`` to a watchdog group."""
        return collections.deque(maxlen=window)

    def _median(self) -> float:
        if not self.window:
            return float("inf")
        s = sorted(self.window)
        return s[len(s) // 2]

    def observe(self, step: int, seconds: float) -> StepStats:
        med = self._median()
        straggler = len(self.window) >= 5 and seconds > self.threshold * med
        if straggler:
            self.consecutive += 1
        else:
            self.consecutive = 0
            self.window.append(seconds)   # only healthy steps update the baseline
        stats = StepStats(step, seconds, straggler)
        self.history.append(stats)
        if straggler and self.consecutive >= self.patience and self.on_straggler:
            self.on_straggler(stats)
            self.consecutive = 0
        return stats

    def timed(self, step: int, fn: Callable, *args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        self.observe(step, time.monotonic() - t0)
        return out


class HeartbeatMonitor:
    """Host liveness registry: hosts report heartbeats; hosts silent past
    ``timeout`` are declared dead and listed for the elastic controller."""

    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout
        self.last_seen: Dict[str, float] = {}

    def beat(self, host: str, now: Optional[float] = None) -> None:
        self.last_seen[host] = now if now is not None else time.monotonic()

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.monotonic()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]

    def healthy_count(self, now: Optional[float] = None) -> int:
        return len(self.last_seen) - len(self.dead_hosts(now))


def elastic_plan(n_healthy: int, axis_candidates=((2, 16, 16), (16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 2), (1, 1))):
    """Largest mesh shape (from the supported ladder) that fits the surviving
    hosts — checkpoint restore re-shards onto it (repro.checkpoint)."""
    for shape in axis_candidates:
        n = 1
        for s in shape:
            n *= s
        if n <= n_healthy:
            return shape
    return (1,)
