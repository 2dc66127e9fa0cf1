"""Deterministic fault injection for the serving tier: the port of
``repro/launch/faults.py``.

Every failure the router tier must survive (a scorer raising mid-round, a
replica stalling past its latency budget, a live index swap racing
in-flight requests) is a declarative :class:`FaultPlan`, so a chaos test or
a load run reproduces the same failure at the same point on every run.
Faults key off counters (the k-th scorer call, the n-th admitted request),
never clocks or random draws.

- :class:`FaultyScorer` wraps any port scorer and raises
  :class:`FaultInjectedError` from its ``__call__`` on the scheduled call.
  The engine calls its scorer once a round with the same (B, n) shapes as
  the reference engine calls its host callback, so call k fails the same
  round in both packages.  The raise is a Python exception between two
  launches, never a device fault; ``AdaCURService.flush`` turns it into
  per-request error responses.
- ``FaultPlan.sleep_s`` is read by each replica worker before it serves a
  batch: a matching :class:`SleepFault` stalls that replica, which drives
  the router's hedging and the straggler watchdog.
- ``FaultPlan.swap_due`` fires at an admission count, telling the router
  to ``swap_index`` while requests are in flight.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch


class FaultInjectedError(RuntimeError):
    """Raised by :class:`FaultyScorer` on a scheduled call."""


@dataclass(frozen=True)
class ScorerFault:
    """Raise out of the scorer's k-th call (1-based, per replica counter).
    ``replica=None`` matches any replica's counter."""

    call_k: int
    replica: Optional[int] = None


@dataclass(frozen=True)
class SleepFault:
    """Stall ``replica`` for ``seconds`` before it serves a batch.

    ``request_seq=None`` makes the replica persistently slow (the
    slow-replica scenario); a sequence number stalls only the batch that
    holds that admitted request.
    """

    replica: int
    seconds: float
    request_seq: Optional[int] = None


@dataclass(frozen=True)
class SwapFault:
    """Swap the live index once ``at_seq`` requests have been admitted."""

    at_seq: int


class FaultPlan:
    """The full deterministic failure schedule of one run.

    Read by :class:`FaultyScorer` (scorer faults), the router's replica
    workers (sleep faults) and its admission path (swap faults: each fires
    once, at the first admission count at or past its ``at_seq``).
    """

    def __init__(self, scorer_faults: Sequence[ScorerFault] = (),
                 sleep_faults: Sequence[SleepFault] = (),
                 swap_faults: Sequence[SwapFault] = ()):
        self.scorer_faults = list(scorer_faults)
        self.sleep_faults = list(sleep_faults)
        self.swap_faults = sorted(swap_faults, key=lambda f: f.at_seq)
        self._swaps_fired: List[SwapFault] = []

    def scorer_should_raise(self, call_k: int, replica: Optional[int]) -> bool:
        return any(f.call_k == call_k and (f.replica is None or f.replica == replica)
                   for f in self.scorer_faults)

    def sleep_s(self, replica: int, request_seqs: Sequence[int]) -> float:
        """Stall before ``replica`` serves the batch holding the given
        admitted sequence numbers (0.0: no fault)."""
        seqs = set(request_seqs)
        hit = [f.seconds for f in self.sleep_faults
               if f.replica == replica and (f.request_seq is None or f.request_seq in seqs)]
        return max(hit, default=0.0)

    def swap_due(self, admitted: int) -> bool:
        """True once, the first time the admission count reaches a
        scheduled swap."""
        if self.swap_faults and admitted >= self.swap_faults[0].at_seq:
            self._swaps_fired.append(self.swap_faults.pop(0))
            return True
        return False


class FaultyScorer:
    """Wrap a scorer; raise on the plan's scheduled calls.

    Scoring, ``stats`` and the pair log stay on the inner scorer (the
    wrapper adds a call counter only), so measured-CE accounting and the
    pair invariants read the same with or without the wrapper.  A call
    that raises scores nothing.
    """

    def __init__(self, inner, plan: Optional[FaultPlan] = None,
                 replica: Optional[int] = None):
        self.inner = inner
        self.plan = plan
        self.replica = replica
        self.calls = 0

    @property
    def stats(self):
        return self.inner.stats

    @property
    def call_log(self):
        return self.inner.call_log

    def reset_stats(self) -> None:
        self.inner.reset_stats()

    def __call__(self, query, item_idx) -> torch.Tensor:
        self.calls += 1
        if self.plan is not None and self.plan.scorer_should_raise(self.calls, self.replica):
            raise FaultInjectedError(
                f"injected scorer fault: call {self.calls} on replica {self.replica}")
        return self.inner(query, item_idx)
