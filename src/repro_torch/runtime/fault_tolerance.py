"""Fault tolerance: heartbeats, failure injection, restart policy,
straggler mitigation (port of ``repro/runtime/fault_tolerance.py``; pure
host code, the same as the reference's).

* `HeartbeatMonitor` — hosts report heartbeats; silence past a deadline
  marks the host failed (transport-agnostic).
* `FailureInjector` — deterministic fault injection for tests
  (raise SimulatedFailure at step N).
* `run_with_restarts` — the restart policy: on failure, restore the last
  complete checkpoint, rebuild step state, resume.  With the
  deterministic pipeline and deterministic steps, recovery is bitwise
  exact.
* `StragglerMonitor` — per-step time tracker; steps slower than
  k x rolling-median are flagged.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


class SimulatedFailure(RuntimeError):
    """Stands in for a lost node / preempted slice."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple[int, ...] = ()
    max_failures: int = 1
    _count: int = 0

    def check(self, step: int):
        if self._count < self.max_failures and step in self.fail_at_steps:
            self._count += 1
            raise SimulatedFailure(f"injected failure at step {step}")


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 5.0):
        self.deadline = deadline_s
        self.last: dict[str, float] = {}
        self.failed: set[str] = set()

    def beat(self, host: str, now: float | None = None):
        self.last[host] = time.time() if now is None else now  # easeylint: allow[wall-clock] — injectable via now=

    def sweep(self, now: float | None = None) -> set[str]:
        now = time.time() if now is None else now  # easeylint: allow[wall-clock] — injectable via now=
        newly = {h for h, t in self.last.items()
                 if now - t > self.deadline and h not in self.failed}
        self.failed |= newly
        return newly

    @property
    def healthy(self) -> set[str]:
        return set(self.last) - self.failed


class StragglerMonitor:
    """Flags steps slower than `factor` x rolling median."""

    def __init__(self, window: int = 16, factor: float = 3.0, warmup: int = 3):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.warmup = warmup
        self.flagged: list[tuple[int, float, float]] = []

    def observe(self, step: int, seconds: float) -> bool:
        is_straggler = False
        if len(self.times) >= self.warmup:
            med = sorted(self.times)[len(self.times) // 2]
            if seconds > self.factor * med:
                self.flagged.append((step, seconds, med))
                is_straggler = True
        # stragglers do not poison the baseline
        if not is_straggler:
            self.times.append(seconds)
        return is_straggler


def run_with_restarts(loop: Callable[[int], int], *, checkpointer,
                      max_restarts: int = 3, logger=print) -> dict:
    """Run `loop(start_step) -> final_step`, restarting from the last
    complete checkpoint on SimulatedFailure.  Returns run stats."""
    restarts = 0
    start = (checkpointer.latest_step() or -1) + 1 if checkpointer else 0
    while True:
        try:
            final = loop(start)
            return {"final_step": final, "restarts": restarts}
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts; giving up") from e
            latest = checkpointer.latest_step() if checkpointer else None
            start = (latest + 1) if latest is not None else 0
            logger(f"[FT] {e} -> restart #{restarts} from step {start}")
