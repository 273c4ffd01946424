"""Fault tolerance & straggler mitigation for the training driver.

* :class:`StragglerWatchdog` — per-step wall-time EWMA + median window;
  steps slower than ``threshold × median`` are flagged and counted.  On a
  real fleet the callback triggers re-scheduling / hot-spare swap; here
  it feeds metrics and the (tested) skip-batch policy.
* :class:`FailureInjector` — deterministic fault injection for tests and
  the resilience example: raises ``SimulatedFailure`` at chosen steps.
* :func:`run_resilient` — the restart loop: run → on failure, restore
  latest checkpoint → continue.  Used by ``repro_torch.launch.train`` and the
  fault-tolerance tests (which assert bit-exact loss continuity across a
  mid-run crash).
"""
from __future__ import annotations

import collections
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    fail_at_steps: tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerWatchdog:
    def __init__(self, window: int = 32, threshold: float = 2.5) -> None:
        self.window = window
        self.threshold = threshold
        self.times: collections.deque = collections.deque(maxlen=window)
        self.flagged: list[tuple[int, float]] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if len(self.times) >= max(4, self.window // 4):
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.flagged.append((step, dt))
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


def run_resilient(
    *,
    total_steps: int,
    make_state: Callable[[], tuple],          # () -> (step, state)
    restore_state: Callable[[], Optional[tuple]],   # () -> (step, state) | None
    run_step: Callable[[int, tuple], tuple],  # (step, state) -> (state, metrics)
    save_state: Callable[[int, tuple], None],
    checkpoint_every: int = 10,
    max_restarts: int = 8,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
) -> tuple:
    """Crash-restart training loop.  Returns the final (step, state)."""
    restarts = 0
    while True:
        restored = restore_state()
        if restored is None:
            step, state = make_state()
        else:
            step, state = restored
        try:
            while step < total_steps:
                state, metrics = run_step(step, state)
                step += 1
                if on_metrics:
                    on_metrics(step, metrics)
                if step % checkpoint_every == 0 or step == total_steps:
                    save_state(step, state)
            return step, state
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            continue  # restart from the latest checkpoint
