"""Faults planted underneath the timed path, to show that the check
fails them: in the port's train step, never in the benchmark.  Each is a
context manager that patches the program for its span."""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged_state", "half_batch")


@contextlib.contextmanager
def plant(name: str):
    """Plant fault ``name`` (one of :data:`FAULTS`)."""
    if name not in FAULTS:
        raise ValueError(f"fault {name!r}: one of {FAULTS}")
    from repro_torch.launch import steps

    make = steps.make_train_step

    def make_broken(*args, **kw):
        step = make(*args, **kw)

        def broken(params, opt_state, batch):
            if name == "half_batch":
                half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                return step(params, opt_state, half)
            _, _, metrics = step(params, opt_state, batch)
            return params, opt_state, metrics

        return broken

    steps.make_train_step = make_broken
    try:
        yield
    finally:
        steps.make_train_step = make
