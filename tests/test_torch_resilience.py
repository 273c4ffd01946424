"""The crash-restart loop and straggler watchdog of the port
(``repro_torch.runtime.resilience``, a copy of the reference's module
that ``test_torch_hygiene.py::test_copied_module_executes_the_same_code``
holds to it) run beside the reference's ``repro.runtime.resilience``.

The reference's ``tests/test_fault_tolerance.py`` cases for the injector
and ``run_resilient`` run on both packages.  Its watchdog cases sleep and
read the wall clock, and ``test_no_false_positives_uniform`` is flaky
under load (ROADMAP §C); here the watchdog reads a fake clock patched
over the module's ``time.perf_counter``, so the step times are exact.
Its end-to-end restart cases fail under the mesh on this jax (ROADMAP
§C): ``test_torch_train_launch.py`` holds the port's launcher to them."""
import types

import pytest

from repro.runtime import resilience as JR
from repro_torch.runtime import resilience as TR

PACKAGES = {"reference": JR, "port": TR}


class FakeClock:
    """``perf_counter`` that advances only when told to."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _watch(mod, monkeypatch, durations, **kw):
    """A watchdog of ``mod`` fed ``durations`` (seconds) as steps 0, 1, …
    on a fake clock."""
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        perf_counter=clock))
    wd = mod.StragglerWatchdog(**kw)
    for i, dt in enumerate(durations):
        wd.start()
        clock.now += dt
        assert wd.stop(i) == pytest.approx(dt)
    return wd


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestWatchdog:
    def test_flags_slow_steps(self, pkg, monkeypatch):
        wd = _watch(PACKAGES[pkg], monkeypatch, [0.002] * 12 + [0.05],
                    window=16, threshold=2.0)
        assert [s for s, _ in wd.flagged] == [12]

    def test_no_false_positives_uniform(self, pkg, monkeypatch):
        wd = _watch(PACKAGES[pkg], monkeypatch, [0.002] * 20,
                    window=16, threshold=3.0)
        assert wd.flagged == []

    def test_no_flag_before_enough_samples(self, pkg, monkeypatch):
        """A window of 32 flags nothing before 8 steps were timed."""
        wd = _watch(PACKAGES[pkg], monkeypatch, [0.01] * 7 + [1.0])
        assert wd.flagged == []
        wd = _watch(PACKAGES[pkg], monkeypatch, [0.01] * 8 + [1.0])
        assert [s for s, _ in wd.flagged] == [8]

    def test_median_of_the_window(self, pkg, monkeypatch):
        wd = _watch(PACKAGES[pkg], monkeypatch, [5.0] * 4 + [1.0, 2.0, 3.0],
                    window=3)
        assert wd.median == 2.0 and len(wd.times) == 3


@pytest.mark.parametrize("durations", [
    [0.1] * 10 + [0.5, 0.1, 0.26, 0.24],
    [0.3, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.9, 0.1] * 4,
    [0.01 * (i % 7 + 1) for i in range(50)],
])
def test_watchdog_flags_what_the_reference_flags(durations, monkeypatch):
    a = _watch(JR, monkeypatch, durations, window=8, threshold=2.5)
    b = _watch(TR, monkeypatch, durations, window=8, threshold=2.5)
    assert b.flagged == a.flagged and b.median == a.median


def test_fires_once():
    inj = TR.FailureInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(TR.SimulatedFailure):
        inj.check(3)
    inj.check(3)  # second pass after restart: no re-fire


def _resilient(mod, *, total, every, fail_at):
    saved, log = {}, []

    def restore_state():
        if not saved:
            return None
        step = max(saved)
        return step, dict(saved[step])

    inj = mod.FailureInjector(fail_at_steps=fail_at)

    def run_step(step, state):
        inj.check(step)
        log.append(step)
        return {"x": state["x"] + 1}, {}

    def save_state(step, state):
        saved[step] = dict(state)

    final, state = mod.run_resilient(
        total_steps=total, make_state=lambda: (0, {"x": 0}),
        restore_state=restore_state, run_step=run_step,
        save_state=save_state, checkpoint_every=every,
    )
    return final, state, log, sorted(saved)


def test_restart_resumes_from_checkpoint():
    final_step, state, log, _ = _resilient(TR, total=10, every=5,
                                           fail_at=(7,))
    assert final_step == 10 and state["x"] == 10
    # steps 5..6 replayed after the crash at 7
    assert log == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]


@pytest.mark.parametrize("total,every,fail_at", [
    (10, 5, (7,)), (12, 4, (2, 9)), (9, 4, (0, 8)), (6, 10, (3,)),
])
def test_run_resilient_replays_what_the_reference_replays(total, every,
                                                          fail_at):
    assert _resilient(TR, total=total, every=every, fail_at=fail_at) == \
        _resilient(JR, total=total, every=every, fail_at=fail_at)


def test_gives_up_after_max_restarts():
    def run_step(step, state):
        raise TR.SimulatedFailure("always")

    with pytest.raises(TR.SimulatedFailure):
        TR.run_resilient(
            total_steps=2, make_state=lambda: (0, {}),
            restore_state=lambda: None, run_step=run_step,
            save_state=lambda s, st: None, max_restarts=2,
        )
