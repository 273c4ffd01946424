"""The check that decides ``correct`` fails what it must: the control
(the reference in float8, put in the program's place) and each fault a
cell can have, planted in the program underneath the timed path, each
driven through the rest of a run on the CPU at a smoke size and held to
the cell's committed limits."""
import pytest

from perfbench import run
from perfbench.lib import cells, faults
from perfbench.tests.smoke import smoke_cell

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def _run(name, system="program", fault=None, seed=2 ** 31 + 3, layers=2):
    cell = smoke_cell(name, layers=layers)
    if fault is None:
        return run.execute(cell, seed, 0.05, False, "cpu", system=system,
                           log=lambda *_: None)
    with faults.plant(fault):
        return run.execute(cell, seed, 0.05, False, "cpu", system=system,
                           log=lambda *_: None)


def _failed(result):
    return [n for n, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    # 16 layers: the float8 control's error grows with depth, as in the
    # 24 and 48 layers of the cells that set the limits
    result = _run(name, system="control", layers=16)
    assert result["correct"] is False and _failed(result), result["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_train_step_is_not_correct(name, fault):
    result = _run(name, fault=fault)
    assert result["correct"] is False and _failed(result), result["checks"]


@pytest.mark.parametrize("layers", [2, 16])
@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name, layers):
    assert _run(name, layers=layers)["correct"] is True


def test_faults_are_undone():
    from repro_torch.launch import steps

    make = steps.make_train_step
    for f in faults.FAULTS:
        with faults.plant(f):
            assert steps.make_train_step is not make
    assert steps.make_train_step is make
    with pytest.raises(ValueError):
        with faults.plant("no_such_fault"):
            pass
