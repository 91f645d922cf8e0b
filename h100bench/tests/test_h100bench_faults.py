"""The check fails what it must fail: the rest of a run (no look for a card)
with the timed path broken underneath, and the control, the reference at
float8 in the program's place, at a tiny size on the CPU (the tiny cells'
limits are their own, ``conftest.TINY_LIMITS``)."""

import pytest

from h100bench import control, judge, run

SEED = 2 ** 31 + 21


@pytest.mark.parametrize("cell,fault", [("tiny_tf_train", "fault:unchanged"),
                                        ("tiny_tf_train", "fault:half_batch")])
def test_a_run_with_a_broken_path_is_not_correct(tiny, cell, fault):
    home, bench = tiny
    with control.fault(fault):
        result = run.run_cell(bench, cell, SEED, 0.3, False, device="cpu", home=home)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,number", [("tiny_tf_train", "loss_gap"),
                                         ("tiny_conformer_train", "loss_gap")])
def test_control_is_not_correct(tiny, cell, number):
    home, bench = tiny
    readings = control.readings(bench, cell, SEED, ["program", "control"], device="cpu",
                                home=home)
    limits = judge.load_limits(cell, home)
    assert judge.verdict(readings["program"], limits)[0], readings
    assert not judge.verdict(readings["control"], limits)[0], readings
    # the control reads at least three times further off
    assert readings["control"][number] >= 3 * readings["program"][number]
