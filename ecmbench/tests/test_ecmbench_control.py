"""The control at a test size: the reference with one guarantee broken,
in the program's place, comes out not correct; the program correct."""

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ebhelp  # noqa: E402
from harness import judge, runner  # noqa: E402


@pytest.fixture(scope="module")
def measured():
    cell = ebhelp.tiny_cell()
    return cell, runner.measure(cell, ebhelp.SEED, 0.01, False,
                                time.perf_counter(), device="cpu")


def test_program_is_correct(measured):
    cell, state = measured
    numbers, wrong, checked = runner.check(state, cell, workers=1)[""]
    assert judge.correct(numbers) and wrong == 0 and checked == 4


@pytest.mark.parametrize("control,number", [("stage1", "stage1_mismatch"),
                                            ("stage2", "stage2_mismatch")])
def test_control_is_not_correct(measured, control, number):
    cell, state = measured
    numbers, wrong, checked = runner.check(state, cell, (control,),
                                           workers=1)[control]
    assert not judge.correct(numbers)
    assert numbers[number] == checked and wrong == checked
