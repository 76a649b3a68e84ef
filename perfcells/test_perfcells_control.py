"""The control at a size a test run holds: the reference put in the
program's place one step below the configuration's precision (float8
activations, keys and values) reads wider gaps than the program does on
the same served tokens, and than the reference rounded to the
configuration's own bfloat16. At this size a near-tie can give the
program and the bfloat16 reference one wide gap, so the mean gap over
the compared positions is held, which reads several times apart."""
import time

import pytest

from perfcells import control, harness, smoke

SEED = 2**31 + 99


@pytest.mark.parametrize("name", list(smoke.SMALL_MIX))
def test_control_reads_wider_than_the_program(name):
    cell = smoke.small_cell(name)
    run = harness.run_cell(cell, SEED, 1.0, False, "cpu", time.perf_counter())
    readings = control.control_readings(cell, run, ["fp8", "bf16"], "cpu")
    assert readings["fp8.mean"] > 2 * control.mean_gap(run.gaps)
    assert readings["fp8.mean"] > 2 * readings["bf16.mean"]
    assert readings["fp8"] >= run.result["check"]["logit_gap"]["value"]
