"""The harness end to end on the CPU at small sizes: generated traffic
through ``AsyncServer`` and the engine (the kernels' plain versions), the
metrics, the check against the reference, the result line; and the
command's refusals."""
import json
import math
import shutil
import subprocess
import sys
import time

import pytest

from perfcells import harness, smoke

CELLS = list(smoke.SMALL_MIX)
SEED = 2**31 + 4242
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, trace, **kw):
    return harness.run_cell(smoke.small_cell(name, **kw), SEED, 1.0, trace,
                            "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end(name):
    run = _run(name, False)
    res = run.result
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] >= len(run.checked) > 0
    cell = smoke.small_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        v = res["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and math.isfinite(v["value"])
        assert v["value"] > 0
    assert res["check"]["compared_tokens"]["value"] == sum(
        len(s.request.generated) for s in run.checked)
    assert res["device"]["platform"] == "cpu"
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_layers(name):
    res = _run(name, True).result
    assert res["correct"] is True, res["check"]
    cell = smoke.small_cell(name)
    # device readers find nothing on the CPU and leave their metric out
    device = {m["name"] for m in cell.per_layer
              if m["source"] == "device_trace"}
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer} - device
    assert "breakdown" not in res


def test_check_fails_over_its_limit():
    res = _run(CELLS[0], False, limit=-1.0).result
    assert res["correct"] is False
    assert res["check"]["logit_gap"]["value"] > -1.0


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfcells/run.py", "--workload",
         "nemotron-4-15b.long-prompt",
         "--seed", "5", "--seconds", "1", *extra], cwd=cwd,
        capture_output=True, text=True, timeout=120)


def test_the_command_refuses_without_a_card():
    p = _command(harness.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfcells",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
