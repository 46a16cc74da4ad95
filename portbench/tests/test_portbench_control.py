"""The control at a size a test run holds: the program's int8 path, put in
place of the bf16 one, reads further from the reference than the program
itself, and is judged by the cell's committed limits as a run is; the
training cells' half-batch fault comes out not correct."""

from __future__ import annotations

import time

import pytest

from portbench import control, harness
from portbench.tests import tiny
from portbench.tests.conftest import SEED

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _readings(name, mode):
    cell = tiny.cell(name)
    # every finished request: a tiny model's margins are wide, and a
    # handful of tokens may hold no flip at all
    cell["traffic"]["check_tokens"] = 10**6
    ctx = harness.Context(name, cell, tiny.config(cell["config"]), SEED,
                          0.0, False, "cpu", time.perf_counter())
    return control.readings(ctx, mode)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_further_than_the_program(name):
    sound = _readings(name, "program")["numbers"]
    low = _readings(name, "int8")["numbers"]
    assert max(low[k] / max(sound[k], 1e-12) for k in sound) > 3


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_judged_by_the_committed_limits(name):
    """`correct` and `checks` as a run makes them, under the limits the
    cell's file holds (at this size int8's errors are a small part of what
    32 layers at full width give, and stay inside them)."""
    limits = harness.load_cell(name)["limits"]
    for mode in ("program", "int8"):
        out = _readings(name, mode)
        assert out["checks"] == harness.checks(out["numbers"], limits)
        assert out["correct"] == harness.judge(0, out["checks"])
    assert _readings(name, "program")["correct"]


def test_the_half_batch_fault_comes_out_not_correct():
    sound = _readings("mistral7b-dpa-train", "program")
    half = _readings("mistral7b-dpa-train", "half")
    assert sound["correct"] and not half["correct"]
    assert max(half["numbers"][k] / max(sound["numbers"][k], 1e-12)
               for k in sound["numbers"]) > 3
