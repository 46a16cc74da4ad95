"""Tiny runs of every cell on the CPU, made once for the session."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 5  # more than 32 signed bits hold


@pytest.fixture(scope="session")
def tiny_results():
    out = {}
    for w in harness.benchmark()["workloads"]:
        name = w["name"]
        cell = tiny.cell(name)
        out[name] = harness.run_cell(name, cell, tiny.config(cell["config"]),
                                     SEED, 0.0, False, "cpu")
    return out
