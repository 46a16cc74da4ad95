"""The harness finds everything by name, and refuses to run without a card.

CPU only: no test here needs a CUDA device.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import re
from contextlib import redirect_stdout

import pytest

from portbench import harness, run

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_names_files_that_exist():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["name"] == w["name"]
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        harness.load_config(cell["config"])
        importlib.import_module(f"portbench.traffic.{cell['traffic']['kind']}")


def test_every_config_file_matches_its_entry():
    for c in BENCH["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        importlib.import_module(f"portbench.reference.{cfg['reference']}")
        harness.port_config(cfg)  # the program takes it as it stands


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    for m in BENCH[kind]:
        assert callable(harness.reader(m["name"]))


def test_names_units_and_moves_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in BENCH["workloads"]:
        reported = harness.cell_metrics(BENCH, w["name"], False)
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)


def test_cell_metrics_follow_the_workloads_key():
    names = [m["name"] for m in harness.cell_metrics(BENCH, "mpt7b-chair",
                                                      True)]
    assert "decode_attn_roofline.eval" not in names
    assert "flash_fwd_roofline.eval" in names


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "mistral7b-pope", "--seed",
                       str(2**31 + 11), "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""


def test_a_run_with_a_forbidden_module_prints_no_result(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "halva_tpu_torch_x",
                        types.ModuleType("halva_tpu_torch_x"))
    assert "halva_tpu" not in harness.forbidden_modules()


def test_the_result_line_has_the_contract_keys(tiny_results):
    for out in tiny_results.values():
        line = json.loads(json.dumps(out))
        assert list(line) == ["correct", "attempted", "failed", "metrics",
                              "device", "checks"]


class _Ev:
    def __init__(self, name, dev, start, dur, annotation=False):
        import torch

        self._n, self._s, self._d, self._a = name, start, dur, annotation
        self._t = (torch.autograd.DeviceType.CUDA if dev
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_the_trace_reduces_to_busy_time_kernels_and_gaps():
    from portbench import trace

    us = 1000
    events = [
        _Ev("void (anonymous namespace)::flash_fwd_kernel<128, 64, 4>"
            "(CUtensorMap, int)", True, 0, 10 * us),
        _Ev("gemm", True, 5 * us, 10 * us),  # overlaps the first
        _Ev("gemm", True, 17 * us, 3 * us),  # a 2 us gap before it
        _Ev("gemm", True, 40 * us, 10 * us),  # a 20 us gap before it
        _Ev("cudaStreamSynchronize", False, 15 * us, 30 * us),
        _Ev("cudaLaunchKernel", False, 21 * us, 1 * us),
        _Ev("portbench span", True, 0, 50 * us, annotation=True),
        _Ev("ProfilerStep#1", False, 0, 50 * us),
    ]
    tr = trace.reduce(events, 60e-6)
    approx = pytest.approx
    assert tr["busy_s"] == approx(28e-6)
    assert tr["kernels"]["(anonymous namespace)::flash_fwd_kernel<128, 64, "
                         "4>"] == approx((10e-6, 1))
    assert tr["kernels"]["gemm"] == approx((23e-6, 3))
    gaps = tr["gaps"]
    assert gaps[trace.SHORT] == approx(2e-6)
    assert gaps["cudaStreamSynchronize"] == approx(20e-6)
    assert gaps[trace.EDGES] == approx(10e-6)
    assert trace.kernel_time(tr, "flash_fwd_kernel") == approx((10e-6, 1))
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["gemm", approx(23e-6)]


def _traced(kind, model, shapes, kernels, **extra):
    units = [{"traced": True, "shapes": s} for s in shapes]
    units.append({"traced": False, "shapes": shapes[0]})
    return {"kind": kind, "model": model, "units": units,
            "trace": {"kernels": kernels}, **extra}


def test_a_roofline_reads_its_kernels_and_work_from_its_own_file():
    """Each roofline reader holds its kernels' names and its work model
    over the units' recorded shapes: the share is the traced units' bound
    over the kernels' device time, and nothing where the launches differ
    from what the model counts."""
    from portbench import flops
    from portbench.tests import tiny

    model = tiny.config("llava-mistral-7b")["model"]
    llm = model["llm"]
    h, kvh, d, w = flops.attn_dims(llm)
    layers = llm["num_layers"]
    sh = {"prefill": [30, 27], "s_pad": 35, "steps": 3,
          "decode_kernel": True}
    fwd = flops.bound_s(*flops.flash_fwd([30, 27], 35, h, kvh, d, w))
    dec = sum(flops.bound_s(*flops.decode_attn([30, 27], t + 1, h, kvh, d))
              for t in range(3))
    kernels = {"flash_fwd_kernel<128>": (2e-5, 2 * layers),
               "decode_attn_kernel<1>": (4e-5, 2 * 3 * layers),
               "gemm": (1.0, 7)}
    rec = _traced("eval_batches", model, [sh, sh], kernels)
    assert harness.reader("flash_fwd_roofline.eval")(rec) == pytest.approx(
        100 * 2 * layers * fwd / 2e-5)
    assert harness.reader("decode_attn_roofline.eval")(rec) == pytest.approx(
        100 * 2 * layers * dec / 4e-5)
    rec["trace"]["kernels"]["flash_fwd_kernel<128>"] = (2e-5, 2 * layers + 1)
    assert harness.reader("flash_fwd_roofline.eval")(rec) is None
    no_k4 = dict(sh, decode_kernel=False)
    assert harness.reader("decode_attn_roofline.eval")(
        _traced("eval_batches", model, [no_k4], kernels)) is None

    tr = {"pn": [40, 38, 40, 39], "pn_pad": 43, "ref": [40, 36],
          "ref_pad": 43}
    per_layer = 0.0
    for lens, s_pad, n in ((tr["pn"], 43, 2), (tr["ref"], 43, 3)):
        per_layer += n * flops.bound_s(*flops.flash_fwd(lens, s_pad, h, kvh,
                                                        d, w))
        per_layer += flops.bound_s(*flops.flash_bwd_dq(lens, s_pad, h, kvh,
                                                       d, w))
        per_layer += flops.bound_s(*flops.flash_bwd_dkv(lens, s_pad, h, kvh,
                                                        d, w))
    kernels = {"flash_fwd_kernel<128>": (1e-4, 5 * layers),
               "flash_bwd_dq_kernel<128>": (1e-4, 2 * layers),
               "flash_bwd_dkv_kernel<128>": (2e-4, 2 * layers)}
    rec = _traced("dpa_train", model, [tr], kernels, job={"remat": True})
    assert harness.reader("flash_roofline.train")(rec) == pytest.approx(
        100 * layers * per_layer / 4e-4)
    rec["job"] = {"remat": False}  # 7 launches a layer, not 9
    assert harness.reader("flash_roofline.train")(rec) is None


def test_the_batch_tail_reads_untraced_batches_only():
    """eval.batch_s_p90: the 90th percentile of the untraced batches'
    wall times; nothing with fewer than two, nothing for a train run."""
    p90 = harness.reader("eval.batch_s_p90")
    units = [{"t": 0.1 * (i + 1), "traced": False} for i in range(10)]
    rec = {"kind": "eval_batches", "units": units}
    assert p90(rec) == pytest.approx(0.91)
    rec["units"] = units + [{"t": 50.0, "traced": True}] * 5
    assert p90(rec) == pytest.approx(0.91)
    assert p90({"kind": "eval_batches", "units": units[:1]}) is None
    assert p90({"kind": "dpa_train", "units": units}) is None
