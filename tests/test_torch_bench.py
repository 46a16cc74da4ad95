"""The port's bench entry (halva_tpu_torch/bench.py) at a tiny preset on the
CPU: its one JSON line has the reference bench's keys (root bench.py, run
in-process at the same preset), its numbers are the ones it computed, and
the synthetic serving tree has the reference's layout (`_synth_spec`)."""

import json

import pytest
import torch

import bench as jbench
from halva_tpu.config import LLAVA_TINY
from halva_tpu_torch import bench, tree

from test_torch_tree import port_cfg

torch.set_num_threads(2)


def d_spec(out):
    return out["detail"].get("speculative", {})


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


@pytest.fixture
def tiny_env(monkeypatch):
    for knob, value in (("HALVA_BENCH_PRESET", "llava-tiny"),
                        ("HALVA_BENCH_BATCH", "2"),
                        ("HALVA_BENCH_TOKENS", "3"),
                        ("HALVA_BENCH_KV", "int4"),
                        ("HALVA_W4A8", "0")):
        monkeypatch.setenv(knob, value)


@pytest.mark.parametrize("weights,spec", [("int4g", "0"), ("bfloat16", "3")])
def test_json_line_has_the_reference_keys(tiny_env, monkeypatch, capsys,
                                          weights, spec):
    monkeypatch.setenv("HALVA_BENCH_WEIGHTS", weights)
    monkeypatch.setenv("HALVA_BENCH_SPEC", spec)
    got = bench.main(device="cpu")
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == got
    # the reference at the same preset, greedy on bf16 weights (its keys do
    # not depend on the weight mode; its verify step has no bf16 dot on the
    # CPU, so its speculative stats, whose keys test_torch_speculative holds
    # equal to the port's, are given to it)
    monkeypatch.setenv("HALVA_BENCH_WEIGHTS", "bfloat16")
    monkeypatch.setenv("HALVA_BENCH_SPEC", "0")
    monkeypatch.setattr(jbench, "DECODE_TOKENS", 3)
    monkeypatch.setattr(jbench, "SPEC_STATS", {
        k: v for k, v in d_spec(got).items() if k in ("verify_steps",
                                                       "emitted_tokens")})
    jbench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _keys(got) == _keys(want)
    d = got["detail"]
    assert got["metric"] == "chair500_eval_throughput"
    assert got["unit"] == "imgs/sec" and got["baseline_is_estimate"] is True
    assert d["batch"] == 2 and d["decode_tokens"] == 3
    assert d["weights"] == weights and d["backend"] == "cpu"
    assert got["value"] > 0
    # value and vs_baseline round one measured rate r, as the reference's
    # bench does: value = round(r, 4), vs_baseline = round(r / 0.25, 3);
    # some r must give both (vs_baseline is not value / 0.25 rounded: that
    # differs in the last place whenever r / 0.25 lies near a rounding edge)
    lo = max(got["value"] - 5e-5, (got["vs_baseline"] - 5e-4) * 0.25)
    hi = min(got["value"] + 5e-5, (got["vs_baseline"] + 5e-4) * 0.25)
    assert lo <= hi + 1e-12
    assert d["tokens_per_sec"] == got["measured_tokens_per_sec"]
    if spec != "0":
        assert d["speculative"]["draft_k"] == 3
        assert d["speculative"]["emitted_tokens"] >= d["speculative"][
            "verify_steps"] >= 1


@pytest.mark.parametrize("weights", ["int8", "int4", "int4g"])
def test_synth_tree_has_the_references_layout(weights):
    """Leaf names, shapes and dtypes of the reference's `_synth_spec` (at
    llava-tiny's widths, and a vocab-sized table)."""
    import dataclasses

    jcfg = dataclasses.replace(LLAVA_TINY, llm=dataclasses.replace(
        LLAVA_TINY.llm, vocab_size=4096, hidden_size=128,
        intermediate_size=256))
    spec = jbench._synth_spec(jcfg, weights)
    got = bench.synth_params(port_cfg(jcfg), weights, device="cpu")
    is_leaf = lambda x: isinstance(x, tuple) and x and isinstance(x[0], str)
    want = {}

    def walk(node, path):
        if is_leaf(node):
            dt = {"randn": "bfloat16", "int8": "int8", "int4p": "int8"}.get(
                node[0], "bfloat16")
            want[path] = (tuple(node[1]), dt)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (str(i),))

    walk(spec, ())
    have = {tuple(str(p) for p in path): (tuple(t.shape),
                                          str(t.dtype).split(".")[-1])
            for path, t in tree.flatten(got)}
    assert have == want
    if weights == "int4g":
        s = got["llm"]["layers"]["mlp"]["down"]["kernel_scale4p"]
        assert s.shape[2] == 2  # K = 256: one scale row per 128 rows


def test_a_failed_run_prints_the_references_failure_line(tiny_env,
                                                         monkeypatch,
                                                         capsys):
    """A run that fails exits 1 and prints one JSON line with the keys of the
    reference's `_fail` line, value 0.0 and the error."""
    monkeypatch.setenv("HALVA_BENCH_WEIGHTS", "no-such-mode")
    assert bench.run(device="cpu") == 1
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1
    got = json.loads(line[0])
    with pytest.raises(SystemExit) as exit_:
        jbench._fail("a failure")
    assert exit_.value.code == 1
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["value"] == 0.0 and got["vs_baseline"] == 0.0
    assert "no-such-mode" in got["error"]
