"""The port's launch scripts (scripts/torch_*.sh) against the reference's
(scripts/halva_7b.sh, halva_13b.sh, halva_vila_13b.sh, eval_suite.sh),
with stub `python` and `torchrun` executables first on PATH that record
their argv and run nothing.

- With the same environment, each script runs the reference's commands
  flag for flag: the module differs (halva_tpu -> halva_tpu_torch), and so
  do only the documented flags: `--grad-accum-steps` (32 / data ranks, for
  the recipe's global batch of 64), the reference's `--mesh-model 2` on
  the 13B recipes (MESH_MODEL, default 1, here), and the `MODEL_PATH`
  default (a convert_checkpoint dir);
- for NGPU in {1, 2, 4, 8} and MESH_MODEL in {1, 2}: one card runs
  `python -m`, several `torchrun --nproc-per-node NGPU -m ... --mesh-data
  D --mesh-model M` with D x M = NGPU, and per-device batch x D x
  accumulation = 64 (the eval suite's batch of 8 split over D); an NGPU
  that does not split the recipe stops the script with a message before
  any stub runs;
- every recorded train command parses with `train.run.parse_args`, every
  eval command with `evals.cli.build_parser()`;
- `bash -n` passes for every new script.
"""

import os
import subprocess

import pytest

from halva_tpu_torch.evals import cli
from halva_tpu_torch.train import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
PAIRS = {"halva_7b.sh": "torch_halva_7b.sh",
         "halva_13b.sh": "torch_halva_13b.sh",
         "halva_vila_13b.sh": "torch_halva_vila_13b.sh",
         "eval_suite.sh": "torch_eval_suite.sh"}
TRAIN = [k for k in PAIRS if k != "eval_suite.sh"]
STUB = """#!/bin/bash
{ printf '%s' "$(basename "$0")"; for a in "$@"; do printf '\\x1f%s' "$a"; done
  printf '\\n'; } >> "$STUB_LOG"
"""
EVAL_ENV = {"MODEL_PATH": "/ckpt/halva-7b", "COCO_VAL2014": "/d/val2014",
            "COCO_ANN": "/d/ann", "POPE_QUESTIONS": "/d/pope.jsonl",
            "POPE_ANN": "/d/pope_ann", "AMBER_QUERY": "/d/amber.json",
            "AMBER_IMAGES": "/d/amber", "AMBER_ANNO": "/d/amber_anno",
            "MME_QUESTIONS": "/d/mme.jsonl", "MME_IMAGES": "/d/mme",
            "MME_DATA": "/d/mme_data"}
NGPUS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stubs")
    for name in ("python", "torchrun"):
        (d / name).write_text(STUB)
        (d / name).chmod(0o755)
    return str(d)


def _run(stubs, tmp_path, script, **env):
    """(exit code, stderr, recorded commands) of one script: each command
    is (program, argv)."""
    log = tmp_path / f"{script}.{len(os.listdir(tmp_path))}.log"
    full = {"PATH": f"{stubs}:{os.environ['PATH']}", "STUB_LOG": str(log),
            "HOME": str(tmp_path)}
    full.update({k: str(v) for k, v in env.items()})
    p = subprocess.run(["bash", os.path.join(SCRIPTS, script)], env=full,
                       capture_output=True, text=True, timeout=60)
    cmds = []
    if log.exists():
        for line in log.read_text().splitlines():
            prog, *argv = line.split("\x1f")
            cmds.append((prog, argv))
    return p.returncode, p.stderr, cmds


def _module_and_flags(prog, argv):
    """(module, flags after the module, torchrun's --nproc-per-node)."""
    nproc = None
    if prog == "torchrun":
        assert argv[0] == "--nproc-per-node"
        nproc, argv = int(argv[1]), argv[2:]
    assert argv[0] == "-m"
    return argv[1], argv[2:], nproc


def _pairs(flags):
    """The flags as a dict; an eval command's sub-command under ''."""
    out, i = {}, 0
    if flags and not flags[0].startswith("--"):
        out[""], i = flags[0], 1
    while i < len(flags):
        assert flags[i].startswith("--"), flags[i:]
        if i + 1 < len(flags) and not flags[i + 1].startswith("--"):
            out[flags[i]], i = flags[i + 1], i + 2
        else:
            out[flags[i]], i = None, i + 1
    return out


DOCUMENTED = {"--grad-accum-steps", "--mesh-data", "--mesh-model"}


@pytest.mark.parametrize("ref,model_path", [
    (ref, mp) for ref in sorted(PAIRS) for mp in ("set", "default")
    if ref in TRAIN or mp == "set"])  # the eval suite has no default
def test_the_port_runs_the_reference_commands(stubs, tmp_path, ref,
                                              model_path):
    env = dict(EVAL_ENV) if ref == "eval_suite.sh" else {}
    if ref in TRAIN and model_path == "set":
        env["MODEL_PATH"] = "/ckpt/base"
    rc, err, want = _run(stubs, tmp_path, ref, **env)
    assert rc == 0, err
    rc, err, got = _run(stubs, tmp_path, PAIRS[ref], **env)
    assert rc == 0, err
    assert len(got) == len(want) == (4 if ref == "eval_suite.sh" else 1)
    for (gp, ga), (wp, wa) in zip(got, want):
        assert gp == wp == "python"
        gm, gf, _ = _module_and_flags(gp, ga)
        wm, wf, _ = _module_and_flags(wp, wa)
        assert wm.startswith("halva_tpu.")
        assert gm == "halva_tpu_torch." + wm[len("halva_tpu."):]
        g, w = _pairs(gf), _pairs(wf)
        skip = set(DOCUMENTED)
        if model_path == "default":
            skip.add("--model-path")
            assert g["--model-path"].endswith("-torch")
        assert {k: v for k, v in g.items() if k not in skip} == {
            k: v for k, v in w.items() if k not in skip}
        if ref in TRAIN:
            assert int(g["--grad-accum-steps"]) == 32
            assert "--mesh-model" not in g  # one card: no mesh flags


def _shapes():
    for script in sorted(PAIRS.values()):
        for ngpu in NGPUS:
            for mm in (1, 2):
                yield script, ngpu, mm


@pytest.mark.parametrize("script,ngpu,mesh_model", list(_shapes()))
def test_every_device_count_keeps_the_recipes_batch(stubs, tmp_path, script,
                                                    ngpu, mesh_model):
    env = dict(EVAL_ENV, NGPU=ngpu, MESH_MODEL=mesh_model)
    rc, err, cmds = _run(stubs, tmp_path, script, **env)
    if ngpu % mesh_model:
        assert rc != 0 and not cmds and "MESH_MODEL" in err
        return
    assert rc == 0, err
    for prog, argv in cmds:
        module, flags, nproc = _module_and_flags(prog, argv)
        f = _pairs(flags)
        if ngpu == 1:
            assert prog == "python" and "--mesh-data" not in f
            data = 1
        else:
            assert prog == "torchrun" and nproc == ngpu
            data = int(f["--mesh-data"])
            assert data * int(f["--mesh-model"]) == ngpu
            assert int(f["--mesh-model"]) == mesh_model
        if module == "halva_tpu_torch.train.run":
            rcfg = run.parse_args(flags)
            assert rcfg.per_device_batch * data * rcfg.grad_accum_steps == 64
            assert (rcfg.mesh_data or 1) == data
            assert rcfg.mesh_model == mesh_model
        else:
            assert module == "halva_tpu_torch.evals.cli"
            args = cli.build_parser().parse_args(flags)
            assert args.batch_size == 8 and args.batch_size % data == 0
            assert (args.mesh_data or 1) == data


@pytest.mark.parametrize("ngpu", ["0", "3", "64", "abc", "-2", ""])
@pytest.mark.parametrize("script", sorted(PAIRS.values()))
def test_a_bad_device_count_stops_before_python(stubs, tmp_path, script,
                                                ngpu):
    env = dict(EVAL_ENV, NGPU=ngpu)
    rc, err, cmds = _run(stubs, tmp_path, script, **env)
    if ngpu == "":  # unset: the default of one card
        assert rc == 0 and cmds[0][0] == "python"
        return
    assert rc != 0 and not cmds
    assert "NGPU" in err or "data ranks" in err


def test_the_eval_suite_refuses_ranks_that_do_not_split_its_batch(
        stubs, tmp_path):
    rc, err, cmds = _run(stubs, tmp_path, "torch_eval_suite.sh",
                         **dict(EVAL_ENV, NGPU=16))
    assert rc != 0 and not cmds and "data ranks" in err
    rc, _, cmds = _run(stubs, tmp_path, "torch_halva_7b.sh", NGPU=16)
    assert rc == 0
    _, flags, nproc = _module_and_flags(*cmds[0])
    assert nproc == 16 and _pairs(flags)["--grad-accum-steps"] == "2"


@pytest.mark.parametrize("script", sorted(PAIRS.values()) + [
    "torch_launch.sh"])
def test_scripts_parse(script):
    p = subprocess.run(["bash", "-n", os.path.join(SCRIPTS, script)],
                       capture_output=True, text=True, timeout=30)
    assert p.returncode == 0, p.stderr
