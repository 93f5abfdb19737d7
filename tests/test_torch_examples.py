"""The five torch examples (``examples/torch_*.py``) at smoke size on the
CPU (``--device cpu``: the kernels' plain versions).

Each example's ``main(argv)`` runs in this process and its printed report
is checked; the dataflow explorer's report must equal, line for line,
the reference example's on the same graph (every number up to the
compiled plan is host arithmetic, and the plan's own lines are the
planner's, held equal to the reference's). One example also runs as a
script, as a user starts it.
"""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    assert _example("torch_quickstart").main(
        ["--device", "cpu", "--epochs", "3", "--network", "graphsage"]) == 0
    out = capsys.readouterr().out
    assert "Executable[sage_mean] backend=cuda device=cpu" in out
    acc = re.search(r"train-acc ([\d.]+) test-acc ([\d.]+)", out)
    assert acc and all(0.0 <= float(a) <= 1.0 for a in acc.groups())
    assert out.rstrip().endswith("done.")


def test_serve_gnn(capsys):
    assert _example("torch_serve_gnn").main(
        ["--device", "cpu", "--scale", "0.1", "--requests", "12"]) == 0
    out = capsys.readouterr().out
    assert "served 12 requests" in out
    assert "server: 12/12 completed, 0 rejected, 0 expired" in out


def test_dataflow_explorer_matches_reference(capsys, monkeypatch):
    assert _example("torch_dataflow_explorer").main(
        ["--device", "cpu", "--dataset", "cora"]) == 0
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["dataflow_explorer.py", "--dataset",
                                      "cora"])
    _example("dataflow_explorer").main()
    exp = capsys.readouterr().out.splitlines()
    # the Executable header names the backend and device: the one line
    # that differs between the packages
    assert [ln for ln in got if not ln.startswith("Executable[")] == \
        [ln for ln in exp if not ln.startswith("Executable[")]
    assert any("traffic ratio (conv/blocked)" in ln for ln in got)


def test_serve_lm(capsys):
    assert _example("torch_serve_lm").main(
        ["--device", "cpu", "--prompt-len", "8", "--new-tokens", "4",
         "--arch", "mamba2-1.3b"]) == 0
    out = capsys.readouterr().out
    assert "mamba2-1.3b-smoke: served 4 requests, 16 tokens" in out
    assert len(re.findall(r"req\d \(T=", out)) == 4


def test_train_lm_learns_and_resumes(capsys, tmp_path):
    example = _example("torch_train_lm")
    argv = ["--device", "cpu", "--d-model", "32", "--layers", "2",
            "--ckpt-every", "20", "--ckpt-dir", str(tmp_path)]
    assert example.main(argv + ["--steps", "40"]) == 0
    out = capsys.readouterr().out
    first, last, uniform = map(float, re.search(
        r"loss: ([\d.]+) -> ([\d.]+) \(uniform floor ([\d.]+)\)",
        out).groups())
    assert last < first and last < uniform
    assert np.isclose(uniform, np.log(256), atol=1e-3)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000020", "step_00000040"]
    # the same command with more steps continues from the last checkpoint
    assert example.main(argv + ["--steps", "50"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored checkpoint at step 40" in out
    assert "step    40 loss" in out and "step     0 loss" not in out


def test_example_runs_as_a_script():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_serve_lm.py"), "--device",
         "cpu", "--prompt-len", "4", "--new-tokens", "2", "--batch", "2"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "served 2 requests, 4 tokens" in out.stdout
