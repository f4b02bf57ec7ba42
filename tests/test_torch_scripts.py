"""The port's launch scripts (``scripts/*_torch.sh``): one beside each of
the JAX package's scripts, each valid bash (``bash -n``), and each
``python`` call it makes, run with a stand-in ``python`` that records its
arguments, parsed by the port CLI's own ``parse_args``; the training
scripts pass ``--n_sp`` through."""

import glob
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
JAX_SCRIPTS = sorted(p for p in glob.glob(os.path.join(SCRIPTS, "*.sh"))
                     if not p.endswith("_torch.sh"))
# records each call's arguments, one a line, in a file of its own
STAND_IN = """#!/bin/sh
for a in "$@"; do printf '%s\\n' "$a"; done > "$CALLS_DIR/call.$$"
"""
TORCHRUN = ["-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2"]


def port_script(path: str) -> str:
    return path[:-len(".sh")] + "_torch.sh"


def calls(script: str, tmp_path) -> list[list[str]]:
    """The argument lists of the ``python`` calls ``script`` makes, run
    with the stand-in on two cards, N_SP 2 and placeholder arguments (an
    experiment directory and a checkpoint, or part 0 of 8)."""
    bin_dir, calls_dir = tmp_path / "bin", tmp_path / "calls"
    bin_dir.mkdir()
    calls_dir.mkdir()
    (bin_dir / "python").write_text(STAND_IN)
    (bin_dir / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               CALLS_DIR=str(calls_dir), NPROC="2", N_SP="2")
    args = (["0", "8"] if os.path.basename(script).startswith("extract")
            else ["exp_dir", "ckpt"])
    r = subprocess.run(["bash", script, *args],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    return [f.read_text().splitlines() for f in sorted(calls_dir.iterdir())]


def test_a_port_script_beside_each_jax_script():
    assert len(JAX_SCRIPTS) == 15
    assert sorted(glob.glob(os.path.join(SCRIPTS, "*_torch.sh"))) == sorted(
        port_script(p) for p in JAX_SCRIPTS)


@pytest.mark.parametrize("jax_script", [os.path.basename(p)
                                        for p in JAX_SCRIPTS])
def test_port_script_parses(jax_script, tmp_path, monkeypatch):
    script = port_script(os.path.join(SCRIPTS, jax_script))
    r = subprocess.run(["bash", "-n", script], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    made = calls(script, tmp_path)
    assert made
    for argv in made:
        if argv[:len(TORCHRUN)] == TORCHRUN:
            argv = argv[len(TORCHRUN):]
        else:
            # the extraction scripts run a process a card themselves
            assert jax_script.startswith("extract"), argv
        cli = argv[0]
        assert cli.endswith("_torch.py") and os.path.exists(
            os.path.join(REPO, cli)), cli
        monkeypatch.setattr(sys, "argv", argv)
        args = importlib.import_module(cli[:-len(".py")]).parse_args()
        if cli == "train_torch.py":
            assert args.n_sp == 2
        if cli == "eval_torch.py":
            assert args.multihost
        if jax_script.startswith("extract"):
            assert args.device.startswith("cuda:")
    if jax_script.startswith("extract"):
        assert sorted(a[a.index("--part") + 1] for a in made) == ["0", "1"]
