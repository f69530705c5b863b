"""`python -m uno_tpu_torch` (the uno_ampl equivalent) on the CPU, after
tests/test_cli.py: solves of a copy of hs015.nl that write the .sol file,
an unknown option, the help, and the option layering held against
uno_tpu's command line."""

import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import uno_tpu
import uno_tpu.__main__ as j_main
import uno_tpu_torch
import uno_tpu_torch.__main__ as t_main
from uno_tpu_torch.io import read_nl

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "nl_corpus" / "hs015.nl"


def run_cli(tmp_path, *args):
    nl = tmp_path / "hs015.nl"
    shutil.copy(FIXTURE, nl)
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    return subprocess.run(
        [sys.executable, "-m", "uno_tpu_torch", str(nl), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path), nl


def read_sol(path, n, m):
    """(message, x, y) of a .sol file written by write_sol."""
    lines = path.read_text().splitlines()
    values = np.array([float(v) for v in lines[-(n + m):]])
    return lines[0], values[m:], values[:m]


@pytest.mark.parametrize("preset", ["ipopt", "byrd"])
def test_cli_solves_and_writes_sol(tmp_path, preset):
    proc, nl = run_cli(tmp_path, "-AMPL", f"preset={preset}", "device=cpu",
                       "logger=SILENT")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "status:           optimal" in proc.stdout
    ref = uno_tpu_torch.solve(read_nl(FIXTURE), preset=preset, device="cpu")
    printed = next(line for line in proc.stdout.splitlines()
                   if line.startswith("objective:"))
    # printed with 12 significant digits
    assert float(printed.split()[1]) == pytest.approx(ref.objective, rel=1e-11)
    assert ref.objective == pytest.approx(306.5, rel=1e-6)
    message, x, y = read_sol(nl.with_suffix(".sol"), 2, 2)
    assert "optimal" in message
    # %.17g round-trips a float64, and the same solve on the same device
    # gives the same numbers
    np.testing.assert_array_equal(x, ref.x)
    np.testing.assert_array_equal(y, ref.y)


def test_cli_unknown_option(tmp_path):
    proc, _ = run_cli(tmp_path, "frobnicate=1", "device=cpu")
    assert proc.returncode == 2
    assert "unknown option" in proc.stderr


def test_cli_help():
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-m", "uno_tpu_torch", "--help"],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0
    assert "presets:" in proc.stdout and "byrd" in proc.stdout


def test_option_file_layering(tmp_path):
    """Option file applies between defaults and CLI (Options.cpp:92-113;
    layering defaults <- option file <- preset <- command line)."""
    opt = tmp_path / "uno.options"
    opt.write_text("# comment line\nmax_iterations 3\nlogger SILENT\n")
    proc, _ = run_cli(tmp_path, f"option_file={opt}", "preset=ipopt", "device=cpu")
    assert proc.returncode == 1, proc.stderr[-2000:]   # hits the 3-iter cap
    assert "iteration_limit" in proc.stdout
    # CLI overrides the file (last layer wins)
    proc2, _ = run_cli(tmp_path, f"option_file={opt}", "preset=ipopt",
                       "max_iterations=500", "device=cpu")
    assert proc2.returncode == 0, proc2.stderr[-2000:]
    assert "status:           optimal" in proc2.stdout


class _Stop(Exception):
    pass


def _options_of(module, solve_owner, monkeypatch, argv):
    """The Options that `module.main(argv)` hands to solve()."""
    seen = []

    def fake_solve(nlp, options=None, **kwargs):
        seen.append(options)
        raise _Stop

    monkeypatch.setattr(solve_owner, "solve", fake_solve)
    with pytest.raises(_Stop):
        module.main(argv)
    return seen[0]


@pytest.mark.parametrize("layers", [
    ("preset=byrd",),
    ("option_file", "preset=filtersqp", "max_iterations=500", "tolerance=1e-7"),
    ("option_file", "LS_scale_duals_with_step_length=yes"),
])
def test_layering_gives_uno_tpu_options(tmp_path, monkeypatch, layers):
    opt = tmp_path / "uno.options"
    opt.write_text("# comment line\nmax_iterations 3\nlogger SILENT\n"
                   "l1_relaxation_initial_parameter 0.5\n")
    argv = [str(FIXTURE), "-AMPL"] + [f"option_file={opt}" if a == "option_file" else a
                                      for a in layers]
    # uno_tpu's main points JAX's compilation cache at HOME; this process
    # keeps the cache it has
    monkeypatch.setattr(jax.config, "update", lambda *args: None)
    j_opts = _options_of(j_main, uno_tpu, monkeypatch, argv)
    t_opts = _options_of(t_main, uno_tpu_torch, monkeypatch, argv + ["device=cpu"])
    assert dataclasses.asdict(t_opts) == dataclasses.asdict(j_opts)
