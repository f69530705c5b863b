"""tools/sweep_torch.py, the port's library sweep, against tools/sweep.py
on the CPU: the same rows for three small keys under two presets, an output
tools/merge_sweeps.py reads; and tests/fixtures/torch_registry_ref.json
(uno_tpu's results that chip_smoke.py's registry phase holds the card
to) covering exactly the port's n + m <= 30 tier."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from uno_tpu_torch.model.library import get_problem, problem_names

REPO = Path(__file__).resolve().parent.parent
KEYS = ("beale", "bt1", "hs035")
PRESETS = ("ipopt", "filtersqp")


def _sweep_py():
    spec = importlib.util.spec_from_file_location("uno_tpu_sweep", REPO / "tools" / "sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rows_match_tools_sweep(tmp_path):
    out = tmp_path / "sweep_torch.json"
    run = subprocess.run(
        [sys.executable, str(REPO / "tools" / "sweep_torch.py"), *PRESETS,
         "--names", ",".join(KEYS), "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    got = json.loads(out.read_text())
    assert "partial" not in got
    sweep = _sweep_py()
    for preset in PRESETS:
        ref = sweep.run_preset(preset, list(KEYS))
        rows = got["rows"][preset]
        assert [r["name"] for r in rows] == [r["name"] for r in ref] == list(KEYS)
        for a, b in zip(rows, ref):
            assert set(a) == set(b)
            assert (a["status"], a["iters"], a["nfev"], a["solved"]) \
                == (b["status"], b["iters"], b["nfev"], b["solved"])
            assert abs(a["f"] - b["f"]) <= 1e-8 * max(1.0, abs(b["f"]))
            assert abs(a["err"] - b["err"]) <= 1e-8
        summary = got["summary"][preset]
        assert summary["platform"] == "cpu"
        assert summary["solved"] == sum(r["solved"] for r in ref)
    merged = tmp_path / "merged.json"
    run = subprocess.run([sys.executable, str(REPO / "tools" / "merge_sweeps.py"),
                          str(merged), str(out)], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    assert json.loads(merged.read_text())["summary"]["ipopt"]["total"] == len(KEYS)


def test_cuda_without_a_card_raises(tmp_path):
    run = subprocess.run(
        [sys.executable, str(REPO / "tools" / "sweep_torch.py"), "ipopt",
         "--names", "hs015", "--out", str(tmp_path / "x.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr
    assert not (tmp_path / "x.json").exists()


def test_registry_reference_covers_the_small_tier():
    with open(REPO / "tests" / "fixtures" / "torch_registry_ref.json") as fh:
        ref = json.load(fh)
    assert ref["max_nm"] == 30 and "partial" not in ref
    tier = [k for k in problem_names() if (lambda p: p.n + p.m)(get_problem(k)) <= 30]
    assert sorted(ref["rows"]) == tier
    for name in tier:
        nlp = get_problem(name)
        assert (ref["rows"][name]["n"], ref["rows"][name]["m"]) == (nlp.n, nlp.m)
    assert np.sum([r["solved"] for r in ref["rows"].values()]) == 247


def test_cliff_filtersqp_parts_from_uno_tpu_at_iteration_7():
    """The sweep's one SQP key that uno_tpu solves and the port does not
    for a reason other than the time limit (ROADMAP.md queue 3): cliff
    under filtersqp.  The two runs are equal bit for bit while the trust
    region halves from 10 to 0.15625; at that radius uno_tpu accepts the
    step (f 4.85e8 -> 1.78e8) and the port rejects it (its trust-region QP
    has curvature 1.9e11 across the cliff and 2e-4 along it).  uno_tpu's
    own run takes 34 iterations from x0 and 622 from x0 moved by one
    ulp."""
    import dataclasses

    import uno_tpu
    import uno_tpu_torch
    from uno_tpu.model import library as j_lib

    jn = j_lib.get_problem("cliff")
    ref = uno_tpu.solve(jn, preset="filtersqp", max_iterations=8, history=True)
    got = uno_tpu_torch.solve(get_problem("cliff"), preset="filtersqp", device="cpu",
                              max_iterations=8, history=True)
    for k in range(7):
        assert np.array_equal(got.history[k].x[0].numpy(), np.asarray(ref.history[k].x))
        assert float(got.history[k].radius[0]) == float(ref.history[k].radius) \
            == 10.0 / 2 ** k
    assert float(ref.history[7].f_cur) < 2e8 < float(got.history[7].f_cur)
    moved = uno_tpu.solve(dataclasses.replace(jn, x0=np.nextafter(jn.x0, np.inf)),
                          preset="filtersqp", max_iterations=2000)
    assert (moved.status, moved.iterations) == ("optimal", 622)
