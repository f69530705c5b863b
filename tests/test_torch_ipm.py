"""uno_tpu_torch's interior-point step, single-instance solve and batch
driver held against uno_tpu on the CPU; the device guards; the port's
independence from JAX; chip_smoke.py's main-path phase on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu_torch
from bench import _flagship_n
from uno_tpu.model.library import get_problem
from uno_tpu.model.nlp import nlp_from_functions as j_nlp
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers import ipm as jipm
from uno_tpu.solvers.batch import build_batch_ipm as j_build_batch_ipm
from uno_tpu_torch.interop import state_from_numpy, state_to_numpy
from uno_tpu_torch.model.library import flagship, hs015
from uno_tpu_torch.model.nlp import nlp_from_functions as t_nlp
from uno_tpu_torch.options import preset as t_preset
from uno_tpu_torch.solvers import ipm as tipm

REPO = Path(__file__).resolve().parent.parent
# one float64 outer iteration from the same state: the same formulas, with
# sums and AD products rounded in another order
STEP_TOL = 1e-10


def _infeasible_pair():
    """x0^2 + x1^2 + 1 = 0 has no solution: the IPM enters restoration."""
    kw = dict(x0=[2.0, 1.0], x_lb=[-10.0, 0.0], x_ub=[10.0, 10.0],
              c_lb=[0.0, 1.0], c_ub=[0.0, np.inf])
    jn = j_nlp("infeasible", lambda x: (x[0] - 1) ** 2 + x[1] ** 2,
               lambda x: jnp.array([x[0] ** 2 + x[1] ** 2 + 1.0, x[0] + x[1]]), **kw)
    tn = t_nlp("infeasible", lambda x: (x[0] - 1) ** 2 + x[1] ** 2,
               lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 + 1.0, x[0] + x[1]]), **kw)
    return jn, tn


_CASES = {}


def _case(name):
    """(jax NLP, torch NLP, x0 rows, params rows or None, jitted uno_tpu
    step, its prob/ws, opts), built once per test process."""
    if name not in _CASES:
        if name == "flagship":
            jn, x0, p = _flagship_n(4, 8)
            tn = flagship(4)[0]
            opts = dict(scale_functions=False)
        elif name == "hs001":       # unconstrained (m = 0), one bound
            jn = get_problem("hs001")
            tn = t_nlp("hs001", lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2
                       + (1.0 - x[0]) ** 2, None, x0=jn.x0, x_lb=jn.x_lb,
                       x_ub=jn.x_ub)
            x0, p, opts = jn.x0[None], None, {}
        elif name == "hs015":
            jn, tn = get_problem("hs015"), hs015()
            # the book start and a second one, to step two instances at once
            x0, p, opts = np.stack([jn.x0, jn.x0 + [0.5, 0.3]]), None, {}
        else:
            jn, tn = _infeasible_pair()
            x0, p, opts = jn.x0[None], None, {}
        jo, to = j_preset("ipopt", **opts), t_preset("ipopt", **opts)
        prob, ws, step, _ = jipm.build_ipm(jn, jo)
        _CASES[name] = (jn, tn, x0, p, jax.jit(step), prob, ws, jo, to)
    return _CASES[name]


def _jax_states(name, row, k):
    """uno_tpu's states of instance `row` after 0..k steps."""
    jn, _, x0, p, stepj, prob, ws, jo, _ = _case(name)
    x0_full = np.concatenate([x0[row], np.zeros(prob.n - jn.n)])
    params = None if p is None else jnp.asarray(p[row])
    s = jipm.canonicalize_state(jipm.make_initial_state(
        prob, ws, jo, x0=jnp.asarray(x0_full), params=params))
    out = [s]
    for _ in range(k):
        s = stepj(s)
        out.append(s)
    return out


def _to_fields(states):
    """uno_tpu states (one instance each) -> batch-first numpy fields."""
    fields = {}
    for name in tipm.IPMState._fields:
        vals = [getattr(s, name) for s in states]
        if name == "filter":
            fields[name] = tuple(np.stack([np.asarray(v[i]) for v in vals])
                                 for i in range(3))
        elif vals[0] is None:
            fields[name] = None
        else:
            fields[name] = np.stack([np.asarray(v) for v in vals])
    return fields


def _assert_states_close(got: dict, ref: dict):
    for name, r in ref.items():
        g = got[name]
        if r is None:
            assert g is None, name
            continue
        for gi, ri in (zip(g, r) if name == "filter" else [(g, r)]):
            np.testing.assert_allclose(gi, ri, rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("name,rows,k", [
    # two instances stepped as one batch, in the step that runs the
    # inertia correction from the book start
    ("hs015", (0, 1), 3),
    ("infeasible", (0,), 8),      # a step in feasibility restoration
])
def test_one_step_matches_from_the_same_state(name, rows, k):
    _, tn, *_, to = _case(name)
    before = [_jax_states(name, r, k + 1) for r in rows]
    start = state_from_numpy(_to_fields([b[k] for b in before]), "cpu")
    _, _, step = tipm.build_ipm(tn, to)
    got = state_to_numpy(step(start))
    _assert_states_close(got, _to_fields([b[k + 1] for b in before]))
    if name == "infeasible":
        assert int(before[0][k].phase) == 1


def test_interop_round_trip():
    fields = _to_fields(_jax_states("hs015", 0, 1))
    back = state_to_numpy(state_from_numpy(fields, "cpu"))
    _assert_states_close(back, fields)


@pytest.mark.parametrize("name,status,iterations", [
    ("hs015", "optimal", 17), ("hs001", "optimal", 25),
    ("infeasible", "algorithmic_error", 9)])
def test_single_instance_solve_matches(name, status, iterations):
    jn, tn, *_ = _case(name)
    states = _jax_states(name, 0, iterations)
    # uno_tpu's own outer loop, step by step, stops here
    assert int(states[-2].status) == jipm.RUNNING
    assert jipm.STATUS_NAMES[int(states[-1].status)] == status
    res = uno_tpu_torch.solve(tn, preset="ipopt", device="cpu")
    assert (res.status, res.iterations) == (status, iterations)
    if name == "hs015":
        assert res.objective == pytest.approx(306.5, rel=1e-6)
        jf = float(jn.objective(states[-1].x[: jn.n]))
        assert res.objective == pytest.approx(jf, rel=1e-9)


def test_flagship_batch_matches_uno_tpu_batch():
    B = 16
    jn, x0, p = _flagship_n(B, 8)
    jo = j_preset("ipopt", scale_functions=False)
    _, run = j_build_batch_ipm(jn, jo, params_example=jnp.asarray(p[0]))
    ref = run(jnp.asarray(x0), jnp.asarray(p))
    tn, tx0, tp = flagship(B)
    res = uno_tpu_torch.solve_batch(tn, tx0, tp, preset="ipopt", device="cpu",
                                    scale_functions=False)
    assert res.status.tolist() == np.asarray(ref.status).tolist()
    assert res.iterations.tolist() == np.asarray(ref.iteration).tolist()
    np.testing.assert_allclose(res.x, np.asarray(ref.x)[:, :8], atol=1e-8)
    assert res.num_solved == B


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nlp, x0, p = flagship(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uno_tpu_torch.solve_batch(nlp, x0, p, preset="ipopt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uno_tpu_torch.solve(hs015(), preset="ipopt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uno_tpu_torch.solve(hs015(), preset="filtersqp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uno_tpu_torch.solve(hs015(), preset="byrd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uno_tpu_torch.solve_batch(nlp, x0, p, preset="byrd")
    # on the CPU, byrd reaches the fused byrd driver
    from uno_tpu_torch.solvers import sqp_fused

    class Routed(Exception):
        pass

    def routed(*args, **kwargs):
        raise Routed

    monkeypatch.setattr(sqp_fused, "solve_byrd_fused", routed)
    with pytest.raises(Routed):
        uno_tpu_torch.solve(hs015(), preset="byrd", device="cpu")


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"          # any import of jax fails
        "import uno_tpu_torch, uno_tpu_torch.interop, chip_smoke\n"
        "import uno_tpu_torch.linalg.cuda_ldlt, uno_tpu_torch.model.library\n"
        "import uno_tpu_torch.solvers.qp, uno_tpu_torch.solvers.sqp_fused\n"
        "import uno_tpu_torch.solvers.sqp\n"
        "import uno_tpu_torch.solvers.batch, uno_tpu_torch.api\n"
        "import uno_tpu_torch.io.nl, uno_tpu_torch.model.library_nl\n"
        "import uno_tpu_torch.__main__\n"
        "import uno_tpu_torch.linalg.banded, uno_tpu_torch.linalg.banded_kkt\n"
        "import uno_tpu_torch.linalg.condensed, uno_tpu_torch.linalg.sparse_ldlt\n"
        "import uno_tpu_torch.linalg.sparse_kkt, uno_tpu_torch.model.library_cutest\n"
        "import uno_tpu_torch.parallel, uno_tpu_torch.parallel.group\n"
        "import uno_tpu_torch.parallel.sharding, uno_tpu_torch.parallel.schur\n"
        "import uno_tpu_torch.parallel.dist_ldlt, uno_tpu_torch.parallel.dryrun\n"
        "import uno_tpu_torch.solvers.structured\n"
        "bad = [m for m in sys.modules if m == 'uno_tpu' or m.startswith('uno_tpu.')\n"
        "       or (m.startswith('jax.') or m == 'jax') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_main_path_phase_on_cpu():
    import chip_smoke
    out = chip_smoke.phase_main_path(device="cpu", batch=16)
    assert out["solved"] == 16
    assert out["iterations_equal"] == 16
    assert out["launches"] == 0          # the CPU runs the plain versions
    assert set(out["calls_by_route"].values()) == {0}


def test_chip_smoke_large_optimum_matches_a_cpu_solve():
    """The closed form chip_smoke.py holds its large single instance to,
    against the port's own solve of the same family at a small n."""
    import chip_smoke
    from uno_tpu_torch.model.library import flagship
    res = uno_tpu_torch.solve(flagship(1, n=16)[0], preset="ipopt", device="cpu")
    f_star, x_star = chip_smoke.large_optimum(16)
    assert res.status == "optimal"
    assert abs(res.objective - f_star) <= chip_smoke.LARGE_F_ATOL
    np.testing.assert_allclose(res.x, x_star, atol=1e-6)


def test_single_solve_reports_every_iteration(capsys):
    from uno_tpu_torch.utils.callbacks import RecordingCallbacks
    rec = RecordingCallbacks()
    res = uno_tpu_torch.solve(hs015(), preset="ipopt", device="cpu",
                              logger="INFO", callbacks=rec, history=True)
    table = capsys.readouterr().out
    assert res.status == "optimal"
    assert len(res.history) == res.iterations + 1
    assert len(rec.primals) == 1 and np.allclose(rec.primals[0], res.x)
    assert "objective" in table and table.count("│ OPT") >= res.iterations


@pytest.mark.parametrize("case", ["empty_box", "evaluation_error"])
def test_preflight_matches_uno_tpu(case):
    import uno_tpu
    if case == "empty_box":
        kw = dict(x0=[0.0, 0.0], x_lb=[1.0, 0.0], x_ub=[0.0, 1.0])
        jf, tf = (lambda x: jnp.sum(x * x)), (lambda x: torch.sum(x * x))
    else:                     # log of a negative number at every start
        kw = dict(x0=[-1.0, 0.0], x_lb=[-3.0, -1.0], x_ub=[-2.0, 1.0])
        jf, tf = (lambda x: jnp.log(x[0]) + x[1]), (lambda x: torch.log(x[0]) + x[1])
    ref = uno_tpu.solve(j_nlp(case, jf, None, **kw), preset="ipopt")
    got = uno_tpu_torch.solve(t_nlp(case, tf, None, **kw), preset="ipopt",
                              device="cpu")
    assert (got.status, got.iterations) == (ref.status, ref.iterations)
    assert got.primal_feasibility == ref.primal_feasibility
