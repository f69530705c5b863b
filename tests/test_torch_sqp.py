"""uno_tpu_torch's fused trust-region SQP family (filtersqp, funnelsqp,
filterslp) held against uno_tpu on the CPU: one step from the same state in
both phases, whole single-instance solves, and a flagship batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu_torch
from bench import _flagship_n
from uno_tpu.model.library import get_problem as j_problem
from uno_tpu.model.nlp import nlp_from_functions as j_nlp
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers import sqp_fused as jsqp
from uno_tpu.solvers.batch import build_batch_sqp as j_build_batch_sqp
from uno_tpu.solvers.ipm import canonicalize_state
from uno_tpu_torch.interop import state_from_numpy, state_to_numpy
from uno_tpu_torch.model.library import flagship, known_optimum, problem_names
from uno_tpu_torch.model.library import get_problem as t_problem
from uno_tpu_torch.model.nlp import nlp_from_functions as t_nlp
from uno_tpu_torch.solvers import sqp_fused as tsqp

# one float64 attempt from the same state: the same formulas, with sums,
# matrix products and AD products rounded in another order (the step
# tolerance of tests/test_torch_ipm.py)
STEP_TOL = 1e-10
# a whole solve: equal status and iterations, then x within X_TOL and the
# objective within F_RTOL of uno_tpu's (the largest gaps seen are 1.4e-14
# in x and 2e-15 relative in f)
X_TOL = 1e-10
F_RTOL = 1e-10


def _ring(mk, stack):
    """tests/test_sqp_fused.py's problem whose first QP is infeasible: the
    solver enters feasibility restoration and comes back."""
    return mk("ring", lambda x: (x[0] - 2.0) ** 2 + (x[1] - 2.0) ** 2,
              lambda x: stack([x[0] ** 2 + x[1] ** 2]), x0=[0.1, 0.0],
              c_lb=[1.0], c_ub=[np.inf])


def _infeas(mk, stack):
    """tests/test_sqp_fused.py's infeasible problem: x^2 + 1 <= 0."""
    return mk("infeas", lambda x: x[0], lambda x: stack([x[0] ** 2 + 1.0]),
              x0=[1.0], c_lb=[-np.inf], c_ub=[0.0])


def _problems(name):
    if name == "ring":
        return _ring(j_nlp, jnp.array), _ring(t_nlp, torch.stack), dict(TR_radius=0.5)
    if name == "infeas":
        return (_infeas(j_nlp, jnp.array), _infeas(t_nlp, torch.stack),
                dict(max_iterations=200))
    return j_problem(name), t_problem(name), {}


_TRACES = {}


def _trace(preset, name):
    """uno_tpu's states of the whole solve, its jitted step called until
    the status leaves RUNNING (what its while_loop runs), and the problems
    and options of both packages; built once per test process."""
    key = (preset, name)
    if key not in _TRACES:
        jn, tn, over = _problems(name)
        jo = j_preset(preset, **over)
        to = uno_tpu_torch.preset(preset, **over)
        prob, ws, step, _ = jsqp.build_sqp_fused(jn, jo)
        stepj = jax.jit(step)
        s = canonicalize_state(jsqp.make_initial_sqp_state(prob, ws, jo))
        states = [s]
        while int(s.status) == jsqp.RUNNING:
            s = stepj(s)
            states.append(s)
        _TRACES[key] = (jn, tn, to, states)
    return _TRACES[key]


def _to_fields(states):
    """uno_tpu states (one instance each) -> batch-first numpy fields."""
    fields = {}
    for name in tsqp.SQPFState._fields:
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


@pytest.mark.parametrize("preset", ["filtersqp", "funnelsqp", "filterslp"])
def test_one_step_in_both_phases_matches_from_the_same_state(preset):
    """One batch holds an instance in feasibility restoration and one in
    the optimality phase (ring's trace): each QP gets its own phase's
    instances, and each instance steps as uno_tpu steps it alone."""
    _, tn, to, states = _trace(preset, "ring")
    phases = [int(s.phase) for s in states]
    k_feas = phases.index(1)
    k_opt = phases.index(0, k_feas)
    assert int(states[k_opt].attempts) > 0
    start = state_from_numpy(_to_fields([states[k_opt], states[k_feas]]), "cpu",
                             tsqp.SQPFState)
    _, _, step = tsqp.build_sqp_fused(tn, to)
    got = state_to_numpy(step(start))
    _assert_states_close(got, _to_fields([states[k_opt + 1], states[k_feas + 1]]))


def test_sqp_state_interop_round_trip():
    fields = _to_fields(_trace("filtersqp", "ring")[3][:3])
    back = state_to_numpy(state_from_numpy(fields, "cpu", tsqp.SQPFState))
    _assert_states_close(back, fields)


@pytest.mark.parametrize("preset,name", [
    ("filtersqp", "hs015"), ("filtersqp", "hs071"), ("filtersqp", "hs035"),
    ("filtersqp", "hs038"), ("filtersqp", "ring"), ("filtersqp", "infeas"),
    ("funnelsqp", "hs015"), ("filterslp", "hs015")])
def test_single_instance_solve_matches(preset, name):
    jn, tn, to, states = _trace(preset, name)
    final = states[-1]
    status = jsqp.SQP_STATUS_NAMES[int(final.status)]
    iterations = int(final.iteration)
    x_ref = np.asarray(final.x)[: jn.n]
    f_ref = float(jn.objective(jnp.asarray(x_ref)))
    res = uno_tpu_torch.solve(tn, options=to, device="cpu")
    assert (res.status, res.iterations) == (status, iterations)
    np.testing.assert_allclose(res.x, x_ref, rtol=0, atol=X_TOL)
    assert res.objective == pytest.approx(f_ref, rel=F_RTOL, abs=1e-300)
    if name in problem_names() and status == "optimal":
        assert res.objective == pytest.approx(known_optimum(name), rel=1e-6,
                                              abs=1e-6)
    if name == "ring":
        assert 1 in [int(s.phase) for s in states]       # restoration ran
    if name == "infeas":
        assert status == "infeasible_stationary_point"


SQP_OPTS = dict(scale_functions=False, kkt_dtype="float32", max_iterations=60)
# of the flagship family at B=8,192 (chip_smoke.py's SQP batch), the
# instances that filtersqp does not solve: 653 reaches the iteration cap,
# the others end feasible_small_step
UNSOLVED = [653, 2605, 2666, 4812, 5402, 6092, 6811]
_BATCH_RUN = {}


@pytest.mark.parametrize("rows", ["first", "unsolved"])
def test_flagship_filtersqp_batch_matches_uno_tpu_batch(rows):
    """16 instances of the flagship family through both packages' batched
    filtersqp: the first 16 (all solved), and the 7 that neither solves at
    B=8,192 with 9 solved ones beside them."""
    B = 16
    idx = np.arange(B) if rows == "first" else np.array(UNSOLVED + list(range(9)))
    jn, x0, p = _flagship_n(8192, 8)
    if "run" not in _BATCH_RUN:
        _BATCH_RUN["run"] = j_build_batch_sqp(
            jn, j_preset("filtersqp", **SQP_OPTS), params_example=jnp.asarray(p[0]))[1]
    ref = _BATCH_RUN["run"](jnp.asarray(x0[idx]), jnp.asarray(p[idx]))
    tn, tx0, tp = flagship(8192)
    res = uno_tpu_torch.solve_batch(tn, tx0[idx], tp[idx], preset="filtersqp",
                                    device="cpu", **SQP_OPTS)
    assert res.status.tolist() == np.asarray(ref.status).tolist()
    assert res.iterations.tolist() == np.asarray(ref.iteration).tolist()
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=0, atol=X_TOL)
    solved = (res.status == tsqp.OPTIMAL) | (res.status == tsqp.ALMOST_OPTIMAL)
    assert solved.tolist() == [int(i) not in UNSOLVED for i in idx]


def test_byrd_and_host_drivers_route(monkeypatch):
    """sqp_driver="host" reaches the host driver (solvers/sqp.solve_sqp)
    for each SQP preset; byrd routes to the fused byrd driver in solve and
    solve_batch, and is_byrd_family agrees with uno_tpu's on every
    preset."""
    from uno_tpu_torch.solvers import sqp as host_sqp
    tn = t_problem("hs015")

    class Routed(Exception):
        pass

    def routed(*args, **kwargs):
        raise Routed

    with monkeypatch.context() as host:
        host.setattr(host_sqp, "solve_sqp", routed)
        for name in ("filtersqp", "funnelsqp", "filterslp", "byrd"):
            with pytest.raises(Routed):
                uno_tpu_torch.solve(tn, preset=name, sqp_driver="host", device="cpu")

    monkeypatch.setattr(tsqp, "solve_byrd_fused", routed)
    monkeypatch.setattr(tsqp, "build_byrd_fused", routed)
    with pytest.raises(Routed):
        uno_tpu_torch.solve(tn, preset="byrd", device="cpu")
    nlp, x0, p = flagship(2)
    with pytest.raises(Routed):
        uno_tpu_torch.solve_batch(nlp, x0, p, preset="byrd", device="cpu")
    assert uno_tpu_torch.solve(tn, preset="filtersqp", device="cpu").status == "optimal"
    from uno_tpu.api import is_byrd_family as j_is_byrd
    from uno_tpu_torch.api import is_byrd_family as t_is_byrd
    for name in ("ipopt", "filtersqp", "byrd", "funnelsqp", "filterslp"):
        assert t_is_byrd(uno_tpu_torch.preset(name)) == j_is_byrd(j_preset(name))
