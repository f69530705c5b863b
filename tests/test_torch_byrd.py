"""uno_tpu_torch's byrd (the fused line-search SQP with l1 relaxation and
the l1 merit) held against uno_tpu's on the CPU: single-instance solves,
models read from .nl files by both packages' readers, a batch instance for
instance, and one step of a flagship batch from the same state."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu_torch
from bench import _flagship_n
from uno_tpu.io import read_nl as j_read_nl
from uno_tpu.model.library import get_problem as j_problem
from uno_tpu.model.nlp import nlp_from_functions as j_nlp
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers import sqp_fused as jsqp
from uno_tpu.solvers.batch import build_batch_sqp as j_build_batch_sqp
from uno_tpu.solvers.batch import solve_batch as j_solve_batch
from uno_tpu.solvers.ipm import canonicalize_state
from uno_tpu_torch.interop import state_from_numpy, state_to_numpy
from uno_tpu_torch.io import read_nl as t_read_nl
from uno_tpu_torch.model.library import OPTIMA, flagship
from uno_tpu_torch.model.library import get_problem as t_problem
from uno_tpu_torch.model.nlp import nlp_from_functions as t_nlp
from uno_tpu_torch.solvers import sqp_fused as tsqp

# a whole solve: equal status, iterations and steering QPs, then x and the
# objective within SOLVE_TOL of uno_tpu's (relative for the objective)
SOLVE_TOL = 1e-8
# one float64 outer iteration from the same state: the same formulas, with
# sums, matrix products and AD products rounded in another order (the step
# tolerance of tests/test_torch_sqp.py)
STEP_TOL = 1e-10
CORPUS = Path(__file__).resolve().parent / "fixtures" / "nl_corpus"
BATCH_OPTS = dict(scale_functions=False, kkt_dtype="float32", max_iterations=60)


def _infeas(mk, stack):
    """tests/test_sqp_fused.py's infeasible model: x^2 + 1 <= 0."""
    return mk("infeas_b", lambda x: x[0], lambda x: stack([x[0] ** 2 + 1.0]),
              x0=[1.0], c_lb=[-np.inf], c_ub=[0.0])


def _problems(name):
    """(uno_tpu's model, the port's, option overrides)."""
    if name == "infeas":
        return (_infeas(j_nlp, jnp.array), _infeas(t_nlp, torch.stack),
                dict(max_iterations=200))
    if name.endswith(".nl"):
        path = CORPUS / name
        return j_read_nl(path), t_read_nl(path), {}
    return j_problem(name), t_problem(name), {}


@pytest.mark.parametrize("name", ["hs015", "hs071", "hs021.nl", "polak5.nl",
                                  "hs038", "infeas"])
def test_single_instance_solve_matches(name):
    jn, tn, over = _problems(name)
    ref = jsqp.solve_byrd_fused(jn, j_preset("byrd", **over))
    res = uno_tpu_torch.solve(tn, preset="byrd", device="cpu", **over)
    assert (res.status, res.iterations, res.num_subproblems_solved) == \
        (ref.status, ref.iterations, ref.num_subproblems_solved)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=SOLVE_TOL)
    assert res.objective == pytest.approx(ref.objective, rel=SOLVE_TOL, abs=1e-300)
    if name == "infeas":
        assert res.status == "infeasible_stationary_point"
    else:
        assert res.status == "optimal"
        assert res.num_subproblems_solved >= res.iterations
    if name in OPTIMA:
        assert res.objective == pytest.approx(OPTIMA[name], rel=1e-6, abs=1e-6)


def _batch_family(mk, total):
    """tests/test_sqp_fused.py's byrd batch family: min |x - p|^2 s.t.
    sum(x) >= 1, x >= 0."""
    return mk("batchfam_b", lambda x, p: total((x - p) ** 2),
              lambda x, p: (jnp.array if mk is j_nlp else torch.stack)([total(x) - 1.0]),
              x0=np.full(4, 0.5), x_lb=np.zeros(4), x_ub=np.full(4, np.inf),
              c_lb=[0.0], c_ub=[np.inf], params=np.zeros(4))


def test_batch_matches_instance_for_instance():
    B = 8
    params = np.random.default_rng(11).uniform(-0.5, 1.0, (B, 4))
    x0 = np.tile(np.full(4, 0.5), (B, 1))
    ref = j_solve_batch(_batch_family(j_nlp, jnp.sum), x0_batch=x0,
                        params_batch=jnp.asarray(params), preset="byrd")
    res = uno_tpu_torch.solve_batch(_batch_family(t_nlp, torch.sum), x0, params,
                                    preset="byrd", device="cpu")
    assert res.status.tolist() == np.asarray(ref.status).tolist()
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=0, atol=SOLVE_TOL)
    assert res.num_solved == B
    # instance 5 alone gives what the batch gave it
    single = uno_tpu_torch.solve(dataclasses.replace(
        _batch_family(t_nlp, torch.sum), params=params[5]), preset="byrd", device="cpu")
    assert single.iterations == res.iterations[5]
    np.testing.assert_allclose(single.x, res.x[5], rtol=0, atol=1e-12)


_FLAGSHIP = {}


def _flagship_states(B=16, steps=3):
    """uno_tpu's byrd states of a flagship batch (options of bench.py's SQP
    batch): the initial one and `steps` vmapped steps, each stepping every
    instance as uno_tpu's step does (finished ones included)."""
    if "states" not in _FLAGSHIP:
        jn, x0, p = _flagship_n(B, 8)
        opts = j_preset("byrd", **BATCH_OPTS)
        prob, ws, step, _ = jsqp.build_byrd_fused(jn, opts)
        init = jax.vmap(lambda x, q: canonicalize_state(
            jsqp.make_initial_byrd_state(prob, ws, opts, x0=x, params=q)))
        s = init(jnp.asarray(x0), jnp.asarray(p))
        stepj = jax.jit(jax.vmap(step))
        states = [s]
        for _ in range(steps):
            s = stepj(s)
            states.append(s)
        _FLAGSHIP["states"] = states
    return _FLAGSHIP["states"]


def _fields(state):
    """A uno_tpu state's fields as writable numpy arrays."""
    return {name: None if getattr(state, name) is None
            else np.array(getattr(state, name)) for name in tsqp.ByrdFState._fields}


@pytest.mark.parametrize("k", [0, 2])
def test_one_step_of_a_flagship_batch_matches_from_the_same_state(k):
    """From uno_tpu's state after k steps (k = 2: some instances have
    finished and only their residuals move), one port step equals
    uno_tpu's, field by field."""
    states = _flagship_states()
    start = _fields(states[k])
    if k == 2:
        assert (start["status"] != tsqp.RUNNING).any() and (start["status"] == tsqp.RUNNING).any()
    tn = flagship(16)[0]
    _, _, step = tsqp.build_byrd_fused(tn, uno_tpu_torch.preset("byrd", **BATCH_OPTS))
    got = state_to_numpy(step(state_from_numpy(start, "cpu", tsqp.ByrdFState)))
    for name, want in _fields(states[k + 1]).items():
        np.testing.assert_allclose(got[name], want, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)


def test_byrd_state_interop_round_trip():
    fields = _fields(_flagship_states()[1])
    back = state_to_numpy(state_from_numpy(fields, "cpu", tsqp.ByrdFState))
    assert set(back) == set(fields)
    for name, want in fields.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)


def test_chip_smoke_byrd_batch_phase_on_cpu():
    import chip_smoke
    out = chip_smoke.phase_byrd_batch(device="cpu", batch=16, rerun=16)
    assert out["preset"] == "byrd" and out["solved"] == 16
    assert out["iterations_equal"] == 16 and out["x_max_abs_diff"] == 0.0
    assert out["qps_per_iteration"] >= 1.0
    assert out["launches"] == 0          # the CPU runs the plain versions


def test_flagship_byrd_batch_unsolved_instances_match_uno_tpu_batch():
    """The 9 instances of the flagship family at B=8,192 that byrd does not
    solve (chip_smoke.py's BYRD_UNSOLVED: uno_tpu and the port end them at
    the 60-iteration cap), with 7 solved ones beside them, through both
    packages' batched byrd: instance for instance."""
    import chip_smoke
    idx = np.array(list(chip_smoke.BYRD_UNSOLVED) + list(range(7)))
    jn, x0, p = _flagship_n(8192, 8)
    run = j_build_batch_sqp(jn, j_preset("byrd", **BATCH_OPTS),
                            params_example=jnp.asarray(p[0]))[1]
    ref = run(jnp.asarray(x0[idx]), jnp.asarray(p[idx]))
    tn, tx0, tp = flagship(8192)
    res = uno_tpu_torch.solve_batch(tn, tx0[idx], tp[idx], preset="byrd",
                                    device="cpu", **BATCH_OPTS)
    assert res.status.tolist() == np.asarray(ref.status).tolist()
    assert res.iterations.tolist() == np.asarray(ref.iteration).tolist()
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=0, atol=SOLVE_TOL)
    assert res.status.tolist() == [tsqp.MAX_ITERATIONS] * 9 + [tsqp.OPTIMAL] * 7
    assert res.iterations[:9].tolist() == [BATCH_OPTS["max_iterations"]] * 9
