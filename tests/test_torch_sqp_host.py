"""uno_tpu_torch's host SQP driver (solvers/sqp.py) held against uno_tpu's
solve_sqp on the CPU: the five presets with sqp_driver="host", the mixes
only the host driver runs (a line search with feasibility restoration, a
trust region with the l1 relaxation), an infeasible model, history and the
callbacks, the time limit and one iteration from the same iterate.  The
multiplier fit above dim 64 is in tests/test_torch_qp_fit.py."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu
import uno_tpu_torch
from uno_tpu.io import read_nl as j_read_nl
from uno_tpu.model.library import get_problem as j_problem
from uno_tpu.model.nlp import nlp_from_functions as j_nlp
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers import sqp as jsqp
from uno_tpu_torch.interop import sqp_iterate_from
from uno_tpu_torch.io import read_nl as t_read_nl
from uno_tpu_torch.model.library import get_problem as t_problem
from uno_tpu_torch.model.nlp import nlp_from_functions as t_nlp
from uno_tpu_torch.solvers import sqp as tsqp
from uno_tpu_torch.utils.callbacks import UserCallbacks

PRESETS = ("ipopt", "filtersqp", "funnelsqp", "filterslp", "byrd")
# a whole solve: equal status, iterations and QPs, x within X_TOL and the
# objective within F_RTOL (relative) of uno_tpu's
X_TOL = 1e-8
F_RTOL = 1e-10
# one iteration from the same iterate: the same formulas, with sums, matrix
# products and AD products rounded in another order
STEP_TOL = 1e-10
HOST = dict(sqp_driver="host")


def _infeas(mk, stack):
    """tests/test_sqp_fused.py's infeasible model: x^2 + 1 <= 0."""
    return mk("infeas_h", lambda x: x[0], lambda x: stack([x[0] ** 2 + 1.0]),
              x0=[1.0], c_lb=[-np.inf], c_ub=[0.0])


def _problems(name):
    if name == "infeas":
        return _infeas(j_nlp, jnp.array), _infeas(t_nlp, torch.stack)
    if name.endswith(".nl"):
        path = f"tests/fixtures/nl/{name}"
        return j_read_nl(path), t_read_nl(path)
    return j_problem(name), t_problem(name)


def _solve_both(name, preset, **kw):
    jn, tn = _problems(name)
    ref = uno_tpu.solve(jn, preset=preset, **kw)
    got = uno_tpu_torch.solve(tn, preset=preset, device="cpu", **kw)
    return ref, got


def _assert_solves_equal(ref, got):
    assert (got.status, got.iterations, got.num_subproblems_solved) \
        == (ref.status, ref.iterations, ref.num_subproblems_solved)
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=0, atol=X_TOL)
    assert got.objective == pytest.approx(ref.objective, rel=F_RTOL, abs=F_RTOL)


@pytest.mark.parametrize("name,preset", [
    (name, preset) for name in ("hs015", "hs071", "hs035") for preset in PRESETS
    if (name, preset) != ("hs071", "filterslp")
    and (preset != "ipopt" or name == "hs015")])
def test_presets_on_the_host_driver_match(name, preset):
    """The SQP presets on the host driver; ipopt, whose interior-point
    method takes no SQP driver, once (tests/test_torch_ipm.py holds it on
    the other problems)."""
    ref, got = _solve_both(name, preset, **HOST)
    assert ref.status in ("optimal", "feasible_small_step")
    _assert_solves_equal(ref, got)


def test_hs071_filterslp_on_the_host_driver_matches():
    """hs071 under filterslp: 183 iterations of LPs over a shrinking trust
    region.  The LPs' interior-point solutions agree to about 1e-11 (their
    tolerance is 1e-8), and near iteration 175 a radius test falls the
    other way: uno_tpu ends at 183 iterations and 224 LPs, the port at 180
    and 220, both feasible_small_step at the optimum.  So the accepted
    iterates are held within X_TOL up to iteration 170, and the ends to
    the same status and objective within 1e-6."""
    ref, got = _solve_both("hs071", "filterslp", history=True, **HOST)
    assert got.status == ref.status == "feasible_small_step"
    for k in range(171):
        np.testing.assert_allclose(got.history[k].x, ref.history[k].x, rtol=0,
                                   atol=X_TOL, err_msg=f"iteration {k}")
    assert got.objective == pytest.approx(ref.objective, rel=1e-6)


@pytest.mark.parametrize("name,preset,mix", [
    (name, "filtersqp", dict(globalization_mechanism="LS")) for name in ("hs015", "hs071")
] + [(name, "byrd", dict(globalization_mechanism="TR")) for name in ("hs015", "hs071")])
def test_mixes_only_the_host_driver_runs_match(name, preset, mix):
    """A line search with feasibility restoration (filtersqp's LS: on hs015
    it ends in algorithmic_error in both packages) and a trust region with
    the l1 relaxation (byrd's TR), routed to the host driver by
    sqp_driver="auto"."""
    ref, got = _solve_both(name, preset, **mix)
    _assert_solves_equal(ref, got)


@pytest.mark.parametrize("preset", ["filtersqp", "byrd"])
def test_infeasible_model_matches(preset):
    ref, got = _solve_both("infeas", preset, max_iterations=200, **HOST)
    assert ref.status in ("infeasible_stationary_point", "infeasible_small_step")
    _assert_solves_equal(ref, got)


def test_history_and_callbacks():
    """solve(history=True) returns the accepted iterates (the initial one
    first) and the three callbacks fire on every accepted iterate, as
    uno_tpu's solve_sqp does (tests/test_sqp.py)."""
    class Rec(UserCallbacks):
        def __init__(self):
            self.calls = {"acceptable": 0, "primals": 0, "multipliers": 0}

        def notify_acceptable_iterate(self, primals, multipliers, objective_multiplier):
            self.calls["acceptable"] += 1

        def notify_new_primals(self, primals):
            self.calls["primals"] += 1

        def notify_new_multipliers(self, multipliers):
            self.calls["multipliers"] += 1

    rec_t, rec_j = Rec(), Rec()
    ref = uno_tpu.solve(j_problem("hs071"), preset="filtersqp", history=True,
                        callbacks=rec_j, **HOST)
    got = uno_tpu_torch.solve(t_problem("hs071"), preset="filtersqp", device="cpu",
                              history=True, callbacks=rec_t, **HOST)
    assert len(got.history) == len(ref.history) == got.iterations + 1
    for a, b in zip(got.history, ref.history):
        np.testing.assert_allclose(a.x, b.x, rtol=0, atol=X_TOL)
    assert rec_t.calls == rec_j.calls
    assert rec_t.calls["primals"] == got.iterations


def test_time_limit():
    ref, got = _solve_both("hs071", "filtersqp", time_limit=1e-9, **HOST)
    assert got.status == ref.status == "time_limit"
    assert got.iterations == ref.iterations == 0


def test_routing_reaches_the_host_driver(monkeypatch):
    """sqp_driver="host" reaches solvers/sqp.solve_sqp for each SQP preset,
    and the auto driver sends the mixes the fused drivers do not take."""
    class Routed(Exception):
        pass

    def routed(*args, **kwargs):
        raise Routed

    monkeypatch.setattr(tsqp, "solve_sqp", routed)
    tn = t_problem("hs015")
    for preset in PRESETS[1:]:
        with pytest.raises(Routed):
            uno_tpu_torch.solve(tn, preset=preset, device="cpu", **HOST)
    for preset, mix in (("filtersqp", dict(globalization_mechanism="LS")),
                        ("byrd", dict(globalization_mechanism="TR")),
                        ("byrd", dict(globalization_strategy="fletcher_filter_method"))):
        with pytest.raises(Routed):
            uno_tpu_torch.solve(tn, preset=preset, device="cpu", **mix)


# ---------------------------------------------------------------------------
# one iteration from the same iterate
# ---------------------------------------------------------------------------

def _one_iteration(mod, ws, relaxation, it, radius):
    """One trial of an outer iteration with the host driver's pieces of
    `mod` (uno_tpu's or the port's solvers/sqp.py): the Hessian, the
    direction (the QPs, penalty steering included), the trial at step 1 and
    its acceptance."""
    sigma = relaxation.sigma
    H = np.asarray(ws.hessian(it.x, it.y, sigma))
    direction = relaxation.compute_direction(it, radius, H)
    trial = mod._make_trial(ws, it, direction, 1.0, 1.0)
    pred = mod._predicted(ws, it, direction, 1.0, relaxation.sigma, H, False)
    accepted = relaxation.accept(it, trial, direction, 1.0, pred)
    return direction, trial, pred, accepted


@pytest.mark.parametrize("preset,phase,k", [
    ("filtersqp", "OPT", 2), ("filtersqp", "FEAS", 2), ("byrd", "OPT", 1),
    ("byrd", "OPT", 3)])
def test_one_iteration_from_the_same_iterate(preset, phase, k):
    """uno_tpu's accepted iterate k of hs071, carried to the port through
    interop.sqp_iterate_from, then one iteration's direction, trial and
    acceptance in both packages from it (in the restoration phase for
    FEAS), within STEP_TOL."""
    ref = uno_tpu.solve(j_problem("hs071"), preset=preset, history=True, **HOST)
    j_it = copy.deepcopy(ref.history[k])
    t_it = sqp_iterate_from(j_it)
    radius = 0.5
    out = []
    for mod, nlp, opts in ((jsqp, j_problem("hs071"), j_preset(preset)),
                           (tsqp, t_problem("hs071"), uno_tpu_torch.preset(preset))):
        it = j_it if mod is jsqp else t_it
        use_tr = opts.globalization_mechanism == "TR"
        nlp_s = (jsqp.transforms if mod is jsqp else tsqp.transforms) \
            .fixed_bounds_to_constraints(nlp)
        ws = (mod.SQPWorkspace(nlp_s, opts, use_tr) if mod is jsqp
              else mod.SQPWorkspace(nlp_s, opts, use_tr, "cpu"))
        strategy = mod.make_strategy(opts)
        strategy.initialize(it.progress)
        relax = (mod.L1RelaxationSQP if preset == "byrd"
                 else mod.FeasibilityRestorationSQP)(ws, strategy, opts)
        if phase == "FEAS":
            relax.switch_to_feasibility(it)
        out.append(_one_iteration(mod, ws, relax, it, radius))
    (jd, jt, jp, ja), (td, tt, tp, ta) = out
    assert ta == ja and td.status == jd.status and td.feasibility == jd.feasibility
    for name in ("dx", "dev", "y_new", "zl_new", "zu_new", "zl_el_new"):
        np.testing.assert_allclose(getattr(td, name), np.asarray(getattr(jd, name)),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=name)
    for name in ("x", "ev", "y", "zl", "zu", "y_f", "zl_f", "zu_f", "c"):
        np.testing.assert_allclose(getattr(tt, name), np.asarray(getattr(jt, name)),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=name)
    for a, b in ((tp, jp), (tt.progress, jt.progress)):
        for name in ("infeasibility", "objective"):
            assert getattr(a, name) == pytest.approx(getattr(b, name), rel=STEP_TOL,
                                                     abs=STEP_TOL)


def test_sqp_iterate_from_copies_every_field():
    ref = uno_tpu.solve(j_problem("hs015"), preset="filtersqp", history=True, **HOST)
    src = ref.history[1]
    it = sqp_iterate_from(src)
    assert isinstance(it, tsqp.SQPIterate)
    for name in ("x", "ev", "y", "zl", "zu", "y_f", "zl_f", "zu_f", "zl_el", "c", "g", "J"):
        got, want = getattr(it, name), np.asarray(getattr(src, name))
        assert got.dtype == np.float64 and np.array_equal(got, want), name
        assert not np.shares_memory(got, getattr(src, name))
    assert (it.f, it.progress.infeasibility, it.progress.objective) == \
        (src.f, src.progress.infeasibility, src.progress.objective)


def test_chip_smoke_sqp_host_phase_on_cpu():
    """chip_smoke.py's sqp_host phase on the CPU (card and CPU runs are
    then the same code), held to uno_tpu's results it records, on hs015."""
    import chip_smoke
    ref = {k: v for k, v in chip_smoke.SQP_HOST_REF.items() if k[1] == "hs015"}
    out = chip_smoke.phase_sqp_host(device="cpu", ref=ref)
    assert len(out["runs"]) == len(ref) and out["launches"] == 0
    assert out["largest_by_route"] == {}
    assert out["qp_counts"]["solves"] > 0
