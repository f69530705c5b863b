"""uno_tpu_torch's interior-point method under every ingredient mix
uno_tpu's takes, held against uno_tpu on the CPU, single solves: the
Fletcher filter, the funnel and the l1 merit function beside the Waechter
filter, the nonmonotone filter, the identity and zero Hessian models on
hs021, and LS_batch_candidates > 1.  The banded Hessian models and the
flagship batches are in tests/test_torch_ipm_mix_batches.py."""

import dataclasses
import functools

import numpy as np
import pytest

import uno_tpu
import uno_tpu_torch
from uno_tpu.model.library import get_problem as j_problem
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers import ipm as jipm
from uno_tpu_torch.model.library import get_problem as t_problem

STRATEGIES = ("waechter_filter_method", "fletcher_filter_method",
              "funnel_method", "l1_merit")
# a whole solve: equal status and iterations, x within X_TOL and the
# objective within F_RTOL (relative) of uno_tpu's
X_TOL = 1e-8
F_RTOL = 1e-10


def _solve_both(name, **kw):
    ref = uno_tpu.solve(j_problem(name), preset="ipopt", **kw)
    got = uno_tpu_torch.solve(t_problem(name), preset="ipopt", device="cpu", **kw)
    return ref, got


def _assert_solves_equal(ref, got):
    assert (got.status, got.iterations) == (ref.status, ref.iterations)
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=0, atol=X_TOL)
    assert got.objective == pytest.approx(ref.objective, rel=F_RTOL, abs=F_RTOL)


@pytest.mark.parametrize("name,mix", [
    (name, dict(globalization_strategy=gs))
    for name in ("hs015", "hs071") for gs in STRATEGIES[1:]
] + [("hs015", dict(filter_type="nonmonotone"))])
def test_single_solve_matches(name, mix):
    ref, got = _solve_both(name, **mix)
    assert ref.status == "optimal"
    _assert_solves_equal(ref, got)


def test_hs021_identity_hessian_matches():
    """uno_tpu's test of the identity model (tests/test_ipm.py:142): hs021
    with 500 iterations allowed."""
    ref, got = _solve_both("hs021", hessian_model="identity", max_iterations=500)
    assert ref.success
    _assert_solves_equal(ref, got)


HS021_ZERO = dict(hessian_model="zero", max_iterations=300, history=True)


@functools.lru_cache(maxsize=1)
def _uno_tpu_hs021_zero():
    return uno_tpu.solve(j_problem("hs021"), preset="ipopt", **HS021_ZERO)


def test_hs021_zero_hessian_matches():
    """uno_tpu's test of the zero model (tests/test_ipm.py:156): hs021 with
    300 iterations, which both packages spend.  The step of this model is
    ill-conditioned: the two trajectories part by one ulp of x at iteration
    2 (sums in another order) and the gap grows about tenfold every three
    iterations, past 1e-8 after iteration 30, to O(1) at 300, as uno_tpu's
    own run from a moved x0 does (the next test).  So the iterates are held
    within X_TOL for the first 30 iterations, and both ends to uno_tpu's
    own bound on the objective."""
    ref = _uno_tpu_hs021_zero()
    got = uno_tpu_torch.solve(t_problem("hs021"), preset="ipopt", device="cpu",
                              **HS021_ZERO)
    assert (got.status, got.iterations) == (ref.status, ref.iterations) \
        == ("iteration_limit", 300)
    for k in range(31):
        np.testing.assert_allclose(got.history[k].x[0].numpy(),
                                   np.asarray(ref.history[k].x), rtol=0,
                                   atol=X_TOL, err_msg=f"iteration {k}")
    assert abs(ref.objective + 99.96) < 0.2 and abs(got.objective + 99.96) < 0.2


def test_hs021_zero_hessian_parts_uno_tpu_from_itself():
    """The witness for the test above in uno_tpu alone: its run from x0
    moved by one ulp (np.nextafter) stays within X_TOL of its run from x0
    for 30 iterations and ends O(1) apart in x at 300.  With -s -n 0 it prints
    the gap in x every third iteration."""
    ref = _uno_tpu_hs021_zero()
    nlp = j_problem("hs021")
    moved = uno_tpu.solve(dataclasses.replace(nlp, x0=np.nextafter(nlp.x0, np.inf)),
                          preset="ipopt", **HS021_ZERO)
    assert (moved.status, moved.iterations) == (ref.status, ref.iterations)
    gaps = [float(np.max(np.abs(np.asarray(a.x)[:nlp.n] - np.asarray(b.x)[:nlp.n])))
            for a, b in zip(ref.history, moved.history)]
    final = float(np.max(np.abs(np.asarray(moved.x) - np.asarray(ref.x))))
    print({k: gaps[k] for k in range(0, len(gaps), 3)}, "final", final)
    assert max(gaps[:31]) <= X_TOL
    assert final > 0.1


@pytest.mark.parametrize("name", ["hs015", "hs071"])
def test_ls_batch_candidates_give_the_iterates_of_one(name):
    """NC candidate step lengths per trip of the line search take the
    sequential search's decisions: the same iterates, bit for bit, the same
    evaluations, and uno_tpu's result."""
    runs = {nc: uno_tpu_torch.solve(t_problem(name), preset="ipopt", device="cpu",
                                    LS_batch_candidates=nc, history=True)
            for nc in (1, 3, 4)}
    for nc in (3, 4):
        r, r1 = runs[nc], runs[1]
        assert (r.status, r.iterations, r.num_objective_evaluations) \
            == (r1.status, r1.iterations, r1.num_objective_evaluations)
        for a, b in zip(r.history, r1.history):
            assert np.array_equal(a.x.numpy(), b.x.numpy())
    ref = uno_tpu.solve(j_problem(name), preset="ipopt", LS_batch_candidates=4)
    _assert_solves_equal(ref, runs[4])
    assert runs[4].num_objective_evaluations == ref.num_objective_evaluations


def test_unknown_strategy_raises_as_uno_tpu():
    with pytest.raises(ValueError, match="unknown globalization strategy"):
        jipm.build_ipm(j_problem("hs015"), j_preset("ipopt", globalization_strategy="x"))
    with pytest.raises(ValueError, match="unknown globalization strategy"):
        uno_tpu_torch.solve(t_problem("hs015"), preset="ipopt", device="cpu",
                            globalization_strategy="x")


def test_chip_smoke_ipm_mixes_phase_on_cpu():
    """chip_smoke.py's ipm_mixes phase at B=16 on the CPU, where the
    kernels' plain versions run and launch nothing."""
    import chip_smoke
    out = chip_smoke.phase_ipm_mixes(device="cpu", full_batch=16, batch=16, rerun=4)
    assert [b["mix"] for b in out["batches"]] == list(chip_smoke.IPM_MIX_BATCHES)
    for b in out["batches"] + [out["standard"]]:
        assert b["solved"] == 16 and b["launches"] == 0 and b["steps"] > 0
    for b in out["batches"]:
        assert b["iterations_equal"] == 4 and b["x_max_abs_diff"] == 0.0
    ls4 = out["batches"][-1]
    assert ls4["x_max_abs_diff_to_standard"] == 0.0
    assert ls4["line_search_trips"] <= ls4["standard_line_search_trips"]
    assert [s["problem"] for s in out["singles"]] == \
        [name for name, _ in chip_smoke.IPM_MIX_SINGLES]
    assert out["singles_largest_by_route"] == {}

