"""The port's structured models held against uno_tpu on the CPU: every
structured family's functions and derivatives (the Hessian band and the
Jacobian windows included), the structure the interior-point
reformulation carries, RCM and structure detection, the registry keys, and
the auto_permute solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu
import uno_tpu_torch
from uno_tpu.model import library_cutest as j_cutest
from uno_tpu.model import library_r4 as j_r4
from uno_tpu.model import transforms as j_tf
from uno_tpu.model.library import get_problem as j_get
from uno_tpu.model.library import known_optimum as j_known
from uno_tpu.model.library import problem_names
from uno_tpu_torch.model import library_cutest as t_cutest
from uno_tpu_torch.model import transforms as t_tf
from uno_tpu_torch.model.library import get_problem as t_get
from uno_tpu_torch.model.library import known_optimum as t_known
from uno_tpu_torch.model.library import problem_names as t_names

FAMILIES = ("srosenbr", "biggsb1", "lukvle1", "lukvli1", "hager1", "catena",
            "chainrosen_ineq", "elec", "chandheq_ls", "steering",
            "vanderpol_ctrl", "chwood_eq", "broydn_eq")
# the same formulas evaluated by two AD systems: sums in another order
DERIV_RTOL = 1e-12


def _j_builder(name):
    if name in j_cutest._FAMILIES:
        return j_cutest._FAMILIES[name][0]
    return j_r4._R4_FAMILIES[name][0]


def _points(nlp, seed=0):
    """x0 and 3 seeded points near it, with seeded multipliers."""
    rng = np.random.default_rng(seed)
    xs = [np.asarray(nlp.x0, dtype=np.float64)]
    xs += [xs[0] + 0.3 * rng.standard_normal(nlp.n) for _ in range(3)]
    return np.stack(xs), rng.standard_normal((4, nlp.m))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.max(np.abs(b), initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=0, atol=DERIV_RTOL * scale)


@pytest.mark.parametrize("n", [10, 100])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_functions_and_derivatives_match(name, n):
    jn = _j_builder(name)(n)
    tn = t_cutest.cutest_problem(name, n)
    assert (jn.name, jn.n, jn.m) == (tn.name, tn.n, tn.m)
    for a in ("x0", "x_lb", "x_ub", "c_lb", "c_ub"):
        np.testing.assert_array_equal(getattr(jn, a), getattr(tn, a))
    X, Y = _points(jn)
    st = jn.structure

    @jax.jit
    def j_all(x, y):
        out = [jn.objective(x), jn.objective_gradient(x)]
        if jn.m:
            out += [jn.constraints(x), jn.constraint_jacobian(x)]
        if st is not None:
            out.append(jn.lagrangian_hessian_band(x, y, 1.0))
            if jn.m:
                out.append(jn.constraint_jacobian_windows(x))
        return out

    xt, yt = torch.as_tensor(X), torch.as_tensor(Y)
    ones = torch.ones(4, dtype=torch.float64)
    t_all = [tn.objective(xt), tn.objective_gradient(xt)]
    if tn.m:
        t_all += [tn.constraints(xt), tn.constraint_jacobian(xt)]
    assert _same_structure(tn.structure, st)
    if st is not None:
        t_all.append(tn.lagrangian_hessian_band(xt, yt, ones))
        if tn.m:
            t_all.append(tn.constraint_jacobian_windows(xt))
    for k in range(4):
        ref = j_all(jnp.asarray(X[k]), jnp.asarray(Y[k]))
        for r, t in zip(ref, t_all):
            _close(t[k].numpy(), r)


def _same_structure(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a.hess_bandwidth == b.hess_bandwidth and a.jac_width == b.jac_width
            and a.jac_col_limit == b.jac_col_limit
            and ((a.jac_starts is None and b.jac_starts is None)
                 or np.array_equal(a.jac_starts, b.jac_starts)))


@pytest.mark.parametrize("n", [10, 100])
@pytest.mark.parametrize("name", FAMILIES)
def test_reformulated_structure_matches(name, n):
    """The structure after scaling and the interior-point reformulation
    (fixed variables as rows, slacks, relaxed bounds) equals uno_tpu's."""
    from uno_tpu.options import preset as j_preset
    jo = j_preset("ipopt")
    jp = j_tf.reformulate_for_interior_point(
        j_tf.scale_model(_j_builder(name)(n)), jo.tolerance)
    tp = t_tf.reformulate_for_interior_point(
        t_tf.scale_model(t_cutest.cutest_problem(name, n)), jo.tolerance)
    assert _same_structure(jp.structure, tp.structure)
    assert (jp.n, jp.m) == (tp.n, tp.m)
    np.testing.assert_array_equal(jp.slack_of_constraint, tp.slack_of_constraint)
    for a in ("x_lb", "x_ub", "c_lb", "c_ub", "x0"):
        np.testing.assert_array_equal(getattr(jp, a), getattr(tp, a))


def test_registry_keys_and_optima_match():
    keys = sorted(k for k in problem_names()
                  if any(k.startswith(f + "_n") for f in FAMILIES))
    assert keys == sorted(k for k in t_names()
                          if any(k.startswith(f + "_n") for f in FAMILIES))
    for k in keys:
        assert t_known(k) == j_known(k)
        assert t_get(k).n == j_get(k).n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rcm_order_matches(seed):
    rng = np.random.default_rng(seed)
    n = 40 + 10 * seed
    ei = rng.integers(0, n, 3 * n)
    ej = np.clip(ei + rng.integers(-6, 7, 3 * n), 0, n - 1)
    np.testing.assert_array_equal(t_tf.rcm_order(n, ei, ej),
                                  j_tf.rcm_order(n, ei, ej))


@pytest.mark.parametrize("name", ["chwood_eq_n100", "broydn_eq_n100",
                                  "vanderpol_ctrl_n15", "elec_n9",
                                  "chandheq_ls_n10", "chwood_eq_n12"])
def test_detect_structure_matches(name):
    """The same permutation (or the same refusal) and the same declared
    structure as uno_tpu's detect_structure."""
    jp, jperm = j_tf.detect_structure(j_get(name))
    tp, tperm = t_tf.detect_structure(t_get(name))
    assert (jperm is None) == (tperm is None)
    if jperm is not None:
        np.testing.assert_array_equal(tperm, jperm)
        assert _same_structure(tp.structure, jp.structure)
        np.testing.assert_array_equal(tp.x0, jp.x0)


@pytest.mark.parametrize("name", ["chwood_eq_n100", "broydn_eq_n100"])
def test_auto_permute_solve_matches(name):
    """auto_permute: detection, the banded solve of the permuted model and
    the map back of x, zl, zu, as uno_tpu's."""
    ref = uno_tpu.solve(j_get(name), preset="ipopt", auto_permute=True)
    res = uno_tpu_torch.solve(t_get(name), preset="ipopt", auto_permute=True,
                              device="cpu")
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert abs(res.objective - ref.objective) <= 1e-10 * max(abs(ref.objective), 1.0)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.zl, ref.zl, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.zu, ref.zu, rtol=0, atol=1e-8)


def test_permute_variables_keeps_values_and_drops_structure():
    nlp = t_get("lukvle1_n10")
    perm = np.random.default_rng(3).permutation(nlp.n)
    p = t_tf.permute_variables(nlp, perm)
    x = torch.as_tensor(np.asarray(nlp.x0) + 0.1)[None]
    assert p.structure is None
    np.testing.assert_allclose(p.objective(x[:, perm]).numpy(), nlp.objective(x).numpy(),
                               rtol=1e-15)
    np.testing.assert_allclose(p.constraints(x[:, perm]).numpy(),
                               nlp.constraints(x).numpy(), rtol=1e-15)
