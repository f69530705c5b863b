"""uno_tpu_torch's globalization strategies (the filters, the nonmonotone
filter, the l1 merit function and the funnel) and its interior-point QP
solver, held against uno_tpu on the CPU on seeded random inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ingredients import filters as jf
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers import qp as jqp
from uno_tpu_torch.ingredients import filters as tf
from uno_tpu_torch.options import preset as t_preset
from uno_tpu_torch.solvers import qp as tqp

B, CAP = 64, 8
BETA, GAMMA, MAX_DOM = 0.999, 0.001, 3
JO, TO = j_preset("filtersqp"), t_preset("filtersqp")


def _filters(seed, sorted_h):
    """B filters of CAP slots, 0 to CAP of them valid (the rest +inf), with
    repeated values, sorted by h (the standard filter) or in insertion
    order (the nonmonotone one); trials near the entries."""
    rng = np.random.default_rng(seed)
    h = rng.choice([0.0, 1e-3, 0.1, 0.5, 1.0, 2.0], (B, CAP)) * rng.uniform(0.5, 1.5, (B, CAP))
    h[:, ::3] = h[:, 1::3][:, : h[:, ::3].shape[1]]          # ties
    phi = rng.normal(size=(B, CAP))
    if sorted_h:
        h = np.sort(h, axis=1)
    valid = np.arange(CAP) < rng.integers(0, CAP + 1, (B, 1))
    h = np.where(valid, h, np.inf)
    phi = np.where(valid, phi, np.inf)
    ub = rng.uniform(0.5, 5.0, B)
    pick = rng.integers(0, CAP, B)
    near = np.where(np.isfinite(h[np.arange(B), pick]), h[np.arange(B), pick], 1.0)
    h_t = near * rng.choice([0.5, 0.999, 1.0, 1.001, 2.0], B)
    phi_t = np.where(np.isfinite(phi[np.arange(B), pick]), phi[np.arange(B), pick], 0.0) \
        + rng.normal(scale=0.01, size=B)
    h_c = h_t * rng.uniform(0.5, 2.0, B)
    phi_c = phi_t + rng.normal(scale=0.1, size=B)
    pred = rng.normal(scale=0.1, size=B)
    width = rng.uniform(0.1, 3.0, B)
    return dict(h=h, phi=phi, ub=ub, h_t=h_t, phi_t=phi_t, h_c=h_c,
                phi_c=phi_c, pred=pred, width=width)


def _jfilt(v):
    return jf.FilterState(jnp.asarray(v["h"]), jnp.asarray(v["phi"]), jnp.asarray(v["ub"]))


def _tfilt(v):
    return tf.FilterState(*(torch.as_tensor(v[k]) for k in ("h", "phi", "ub")))


def _j(v, *keys):
    return [jnp.asarray(v[k]) for k in keys]


def _t(v, *keys):
    return [torch.as_tensor(v[k]) for k in keys]


# name -> (filter sorted?, uno_tpu on one instance (vmapped), the port on
# the batch); each returns an array or a tuple of arrays
CASES = {
    "filter_reset": (True,
                     lambda v: jax.vmap(jf.filter_reset)(_jfilt(v)),
                     lambda v: tf.filter_reset(_tfilt(v))),
    "filter_set_ub": (True,
                      lambda v: jax.vmap(jf.filter_set_ub)(_jfilt(v), *_j(v, "width")),
                      lambda v: tf.filter_set_ub(_tfilt(v), *_t(v, "width"))),
    "fletcher_is_acceptable": (
        True,
        lambda v: jax.vmap(lambda f, hc, pc, ht, pt, pr: jf.fletcher_is_acceptable(
            f, hc, pc, ht, pt, pr, JO, 1e-15 * jnp.abs(pc)))(
            _jfilt(v), *_j(v, "h_c", "phi_c", "h_t", "phi_t", "pred")),
        lambda v: tf.fletcher_is_acceptable(
            _tfilt(v), *_t(v, "h_c", "phi_c", "h_t", "phi_t", "pred"), TO,
            1e-15 * torch.abs(torch.as_tensor(v["phi_c"])))),
    "l1_merit_acceptable": (
        True,
        lambda v: jax.vmap(lambda hc, pc, ht, pt, pr, w: jf.l1_merit_acceptable(
            hc, pc, 0.1, ht, pt, 0.2, w, pr, 0.01, JO, 1e-15))(
            *_j(v, "h_c", "phi_c", "h_t", "phi_t", "pred", "width")),
        lambda v: tf.l1_merit_acceptable(
            *_t(v, "h_c", "phi_c"), 0.1, *_t(v, "h_t", "phi_t"), 0.2,
            *_t(v, "width", "pred"), 0.01, TO, 1e-15)),
    "nm_count_dominated": (
        False,
        lambda v: jax.vmap(lambda f, ht, pt: jf.nm_count_dominated(f, ht, pt, BETA, GAMMA))(
            _jfilt(v), *_j(v, "h_t", "phi_t")),
        lambda v: tf.nm_count_dominated(_tfilt(v), *_t(v, "h_t", "phi_t"), BETA, GAMMA)),
    "nm_filter_acceptable": (
        False,
        lambda v: jax.vmap(lambda f, ht, pt: jf.nm_filter_acceptable(
            f, ht, pt, BETA, GAMMA, MAX_DOM))(_jfilt(v), *_j(v, "h_t", "phi_t")),
        lambda v: tf.nm_filter_acceptable(_tfilt(v), *_t(v, "h_t", "phi_t"),
                                          BETA, GAMMA, MAX_DOM)),
    "nm_filter_acceptable_wrt": (
        False,
        lambda v: jax.vmap(lambda f, hc, pc, ht, pt: jf.nm_filter_acceptable_wrt(
            f, hc, pc, ht, pt, BETA, GAMMA, MAX_DOM))(
            _jfilt(v), *_j(v, "h_c", "phi_c", "h_t", "phi_t")),
        lambda v: tf.nm_filter_acceptable_wrt(
            _tfilt(v), *_t(v, "h_c", "phi_c", "h_t", "phi_t"), BETA, GAMMA, MAX_DOM)),
    "nm_filter_add": (
        False,
        lambda v: jax.vmap(lambda f, hc, pc: jf.nm_filter_add(f, hc, pc, MAX_DOM))(
            _jfilt(v), *_j(v, "h_c", "phi_c")),
        lambda v: tf.nm_filter_add(_tfilt(v), *_t(v, "h_c", "phi_c"), MAX_DOM)),
    "nm_actual_objective_reduction": (
        False,
        lambda v: jax.vmap(lambda f, pc, hc, pt: jf.nm_actual_objective_reduction(
            f, pc, hc, pt, GAMMA, MAX_DOM))(_jfilt(v), *_j(v, "phi_c", "h_c", "phi_t")),
        lambda v: tf.nm_actual_objective_reduction(
            _tfilt(v), *_t(v, "phi_c", "h_c", "phi_t"), GAMMA, MAX_DOM)),
    "nm_smallest_infeasibility": (
        False,
        lambda v: jax.vmap(jf.nm_smallest_infeasibility)(_jfilt(v)),
        lambda v: tf.nm_smallest_infeasibility(_tfilt(v))),
    **{f"funnel_update_width_{k}": (
        True,
        lambda v, k=k: jax.vmap(lambda w, hc, ht: jf.funnel_update_width(
            w, hc, ht, 0.9999, 0.5, k))(*_j(v, "width", "h_c", "h_t")),
        lambda v, k=k: tf.funnel_update_width(*_t(v, "width", "h_c", "h_t"),
                                              0.9999, 0.5, k))
       for k in (1, 2, 3)},
    **{f"funnel_is_acceptable_{wrt}": (
        True,
        lambda v, wrt=wrt: jax.vmap(lambda w, hc, pc, ht, pt, pr: jf.funnel_is_acceptable(
            w, hc, pc, ht, pt, pr,
            JO.replace(funnel_require_acceptance_wrt_current_iterate=wrt), 1e-15))(
            *_j(v, "width", "h_c", "phi_c", "h_t", "phi_t", "pred")),
        lambda v, wrt=wrt: tf.funnel_is_acceptable(
            *_t(v, "width", "h_c", "phi_c", "h_t", "phi_t", "pred"),
            TO.replace(funnel_require_acceptance_wrt_current_iterate=wrt), 1e-15))
       for wrt in (False, True)},
}


def _flat(out):
    if isinstance(out, tuple):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_filter_function_matches_uno_tpu(name, seed):
    """The same elementwise operations on the same inputs: equal bit for
    bit, instance by instance."""
    sorted_h, jfn, tfn = CASES[name]
    v = _filters(seed, sorted_h)
    ref, got = _flat(jfn(v)), _flat(tfn(v))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, np.broadcast_to(r, g.shape), err_msg=name)


# ---------------------------------------------------------------------------
# the QP solver
# ---------------------------------------------------------------------------

# float64 QP solves of up to 150 interior-point iterations: the same
# formulas, with the matrix products summed in another order
QP_TOL = 1e-9
QP_B = 4


def _qp(kind, seed):
    """QP_B instances of a QP family with n = 6, m = 4: two equality rows,
    one two-sided and one lower-bounded inequality, a box with one
    variable unbounded above.  'convex': H positive definite; 'nonconvex':
    H indefinite; 'infeasible': an equality row no point of the box meets."""
    rng = np.random.default_rng(seed)
    n, m = 6, 4
    M = rng.normal(size=(QP_B, n, n))
    if kind == "nonconvex":
        H = (M + np.swapaxes(M, 1, 2)) / 2
    else:
        H = M @ np.swapaxes(M, 1, 2) / n + 0.1 * np.eye(n)
    g = rng.normal(size=(QP_B, n))
    J = rng.normal(size=(QP_B, m, n))
    x_in = rng.uniform(-0.5, 0.5, (QP_B, n))
    r = np.einsum("bmn,bn->bm", J, x_in)
    rl = np.stack([r[:, 0], r[:, 1], r[:, 2] - 0.3, r[:, 3] - 0.2], 1)
    ru = np.stack([r[:, 0], r[:, 1], r[:, 2] + 0.3, np.full(QP_B, np.inf)], 1)
    if kind == "infeasible":
        J[:, 0] = np.abs(J[:, 0])
        rl[:, 0] = ru[:, 0] = 10.0 * np.abs(J[:, 0]).sum(1)
    dl = np.full((QP_B, n), -1.0)
    du = np.full((QP_B, n), 1.0)
    du[:, 5] = np.inf
    return dict(g=g, H=H, J=J, rl=rl, ru=ru, dl=dl, du=du)


_QP_SOLVERS = {}


def _solvers(purify):
    if purify not in _QP_SOLVERS:
        q = _qp("convex", 0)
        struct_j = jqp.qp_structure_from_bounds(q["rl"][0], q["ru"][0], q["dl"][0], q["du"][0])
        struct_t = tqp.qp_structure_from_bounds(q["rl"][0], q["ru"][0], q["dl"][0], q["du"][0])
        jsolve = jqp.build_qp_solver(struct_j, JO, tol=1e-10, purify=purify)
        _QP_SOLVERS[purify] = (
            jax.jit(jax.vmap(lambda g, H, J, rl, ru, dl, du, wd, wy, Hp: jsolve(
                g, H, J, rl, ru, dl, du, warm_d=wd, warm_y=wy, H_purify=Hp))),
            jax.jit(jax.vmap(lambda g, H, J, rl, ru, dl, du: jsolve(
                g, H, J, rl, ru, dl, du))),
            tqp.build_qp_solver(struct_t, TO, tol=1e-10, purify=purify))
    return _QP_SOLVERS[purify]


def _solve_both(q, purify, warm=None, H_purify=None):
    jwarm, jcold, tsolve = _solvers(purify)
    keys = ("g", "H", "J", "rl", "ru", "dl", "du")
    if warm is None and H_purify is None:
        ref = jcold(*(jnp.asarray(q[k]) for k in keys))
        got = tsolve(*(torch.as_tensor(q[k]) for k in keys))
    else:
        wd, wy = warm
        Hp = q["H"] if H_purify is None else H_purify
        ref = jwarm(*(jnp.asarray(q[k]) for k in keys), jnp.asarray(wd),
                    jnp.asarray(wy), jnp.asarray(Hp))
        got = tsolve(*(torch.as_tensor(q[k]) for k in keys), warm_d=torch.as_tensor(wd),
                     warm_y=torch.as_tensor(wy), H_purify=torch.as_tensor(Hp))
    return ref, got


def _assert_qp_equal(ref, got):
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    for name in ("d", "y", "zl", "zu", "objective", "kkt_error"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=QP_TOL, atol=QP_TOL, err_msg=name)


@pytest.mark.parametrize("purify", [True, False])
@pytest.mark.parametrize("kind", ["convex", "nonconvex"])
def test_qp_cold_start_matches_uno_tpu(kind, purify):
    q = _qp(kind, 1)
    ref, got = _solve_both(q, purify)
    _assert_qp_equal(ref, got)
    assert set(got.status.tolist()) == {tqp.QP_OPTIMAL}


@pytest.mark.parametrize("kind", ["convex", "nonconvex"])
def test_qp_warm_start_matches_uno_tpu(kind):
    """Warm started from a perturbed cold solution, with the multipliers
    refitted against another Hessian (H_purify)."""
    q = _qp(kind, 2)
    ref_cold, _ = _solve_both(q, True)
    rng = np.random.default_rng(3)
    wd = np.asarray(ref_cold.d) + rng.normal(scale=1e-3, size=q["g"].shape)
    wy = np.array(ref_cold.y)
    H_p = q["H"] - 0.05 * np.eye(6)
    ref, got = _solve_both(q, True, warm=(wd, wy), H_purify=H_p)
    _assert_qp_equal(ref, got)
    assert (got.iterations.numpy() < np.asarray(ref_cold.iterations)).all()


def test_qp_infeasible_is_classified_as_uno_tpu_classifies_it():
    """The classification only: an infeasible QP's iterates diverge (KKT
    errors of 1e8 to 1e15 at the exit), which magnifies the rounding of the
    sums, so the exit iteration may differ by one between the packages."""
    q = _qp("infeasible", 4)
    ref, got = _solve_both(q, True)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert set(got.status.tolist()) == {tqp.QP_INFEASIBLE}
    assert (got.iterations.numpy() >= 5).all()


def test_qp_unconstrained_rows_and_float32_factors():
    """m = 0 (box only), and the float32 factorization with its two float64
    refinement steps."""
    q = _qp("convex", 5)
    n = q["g"].shape[1]
    struct_j = jqp.qp_structure_from_bounds(np.zeros(0), np.zeros(0), q["dl"][0], q["du"][0])
    struct_t = tqp.qp_structure_from_bounds(np.zeros(0), np.zeros(0), q["dl"][0], q["du"][0])
    for kkt in ("float64", "float32"):
        jsolve = jqp.build_qp_solver(struct_j, JO.replace(kkt_dtype=kkt))
        tsolve = tqp.build_qp_solver(struct_t, TO.replace(kkt_dtype=kkt))
        args = (q["g"], q["H"], np.zeros((QP_B, 0, n)), np.zeros((QP_B, 0)),
                np.zeros((QP_B, 0)), q["dl"], q["du"])
        ref = jax.vmap(jsolve)(*(jnp.asarray(a) for a in args))
        got = tsolve(*(torch.as_tensor(a) for a in args))
        _assert_qp_equal(ref, got)
