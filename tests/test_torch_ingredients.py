"""uno_tpu_torch's barrier terms, Waechter filter and inertia-correcting
regularization held against uno_tpu's (mapped over a batch with jax.vmap),
on inputs made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.ingredients import barrier as jb
from uno_tpu.ingredients import filters as jfl
from uno_tpu.ingredients.regularization import regularize_and_factor as j_reg
from uno_tpu.options import preset as j_preset
from uno_tpu_torch.ingredients import barrier as tb
from uno_tpu_torch.ingredients import filters as tfl
from uno_tpu_torch.ingredients.regularization import regularize_and_factor as t_reg
from uno_tpu_torch.options import preset as t_preset

# elementwise float64 formulas in the same order; sums over a handful of
# terms may round differently
TOL = 1e-13
B, N = 6, 7


def _close(got, ref):
    if isinstance(got, tuple):
        for g, r in zip(got, ref):
            _close(g, r)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _barrier_inputs(seed):
    rng = np.random.default_rng(seed)
    has_lb = rng.uniform(size=N) < 0.7
    has_ub = rng.uniform(size=N) < 0.5
    lb = np.where(has_lb, rng.uniform(-2, 0, N), -1e25)
    ub = np.where(has_ub, rng.uniform(1, 3, N), 1e25)
    x = rng.uniform(0.05, 0.95, (B, N))
    dx = rng.standard_normal((B, N))
    zl = np.where(has_lb, rng.uniform(0.1, 2, (B, N)), 0.0)
    zu = np.where(has_ub, -rng.uniform(0.1, 2, (B, N)), 0.0)
    dzl = rng.standard_normal((B, N))
    dzu = rng.standard_normal((B, N))
    mu = 10.0 ** rng.uniform(-6, -1, B)
    tau = np.maximum(0.99, 1 - mu)
    return dict(x=x, dx=dx, zl=zl, zu=zu, dzl=dzl, dzu=dzu, lb=lb, ub=ub,
                has_lb=has_lb, has_ub=has_ub, mu=mu, tau=tau)


# name -> (argument names, per-instance argument names)
BARRIER_FUNCTIONS = {
    "push_to_interior": ("x lb ub k1 k2", "x"),
    "barrier_gradient": ("x lb ub has_lb has_ub mu damping", "x mu"),
    "barrier_hessian_diag": ("x zl zu lb ub has_lb has_ub", "x zl zu"),
    "barrier_auxiliary_measure": ("x lb ub has_lb has_ub mu damping", "x mu"),
    "barrier_directional_derivative": ("x dx lb ub has_lb has_ub mu damping", "x dx mu"),
    "bound_dual_direction": ("x dx zl zu lb ub has_lb has_ub mu", "x dx zl zu mu"),
    "primal_fraction_to_boundary": ("x dx lb ub has_lb has_ub tau", "x dx tau"),
    "dual_fraction_to_boundary": ("zl zu dzl dzu has_lb has_ub tau", "zl zu dzl dzu tau"),
    "k_sigma_rescale": ("x zl zu lb ub has_lb has_ub mu k_sigma", "x zl zu mu"),
    "centrality_error": ("x zl zu lb ub has_lb has_ub mu", "x zl zu mu"),
    "bound_complementarity_error": ("x zl zu lb ub has_lb has_ub", "x zl zu"),
}


@pytest.mark.parametrize("name", list(BARRIER_FUNCTIONS))
def test_barrier_function_matches(name):
    args, batched = (s.split() for s in BARRIER_FUNCTIONS[name])
    for seed in range(2):
        data = dict(_barrier_inputs(seed), k1=1e-2, k2=1e-2, damping=1e-5,
                    k_sigma=1e10)
        j_args = [jnp.asarray(data[a]) if isinstance(data[a], np.ndarray)
                  else data[a] for a in args]
        in_axes = [0 if a in batched else None for a in args]
        ref = jax.vmap(getattr(jb, name), in_axes=in_axes)(*j_args)
        t_args = [torch.as_tensor(data[a]) if isinstance(data[a], np.ndarray)
                  else data[a] for a in args]
        _close(getattr(tb, name)(*t_args), ref)


def _filter_pair(seed, cap=6):
    """Fill uno_tpu and port filters with the same seeded sequence of adds,
    several instances at once; returns (jax filters, torch filter, rng)."""
    rng = np.random.default_rng(seed)
    jf = [jfl.filter_set_ub(jfl.filter_init(cap), 50.0) for _ in range(B)]
    tf = tfl.filter_init(B, cap)._replace(ub=torch.full((B,), 50.0, dtype=torch.float64))
    for _ in range(9):
        h = rng.uniform(0, 10, B)
        phi = rng.uniform(-5, 5, B)
        jf = [jfl.filter_add(f, h[i], phi[i], 0.99) for i, f in enumerate(jf)]
        tf = tfl.filter_add(tf, torch.as_tensor(h), torch.as_tensor(phi), 0.99)
    return jf, tf, rng


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_add_and_acceptable_match(seed):
    jf, tf, rng = _filter_pair(seed)
    for i, f in enumerate(jf):
        _close((tf.h[i], tf.phi[i], tf.ub[i]), (f.h, f.phi, f.ub))
    h_t = rng.uniform(0, 10, B)
    phi_t = rng.uniform(-5, 5, B)
    got = tfl.filter_acceptable(tf, torch.as_tensor(h_t), torch.as_tensor(phi_t),
                                0.99, 1e-3)
    ref = [bool(jfl.filter_acceptable(f, h_t[i], phi_t[i], 0.99, 1e-3))
           for i, f in enumerate(jf)]
    assert got.tolist() == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_waechter_and_feasibility_acceptance_match(seed):
    jf, tf, rng = _filter_pair(seed)
    opts_j, opts_t = j_preset("ipopt"), t_preset("ipopt")
    v = {k: rng.uniform(lo, hi, B) for k, lo, hi in (
        ("h_cur", 0, 1e-3), ("merit_cur", -1, 1), ("h_tri", 0, 1e-3),
        ("merit_tri", -1.2, 1), ("merit_pred", -0.5, 1), ("h_initial", 0, 5),
        ("aux_cur", 0, 1), ("aux_tri", 0, 1), ("pred_h", -1, 1),
        ("pred_aux", -1, 1), ("roundoff", 0, 1e-12))}
    T = {k: torch.as_tensor(a) for k, a in v.items()}
    got = tfl.waechter_is_acceptable(
        tf, T["h_cur"], T["merit_cur"], T["h_tri"], T["merit_tri"],
        T["merit_pred"], T["h_initial"], opts_t, T["roundoff"])
    got_feas = tfl.feasibility_armijo_acceptable(
        T["h_cur"], T["aux_cur"], T["h_tri"], T["aux_tri"], T["pred_h"],
        T["pred_aux"], opts_t)
    for i, f in enumerate(jf):
        ref = jfl.waechter_is_acceptable(
            f, v["h_cur"][i], v["merit_cur"][i], v["h_tri"][i], v["merit_tri"][i],
            v["merit_pred"][i], v["h_initial"][i], opts_j, v["roundoff"][i])
        assert (bool(got.accept[i]), bool(got.augment[i])) == \
            (bool(ref.accept), bool(ref.augment))
        ref_feas = jfl.feasibility_armijo_acceptable(
            v["h_cur"][i], v["aux_cur"][i], v["h_tri"][i], v["aux_tri"][i],
            v["pred_h"][i], v["pred_aux"][i], opts_j)
        assert bool(got_feas[i]) == bool(ref_feas)


def _regularization_case(seed, n=8, m=3):
    """Barrier KKT pieces whose Hessian block is indefinite or singular for
    some instances, so the correction loop runs a varying number of times."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((B, n, n))
    H = (H + np.swapaxes(H, 1, 2)) / 2
    shift = np.array([-3.0, 0.0, 2.0, 6.0, -0.5, 1.0])[:B]
    H = H + shift[:, None, None] * np.eye(n)
    J = rng.standard_normal((B, m, n))
    J[1] = 0.0                       # rank-deficient Jacobian
    D_e = np.zeros((B, m))
    prev = np.array([0.0, 1e-4, 0.0, 3e-2, 1e-8, 0.0])[:B]
    dual = 10.0 ** rng.uniform(-3, 0, B)
    return H, J, D_e, prev, dual


@pytest.mark.parametrize("kkt_dtype", ["float64", "float32"])
def test_regularize_and_factor_matches(kkt_dtype):
    H, J, D_e, prev, dual = _regularization_case(0)
    n, m = H.shape[-1], J.shape[1]
    opts_j = j_preset("ipopt", kkt_dtype=kkt_dtype)
    opts_t = t_preset("ipopt", kkt_dtype=kkt_dtype)

    def j_one(Hi, Ji, De, pd, dr):
        def assemble(delta, eps):
            Hd = Hi + delta * jnp.eye(n)
            return jnp.block([[Hd, Ji.T], [Ji, -jnp.diag(De + eps)]])
        return j_reg(assemble, n, m, dr, pd, opts_j)

    ref = jax.vmap(j_one)(*(jnp.asarray(a) for a in (H, J, D_e, prev, dual)))

    Ht, Jt, Dt = (torch.as_tensor(a) for a in (H, J, D_e))

    def assemble_t(delta, eps):
        Hd = Ht + delta[:, None, None] * torch.eye(n, dtype=torch.float64)
        top = torch.cat([Hd, Jt.transpose(1, 2)], dim=-1)
        bottom = torch.cat([Jt, -torch.diag_embed(Dt + eps[:, None])], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    got = t_reg(assemble_t, n, m, torch.as_tensor(dual), torch.as_tensor(prev), opts_t)
    assert got.attempts.tolist() == np.asarray(ref.attempts).tolist()
    assert got.failed.tolist() == np.asarray(ref.failed).tolist()
    assert got.singular.tolist() == np.asarray(ref.singular).tolist()
    for field in ("delta", "eps", "prev_delta"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)), rtol=1e-12,
                                   err_msg=field)
    assert max(got.attempts.tolist()) > 1      # the loop ran
    assert got.fac.num_pos.tolist() == np.asarray(ref.fac.num_pos).tolist()
