"""Primal-dual interior-point solver (the `ipopt` preset and every
strategy and Hessian model mix), batched.

Counterpart of uno_tpu/solvers/ipm.py (reference call stack: Uno::solve,
BacktrackingLineSearch, FeasibilityRestoration, PrimalDualInteriorPoint*,
BarrierParameterUpdateStrategy, PrimalDualRegularization, the
globalization strategies of GlobalizationStrategyFactory).  One outer
iteration of every instance of a batch runs as one call of the step:

  1. AD derivatives (or the identity or zero Hessian model);  2. barrier
  terms;  3. KKT assembly with the condensed restoration elastics;
  4. inertia-corrected LDL^T;  5. the f32 solve with f64 refinement
  (kkt_dtype="float32");  6. the backtracking line search under the
  globalization strategy (the Waechter or Fletcher filter, standard or
  nonmonotone, the funnel or the l1 merit function), one candidate step
  length per trip or LS_batch_candidates of them;  7. the termination
  test.

uno_tpu runs `vmap(while_loop)`; here the batch is the leading axis of
every tensor, and each data-dependent loop (the outer iteration, the
barrier update, the line search, the inertia correction) is a host loop
capped by the option that bounds it, in which an instance that is done
keeps its values.  The single instance is the batch of one.

The KKT backend is chosen in `build_ipm` as uno_tpu's is: the dense
augmented LDL^T (the CUDA kernels), the lifted Cholesky
(linalg/condensed.py), the banded condensed backend for models that declare
an NLPStructure (linalg/banded_kkt.py, structured assembly from band and
window probes, refinement through its exact operator), the supernodal
sparse LDL^T (linalg/sparse_kkt.py) or, with a process group, the
distributed dense LDL^T (parallel/dist_ldlt.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from uno_tpu_torch.ingredients import barrier as bar
from uno_tpu_torch.ingredients import filters as flt
from uno_tpu_torch.ingredients.regularization import (pick_factorizer,
                                                      regularize_and_factor)
from uno_tpu_torch.linalg.banded_kkt import (BandedKKT, dense_from_windows,
                                             make_banded_kkt_backend)
from uno_tpu_torch.linalg.ldlt import ldlt_solve
from uno_tpu_torch.model import transforms
from uno_tpu_torch.model.nlp import NLP, vector_norm
from uno_tpu_torch.options import Options
from uno_tpu_torch.utils.timer import over_time_limit

# status codes
RUNNING = 0
OPTIMAL = 1            # FEASIBLE_KKT_POINT at tight tolerance
ALMOST_OPTIMAL = 2     # FEASIBLE_KKT_POINT at loose tolerance (15 consecutive)
INFEASIBLE_STATIONARY = 3
UNBOUNDED = 4
ALGORITHMIC_ERROR = 5  # unstable regularization / LS failed
MAX_ITERATIONS = 6
TIME_LIMIT = 7         # reference OptimizationStatus::TIME_LIMIT

STATUS_NAMES = {
    RUNNING: "running",
    OPTIMAL: "optimal",
    ALMOST_OPTIMAL: "almost_optimal",
    INFEASIBLE_STATIONARY: "infeasible_stationary_point",
    UNBOUNDED: "unbounded",
    ALGORITHMIC_ERROR: "algorithmic_error",
    MAX_ITERATIONS: "iteration_limit",
    TIME_LIMIT: "time_limit",
}

# stands in for an infinite bound; uno_tpu's value, kept so both packages
# see the same barrier terms
LARGE_BOUND = 1e25
# cap of the barrier-update loop: each trip divides mu by >= 1/barrier_k_mu
# until it reaches tolerance/barrier_update_fraction, so a few dozen trips
# cover any mu a float64 can hold
MAX_BARRIER_UPDATES = 500

# since the last reset_counts(): calls of a step (each over a batch) and the
# trips of their line searches' host loop, summed; read by chip_smoke.py
counts = {"steps": 0, "line_search_trips": 0}


def reset_counts() -> None:
    counts.update(dict.fromkeys(counts, 0))


class IPMState(NamedTuple):
    # primal-dual iterate (n includes slacks from homogenization), (B, .)
    x: torch.Tensor
    y: torch.Tensor       # optimality constraint multipliers (B, m)
    zl: torch.Tensor      # optimality bound duals (B, n)
    zu: torch.Tensor
    # feasibility-phase multipliers
    y_f: torch.Tensor
    zl_f: torch.Tensor
    zu_f: torch.Tensor
    # l1 elastics (restoration phase), strictly positive placeholders in OPT
    p: torch.Tensor       # (B, m)
    q: torch.Tensor
    zp: torch.Tensor
    zq: torch.Tensor
    # barrier, (B,)
    mu: torch.Tensor
    mu_backup: torch.Tensor
    prev_delta: torch.Tensor
    # phase machine
    phase: torch.Tensor           # 0 = optimality, 1 = feasibility restoration
    skip_mu_update: torch.Tensor  # bool: first iteration after entering FEAS
    subproblem_changed: torch.Tensor
    # globalization
    filter: flt.FilterState
    gs_scalar: torch.Tensor
    x_ref: torch.Tensor           # proximal center (restoration)
    h_ref: torch.Tensor           # reference infeasibility at phase switch
    h_initial: torch.Tensor
    # progress measures of the current iterate
    h_cur: torch.Tensor
    f_cur: torch.Tensor
    aux_cur: torch.Tensor
    # residuals of the current iterate
    stat: torch.Tensor
    stat_scaling: torch.Tensor
    compl: torch.Tensor
    compl_scaling: torch.Tensor
    primal_feas: torch.Tensor
    feas_stat: torch.Tensor
    feas_stat_scaling: torch.Tensor
    feas_compl: torch.Tensor
    feas_compl_scaling: torch.Tensor
    # bookkeeping
    loose_count: torch.Tensor
    iteration: torch.Tensor
    status: torch.Tensor
    step_norm: torch.Tensor
    num_subproblems: torch.Tensor
    num_factorizations: torch.Tensor
    num_obj_evals: torch.Tensor
    num_con_evals: torch.Tensor
    # per-instance NLP parameters (B, ...), or None
    params: Optional[torch.Tensor]


@dataclass(frozen=True)
class IPMWorkspace:
    """Static problem data of the reformulated NLP."""
    n: int
    m: int
    lb: np.ndarray
    ub: np.ndarray
    has_lb: np.ndarray
    has_ub: np.ndarray
    n_bounded: int       # |lb set| + |ub set|  (residual scalings)
    constrained: bool
    _cache: dict = field(default_factory=dict, init=False, compare=False,
                         repr=False)

    def bounds(self, device):
        """(lb, ub, has_lb, has_ub) as float64 / bool tensors on `device`."""
        device = torch.device(device)
        out = self._cache.get(device)
        if out is None:
            out = self._cache[device] = (
                torch.as_tensor(self.lb, dtype=torch.float64, device=device),
                torch.as_tensor(self.ub, dtype=torch.float64, device=device),
                torch.as_tensor(self.has_lb, device=device),
                torch.as_tensor(self.has_ub, device=device))
        return out


def _build_workspace(prob: NLP) -> IPMWorkspace:
    has_lb, has_ub = prob.has_x_lb, prob.has_x_ub
    lb = np.where(has_lb, prob.x_lb, -LARGE_BOUND)
    ub = np.where(has_ub, prob.x_ub, LARGE_BOUND)
    return IPMWorkspace(
        n=prob.n, m=prob.m, lb=lb, ub=ub,
        has_lb=has_lb, has_ub=has_ub,
        n_bounded=int(has_lb.sum() + has_ub.sum()),
        constrained=prob.m > 0,
    )


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


def _rmatvec(A, y):
    """A^T y for each instance."""
    return (A.transpose(-1, -2) @ y[..., None])[..., 0]


def _max0(v):
    """max(0, max over the last axis): jnp.max(v, initial=0.0)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.clamp(torch.amax(v, dim=-1), min=0.0)


def _masked_full(mask, value, like):
    """(B, n) tensor like `like`: value where mask (n,), else +0.0."""
    full = torch.full(mask.shape, value, dtype=like.dtype, device=like.device)
    return torch.where(mask, full, 0.0).expand_as(like)


def _where(cond, a, b):
    """Per-instance select: cond (B,) against (B, ...) tensors."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _tile(v, k: int):
    """k copies of the batch v, stacked on its leading axis (a FilterState
    field by field; None stays None)."""
    if v is None:
        return None
    if isinstance(v, flt.FilterState):
        return flt.FilterState(*(_tile(t, k) for t in v))
    return v.repeat((k,) + (1,) * (v.dim() - 1))


# --------------------------------------------------------------------------
# residuals & termination  (ConstraintRelaxationStrategy.cpp:128-258)
# --------------------------------------------------------------------------

def _residuals(prob: NLP, ws: IPMWorkspace, opts: Options, x, y, zl, zu,
               y_f, zl_f, zu_f, p, q, zp, zq, sigma, nu, params=None):
    g = prob.objective_gradient(x, params)
    c = prob.constraints(x, params)
    J = prob.constraint_jacobian(x, params)
    lbj, ubj, hlb, hub = ws.bounds(x.device)
    rn = opts.residual_norm

    # optimality stationarity: sigma*grad f - J^T y - zl - zu
    cons_contrib = -(_rmatvec(J, y) if ws.m else torch.zeros_like(x)) - zl - zu
    stat = vector_norm(sigma[:, None] * g + cons_contrib, rn)
    # primal feasibility (homogenized model: all equalities at 0)
    primal_feas = prob.constraint_violation(c, rn)
    compl_vec = bar.bound_complementarity_error(x, zl, zu, lbj, ubj, hlb, hub)
    compl = vector_norm(compl_vec, rn)

    thr = opts.residual_scaling_threshold
    ones = torch.ones_like(stat)

    def stat_scaling_of(yv, zlv, zuv):
        total = ws.n_bounded + ws.m
        if total == 0:
            return ones
        norm1 = torch.sum(torch.abs(yv), dim=-1) + torch.sum(torch.abs(zlv), dim=-1) \
            + torch.sum(torch.abs(zuv), dim=-1)
        return torch.clamp(norm1 / (thr * total), min=1.0)

    def compl_scaling_of(zlv, zuv):
        if ws.n_bounded == 0:
            return ones
        norm1 = torch.sum(torch.abs(zlv), dim=-1) + torch.sum(torch.abs(zuv), dim=-1)
        return torch.clamp(norm1 / (thr * ws.n_bounded), min=1.0)

    stat_scaling = stat_scaling_of(y, zl, zu)
    compl_scaling = compl_scaling_of(zl, zu)

    # feasibility problem (l1 relaxed, rho=0, no proximal) residuals
    feas_x = -(_rmatvec(J, y_f) if ws.m else torch.zeros_like(x)) - zl_f - zu_f
    if ws.m:
        feas_p = nu - y_f - zp
        feas_q = nu + y_f - zq
        feas_stat = vector_norm(torch.cat([feas_x, feas_p, feas_q], dim=-1), rn)
        el_compl = torch.cat([torch.where(zp > 0, zp * p, 0.0),
                              torch.where(zq > 0, zq * q, 0.0)], dim=-1)
    else:
        feas_stat = vector_norm(feas_x, rn)
        el_compl = x.new_zeros((x.shape[0], 0))
    feas_compl_vec = bar.bound_complementarity_error(x, zl_f, zu_f, lbj, ubj, hlb, hub)
    feas_compl = vector_norm(torch.cat([feas_compl_vec, el_compl], dim=-1), rn)
    feas_stat_scaling = stat_scaling_of(y_f, zl_f, zu_f)
    feas_compl_scaling = compl_scaling_of(zl_f, zu_f)

    return dict(stat=stat, stat_scaling=stat_scaling, compl=compl,
                compl_scaling=compl_scaling, primal_feas=primal_feas,
                feas_stat=feas_stat, feas_stat_scaling=feas_stat_scaling,
                feas_compl=feas_compl, feas_compl_scaling=feas_compl_scaling)


def _first_order_status(ws, opts, res, sigma, y_f, zl_f, zu_f, tol):
    """IterateStatus per tolerance (check_first_order_convergence :230-258)."""
    stationarity = res["stat"] / res["stat_scaling"] <= tol
    primal_feas_ok = res["primal_feas"] <= tol
    compl_ok = res["compl"] / res["compl_scaling"] <= tol
    kkt = stationarity & primal_feas_ok & (sigma > 0) & compl_ok

    feas_stat_ok = res["feas_stat"] <= tol
    feas_compl_ok = res["feas_compl"] <= tol
    nontrivial = (_max0(torch.abs(y_f)) > tol) | (_max0(torch.abs(zl_f + zu_f)) > tol)
    infeas_stat = feas_stat_ok & ~primal_feas_ok & feas_compl_ok & nontrivial
    if not ws.constrained:
        infeas_stat = torch.zeros_like(infeas_stat)
    return kkt, infeas_stat


# --------------------------------------------------------------------------
# barrier parameter update  (BarrierParameterUpdateStrategy.cpp:33-63)
# --------------------------------------------------------------------------

def _update_barrier_parameter(ws, opts, mu, x, zl, zu, p, q, zp, zq, is_feas,
                              sigma, stat, stat_scaling, compl, compl_scaling,
                              primal_feas):
    lbj, ubj, hlb, hub = ws.bounds(x.device)
    scaled_stat = stat / stat_scaling
    pf = torch.where(sigma == 0.0, 0.0, primal_feas)
    error0 = torch.maximum(torch.maximum(scaled_stat, pf), compl / compl_scaling)
    tol_fraction = opts.tolerance / opts.barrier_update_fraction

    def centrality(mu_n):
        e = bar.centrality_error(x, zl, zu, lbj, ubj, hlb, hub, mu_n)
        if ws.m:
            # elastic complementarity enters in the feasibility phase
            e_p = _max0(torch.where(zp > 0, torch.abs(zp * p - mu_n[:, None]), 0.0))
            e_q = _max0(torch.where(zq > 0, torch.abs(zq * q - mu_n[:, None]), 0.0))
            e = torch.where(is_feas, torch.maximum(e, torch.maximum(e_p, e_q)), e)
        return e

    mu_c, err = mu, error0
    changed = torch.zeros_like(is_feas)
    for _ in range(MAX_BARRIER_UPDATES):
        active = (err <= opts.barrier_k_epsilon * mu_c) & (tol_fraction < mu_c)
        if not bool(active.any()):
            break
        mu_n = torch.clamp(torch.minimum(opts.barrier_k_mu * mu_c,
                                         torch.pow(mu_c, opts.barrier_theta_mu)),
                           min=tol_fraction)
        cent = centrality(mu_n) / compl_scaling
        err_n = torch.maximum(torch.maximum(scaled_stat, pf), cent)
        mu_c = torch.where(active, mu_n, mu_c)
        err = torch.where(active, err_n, err)
        changed = changed | active
    return mu_c, changed


# --------------------------------------------------------------------------
# the solver step
# --------------------------------------------------------------------------

def make_ipm_step(prob: NLP, ws: IPMWorkspace, opts: Options,
                  kkt_backend=None):
    """The batched single-outer-iteration function state -> state.
    kkt_backend: None for the dense augmented LDL^T, or a (factorize,
    solve[, matvec]) tuple replacing it; with a matvec it is the structured
    (banded) backend, whose assembly is a BandedKKT and whose matvec is the
    exact augmented operator of the refinement.

    The globalization strategy (reference GlobalizationStrategyFactory.cpp:
    l1_merit | fletcher_filter_method | waechter_filter_method |
    funnel_method), the filter type (standard | nonmonotone), the Hessian
    model (exact | identity | zero) and the line search's candidates per
    trip (LS_batch_candidates) are chosen here, as in uno_tpu."""
    gs = opts.globalization_strategy
    if gs not in ("l1_merit", "fletcher_filter_method",
                  "waechter_filter_method", "funnel_method"):
        raise ValueError(f"unknown globalization strategy {gs!r}")
    filter_method = gs in ("waechter_filter_method", "fletcher_filter_method")
    nonmono = opts.filter_type == "nonmonotone"
    max_dom = opts.nonmonotone_filter_number_dominated_entries
    beta, gamma = opts.filter_beta, opts.filter_gamma
    NC = max(1, int(opts.LS_batch_candidates))

    def _flt_acceptable(f, h_t, phi_t):
        if nonmono:
            return flt.nm_filter_acceptable(f, h_t, phi_t, beta, gamma, max_dom)
        return flt.filter_acceptable(f, h_t, phi_t, beta, gamma)

    def _flt_acceptable_wrt(f, h_c, phi_c, h_t, phi_t):
        if nonmono:
            return flt.nm_filter_acceptable_wrt(f, h_c, phi_c, h_t, phi_t,
                                                beta, gamma, max_dom)
        return flt.filter_acceptable_wrt(h_c, phi_c, h_t, phi_t, beta, gamma)

    def _flt_add(f, h_c, phi_c):
        if nonmono:
            return flt.nm_filter_add(f, h_c, phi_c, max_dom)
        return flt.filter_add(f, h_c, phi_c, beta)

    def _actual_reduction(f, merit_cur, h_cur, merit_tri, roundoff):
        if nonmono:
            return flt.nm_actual_objective_reduction(
                f, merit_cur, h_cur, merit_tri, gamma, max_dom) + roundoff
        return merit_cur - merit_tri + roundoff

    if kkt_backend:
        kkt_factorizer, kkt_solver = kkt_backend[0], kkt_backend[1]
        kkt_matvec = kkt_backend[2] if len(kkt_backend) > 2 else None
    else:
        kkt_factorizer = kkt_matvec = None
        kkt_solver = ldlt_solve
    banded = kkt_matvec is not None
    n, m = ws.n, ws.m
    nu = opts.l1_constraint_violation_coefficient
    damping = opts.barrier_damping_factor
    eps_machine = float(np.finfo(np.float64).eps)
    kkt32 = opts.kkt_dtype == "float32"
    if banded:
        bst = prob.structure
        slack_cols = prob.slack_of_constraint \
            if prob.slack_of_constraint is not None \
            else np.full(m, -1, dtype=np.int64)
        n0_b = n - int(np.sum(slack_cols >= 0))

    def prox_scaling(x_ref):
        s = torch.clamp(1.0 / torch.clamp(torch.abs(x_ref), min=1e-35), max=1.0)
        return s * s

    def progress(x, p, q, mu, is_feas, params, bounds):
        lbj, ubj, hlb, hub = bounds
        f_val = prob.objective(x, params)
        c = prob.constraints(x, params)
        h = prob.constraint_violation(c, opts.progress_norm)
        aux = bar.barrier_auxiliary_measure(x, lbj, ubj, hlb, hub, mu, damping)
        if m:
            # elastics are single-lower-bounded at 0
            ael = mu * torch.sum(-torch.log(torch.clamp(p, min=1e-35))
                                 - torch.log(torch.clamp(q, min=1e-35))
                                 + damping * (p + q), dim=-1)
            aux = aux + torch.where(is_feas, ael, 0.0)
        return h, f_val, aux

    def step(s: IPMState) -> IPMState:
        counts["steps"] += 1
        bounds = ws.bounds(s.x.device)
        lbj, ubj, hlb, hub = bounds
        is_feas = s.phase == 1
        fe = is_feas[:, None]
        sigma = (~is_feas).to(s.x.dtype)

        # active multiplier set for the current phase
        y_a = torch.where(fe, s.y_f, s.y)
        zl_a = torch.where(fe, s.zl_f, s.zl)
        zu_a = torch.where(fe, s.zu_f, s.zu)

        # -- barrier parameter update (uses current-iterate residuals) -------
        mu_new, mu_changed = _update_barrier_parameter(
            ws, opts, s.mu, s.x, zl_a, zu_a, s.p, s.q, s.zp, s.zq, is_feas,
            sigma,
            torch.where(is_feas, s.feas_stat, s.stat),
            torch.where(is_feas, s.feas_stat_scaling, s.stat_scaling),
            torch.where(is_feas, s.feas_compl, s.compl),
            torch.where(is_feas, s.feas_compl_scaling, s.compl_scaling),
            s.primal_feas)
        mu = torch.where(s.skip_mu_update, s.mu, mu_new)
        mu_changed = mu_changed & ~s.skip_mu_update

        # subproblem changed -> reset the filter (keep its upper bound)
        changed = (s.subproblem_changed | mu_changed)[:, None]
        filt = flt.FilterState(torch.where(changed, flt.BIG, s.filter.h),
                               torch.where(changed, flt.BIG, s.filter.phi),
                               s.filter.ub)

        h_cur, f_cur, aux_cur = progress(s.x, s.p, s.q, mu, is_feas, s.params,
                                         bounds)
        merit_cur = f_cur + aux_cur

        # -- 1. derivatives at the current x --------------------------------
        g = prob.objective_gradient(s.x, s.params)
        c = prob.constraints(s.x, s.params)
        if banded:
            # windowed Jacobian (w jvp probes) and Hessian band (2b+1 hvp
            # probes); the dense J is still built, by a scatter, for the
            # rhs, the line search and the residuals
            if m:
                J_local = prob.constraint_jacobian_windows(s.x, s.params)
                J = dense_from_windows(J_local, bst.jac_starts, n, slack_cols)
            else:
                J_local = s.x.new_zeros((s.x.shape[0], 0, max(bst.jac_width, 1)))
                J = prob.constraint_jacobian(s.x, s.params)
            # the Hessian model (reference hessian_models/: exact | identity
            # | zero, HessianModelFactory.cpp); identity puts 1 on the
            # slack diagonal too
            if opts.hessian_model == "identity":
                H_band = s.x.new_zeros((s.x.shape[0], bst.hess_bandwidth + 1, n0_b))
                H_band[:, 0, :] = 1.0
                hess_slack_diag = 1.0
            elif opts.hessian_model == "zero":
                H_band = s.x.new_zeros((s.x.shape[0], bst.hess_bandwidth + 1, n0_b))
                hess_slack_diag = 0.0
            else:
                H_band = prob.lagrangian_hessian_band(
                    s.x, y_a, sigma, s.params)[:, :, :n0_b]
                hess_slack_diag = 0.0
        else:
            J = prob.constraint_jacobian(s.x, s.params)
            if opts.hessian_model == "identity":
                H_lag = torch.eye(n, dtype=s.x.dtype, device=s.x.device) \
                    .expand(s.x.shape[0], n, n)
            elif opts.hessian_model == "zero":
                H_lag = s.x.new_zeros((s.x.shape[0], n, n))
            else:
                H_lag = prob.lagrangian_hessian(s.x, y_a, sigma, s.params)

        # -- 2. barrier terms (+ the restoration proximal term) -------------
        prox_coef = torch.sqrt(mu)[:, None]
        prox_diag = torch.where(fe, prox_coef * prox_scaling(s.x_ref), 0.0)
        Sigma = bar.barrier_hessian_diag(s.x, zl_a, zu_a, lbj, ubj, hlb, hub)
        if not banded:
            H = H_lag + torch.diag_embed(prox_diag + Sigma)
        g_bar = sigma[:, None] * g \
            + bar.barrier_gradient(s.x, lbj, ubj, hlb, hub, mu, damping) \
            + torch.where(fe, prox_coef * prox_scaling(s.x_ref) * (s.x - s.x_ref), 0.0)
        rhs_x = -(g_bar - _rmatvec(J, y_a)) if m else -g_bar

        # -- 3. KKT assembly with the condensed restoration elastics --------
        if m:
            mu_c = mu[:, None]
            r_p = nu + damping * mu_c - mu_c / s.p - y_a
            r_q = nu + damping * mu_c - mu_c / s.q + y_a
            inv_sp = s.p / s.zp
            inv_sq = s.q / s.zq
            D_e = torch.where(fe, inv_sp + inv_sq, 0.0)
            r_c = c + torch.where(fe, s.p - s.q, 0.0)
            rhs_c = -r_c + torch.where(fe, inv_sp * r_p - inv_sq * r_q, 0.0)
            rhs = torch.cat([rhs_x, rhs_c], dim=-1)
        else:
            rhs = rhs_x
        if banded:
            C0 = D_e if m else s.x.new_zeros((s.x.shape[0], 0))

            def assemble(delta, eps):
                sd = prox_diag + Sigma
                return BandedKKT(H_band=H_band,
                                 diag0=sd[:, :n0_b] + delta[:, None],
                                 sig_s=sd[:, n0_b:] + hess_slack_diag + delta[:, None],
                                 J_local=J_local, C=C0 + eps[:, None])

            kkt_mv = kkt_matvec
        else:
            eye_n = torch.eye(n, dtype=H.dtype, device=H.device)

            def assemble(delta, eps):
                Hd = H + delta[:, None, None] * eye_n
                if m == 0:
                    return Hd
                dual_block = -torch.diag_embed(D_e + eps[:, None])
                return torch.cat([torch.cat([Hd, J.transpose(-1, -2)], dim=-1),
                                  torch.cat([J, dual_block], dim=-1)], dim=-2)

            kkt_mv = _matvec

        # -- 4. inertia-corrected factorization ------------------------------
        dual_reg_param = torch.pow(mu, opts.barrier_regularization_exponent)
        reg = regularize_and_factor(assemble, n, m, dual_reg_param,
                                    s.prev_delta, opts, block=opts.ldlt_block_size,
                                    factorizer=kkt_factorizer)

        # -- 5. solve: f32 factors + f64 refinement, or f64 throughout; the
        # banded backend refines in f64 too (its lifted tau leaves an
        # O(tau |w|) error on the equality rows)
        if kkt32:
            sol = kkt_solver(reg.fac, rhs.to(torch.float32)).to(rhs.dtype)
            K64 = assemble(reg.delta, reg.eps)
            for _ in range(opts.kkt_refinement_steps):
                resid = rhs - kkt_mv(K64, sol)
                sol = sol + kkt_solver(reg.fac, resid.to(torch.float32)).to(rhs.dtype)
        else:
            sol = kkt_solver(reg.fac, rhs)
            if banded:
                K64 = assemble(reg.delta, reg.eps)
                for _ in range(opts.kkt_refinement_steps):
                    sol = sol + kkt_solver(reg.fac, rhs - kkt_mv(K64, sol))
        dx = sol[:, :n]
        w = sol[:, n:]
        dy = -w
        kkt_failed = reg.failed  # unstable regularization -> restoration

        # -- direction assembly + fraction-to-boundary ----------------------
        dzl, dzu = bar.bound_dual_direction(s.x, dx, zl_a, zu_a, lbj, ubj, hlb, hub, mu)
        if m:
            dp = torch.where(fe, inv_sp * (-r_p - w), 0.0)
            dq = torch.where(fe, inv_sq * (-r_q + w), 0.0)
            dzp = torch.where(fe, (mu_c - dp * s.zp) / s.p - s.zp, 0.0)
            dzq = torch.where(fe, (mu_c - dq * s.zq) / s.q - s.zq, 0.0)
        else:
            dp = dq = dzp = dzq = w     # (B, 0): no constraints, no elastics

        tau = torch.clamp(1.0 - mu, min=opts.barrier_tau_min)
        alpha_p = bar.primal_fraction_to_boundary(s.x, dx, lbj, ubj, hlb, hub, tau)
        alpha_z = bar.dual_fraction_to_boundary(zl_a, zu_a, dzl, dzu, hlb, hub, tau)
        if m:
            # elastics: lower bound 0 on p, q; their duals zp, zq stay > 0
            zero_m = s.p.new_zeros((m,))
            big_m = zero_m + LARGE_BOUND
            tm = torch.ones((m,), dtype=torch.bool, device=s.p.device)
            fm = ~tm
            a_pp = bar.primal_fraction_to_boundary(s.p, dp, zero_m, big_m, tm, fm, tau)
            a_pq = bar.primal_fraction_to_boundary(s.q, dq, zero_m, big_m, tm, fm, tau)
            a_zp = bar.primal_fraction_to_boundary(s.zp, dzp, zero_m, big_m, tm, fm, tau)
            a_zq = bar.primal_fraction_to_boundary(s.zq, dzq, zero_m, big_m, tm, fm, tau)
            alpha_p = torch.where(is_feas, torch.minimum(alpha_p, torch.minimum(a_pp, a_pq)), alpha_p)
            alpha_z = torch.where(is_feas, torch.minimum(alpha_z, torch.minimum(a_zp, a_zq)), alpha_z)

        ap, az = alpha_p[:, None], alpha_z[:, None]
        dx = dx * ap
        dy = dy * ap
        dzl, dzu = dzl * az, dzu * az
        dp, dq = dp * ap, dq * ap
        dzp, dzq = dzp * az, dzq * az
        dir_norm = _max0(torch.abs(dx))

        # -- 6. backtracking line search ------------------------------------
        if opts.protect_actual_reduction_against_roundoff:
            roundoff = 10.0 * eps_machine * torch.abs(merit_cur)
        else:
            roundoff = torch.zeros_like(merit_cur)
        Jdx = _matvec(J, dx)
        gdx = torch.sum(g * dx, dim=-1)
        bdd_h = bar.barrier_directional_derivative(s.x, dx, lbj, ubj, hlb, hub,
                                                   mu, damping)
        if m:
            el_dd_h = torch.sum((-mu_c / s.p + damping * mu_c) * dp
                                + (-mu_c / s.q + damping * mu_c) * dq, dim=-1)
            bdd_h = bdd_h + torch.where(is_feas, el_dd_h, 0.0)
        prim_step = dir_norm
        if m:
            prim_step = torch.maximum(prim_step, torch.maximum(
                _max0(torch.abs(dp)), _max0(torch.abs(dq))))

        # what a trial reads of each instance; the NC candidates of a trip
        # are evaluated as NC copies of the batch, candidate-major
        frozen = dict(x=s.x, dx=dx, y=y_a, dy=dy, zl=zl_a, zu=zu_a, dzl=dzl,
                      dzu=dzu, p=s.p, q=s.q, dp=dp, dq=dq, zp=s.zp, zq=s.zq,
                      dzp=dzp, dzq=dzq, mu=mu, is_feas=is_feas, params=s.params,
                      c=c, Jdx=Jdx, gdx=gdx, bdd_h=bdd_h, h_cur=h_cur,
                      f_cur=f_cur, aux_cur=aux_cur, merit_cur=merit_cur,
                      roundoff=roundoff, prim_step=prim_step,
                      h_initial=s.h_initial, gs_scalar=s.gs_scalar, filt=filt)

        def ls_trial(alpha, v):
            a = alpha[:, None]
            fe_, mu_ = v["is_feas"][:, None], v["mu"]
            mu_c_ = mu_[:, None]
            h_c, m_c = v["h_cur"], v["merit_cur"]
            dual_a = a if opts.LS_scale_duals_with_step_length else 1.0
            x_t = torch.clamp(v["x"] + a * v["dx"], lbj, ubj)
            y_t = v["y"] + dual_a * v["dy"]
            zl_t, zu_t = v["zl"] + v["dzl"], v["zu"] + v["dzu"]
            p_t = v["p"] + a * v["dp"]
            q_t = v["q"] + a * v["dq"]
            zp_t, zq_t = v["zp"] + v["dzp"], v["zq"] + v["dzq"]
            # postprocess: k_sigma rescale (PrimalDualInteriorPointProblem:348)
            zl_t, zu_t = bar.k_sigma_rescale(x_t, zl_t, zu_t, lbj, ubj, hlb, hub,
                                             mu_, opts.barrier_k_sigma)
            if m:
                ks = opts.barrier_k_sigma
                coef = mu_c_ / torch.clamp(p_t, min=1e-35)
                zp_t = torch.where(fe_, torch.clamp(zp_t, coef / ks, coef * ks), zp_t)
                coef = mu_c_ / torch.clamp(q_t, min=1e-35)
                zq_t = torch.where(fe_, torch.clamp(zq_t, coef / ks, coef * ks), zq_t)
            h_t, f_t, aux_t = progress(x_t, p_t, q_t, mu_, v["is_feas"],
                                       v["params"], bounds)
            finite = torch.isfinite(f_t) & torch.isfinite(h_t) & torch.isfinite(aux_t)

            # predicted reductions at step length alpha
            c_lin = v["c"] + a * v["Jdx"]
            pred_h = h_c - prob.constraint_violation(c_lin, opts.progress_norm)
            pred_obj = alpha * (-v["gdx"])  # evaluated at multiplier 1
            pred_aux = alpha * (-v["bdd_h"])

            # the strategy's regular test; `augment` means "add the current
            # point to the filter" for the filter methods and "h-type width
            # update" for the funnel, applied once after the line search
            f = v["filt"]
            merit_t = f_t + aux_t
            merit_pred = pred_obj + pred_aux
            switching = (merit_pred > 0.0) & flt.switching_condition(
                merit_pred, h_c, opts.switching_delta,
                opts.switching_infeasibility_exponent)
            sufficient = flt.armijo_sufficient_decrease(
                merit_pred, _actual_reduction(f, m_c, h_c, merit_t, v["roundoff"]),
                opts.armijo_decrease_fraction, opts.armijo_tolerance)
            if gs == "waechter_filter_method":
                # WaechterFilterMethod.cpp:25-90
                small_inf = h_c <= 1e-4 * torch.clamp(v["h_initial"], min=1.0)
                f_type = small_inf & switching
                accept_h = ~f_type & _flt_acceptable_wrt(f, h_c, m_c, h_t, merit_t)
                accept_reg = _flt_acceptable(f, h_t, merit_t) \
                    & ((f_type & sufficient) | accept_h)
                augment_t = accept_reg & (~switching | ~sufficient)
            elif gs == "fletcher_filter_method":
                # FletcherFilterMethod.cpp:15-66
                pair_ok = _flt_acceptable(f, h_t, merit_t) \
                    & _flt_acceptable_wrt(f, h_c, m_c, h_t, merit_t)
                accept_reg = pair_ok & torch.where(switching, sufficient, True)
                augment_t = accept_reg & ~switching
            elif gs == "funnel_method":
                dec = flt.funnel_is_acceptable(v["gs_scalar"], h_c, m_c, h_t,
                                               merit_t, merit_pred, opts,
                                               v["roundoff"])
                accept_reg, augment_t = dec.accept, dec.h_type
            else:  # l1_merit (l1MeritFunction.cpp); sigma = 1 in this phase
                accept_reg = flt.l1_merit_acceptable(
                    h_c, v["f_cur"], v["aux_cur"], h_t, f_t, aux_t,
                    pred_h, pred_obj, pred_aux, opts, v["roundoff"])
                augment_t = torch.zeros_like(accept_reg)
            accept_feas = flt.feasibility_armijo_acceptable(
                h_c, v["aux_cur"], h_t, aux_t, pred_h, pred_aux, opts)
            accept = torch.where(v["is_feas"], accept_feas, accept_reg) & finite
            # a pure dual-correction step (no primal move, x AND elastics)
            # is accepted to pick up the fresh multipliers
            # (ConstraintRelaxationStrategy.cpp:110-115); 1e-10 over the
            # f32-factorization solve dust
            accept = accept | (v["prim_step"] <= 1e-10)
            augment = augment_t & ~v["is_feas"]
            trial = (x_t, y_t, zl_t, zu_t, p_t, q_t, zp_t, zq_t, h_t, f_t, aux_t)
            return accept, trial, augment

        B = s.x.shape[0]
        alpha = torch.ones_like(mu)
        accepted = torch.zeros_like(is_feas)
        ls_failed = torch.zeros_like(is_feas)
        ls_iters = torch.zeros_like(s.iteration)
        trial = (s.x, y_a, zl_a, zu_a, s.p, s.q, s.zp, s.zq, h_cur, f_cur, aux_cur)
        augment = torch.zeros_like(is_feas)
        tiled = {k: _tile(v, NC) for k, v in frozen.items()} if NC > 1 else frozen
        ratios = torch.pow(torch.full((NC,), opts.LS_backtracking_ratio,
                                      dtype=mu.dtype, device=mu.device),
                           torch.arange(NC, dtype=mu.dtype, device=mu.device))
        cand = torch.arange(NC, device=mu.device)[:, None]
        cols = torch.arange(B, device=mu.device)
        for _ in range(opts.max_line_search_iterations):
            active = ~accepted & ~ls_failed & (ls_iters < opts.max_line_search_iterations)
            if not bool(active.any()):
                break
            counts["line_search_trips"] += 1
            # NC candidates {a, a r, ..., a r^(NC-1)} in one trip, the
            # first acceptable one taken: the sequential loop's
            # decisions, since a trial reads only the frozen current
            # iterate and filter (uno_tpu's vectorized line search)
            alphas = alpha[None, :] * ratios[:, None]             # (NC, B)
            acc_v, tr_v, aug_v = ls_trial(alphas.reshape(-1), tiled)
            acc_v, aug_v = acc_v.reshape(NC, B), aug_v.reshape(NC, B)
            small = alphas < opts.LS_min_step_length
            any_small = small.any(dim=0)
            # the sequential loop stops at the first too-small alpha
            last = torch.where(any_small, torch.argmax(small.to(torch.int8), dim=0),
                               NC - 1)
            acc_t = acc_v & (cand <= last)
            acc = acc_t.any(dim=0)
            idx = torch.argmax(acc_t.to(torch.int8), dim=0)   # first acceptable
            tr = tuple(t.reshape((NC, B) + t.shape[1:])[idx, cols] for t in tr_v)
            aug = aug_v[idx, cols]
            fail = ~acc & any_small
            alpha_next = torch.where(
                acc, alphas[idx, cols],
                torch.where(fail, alpha, alpha * opts.LS_backtracking_ratio ** NC))
            tried = torch.where(acc, idx + 1, last + 1)
            take = active & acc
            trial = tuple(_where(take, b, a_) for a_, b in zip(trial, tr))
            augment = torch.where(take, aug, augment)
            alpha = torch.where(active, alpha_next, alpha)
            accepted = torch.where(active, acc, accepted)
            ls_failed = torch.where(active, fail, ls_failed)
            ls_iters = ls_iters + torch.where(active, tried, 0)
        # a failed KKT solve invalidates the direction entirely
        accepted = accepted & ~kkt_failed
        ls_failed = ls_failed | kkt_failed | \
            (~accepted & ~kkt_failed & (ls_iters >= opts.max_line_search_iterations))

        (x_t, yv_t, zl_t, zu_t, p_t, q_t, zp_t, zq_t, h_t, f_t, aux_t) = trial

        # deferred globalization state update (once, not per trial)
        gs_scalar = s.gs_scalar
        if filter_method:
            filt = flt.filter_select(augment & accepted, filt,
                                     _flt_add(filt, h_cur, merit_cur))
        elif gs == "funnel_method":
            w_new = flt.funnel_update_width(
                s.gs_scalar, h_cur, h_t, opts.funnel_beta, opts.funnel_kappa,
                opts.funnel_update_strategy)
            gs_scalar = torch.where(augment & accepted, w_new, gs_scalar)
        else:  # l1_merit: the smallest known infeasibility (.cpp:39)
            gs_scalar = torch.where(accepted & ~is_feas,
                                    torch.minimum(gs_scalar, h_t), gs_scalar)

        # -- commit the trial iterate (or keep current on failure) ----------
        acc_opt = accepted & ~is_feas
        acc_feas = accepted & is_feas
        x_n = _where(accepted, x_t, s.x)
        y_n = _where(acc_opt, yv_t, s.y)
        zl_n = _where(acc_opt, zl_t, s.zl)
        zu_n = _where(acc_opt, zu_t, s.zu)
        y_f_n = _where(acc_feas, yv_t, s.y_f)
        zl_f_n = _where(acc_feas, zl_t, s.zl_f)
        zu_f_n = _where(acc_feas, zu_t, s.zu_f)
        p_n = _where(accepted, p_t, s.p)
        q_n = _where(accepted, q_t, s.q)
        zp_n = _where(accepted, zp_t, s.zp)
        zq_n = _where(accepted, zq_t, s.zq)
        h_n = torch.where(accepted, h_t, h_cur)
        f_n = torch.where(accepted, f_t, f_cur)
        aux_n = torch.where(accepted, aux_t, aux_cur)

        # -- phase transitions ----------------------------------------------
        # (a) restoration -> optimality: the strategy's
        # is_infeasibility_sufficiently_reduced (GlobalizationStrategy.hpp:27),
        # or feasible to tolerance
        merit_n = f_n + aux_n
        if gs == "waechter_filter_method":
            # WaechterFilterMethod.cpp:85-88
            inf_reduced = \
                (h_n <= opts.filter_sufficient_infeasibility_decrease_factor * s.h_ref) \
                & _flt_acceptable(filt, h_n, merit_n)
        elif gs == "fletcher_filter_method":
            # FletcherFilterMethod.cpp:66-69: beat the filter's smallest h
            inf_reduced = h_n < beta * torch.amin(filt.h, dim=-1)
        elif gs == "funnel_method":
            # FunnelMethod.cpp:97-100: in the funnel, and a sufficient decrease
            inf_reduced = (h_n <= gs_scalar) & (h_n <= opts.funnel_beta * s.h_ref)
        else:  # l1_merit (.cpp:48-52): beat the best known infeasibility
            inf_reduced = h_n <= 0.9 * gs_scalar
        inf_reduced = inf_reduced | (h_n <= opts.tolerance)
        back_ok = accepted & is_feas & inf_reduced
        # (b) optimality -> restoration: LS failure or unstable KKT
        if ws.constrained:
            to_feas = ls_failed & ~is_feas
            hard_fail = ls_failed & is_feas
        else:
            to_feas = torch.zeros_like(ls_failed)
            hard_fail = ls_failed

        # apply (a): notify_switch_to_optimality — the filter methods record
        # the current point (FilterMethod.cpp:31-39), the funnel shrinks
        # (Funnel::update_restoration), the merit does nothing; then mu is
        # restored
        if filter_method:
            filt = flt.filter_select(back_ok, filt, _flt_add(filt, h_cur, merit_cur))
        elif gs == "funnel_method":
            w_rest = opts.funnel_kappa * gs_scalar + (1.0 - opts.funnel_kappa) * h_cur
            gs_scalar = torch.where(back_ok, w_rest, gs_scalar)
        phase_n = torch.where(back_ok, 0, s.phase)
        mu_n = torch.where(back_ok, s.mu_backup, mu)

        # multiplier safeguard on restoration exit (uno_tpu's reset of
        # oversized multipliers)
        if m:
            y_over = _max0(torch.abs(y_n)) > opts.least_square_multiplier_max_norm
            y_n = _where(back_ok & y_over, torch.zeros_like(y_n), y_n)

        # apply (b): enter restoration at the (unchanged) current iterate
        mu_enter = torch.maximum(mu, s.primal_feas)
        phase_n = torch.where(to_feas, 1, phase_n)
        mu_backup_n = torch.where(to_feas, mu, s.mu_backup)
        mu_n = torch.where(to_feas, mu_enter, mu_n)
        x_ref_n = _where(to_feas, x_n, s.x_ref)
        h_ref_n = torch.where(to_feas, h_n, s.h_ref)
        if m:
            # elastic init p = q = mu/rho, duals = rho (uno_tpu's choice)
            p_init = torch.ones_like(p_n) * (mu_enter / nu)[:, None]
            p_n = _where(to_feas, p_init, p_n)
            q_n = _where(to_feas, p_init, q_n)
            zp_n = _where(to_feas, torch.full_like(zp_n, nu), zp_n)
            zq_n = _where(to_feas, torch.full_like(zq_n, nu), zq_n)
        zl_f_n = _where(to_feas, _masked_full(hlb, opts.barrier_default_multiplier,
                                              zl_f_n), zl_f_n)
        zu_f_n = _where(to_feas, _masked_full(hub, -opts.barrier_default_multiplier,
                                              zu_f_n), zu_f_n)
        # notify_switch_to_feasibility: the filter methods record the
        # current point; the funnel and the merit do nothing
        if filter_method:
            filt = flt.filter_select(to_feas, filt, _flt_add(filt, h_cur, merit_cur))

        changed_next = back_ok | to_feas
        # on an optimality-phase LS failure the termination test runs with
        # the objective multiplier still 1 (uno_tpu's sigma_check)
        sigma_check = torch.where(to_feas | (phase_n != 1), 1.0, 0.0).to(s.x.dtype)

        # -- residuals at the new iterate, with the new phase's multiplier --
        res = _residuals(prob, ws, opts, x_n, y_n, zl_n, zu_n,
                         y_f_n, zl_f_n, zu_f_n, p_n, q_n, zp_n, zq_n,
                         sigma_check, nu, s.params)

        # -- 7. termination ---------------------------------------------------
        kkt_tight, infeas_tight = _first_order_status(
            ws, opts, res, sigma_check, y_f_n, zl_f_n, zu_f_n, opts.tolerance)
        kkt_loose, infeas_loose = _first_order_status(
            ws, opts, res, sigma_check, y_f_n, zl_f_n, zu_f_n, opts.loose_tolerance)

        status = torch.full_like(s.status, RUNNING)
        unbounded = f_n < opts.unbounded_objective_threshold
        loose_any = (kkt_loose | infeas_loose) & (opts.loose_tolerance > opts.tolerance)
        loose_count = torch.where(loose_any, s.loose_count + 1, 0)
        loose_hit = loose_count >= opts.loose_tolerance_consecutive_iteration_threshold

        status = torch.where(loose_hit & kkt_loose, ALMOST_OPTIMAL, status)
        status = torch.where(loose_hit & infeas_loose & ~kkt_loose, INFEASIBLE_STATIONARY, status)
        status = torch.where(infeas_tight, INFEASIBLE_STATIONARY, status)
        status = torch.where(kkt_tight, OPTIMAL, status)
        status = torch.where(unbounded, UNBOUNDED, status)
        status = torch.where(hard_fail, ALGORITHMIC_ERROR, status)
        iteration = s.iteration + 1
        status = torch.where((status == RUNNING) & (iteration >= opts.max_iterations),
                             MAX_ITERATIONS, status)

        return IPMState(
            x=x_n, y=y_n, zl=zl_n, zu=zu_n,
            y_f=y_f_n, zl_f=zl_f_n, zu_f=zu_f_n,
            p=p_n, q=q_n, zp=zp_n, zq=zq_n,
            mu=mu_n, mu_backup=mu_backup_n, prev_delta=reg.prev_delta,
            phase=phase_n,
            skip_mu_update=to_feas,
            subproblem_changed=changed_next,
            filter=filt, gs_scalar=gs_scalar,
            x_ref=x_ref_n, h_ref=h_ref_n, h_initial=s.h_initial,
            h_cur=h_n, f_cur=f_n, aux_cur=aux_n,
            stat=res["stat"], stat_scaling=res["stat_scaling"],
            compl=res["compl"], compl_scaling=res["compl_scaling"],
            primal_feas=res["primal_feas"],
            feas_stat=res["feas_stat"], feas_stat_scaling=res["feas_stat_scaling"],
            feas_compl=res["feas_compl"], feas_compl_scaling=res["feas_compl_scaling"],
            loose_count=loose_count, iteration=iteration, status=status,
            step_norm=alpha * dir_norm,
            num_subproblems=s.num_subproblems + 1,
            num_factorizations=s.num_factorizations + reg.attempts,
            num_obj_evals=s.num_obj_evals + ls_iters + 1,
            num_con_evals=s.num_con_evals + ls_iters + 1,
            params=s.params,
        )

    return step


def make_initial_state(prob: NLP, ws: IPMWorkspace, opts: Options,
                       x0: torch.Tensor, params=None) -> IPMState:
    """generate_initial_iterate (PrimalDualInteriorPointMethod.cpp:64-108)
    for a batch: interior push of the primals x0 (B, n), slack init from
    c(x), default bound duals, least-square constraint multipliers."""
    n, m = ws.n, ws.m
    B, dev, dt = x0.shape[0], x0.device, x0.dtype
    lbj, ubj, hlb, hub = ws.bounds(dev)
    k1 = opts.barrier_push_variable_to_interior_k1
    k2 = opts.barrier_push_variable_to_interior_k2

    x = bar.push_to_interior(x0, lbj, ubj, k1, k2)

    # slacks <- interior push of the model constraint values c_i(x)
    if prob.slack_of_constraint is not None and m:
        cvals = prob.constraints(x, params)
        for ci, si in enumerate(prob.slack_of_constraint.tolist()):
            if si >= 0:
                raw = cvals[:, ci] + x[:, si]   # c_tilde + s == c_model - shift
                x = x.clone()
                x[:, si] = bar.push_to_interior(raw, lbj[si], ubj[si], k1, k2)

    zeros_n = x.new_zeros((B, n))
    zl = _masked_full(hlb, opts.barrier_default_multiplier, zeros_n).clone()
    zu = _masked_full(hub, -opts.barrier_default_multiplier, zeros_n).clone()

    # least-square multipliers (Preprocessing.cpp:17-75):
    # solve [I J^T; J 0][r; y] = [g - zl - zu; 0], keep y if ||y||inf <= 1e3
    y = x.new_zeros((B, m))
    if m:
        g = prob.objective_gradient(x, params)
        J = prob.constraint_jacobian(x, params)
        eye = torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
        K = torch.cat([torch.cat([eye, J.transpose(-1, -2)], dim=-1),
                       torch.cat([J, x.new_zeros((B, m, m))], dim=-1)], dim=-2)
        rhs = torch.cat([g - zl - zu, x.new_zeros((B, m))], dim=-1)
        # an initialization heuristic: factor in the KKT dtype
        ls_dt = torch.float32 if opts.kkt_dtype == "float32" else dt
        fac = pick_factorizer(n + m, opts.ldlt_block_size)(K.to(ls_dt).contiguous())
        sol = ldlt_solve(fac, rhs.to(ls_dt)).to(dt)
        y_try = sol[:, n:]
        ok = (_max0(torch.abs(y_try)) <= opts.least_square_multiplier_max_norm) \
            & torch.all(torch.isfinite(y_try), dim=-1) & (fac.num_zero == 0)
        y = _where(ok, y_try, torch.zeros_like(y_try))

    mu0 = x.new_full((B,), opts.barrier_initial_parameter)
    ones_m = x.new_ones((B, m))
    zeros_m = x.new_zeros((B, m))
    res = _residuals(prob, ws, opts, x, y, zl, zu, zeros_m, zeros_n, zeros_n,
                     ones_m, ones_m, ones_m, ones_m, x.new_ones((B,)),
                     opts.l1_constraint_violation_coefficient, params)

    c = prob.constraints(x, params)
    h0 = prob.constraint_violation(c, opts.progress_norm)
    f0 = prob.objective(x, params)
    aux0 = bar.barrier_auxiliary_measure(x, lbj, ubj, hlb, hub, mu0,
                                         opts.barrier_damping_factor)

    filt = flt.filter_init(B, opts.filter_capacity, dtype=dt, device=dev)
    # FilterMethod::initialize: ub = max(filter_ubd, filter_fact * h0)
    filt = filt._replace(ub=torch.clamp(opts.filter_fact * h0, min=opts.filter_ubd))

    zero_b = x.new_zeros((B,))
    # the strategy's scalar: the funnel's width (FunnelMethod::initialize) or
    # the merit function's smallest known infeasibility (+inf at first)
    if opts.globalization_strategy == "funnel_method":
        gs_scalar = torch.clamp(opts.funnel_fact * h0, min=opts.funnel_ubd)
    elif opts.globalization_strategy == "l1_merit":
        gs_scalar = torch.full_like(zero_b, float("inf"))
    else:
        gs_scalar = zero_b
    izero = torch.zeros((B,), dtype=torch.int64, device=dev)
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    return IPMState(
        x=x, y=y, zl=zl, zu=zu,
        y_f=zeros_m, zl_f=zeros_n, zu_f=zeros_n,
        p=ones_m, q=ones_m, zp=ones_m, zq=ones_m,
        mu=mu0, mu_backup=mu0, prev_delta=zero_b,
        phase=izero, skip_mu_update=false, subproblem_changed=false,
        filter=filt, gs_scalar=gs_scalar, x_ref=x, h_ref=h0, h_initial=h0,
        h_cur=h0, f_cur=f0, aux_cur=aux0,
        stat=res["stat"], stat_scaling=res["stat_scaling"],
        compl=res["compl"], compl_scaling=res["compl_scaling"],
        primal_feas=res["primal_feas"],
        feas_stat=res["feas_stat"], feas_stat_scaling=res["feas_stat_scaling"],
        feas_compl=res["feas_compl"], feas_compl_scaling=res["feas_compl_scaling"],
        loose_count=izero, iteration=izero, status=izero, step_norm=zero_b,
        num_subproblems=izero, num_factorizations=izero,
        num_obj_evals=izero, num_con_evals=izero,
        params=params,
    )


def _map_state(fn, state):
    """fn over every tensor of a batched state (an IPMState or an
    SQPFState), its filter's included."""
    def one(v):
        if v is None:
            return None
        if isinstance(v, flt.FilterState):
            return flt.FilterState(*(fn(t) for t in v))
        return fn(v)

    return type(state)(*(one(v) for v in state))


def take_instances(state, idx: torch.Tensor):
    """The sub-batch of instances `idx`."""
    return _map_state(lambda t: t.index_select(0, idx), state)


def put_instances(state, idx: torch.Tensor, sub):
    """`state` with the instances `idx` replaced by `sub`."""
    flat = [t for v in sub if v is not None
            for t in (v if isinstance(v, flt.FilterState) else (v,))]
    it = iter(flat)
    return _map_state(lambda t: t.index_copy(0, idx, next(it)), state)


def run_ipm(step, state, opts: Options, t0: float, on_iterate=None,
            max_steps: int | None = None):
    """The outer loop over a batch: step the instances that are still
    RUNNING until none is, at most `max_steps` times (default
    `max_iterations`: the step itself stamps MAX_ITERATIONS there), with
    the wall-clock `time_limit` checked after every step (reference
    Uno.cpp:61-78)."""
    if max_steps is None:
        max_steps = max(opts.max_iterations, 0)
    for _ in range(max_steps):
        running = state.status == RUNNING
        idx = torch.nonzero(running).squeeze(1)
        if idx.numel() == 0:
            break
        if idx.numel() == running.numel():
            state = step(state)
        else:
            state = put_instances(state, idx, step(take_instances(state, idx)))
        if on_iterate is not None:
            on_iterate(state)
        if over_time_limit(t0, opts.time_limit):
            state = state._replace(status=torch.where(
                state.status == RUNNING, TIME_LIMIT, state.status))
            break
    return state


@dataclass
class Result:
    """Reference Result (optimization/Result.hpp:11-29) analogue."""
    status: str
    x: np.ndarray
    y: np.ndarray
    zl: np.ndarray
    zu: np.ndarray
    objective: float
    iterations: int
    primal_feasibility: float
    stationarity: float
    complementarity: float
    cpu_time: float
    num_subproblems_solved: int
    num_factorizations: int
    num_objective_evaluations: int
    num_constraint_evaluations: int
    # per-iteration IPMState trace, populated by solve_ipm(history=True)
    history: list | None = None
    # set when kkt_formulation="auto" retried a structured model with the
    # augmented formulation after an algorithmic error (api.solve): the
    # first attempt's status and iterations
    retried_after: dict | None = None

    @property
    def success(self) -> bool:
        return self.status in ("optimal", "almost_optimal")

    def __repr__(self):
        return (f"Result(status={self.status}, f={self.objective:.8g}, "
                f"iters={self.iterations}, feas={self.primal_feasibility:.2e}, "
                f"stat={self.stationarity:.2e}, time={self.cpu_time:.3f}s)")


def pick_kkt_backend(prob: NLP, m: int, opts: Options):
    """uno_tpu's dispatch (uno_tpu/solvers/ipm.py:1068-1127): the lifted
    Cholesky for kkt_formulation="lifted"; the sparse LDL^T for "sparse",
    or for "auto" with auto_permute on a model without structure (None,
    the dense path, where its probe declines); the banded backend for
    "banded", or for "auto" on a complete declaration (an NLPStructure
    with jac_starts when m > 0); else None, the dense augmented LDL^T."""
    form = opts.kkt_formulation
    st = prob.structure
    if form == "lifted":
        from uno_tpu_torch.linalg.condensed import make_lifted_kkt_backend
        return make_lifted_kkt_backend(prob.n, m, tau=opts.lifted_kkt_relaxation)
    if form == "sparse" or (form == "auto" and opts.auto_permute and st is None):
        from uno_tpu_torch.linalg.sparse_kkt import try_make_sparse_kkt_backend
        return try_make_sparse_kkt_backend(prob, m, opts, force=(form == "sparse"))
    if form == "banded" or (form == "auto" and st is not None
                            and (m == 0 or st.jac_starts is not None)):
        if st is None:
            raise ValueError("kkt_formulation='banded' requires the model "
                             "to declare an NLPStructure")
        if m and st.jac_starts is None:
            raise ValueError("kkt_formulation='banded' on a constrained "
                             "model requires NLPStructure.jac_starts")
        slack_cols = prob.slack_of_constraint \
            if prob.slack_of_constraint is not None \
            else np.full(m, -1, dtype=np.int64)
        n0 = prob.n - int(np.sum(slack_cols >= 0))
        return make_banded_kkt_backend(
            prob.n, n0, m, st.jac_starts if m else np.zeros(0, dtype=np.int64),
            slack_cols, st.hess_bandwidth, st.jac_width,
            tau=opts.lifted_kkt_relaxation)
    return None


def build_ipm(nlp: NLP, opts: Options, group=None):
    """Setup: scaling, reformulation, workspace, KKT backend, step.

    With ldlt_backend="distributed" the KKT factorization and its solves
    are split over the ranks of `group` (parallel/group.py;
    parallel/dist_ldlt.py), each rank running the same iteration on the
    same replicated data; the instance is the batch of one."""
    scaled = transforms.scale_model(nlp, opts.function_scaling_threshold) \
        if opts.scale_functions else nlp
    prob = transforms.reformulate_for_interior_point(scaled, opts.tolerance)
    ws = _build_workspace(prob)
    if opts.ldlt_backend == "distributed":
        if group is None:
            raise ValueError("ldlt_backend='distributed' requires a process group")
        from uno_tpu_torch.parallel.dist_ldlt import make_dist_kkt_backend
        kkt_backend = make_dist_kkt_backend(group, prob.n + ws.m,
                                            block=opts.dist_ldlt_block)
    else:
        kkt_backend = pick_kkt_backend(prob, ws.m, opts)
    return prob, ws, make_ipm_step(prob, ws, opts, kkt_backend=kkt_backend)


def map_fixed_bound_duals(nlp_orig, y_full_scaled, zl, zu):
    """FixedBoundsConstraintsModel::postprocess_solution parity
    (FixedBoundsConstraintsModel.cpp:168-181): the multipliers of the
    equality rows appended for fixed variables move back to the BOUND duals
    of those variables — positive to zl, negative to zu."""
    fixed_idx = np.nonzero(nlp_orig.fixed_variables)[0]
    zl = np.asarray(zl).copy()
    zu = np.asarray(zu).copy()
    for k, vi in enumerate(fixed_idx):
        row = nlp_orig.m + k
        if row < y_full_scaled.shape[0]:
            ym = float(y_full_scaled[row])
            if ym > 0.0:
                zl[vi] = ym
            else:
                zu[vi] = ym
    return zl, zu


def _params_batch(params, batch: int, device) -> Optional[torch.Tensor]:
    if params is None:
        return None
    p = torch.as_tensor(np.asarray(params), dtype=torch.float64, device=device)
    return p.expand((batch,) + tuple(p.shape)).contiguous()


def solve_ipm(nlp: NLP, opts: Options, device, callbacks=None,
              history=False, group=None) -> Result:
    """One instance, as the batch of one, on `device` (the group's device
    when a process group is given, for ldlt_backend="distributed")."""
    t0 = time.monotonic()
    if group is not None:
        device = group.device
    prob, ws, step = build_ipm(nlp, opts, group)
    x0 = torch.as_tensor(prob.x0, dtype=torch.float64, device=device)[None]
    params = _params_batch(nlp.params, 1, device)
    state0 = make_initial_state(prob, ws, opts, x0, params)

    from uno_tpu_torch.utils.logger import LEVELS
    verbose = LEVELS.index(opts.logger) >= LEVELS.index("INFO")
    trace = [state0] if history else None
    stats = None
    if verbose:
        from uno_tpu_torch.utils.statistics import Statistics
        stats = Statistics()
        for name, w, order in (("iter", Statistics.INT_WIDTH, 1),
                               ("step norm", Statistics.DOUBLE_WIDTH - 5, 31),
                               ("objective", Statistics.DOUBLE_WIDTH - 5, 100),
                               ("primal feas", Statistics.DOUBLE_WIDTH - 4, 101),
                               ("stationarity", Statistics.DOUBLE_WIDTH - 3, 104),
                               ("complementarity", Statistics.DOUBLE_WIDTH, 105),
                               ("barrier", Statistics.DOUBLE_WIDTH - 5, 8),
                               ("phase", Statistics.INT_WIDTH, 20)):
            stats.add_column(name, w, order)
    cs = prob.c_scale if prob.c_scale is not None else np.ones(max(ws.m, 1))

    def on_iterate(s):
        if history:
            trace.append(s)
        if stats is not None:
            stats.start_new_line()
            stats.set("iter", int(s.iteration[0]))
            stats.set("step norm", float(s.step_norm[0]))
            stats.set("objective", float(s.f_cur[0]) / prob.f_scale)
            stats.set("primal feas", float(s.primal_feas[0]))
            stats.set("stationarity", float(s.stat[0] / s.stat_scaling[0]))
            stats.set("complementarity", float(s.compl[0] / s.compl_scaling[0]))
            stats.set("barrier", float(s.mu[0]))
            stats.set("phase", "FEAS" if int(s.phase[0]) else "OPT")
            stats.print_current_line()
        if callbacks is not None:
            callbacks.notify_new_primals(s.x[0, : nlp.n].cpu().numpy())
            callbacks.notify_new_multipliers(
                s.y[0, : nlp.m].cpu().numpy() * cs[: nlp.m] / prob.f_scale
                if nlp.m else np.zeros(0))

    hooks = history or stats is not None or callbacks is not None
    final = run_ipm(step, state0, opts, t0, on_iterate if hooks else None)
    if stats is not None:
        stats.print_footer()
    elapsed = time.monotonic() - t0

    x_full = final.x[0].cpu().numpy()
    x_orig = x_full[: nlp.n]
    f_scale = prob.f_scale
    y_all = final.y[0].cpu().numpy()
    y_full = y_all * cs[: y_all.shape[0]] / f_scale
    y = y_full[: nlp.m] if nlp.m else np.zeros(0)
    zl_out, zu_out = map_fixed_bound_duals(
        nlp, y_full, final.zl[0].cpu().numpy()[: nlp.n] / f_scale,
        final.zu[0].cpu().numpy()[: nlp.n] / f_scale)
    x_t = torch.as_tensor(x_orig, dtype=torch.float64)[None]
    f_val = float(nlp.objective(x_t, _params_batch(nlp.params, 1, "cpu"))[0])
    if callbacks is not None:
        callbacks.notify_acceptable_iterate(x_orig, y, 1.0)
    return Result(
        status=STATUS_NAMES[int(final.status[0])],
        x=x_orig, y=y,
        zl=zl_out, zu=zu_out,
        objective=f_val,
        iterations=int(final.iteration[0]),
        primal_feasibility=float(final.primal_feas[0]),
        stationarity=float(final.stat[0] / final.stat_scaling[0]),
        complementarity=float(final.compl[0] / final.compl_scaling[0]),
        cpu_time=elapsed,
        num_subproblems_solved=int(final.num_subproblems[0]),
        num_factorizations=int(final.num_factorizations[0]),
        num_objective_evaluations=int(final.num_obj_evals[0]),
        num_constraint_evaluations=int(final.num_con_evals[0]),
        history=trace,
    )
