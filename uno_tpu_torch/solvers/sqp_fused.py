"""The fused SQP drivers, batched: the trust-region SQP/SLP family
(filtersqp, funnelsqp, filterslp) and byrd (line search, l1 relaxation,
l1 merit).

Counterpart of uno_tpu/solvers/sqp_fused.py (reference
TrustRegionStrategy.cpp:40-190, FeasibilityRestoration.cpp:78-207,
l1Relaxation.cpp:105-263, BacktrackingLineSearch.cpp:51-124,
InequalityConstrainedMethod.cpp:26-98, the Fletcher / Waechter filter
methods, the funnel and the l1 merit function, and the residuals and
first-order tests of ConstraintRelaxationStrategy.cpp:91-258).

As in uno_tpu, the reference's outer iteration with its inner trust-region
loop is a flat loop of trust-region ATTEMPTS: each attempt solves one QP,
builds one trial, and either commits it (the radius may grow) or shrinks
the radius; a phase switch (optimality <-> feasibility restoration) takes
effect at the next attempt.  `iteration` counts accepted steps (the
reference's outer iterations) and `attempts` bounds the loop.

uno_tpu runs the attempts as `vmap(while_loop)`; here the batch is the
leading axis, the host loop steps the instances that are still running
(solvers/ipm.run_ipm), and each attempt gives each QP (width n in the
optimality phase, n + n_el in restoration) only the instances of its
phase, so every instance computes what it computes alone.  The QP is the
interior-point solver of solvers/qp.py with BQPD-parity dual purification.

byrd's outer iteration (make_byrd_step) holds three data-dependent loops,
which uno_tpu runs as nested `while_loop`s under `vmap`: the primal
regularization, the penalty-steering loop of relaxed-QP solves and the
backtracking line search.  Each is a host loop here over the instances
still in it (gather by index, step, scatter), so again every instance
computes what it computes alone.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from uno_tpu_torch.ingredients import filters as flt
from uno_tpu_torch.model import transforms
from uno_tpu_torch.model.nlp import NLP, vector_norm
from uno_tpu_torch.options import Options
from uno_tpu_torch.solvers.ipm import (ALGORITHMIC_ERROR, ALMOST_OPTIMAL,
                                       INFEASIBLE_STATIONARY, LARGE_BOUND,
                                       MAX_ITERATIONS, OPTIMAL, RUNNING,
                                       STATUS_NAMES, UNBOUNDED, Result,
                                       _matvec, _max0, _params_batch,
                                       _rmatvec, _where, map_fixed_bound_duals,
                                       run_ipm)
from uno_tpu_torch.solvers.qp import (QP_ERROR, QP_INFEASIBLE, QP_OPTIMAL,
                                      QP_UNBOUNDED, QPStructure,
                                      build_qp_solver, take)

# extra terminal statuses of the TR mechanism (TrustRegionStrategy.cpp:150-166)
FEASIBLE_SMALL_STEP = 8
INFEASIBLE_SMALL_STEP = 9

SQP_STATUS_NAMES = {
    **STATUS_NAMES,
    FEASIBLE_SMALL_STEP: "feasible_small_step",
    INFEASIBLE_SMALL_STEP: "infeasible_small_step",
}


class SQPFState(NamedTuple):
    # primal-dual iterate, (B, .)
    x: torch.Tensor        # (B, n)
    ev: torch.Tensor       # (B, n_el) elastic values (restoration phase)
    y: torch.Tensor        # (B, m) optimality multipliers
    zl: torch.Tensor       # (B, n)
    zu: torch.Tensor
    y_f: torch.Tensor      # feasibility multipliers
    zl_f: torch.Tensor
    zu_f: torch.Tensor
    zl_el: torch.Tensor    # (B, n_el)
    # objective and constraints at x (refreshed on acceptance)
    f_cur: torch.Tensor
    c_cur: torch.Tensor    # (B, m)
    # mechanism and strategy state, (B,)
    radius: torch.Tensor
    phase: torch.Tensor        # 0 = optimality, 1 = feasibility restoration
    filter: flt.FilterState
    gs_scalar: torch.Tensor    # funnel width | merit smallest-known h
    h_initial: torch.Tensor
    h_ref: torch.Tensor        # restoration reference infeasibility
    # progress and termination
    status: torch.Tensor
    iteration: torch.Tensor    # accepted steps (the reference's outer iterations)
    attempts: torch.Tensor
    loose_count: torch.Tensor
    creep_count: torch.Tensor  # consecutive accepted feasible roundoff steps
    # residuals at the current iterate, for the report
    stat: torch.Tensor
    stat_scaling: torch.Tensor
    compl: torch.Tensor
    compl_scaling: torch.Tensor
    primal_feas: torch.Tensor
    # counters
    num_qp: torch.Tensor
    num_obj_evals: torch.Tensor
    num_con_evals: torch.Tensor
    num_hess: torch.Tensor
    params: Optional[torch.Tensor] = None


class FusedSQPWorkspace(NamedTuple):
    n: int
    m: int
    n_el: int
    xl: np.ndarray
    xu: np.ndarray
    has_xl: np.ndarray
    has_xu: np.ndarray
    cl: np.ndarray
    cu: np.ndarray
    has_cl: np.ndarray
    has_cu: np.ndarray
    is_eq: np.ndarray
    E: np.ndarray          # (m, n_el) elastic signs
    nb: int                # number of finite variable bounds


def _build_workspace(nlp: NLP) -> FusedSQPWorkspace:
    n, m = nlp.n, nlp.m
    xl = np.asarray(nlp.x_lb, dtype=float)
    xu = np.asarray(nlp.x_ub, dtype=float)
    has_xl = np.asarray(nlp.has_x_lb)
    has_xu = np.asarray(nlp.has_x_ub)
    cl = np.asarray(nlp.c_lb, dtype=float)
    cu = np.asarray(nlp.c_ub, dtype=float)
    has_cl = np.isfinite(cl)
    has_cu = np.isfinite(cu)
    is_eq = has_cl & has_cu & (cl == cu)
    ineq_idx = np.nonzero(~is_eq)[0]
    eq_idx = np.nonzero(is_eq)[0]
    n_el = len(ineq_idx) + 2 * len(eq_idx)
    E = np.zeros((m, n_el))
    col = 0
    for j in ineq_idx:
        E[j, col] = 1.0 if has_cl[j] else -1.0
        col += 1
    for j in eq_idx:
        E[j, col] = 1.0
        E[j, col + 1] = -1.0
        col += 2
    nb = int(has_xl.sum() + has_xu.sum())
    return FusedSQPWorkspace(n=n, m=m, n_el=n_el, xl=xl, xu=xu,
                             has_xl=has_xl, has_xu=has_xu, cl=cl, cu=cu,
                             has_cl=has_cl, has_cu=has_cu, is_eq=is_eq, E=E,
                             nb=nb)


def _tensors(ws: FusedSQPWorkspace, device) -> dict:
    """The workspace's arrays as float64 / bool tensors on `device`."""
    f64 = dict(dtype=torch.float64, device=device)
    out = {k: torch.as_tensor(getattr(ws, k), **f64)
           for k in ("xl", "xu", "cl", "cu", "E")}
    out.update({k: torch.as_tensor(getattr(ws, k), device=device)
                for k in ("has_xl", "has_xu", "has_cl", "has_cu", "is_eq")})
    return out


def _residual_fns(k: dict, ws: FusedSQPWorkspace, thr: float):
    """The constraint violation, the complementarity terms and the residual
    scalings (ConstraintRelaxationStrategy.cpp:128-258) over the workspace
    tensors `k` of one device; returns (violation, con_compl, bound_compl,
    scalings)."""
    xl, xu, cl, cu = k["xl"], k["xu"], k["cl"], k["cu"]
    has_xl, has_xu, has_cl, has_cu, is_eq = (
        k["has_xl"], k["has_xu"], k["has_cl"], k["has_cu"], k["is_eq"])

    def violation(cv, kind):
        viol = torch.where(has_cl, torch.clamp(cl - cv, min=0.0), 0.0) + \
            torch.where(has_cu, torch.clamp(cv - cu, min=0.0), 0.0)
        return vector_norm(viol, kind)

    def con_compl(cv, yv):
        lo = torch.where(has_cl, cl, 0.0)
        hi = torch.where(has_cu, cu, 0.0)
        out = torch.where(~is_eq & (yv > 0) & has_cl, yv * (cv - lo), 0.0)
        return torch.where(~is_eq & (yv < 0) & has_cu, yv * (cv - hi), out)

    def bound_compl(xv, zlv, zuv):
        return torch.where(has_xl & (zlv > 0),
                           zlv * (xv - torch.where(has_xl, xl, 0.0)), 0.0) \
            + torch.where(has_xu & (zuv < 0),
                          zuv * (xv - torch.where(has_xu, xu, 0.0)), 0.0)

    def scalings(yv, zlv, zuv):
        ones = yv.new_ones(yv.shape[:1])
        total = ws.nb + ws.m
        ssc = torch.clamp((torch.sum(torch.abs(yv), dim=-1)
                           + torch.sum(torch.abs(zlv), dim=-1)
                           + torch.sum(torch.abs(zuv), dim=-1))
                          / (thr * max(total, 1)), min=1.0) if total else ones
        csc = torch.clamp((torch.sum(torch.abs(zlv), dim=-1)
                           + torch.sum(torch.abs(zuv), dim=-1))
                          / (thr * max(ws.nb, 1)), min=1.0) if ws.nb else ones
        return ssc, csc

    return violation, con_compl, bound_compl, scalings


def make_sqp_step(nlp: NLP, ws: FusedSQPWorkspace, opts: Options):
    """One trust-region attempt of every instance of a batch; returns a
    function state -> state."""
    if opts.globalization_mechanism != "TR":
        raise ValueError("the fused SQP driver implements the TR mechanism; "
                         "the line-search SQP drivers are not ported")
    n, m, n_el = ws.n, ws.m, ws.n_el
    nu = opts.l1_constraint_violation_coefficient
    tol = opts.tolerance
    thr = opts.residual_scaling_threshold
    roundoff = (10.0 * float(np.finfo(np.float64).eps)
                if opts.protect_actual_reduction_against_roundoff else 0.0)
    zero_hessian = opts.hessian_model == "zero"
    identity_hessian = opts.hessian_model == "identity"
    cache = {}

    def consts(device):
        key = torch.device(device)
        if key not in cache:
            cache[key] = _tensors(ws, key)
        return cache[key]

    def hessian(x, y, sigma, params):
        if zero_hessian:
            return x.new_zeros((x.shape[0], n, n))
        if identity_hessian:
            return torch.eye(n, dtype=x.dtype, device=x.device).expand(
                x.shape[0], n, n).clone()
        return nlp.lagrangian_hessian(x, y, sigma, params)

    # ---- QP solvers (static structures) -----------------------------------
    struct_opt = QPStructure(
        n=n, m=m, has_dl=np.ones(n, bool), has_du=np.ones(n, bool),
        is_eq=ws.is_eq, has_rl=ws.has_cl, has_ru=ws.has_cu)
    struct_rel = QPStructure(
        n=n + n_el, m=m,
        has_dl=np.ones(n + n_el, bool),
        has_du=np.concatenate([np.ones(n, bool), np.zeros(n_el, bool)]),
        is_eq=ws.is_eq, has_rl=ws.has_cl, has_ru=ws.has_cu)
    solve_qp_opt = build_qp_solver(struct_opt, opts, tol=opts.tolerance * 1e-2)
    solve_qp_rel = build_qp_solver(struct_rel, opts, tol=opts.tolerance * 1e-2)

    # ---- globalization strategy ---------------------------------------------
    gs = opts.globalization_strategy
    if gs not in ("l1_merit", "fletcher_filter_method",
                  "waechter_filter_method", "funnel_method"):
        raise ValueError(f"unknown globalization strategy {gs!r}")
    nonmono = opts.filter_type == "nonmonotone"
    max_dom = opts.nonmonotone_filter_number_dominated_entries
    beta, gamma = opts.filter_beta, opts.filter_gamma

    def flt_acceptable(f, h_t, phi_t):
        if nonmono:
            return flt.nm_filter_acceptable(f, h_t, phi_t, beta, gamma, max_dom)
        return flt.filter_acceptable(f, h_t, phi_t, beta, gamma)

    def flt_acceptable_wrt(f, h_c, phi_c, h_t, phi_t):
        if nonmono:
            return flt.nm_filter_acceptable_wrt(f, h_c, phi_c, h_t, phi_t,
                                                beta, gamma, max_dom)
        return flt.filter_acceptable_wrt(h_c, phi_c, h_t, phi_t, beta, gamma)

    def flt_add(f, h_c, phi_c):
        if nonmono:
            return flt.nm_filter_add(f, h_c, phi_c, max_dom)
        return flt.filter_add(f, h_c, phi_c, beta)

    def actual_reduction(f, merit_cur, h_cur, merit_tri):
        if nonmono:
            return flt.nm_actual_objective_reduction(
                f, merit_cur, h_cur, merit_tri, gamma, max_dom) \
                + roundoff * torch.abs(merit_cur)
        return merit_cur - merit_tri + roundoff * torch.abs(merit_cur)

    rn = opts.residual_norm
    act = opts.TR_activity_tolerance

    def step(s: SQPFState) -> SQPFState:
        k = consts(s.x.device)
        xl, xu, cl, cu, E = k["xl"], k["xu"], k["cl"], k["cu"], k["E"]
        has_xl, has_xu, has_cl, has_cu = (k["has_xl"], k["has_xu"],
                                          k["has_cl"], k["has_cu"])
        params = s.params
        x, f, c = s.x, s.f_cur, s.c_cur
        B = x.shape[0]
        violation, con_compl, bound_compl, scalings = _residual_fns(k, ws, thr)

        g = nlp.objective_gradient(x, params)
        J = nlp.constraint_jacobian(x, params)
        is_feas = s.phase == 1
        fe = is_feas[:, None]
        sigma = torch.where(is_feas, 0.0, 1.0).to(x.dtype)
        h_cur = violation(c, opts.progress_norm)
        merit_cur = f  # the strategies measure the objective at sigma = 1

        # ---- termination at the current iterate ---------------------------
        grad_lag = sigma[:, None] * g - (_rmatvec(J, s.y) if m else 0.0) - s.zl - s.zu
        stat = vector_norm(grad_lag, rn)
        pf = violation(c, rn)
        bc = bound_compl(x, s.zl, s.zu)
        compl = vector_norm(torch.cat([bc, con_compl(c, s.y)], dim=-1), rn)
        ssc, csc = scalings(s.y, s.zl, s.zu)
        # feasibility-problem residuals (l1 relaxed, rho = 0)
        grad_lag_f = -(_rmatvec(J, s.y_f) if m else 0.0) - s.zl_f - s.zu_f
        el_stat = nu - (_rmatvec(E, s.y_f) if m else 0.0) - s.zl_el
        feas_stat = vector_norm(torch.cat([grad_lag_f, el_stat], dim=-1), rn)
        bc_f = bound_compl(x, s.zl_f, s.zu_f)
        el_compl = torch.where(s.zl_el > 0, s.zl_el * s.ev, 0.0)
        # the feasibility problem's complementarity uses the RELAXED
        # constraints c + E e (l1RelaxedProblem.cpp:67-86)
        c_relaxed = c + (_matvec(E.expand(B, m, n_el), s.ev) if n_el else 0.0)
        feas_compl = vector_norm(torch.cat(
            [bc_f, el_compl, con_compl(c_relaxed, s.y_f)], dim=-1), rn)
        fssc, fcsc = scalings(s.y_f, s.zl_f, s.zu_f)

        # the reference never applies the first-order test to the initial
        # iterate (Uno.cpp:61-78 tests after compute_next_iterate)
        tested = s.attempts > 0

        def kkt_ok(t):
            return ((stat / ssc <= t) & (pf <= t) & (compl / csc <= t)
                    & ~is_feas & tested)

        nontrivial = (_max0(torch.abs(s.y_f)) > tol) | \
            (_max0(torch.abs(s.zl_f + s.zu_f)) > tol)

        def fj_ok(t):
            if m == 0:
                return torch.zeros_like(is_feas)
            return (feas_stat / fssc <= t) & (pf > t) & \
                (feas_compl / fcsc <= t) & nontrivial & tested

        status = s.status
        loose = opts.loose_tolerance
        kkt_loose, fj_loose = kkt_ok(loose), fj_ok(loose)
        loose_count = torch.where(kkt_loose | fj_loose, s.loose_count + 1, 0)
        loose_fire = loose_count >= opts.loose_tolerance_consecutive_iteration_threshold
        status = torch.where(loose_fire & kkt_loose, ALMOST_OPTIMAL, status)
        status = torch.where(loose_fire & fj_loose & ~kkt_loose,
                             INFEASIBLE_STATIONARY, status)
        status = torch.where(fj_ok(tol), INFEASIBLE_STATIONARY, status)
        kkt_tight = kkt_ok(tol)
        status = torch.where(kkt_tight, OPTIMAL, status)
        status = torch.where(f < opts.unbounded_objective_threshold, UNBOUNDED, status)
        # the reference bounds ACCEPTED (outer) iterations; a hard attempts
        # cap guards accept/reject limit cycles
        status = torch.where((status == RUNNING)
                             & ((s.iteration >= opts.max_iterations)
                                | (s.attempts >= 20 * opts.max_iterations)),
                             MAX_ITERATIONS, status)

        # ---- direction: one QP per instance, of its phase -----------------
        radius = s.radius
        r_col = radius[:, None]
        dl = torch.maximum(-r_col, torch.where(has_xl, xl - x, -LARGE_BOUND))
        du = torch.minimum(r_col, torch.where(has_xu, xu - x, LARGE_BOUND))
        rl = torch.where(has_cl, cl - c, -LARGE_BOUND)
        ru = torch.where(has_cu, cu - c, LARGE_BOUND)

        d_full = x.new_zeros((B, n + n_el))
        zl_full = x.new_zeros((B, n + n_el))
        zu_full = x.new_zeros((B, n + n_el))
        y_new = x.new_zeros((B, m))
        qp_status = torch.zeros((B,), dtype=torch.int64, device=x.device)
        H_used = x.new_zeros((B, n, n))

        def put(idx, d_, y_, zl_, zu_, st_, H_):
            nonlocal d_full, zl_full, zu_full, y_new, qp_status, H_used
            w = d_.shape[-1]
            pad = (0, n + n_el - w)
            d_full = d_full.index_copy(0, idx, torch.nn.functional.pad(d_, pad))
            zl_full = zl_full.index_copy(0, idx, torch.nn.functional.pad(zl_, pad))
            zu_full = zu_full.index_copy(0, idx, torch.nn.functional.pad(zu_, pad))
            y_new = y_new.index_copy(0, idx, y_)
            qp_status = qp_status.index_copy(0, idx, st_)
            H_used = H_used.index_copy(0, idx, H_)

        idx_opt = torch.nonzero(~is_feas).squeeze(1)
        if idx_opt.numel():
            xo, yo, po, go, Jo, rlo, ruo, dlo, duo = take(
                (x, s.y, params, g, J, rl, ru, dl, du), idx_opt)
            H = hessian(xo, yo, xo.new_ones(xo.shape[0]), po)
            res = solve_qp_opt(go, H, Jo, rlo, ruo, dlo, duo)
            put(idx_opt, res.d, res.y, res.zl, res.zu, res.status, H)
        idx_feas = torch.nonzero(is_feas).squeeze(1)
        if idx_feas.numel():
            xf, yf, pf_, gf, Jf, cf, evf, dlf, duf = take(
                (x, s.y_f, params, g, J, c, s.ev, dl, du), idx_feas)
            Bf = xf.shape[0]
            H_f = hessian(xf, yf, xf.new_zeros(Bf), pf_)
            c_rel = cf + (_matvec(E.expand(Bf, m, n_el), evf) if n_el else 0.0)
            rl_f = torch.where(has_cl, cl - c_rel, -LARGE_BOUND)
            ru_f = torch.where(has_cu, cu - c_rel, LARGE_BOUND)
            g_q = torch.cat([xf.new_zeros((Bf, n)), xf.new_full((Bf, n_el), nu)], dim=-1)
            H_q = xf.new_zeros((Bf, n + n_el, n + n_el))
            H_q[:, :n, :n] = H_f
            J_q = torch.cat([Jf, E.expand(Bf, m, n_el)], dim=-1)
            dl_q = torch.cat([dlf, -evf], dim=-1)
            du_q = torch.cat([duf, xf.new_full((Bf, n_el), LARGE_BOUND)], dim=-1)
            res = solve_qp_rel(g_q, H_q, J_q, rl_f, ru_f, dl_q, du_q)
            put(idx_feas, res.d, res.y, res.zl, res.zu, res.status, H_f)

        dx = d_full[:, :n]
        dev = d_full[:, n:]
        zl_new, zu_new = zl_full[:, :n], zu_full[:, :n]
        zl_el_new = zl_full[:, n:]
        dir_norm = _max0(torch.abs(dx))

        # an infeasible optimality QP at an infeasible iterate -> restoration
        switch_to_feas = (~is_feas) & (qp_status == QP_INFEASIBLE) & (h_cur > tol)
        if m == 0:
            switch_to_feas = torch.zeros_like(switch_to_feas)
        qp_err = (qp_status == QP_ERROR) | ((qp_status == QP_INFEASIBLE) & ~switch_to_feas)
        qp_unb = qp_status == QP_UNBOUNDED

        # ---- trial iterate (GlobalizationMechanism.cpp:11-31, alpha = 1) --
        x_t = torch.clamp(x + dx, torch.where(has_xl, xl, -float("inf")),
                          torch.where(has_xu, xu, float("inf")))
        ev_t = torch.clamp(s.ev + dev, min=0.0)
        # TR-active bound-dual reset (TrustRegionStrategy.cpp:115-130), with
        # the IP-QP dual-dust strip: zero the duals whose box side came from
        # the trust region rather than the model bound
        tr_l = torch.where(has_xl, xl - x, -LARGE_BOUND) < -r_col
        tr_u = torch.where(has_xu, xu - x, LARGE_BOUND) > r_col
        zl_new = torch.where(tr_l, 0.0, zl_new)
        zu_new = torch.where(tr_u, 0.0, zu_new)
        f_t = nlp.objective(x_t, params)
        c_t = nlp.constraints(x_t, params)
        h_t = violation(c_t, opts.progress_norm)
        merit_t = f_t

        # predicted reductions (ConstraintRelaxationStrategy.cpp:91-98), the
        # second-order objective model of the TR mechanism
        c_lin = c + (_matvec(J, dx) if m else 0.0)
        pred_h = h_cur - violation(c_lin, opts.progress_norm)
        quad = torch.sum(dx * _matvec(H_used, dx), dim=-1)
        pred_obj = -torch.sum(g * dx, dim=-1) - 0.5 * quad
        merit_pred = pred_obj

        # ---- acceptance ----------------------------------------------------
        filt = s.filter
        merit_actual = actual_reduction(filt, merit_cur, h_cur, merit_t)
        switching = (merit_pred > 0.0) & flt.switching_condition(
            merit_pred, h_cur, opts.switching_delta,
            opts.switching_infeasibility_exponent)
        sufficient = flt.armijo_sufficient_decrease(
            merit_pred, merit_actual, opts.armijo_decrease_fraction,
            opts.armijo_tolerance)
        if gs == "waechter_filter_method":
            filter_ok = flt_acceptable(filt, h_t, merit_t)
            small_inf = h_cur <= 1e-4 * torch.clamp(s.h_initial, min=1.0)
            f_type = small_inf & switching
            accept_h = (~f_type) & flt_acceptable_wrt(filt, h_cur, merit_cur,
                                                      h_t, merit_t)
            accept_reg = filter_ok & ((f_type & sufficient) | accept_h)
            augment_t = accept_reg & (~switching | ~sufficient)
        elif gs == "fletcher_filter_method":
            pair_ok = flt_acceptable(filt, h_t, merit_t) & \
                flt_acceptable_wrt(filt, h_cur, merit_cur, h_t, merit_t)
            accept_reg = pair_ok & torch.where(switching, sufficient, True)
            augment_t = accept_reg & ~switching
        elif gs == "funnel_method":
            dec = flt.funnel_is_acceptable(
                s.gs_scalar, h_cur, merit_cur, h_t, merit_t, merit_pred, opts,
                roundoff * torch.abs(merit_cur))
            accept_reg, augment_t = dec.accept, dec.h_type
        else:  # l1_merit
            accept_reg = flt.l1_merit_acceptable(
                h_cur, f, 0.0, h_t, f_t, 0.0, pred_h, pred_obj, 0.0, opts,
                roundoff * torch.abs(merit_cur))
            augment_t = torch.zeros_like(accept_reg)
        accept_feas = flt.feasibility_armijo_acceptable(
            h_cur, 0.0, h_t, 0.0, pred_h, 0.0, opts)
        finite = torch.isfinite(f_t) & torch.all(torch.isfinite(c_t), dim=-1) & \
            torch.all(torch.isfinite(x_t), dim=-1)
        accept = torch.where(is_feas, accept_feas, accept_reg) & finite
        # a zero primal step is accepted to pick up the fresh multipliers
        # (ConstraintRelaxationStrategy.cpp:110-115)
        accept = accept | (dir_norm <= 1e-10)
        accept = accept & ~qp_err & ~qp_unb & ~switch_to_feas

        # ---- strategy state updates ---------------------------------------
        augment = augment_t & accept & ~is_feas
        filt = flt.filter_select(augment, filt, flt_add(filt, h_cur, merit_cur))
        gs_scalar = s.gs_scalar
        if gs == "funnel_method":
            w_new = flt.funnel_update_width(
                s.gs_scalar, h_cur, h_t, opts.funnel_beta, opts.funnel_kappa,
                opts.funnel_update_strategy)
            gs_scalar = torch.where(augment_t & accept & ~is_feas, w_new, gs_scalar)
        elif gs == "l1_merit":
            gs_scalar = torch.where(accept & ~is_feas,
                                    torch.minimum(gs_scalar, h_t), gs_scalar)

        # ---- phase transitions ---------------------------------------------
        # OPT -> FEAS: the current point goes into the filter, the elastics
        # and their duals are reset (FeasibilityRestoration.cpp:126-143)
        filt = flt.filter_select(switch_to_feas, filt, flt_add(filt, h_cur, merit_cur))
        h_ref = torch.where(switch_to_feas, h_cur, s.h_ref)

        # FEAS -> OPT on an accepted trial with sufficiently reduced
        # infeasibility (FeasibilityRestoration.cpp:156-162)
        if gs == "fletcher_filter_method":
            smallest_h = torch.amin(filt.h, dim=-1)
            reduced = h_t < opts.filter_beta * torch.minimum(smallest_h, filt.ub)
        elif gs == "waechter_filter_method":
            reduced = (h_t <= opts.filter_sufficient_infeasibility_decrease_factor
                       * s.h_ref) & flt_acceptable(filt, h_t, merit_t)
        elif gs == "funnel_method":
            reduced = (h_t <= gs_scalar) & (h_t <= opts.funnel_beta * s.h_ref)
        else:
            reduced = h_t <= 0.9 * s.h_ref
        # the linearized residual along the accepted step must be feasible
        # too where the preset asks (filtersqp,
        # switch_to_optimality_requires_linearized_feasibility)
        if opts.switch_to_optimality_requires_linearized_feasibility:
            lin_ok = violation(c_lin, rn) <= tol
        else:
            lin_ok = torch.ones_like(accept)
        switch_back = is_feas & accept & (reduced | (h_t <= tol)) & lin_ok
        filt = flt.filter_select(switch_back, filt, flt_add(filt, h_t, merit_t))
        if gs == "funnel_method":
            # Funnel::update_restoration on leaving restoration
            gs_scalar = torch.where(
                switch_back,
                opts.funnel_kappa * gs_scalar + (1 - opts.funnel_kappa) * h_t,
                gs_scalar)
        phase = torch.where(switch_to_feas, 1, s.phase)
        phase = torch.where(switch_back, 0, phase)

        # ---- radius update (TrustRegionStrategy.cpp:168-190) ---------------
        grow = accept & (dir_norm >= radius - act)
        radius_new = torch.where(grow, radius * opts.TR_increase_factor, radius)
        shrink = ~accept & ~qp_err & ~qp_unb & ~switch_to_feas
        radius_new = torch.where(
            shrink, torch.minimum(radius, torch.clamp(dir_norm, min=1e-16))
            / opts.TR_decrease_factor, radius_new)
        radius_new = torch.where(qp_unb, radius / opts.TR_aggressive_decrease_factor,
                                 radius_new)
        radius_new = torch.where(qp_err, radius / opts.TR_decrease_factor, radius_new)
        # the reset happens once per OUTER iteration in the reference
        # (TrustRegionStrategy.cpp:43): on acceptance only
        radius_new = torch.where(
            accept, torch.clamp(radius_new, min=opts.TR_radius_reset_threshold),
            radius_new)

        # small-radius termination (TrustRegionStrategy.cpp:150-166); a
        # feasible small step that passes the first-order test at the loose
        # tolerance ends optimal
        small = (radius_new < opts.TR_min_radius) & ~accept
        feasible = h_cur <= tol
        status = torch.where(small & feasible,
                             torch.where(kkt_loose | kkt_tight, OPTIMAL,
                                         FEASIBLE_SMALL_STEP), status)
        status = torch.where(small & ~feasible & is_feas, INFEASIBLE_SMALL_STEP, status)
        # a breakdown at an infeasible point that meets the FJ conditions at
        # the loose tolerance is the infeasibility certificate
        status = torch.where(small & ~feasible & ~is_feas & fj_loose,
                             INFEASIBLE_STATIONARY, status)
        status = torch.where(small & ~feasible & ~is_feas & ~fj_loose,
                             ALGORITHMIC_ERROR, status)

        # accepted-creep termination: 15 consecutive accepted feasible steps
        # whose objective progress is at roundoff scale end
        # FEASIBLE_SMALL_STEP (or OPTIMAL at the loose tolerance)
        creeping = accept & (h_t <= tol) & ~is_feas \
            & (dir_norm <= np.sqrt(tol) * (1.0 + _max0(torch.abs(x)))) \
            & (torch.abs(merit_actual) <= 1e-11 * torch.clamp(torch.abs(merit_cur), min=1.0))
        creep_count = torch.where(creeping, s.creep_count + 1, 0)
        status = torch.where(
            (status == RUNNING)
            & (creep_count >= opts.loose_tolerance_consecutive_iteration_threshold),
            torch.where(kkt_loose, OPTIMAL, FEASIBLE_SMALL_STEP), status)

        # ---- commit ---------------------------------------------------------
        running = status == RUNNING
        com = accept & running

        def sel(new, old):
            return _where(com, new, old)

        # the multipliers of each phase (the host driver's conventions)
        y_c = _where(is_feas, s.y, sel(y_new, s.y))
        zl_c = _where(is_feas, s.zl, sel(zl_new, s.zl))
        zu_c = _where(is_feas, s.zu, sel(zu_new, s.zu))
        y_f_c = _where(is_feas, sel(y_new, s.y_f), s.y_f)
        zl_f_c = _where(is_feas, sel(zl_new, s.zl_f), s.zl_f)
        zu_f_c = _where(is_feas, sel(zu_new, s.zu_f), s.zu_f)
        # entering restoration: reset the elastics and their duals
        # (l1RelaxedProblem::set_elastic_variable_values)
        ev_c = _where(switch_to_feas, torch.zeros_like(s.ev), sel(ev_t, s.ev))
        zl_el_c = _where(switch_to_feas, torch.ones_like(s.zl_el),
                         sel(zl_el_new, s.zl_el))
        y_f_c = _where(switch_to_feas, torch.zeros_like(y_f_c), y_f_c)
        ones_n = torch.ones_like(x)
        zl_f_c = _where(switch_to_feas, torch.where(has_xl, ones_n, 0.0), zl_f_c)
        zu_f_c = _where(switch_to_feas, torch.where(has_xu, -ones_n, 0.0), zu_f_c)

        run_i = running.to(s.attempts.dtype)
        return SQPFState(
            x=sel(x_t, x), ev=ev_c, y=y_c, zl=zl_c, zu=zu_c,
            y_f=y_f_c, zl_f=zl_f_c, zu_f=zu_f_c, zl_el=zl_el_c,
            f_cur=sel(f_t, f), c_cur=sel(c_t, c),
            radius=torch.where(running, radius_new, radius),
            phase=torch.where(running, phase, s.phase),
            filter=filt, gs_scalar=gs_scalar, h_initial=s.h_initial,
            h_ref=h_ref, status=status,
            iteration=s.iteration + com.to(s.iteration.dtype),
            attempts=s.attempts + run_i,
            loose_count=loose_count, creep_count=creep_count,
            stat=stat, stat_scaling=ssc, compl=compl, compl_scaling=csc,
            primal_feas=pf,
            num_qp=s.num_qp + run_i,
            num_obj_evals=s.num_obj_evals + 2 * run_i,
            num_con_evals=s.num_con_evals + 2 * run_i,
            num_hess=s.num_hess + run_i,
            params=params,
        )

    return step


def make_initial_sqp_state(nlp: NLP, ws: FusedSQPWorkspace, opts: Options,
                           x0: torch.Tensor, params=None) -> SQPFState:
    """The initial state of a batch: x0 (B, n) projected onto the bounds,
    f and c there, the filter's (or the funnel's) upper bound from h0."""
    n, m, n_el = ws.n, ws.m, ws.n_el
    B, dev = x0.shape[0], x0.device
    k = _tensors(ws, dev)
    x = torch.clamp(x0.to(torch.float64), k["xl"], k["xu"])
    f = nlp.objective(x, params)
    c = nlp.constraints(x, params)
    viol = torch.where(k["has_cl"], torch.clamp(k["cl"] - c, min=0.0), 0.0) + \
        torch.where(k["has_cu"], torch.clamp(c - k["cu"], min=0.0), 0.0)
    h0 = vector_norm(viol, opts.progress_norm)
    filt = flt.filter_init(B, opts.filter_capacity, device=dev)
    filt = flt.filter_set_ub(filt, torch.clamp(opts.filter_fact * h0,
                                               min=opts.filter_ubd))
    if opts.globalization_strategy == "funnel_method":
        gs_scalar = torch.clamp(opts.funnel_fact * h0, min=opts.funnel_ubd)
    else:
        gs_scalar = torch.full_like(h0, float("inf"))
    y0 = x.new_zeros((B, m)) if nlp.y0 is None else torch.as_tensor(
        np.asarray(nlp.y0, dtype=float), device=dev).expand(B, m).clone()
    z = x.new_zeros((B, n))
    izero = torch.zeros((B,), dtype=torch.int64, device=dev)
    ione = izero + 1
    return SQPFState(
        x=x, ev=x.new_zeros((B, n_el)), y=y0, zl=z, zu=z,
        y_f=x.new_zeros((B, m)), zl_f=z, zu_f=z, zl_el=x.new_ones((B, n_el)),
        f_cur=f, c_cur=c,
        radius=x.new_full((B,), float(opts.TR_radius)),
        phase=izero,
        filter=filt, gs_scalar=gs_scalar, h_initial=h0, h_ref=h0,
        status=izero + RUNNING, iteration=izero, attempts=izero,
        loose_count=izero, creep_count=izero,
        stat=x.new_full((B,), float("inf")), stat_scaling=x.new_ones((B,)),
        compl=x.new_full((B,), float("inf")), compl_scaling=x.new_ones((B,)),
        primal_feas=h0,
        num_qp=izero, num_obj_evals=ione, num_con_evals=ione, num_hess=izero,
        params=params,
    )


def build_sqp_fused(nlp: NLP, opts: Options):
    """Setup: scaling, fixed bounds as constraints, workspace, step;
    returns (prob, ws, step)."""
    scaled = transforms.scale_model(nlp, opts.function_scaling_threshold) \
        if opts.scale_functions else nlp
    prob = transforms.fixed_bounds_to_constraints(scaled)
    ws = _build_workspace(prob)
    return prob, ws, make_sqp_step(prob, ws, opts)


def run_sqp(step, state: SQPFState, opts: Options, t0: float,
            on_iterate=None) -> SQPFState:
    """The attempts loop over a batch: step the RUNNING instances until none
    is.  The step stamps MAX_ITERATIONS at `max_iterations` accepted steps
    or 20 times as many attempts, so the loop takes one trip more at most;
    the wall-clock `time_limit` is checked after every trip."""
    return run_ipm(step, state, opts, t0, on_iterate,
                   max_steps=20 * max(opts.max_iterations, 0) + 1)


def _result(nlp: NLP, prob: NLP, ws: FusedSQPWorkspace, final, elapsed: float,
            trace, callbacks, weight: float) -> Result:
    """The Result of instance 0 of a final SQPFState or ByrdFState, in the
    original model's space; `weight` is the objective multiplier handed to
    callbacks.notify_acceptable_iterate."""
    f_scale = prob.f_scale
    c_scale = prob.c_scale if prob.c_scale is not None else np.ones(max(ws.m, 1))
    x_orig = final.x[0].cpu().numpy()[: nlp.n]
    y_all = final.y[0].cpu().numpy()
    y_full = y_all * c_scale[: y_all.shape[0]] / f_scale
    y = y_full[: nlp.m] if nlp.m else np.zeros(0)
    zl_out, zu_out = map_fixed_bound_duals(
        nlp, y_full, final.zl[0].cpu().numpy()[: nlp.n] / f_scale,
        final.zu[0].cpu().numpy()[: nlp.n] / f_scale)
    if callbacks is not None:
        callbacks.notify_acceptable_iterate(x_orig, y, weight)
    x_t = torch.as_tensor(x_orig, dtype=torch.float64)[None]
    f_val = float(nlp.objective(x_t, _params_batch(nlp.params, 1, "cpu"))[0])
    return Result(
        status=SQP_STATUS_NAMES[int(final.status[0])],
        x=x_orig, y=y, zl=zl_out, zu=zu_out,
        objective=f_val,
        iterations=int(final.iteration[0]),
        primal_feasibility=float(final.primal_feas[0]),
        stationarity=float(final.stat[0] / final.stat_scaling[0]),
        complementarity=float(final.compl[0] / final.compl_scaling[0]),
        cpu_time=elapsed,
        num_subproblems_solved=int(final.num_qp[0]),
        num_factorizations=int(final.num_hess[0]),
        num_objective_evaluations=int(final.num_obj_evals[0]),
        num_constraint_evaluations=int(final.num_con_evals[0]),
        history=trace,
    )


def _solve_single(nlp: NLP, opts: Options, device, callbacks, history,
                  build, make_initial, run):
    """One instance, as the batch of one, on `device`: returns (prob, ws,
    final state, elapsed seconds, trace)."""
    t0 = time.monotonic()
    prob, ws, step = build(nlp, opts)
    x0 = torch.as_tensor(prob.x0, dtype=torch.float64, device=device)[None]
    state0 = make_initial(prob, ws, opts, x0, _params_batch(nlp.params, 1, device))
    trace = [state0] if history else None

    def on_iterate(s):
        if history:
            trace.append(s)
        if callbacks is not None:
            callbacks.notify_new_primals(s.x[0, : nlp.n].cpu().numpy())
            callbacks.notify_new_multipliers(s.y[0, : nlp.m].cpu().numpy())

    hooks = history or callbacks is not None
    final = run(step, state0, opts, t0, on_iterate if hooks else None)
    return prob, ws, final, time.monotonic() - t0, trace


def solve_sqp_fused(nlp: NLP, opts: Options, device, callbacks=None,
                    history=False) -> Result:
    """One instance of the trust-region family, as the batch of one."""
    prob, ws, final, elapsed, trace = _solve_single(
        nlp, opts, device, callbacks, history, build_sqp_fused,
        make_initial_sqp_state, run_sqp)
    return _result(nlp, prob, ws, final, elapsed, trace, callbacks, 1.0)


# ===========================================================================
# byrd: LS + l1 relaxation + l1 merit with Sl1QP penalty steering (the
# reference's l1Relaxation.cpp path).  One step = one OUTER iteration: the
# steering loop (one relaxed-QP solve per trip, stages a/c/d/e/f of
# l1Relaxation.cpp:105-263), the backtracking line search on the l1 merit
# (BacktrackingLineSearch.cpp:51-113), and the commit.
# ===========================================================================

class ByrdFState(NamedTuple):
    # primal-dual iterate, (B, .)
    x: torch.Tensor
    ev: torch.Tensor       # (B, n_el) elastic values
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    y_f: torch.Tensor      # feasibility multipliers (of the steering's rho = 0 QP)
    zl_f: torch.Tensor
    zu_f: torch.Tensor
    zl_el: torch.Tensor
    f_cur: torch.Tensor
    c_cur: torch.Tensor
    rho: torch.Tensor      # l1 penalty (steered down across iterations)
    status: torch.Tensor
    iteration: torch.Tensor
    loose_count: torch.Tensor
    stat: torch.Tensor
    stat_scaling: torch.Tensor
    compl: torch.Tensor
    compl_scaling: torch.Tensor
    primal_feas: torch.Tensor
    num_qp: torch.Tensor   # steering QPs
    num_obj_evals: torch.Tensor
    num_con_evals: torch.Tensor
    num_hess: torch.Tensor
    params: Optional[torch.Tensor] = None


# the steering's caps on the stage-d and stage-e decreases of rho (uno_tpu's
# bound), so at most 3 + 2 MAXD relaxed QPs an iteration
MAXD = 60
PRIMAL_REG_TRIPS = 80


def _pd_ok(Hd):
    """(B,) positive definiteness by Cholesky of the symmetrized matrix, as
    jnp.linalg.cholesky factors it: the factorization succeeded, L is
    finite and its diagonal positive (a failed cholesky_ex leaves L partly
    written, where JAX leaves NaN)."""
    L, info = torch.linalg.cholesky_ex((Hd + Hd.transpose(-1, -2)) / 2)
    return (info == 0) & torch.all(torch.isfinite(L), dim=(-2, -1)) \
        & torch.all(torch.diagonal(L, dim1=-2, dim2=-1) > 0.0, dim=-1)


def make_byrd_step(nlp: NLP, ws: FusedSQPWorkspace, opts: Options):
    """One byrd outer iteration of every instance of a batch; returns a
    function state -> state."""
    n, m, n_el = ws.n, ws.m, ws.n_el
    nu = opts.l1_constraint_violation_coefficient
    tol = opts.tolerance
    loose = opts.loose_tolerance
    thr = opts.residual_scaling_threshold
    rn = opts.residual_norm
    pn = opts.progress_norm
    roundoff = (10.0 * float(np.finfo(np.float64).eps)
                if opts.protect_actual_reduction_against_roundoff else 0.0)
    zero_hessian = opts.hessian_model == "zero"
    identity_hessian = opts.hessian_model == "identity"
    cache = {}

    def consts(device):
        key = torch.device(device)
        if key not in cache:
            cache[key] = _tensors(ws, key)
        return cache[key]

    def hessian(x, y, sigma, params):
        if zero_hessian:
            return x.new_zeros((x.shape[0], n, n))
        if identity_hessian:
            return torch.eye(n, dtype=x.dtype, device=x.device).expand(
                x.shape[0], n, n).clone()
        return nlp.lagrangian_hessian(x, y, sigma, params)

    # NO trust region (LS mechanism): the QP box is the MODEL bound
    # structure, not all-finite like the trust-region step's
    struct_rel = QPStructure(
        n=n + n_el, m=m,
        has_dl=np.concatenate([np.asarray(ws.has_xl, bool), np.ones(n_el, bool)]),
        has_du=np.concatenate([np.asarray(ws.has_xu, bool), np.zeros(n_el, bool)]),
        is_eq=ws.is_eq, has_rl=ws.has_cl, has_ru=ws.has_cu)
    solve_qp_rel = build_qp_solver(struct_rel, opts, tol=opts.tolerance * 1e-2)

    # PrimalRegularization (reference PrimalRegularization.hpp:80-140; the
    # byrd preset sets regularization_strategy="primal"): H + delta I until
    # positive definite, at most PRIMAL_REG_TRIPS tries, each instance on
    # its own.  uno_tpu tests with jnp.linalg.cholesky outside any Pallas
    # kernel, so the library's Cholesky stands in for it here
    use_primal_reg = opts.regularization_strategy == "primal"
    reg0 = opts.regularization_initial_value
    reg_inc = opts.regularization_increase_factor

    def primal_reg(H):
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        ok0 = _pd_ok(H)
        min_diag = torch.amin(torch.diagonal(H, dim1=-2, dim2=-1), dim=-1)
        delta = torch.clamp(reg0 - min_diag, min=reg0)
        ok = ok0.clone()
        for _ in range(PRIMAL_REG_TRIPS):
            idx = torch.nonzero(~ok).squeeze(1)
            if idx.numel() == 0:
                break
            d = delta.index_select(0, idx)
            ok_d = _pd_ok(H.index_select(0, idx) + d[:, None, None] * eye)
            delta = delta.index_copy(0, idx, torch.where(ok_d, d, d * reg_inc))
            ok = ok.index_copy(0, idx, ok_d)
        return H + torch.where(ok0, 0.0, delta)[:, None, None] * eye

    # steering constants (l1Relaxation.cpp / Presets.cpp byrd)
    fixed_rho = opts.l1_relaxation_fixed_parameter
    eps1 = opts.l1_relaxation_epsilon1
    eps2 = opts.l1_relaxation_epsilon2
    small_thr = opts.l1_relaxation_residual_small_threshold
    dec = opts.l1_relaxation_decrease_factor
    dust = opts.l1_small_duals_threshold
    max_qps = 3 + 2 * MAXD
    # LS trip bound: alpha = ratio^k until < min_step
    ls_max = int(np.ceil(np.log(opts.LS_min_step_length)
                         / np.log(opts.LS_backtracking_ratio))) + 2

    def JT(Jv, yv):
        return _rmatvec(Jv, yv) if m else 0.0

    def step(s: ByrdFState) -> ByrdFState:
        k = consts(s.x.device)
        E = k["E"]
        params = s.params
        x, f, c = s.x, s.f_cur, s.c_cur
        B = x.shape[0]
        violation, con_compl, bound_compl, scalings = _residual_fns(k, ws, thr)

        g = nlp.objective_gradient(x, params)
        J = nlp.constraint_jacobian(x, params)
        rho0 = s.rho
        h_cur = violation(c, pn)
        pf = violation(c, rn)

        # ---- termination at the current iterate (sigma = rho) ------------
        grad_lag = rho0[:, None] * g - JT(J, s.y) - s.zl - s.zu
        stat = vector_norm(grad_lag, rn)
        compl = vector_norm(torch.cat([bound_compl(x, s.zl, s.zu),
                                       con_compl(c, s.y)], dim=-1), rn)
        ssc, csc = scalings(s.y, s.zl, s.zu)
        grad_lag_f = -JT(J, s.y_f) - s.zl_f - s.zu_f
        el_stat = nu - JT(E, s.y_f) - s.zl_el if n_el else x.new_zeros((B, 0))
        feas_stat = vector_norm(torch.cat([grad_lag_f, el_stat], dim=-1), rn)
        el_compl = torch.where(s.zl_el > 0, s.zl_el * s.ev, 0.0)
        c_relaxed = c + (_matvec(E, s.ev) if n_el else 0.0)
        feas_compl = vector_norm(torch.cat(
            [bound_compl(x, s.zl_f, s.zu_f), el_compl,
             con_compl(c_relaxed, s.y_f)], dim=-1), rn)
        fssc, fcsc = scalings(s.y_f, s.zl_f, s.zu_f)
        # the reference never applies the first-order test to the initial
        # iterate (Uno.cpp:61-78 tests after compute_next_iterate)
        tested = s.iteration > 0

        def kkt_ok(t):
            return ((stat / ssc <= t) & (pf <= t) & (compl / csc <= t)
                    & (rho0 > 0) & tested)

        nontrivial_f = (_max0(torch.abs(s.y_f)) > tol) | \
            (_max0(torch.abs(s.zl_f + s.zu_f)) > tol)

        def fj_ok(t):
            if m == 0:
                return torch.zeros_like(tested)
            return (feas_stat / fssc <= t) & (pf > t) & \
                (feas_compl / fcsc <= t) & nontrivial_f & tested

        status = s.status
        kkt_loose = kkt_ok(loose)
        loose_hit = kkt_loose | fj_ok(loose)
        loose_count = torch.where(loose_hit, s.loose_count + 1, 0)
        loose_fire = loose_count >= opts.loose_tolerance_consecutive_iteration_threshold
        status = torch.where(loose_fire & kkt_loose, ALMOST_OPTIMAL, status)
        status = torch.where(loose_fire & fj_ok(loose) & ~kkt_loose,
                             INFEASIBLE_STATIONARY, status)
        status = torch.where(fj_ok(tol), INFEASIBLE_STATIONARY, status)
        status = torch.where(kkt_ok(tol), OPTIMAL, status)
        status = torch.where(f < opts.unbounded_objective_threshold, UNBOUNDED, status)
        status = torch.where((status == RUNNING) & (s.iteration >= opts.max_iterations),
                             MAX_ITERATIONS, status)
        running = s.status == RUNNING
        # an instance terminal at the top of the trip (converged, iteration
        # limit) does no more work this trip, like the reference's
        # while-condition check before each pass (Uno.cpp:61-78); uno_tpu
        # computes that work and discards it
        alive = status == RUNNING

        out = dict(s._asdict())
        out.update(status=torch.where(running, status, s.status),
                   loose_count=loose_count, stat=stat, stat_scaling=ssc,
                   compl=compl, compl_scaling=csc, primal_feas=pf)
        idx = torch.nonzero(alive).squeeze(1)
        if idx.numel() == 0:
            return ByrdFState(**out)
        v = dict(x=x, f=f, c=c, g=g, J=J, y=s.y, zl=s.zl, zu=s.zu, ev=s.ev,
                 zl_el=s.zl_el, y_f=s.y_f, zl_f=s.zl_f, zu_f=s.zu_f, rho=rho0,
                 h_cur=h_cur, pf=pf, status=status, kkt_loose=kkt_loose,
                 iteration=s.iteration, num_qp=s.num_qp,
                 num_obj_evals=s.num_obj_evals, num_con_evals=s.num_con_evals,
                 num_hess=s.num_hess, params=params)
        whole = idx.numel() == B
        if not whole:
            v = {key: None if t is None else t.index_select(0, idx)
                 for key, t in v.items()}
        new = advance(v)
        for key, t in new.items():
            out[key] = t if whole else out[key].index_copy(0, idx, t)
        return ByrdFState(**out)

    def advance(v):
        """The steering, the line search and the commit of the instances
        alive at the top of the trip (all of `v`'s); returns their new
        values of the state's fields that these change."""
        k = consts(v["x"].device)
        xl, xu, cl, cu, E = k["xl"], k["xu"], k["cl"], k["cu"], k["E"]
        has_xl, has_xu, has_cl, has_cu = (k["has_xl"], k["has_xu"],
                                          k["has_cl"], k["has_cu"])
        violation, con_compl, bound_compl, scalings = _residual_fns(k, ws, thr)
        x, f, c, g, J, params = v["x"], v["f"], v["c"], v["g"], v["J"], v["params"]
        pf, h_cur = v["pf"], v["h_cur"]
        A = x.shape[0]

        # ---- steering loop: one relaxed-QP solve per trip -----------------
        # stage 0: solve at rho, decide whether to steer (linearized residual
        #          > tol, l1Relaxation.cpp:105-155)
        # stage 1: feasibility solve at rho = 0 (stage c) + aggressive cut
        #          from the FJ dual error (stage f)
        # stage 2: refresh at the current rho, then the stage-d (linearized
        #          sufficient decrease) and stage-e (l1-merit descent)
        #          checks; on failure divide rho and refresh again
        dl = torch.where(has_xl, xl - x, -LARGE_BOUND)
        du = torch.where(has_xu, xu - x, LARGE_BOUND)
        c_rel = c + (_matvec(E, v["ev"]) if n_el else 0.0)
        qp_data = dict(
            x=x, c=c, g=g, J=J, y=v["y"], pf=pf, params=params,
            h_l1=violation(c, "L1"),
            rl=torch.where(has_cl, cl - c_rel, -LARGE_BOUND),
            ru=torch.where(has_cu, cu - c_rel, LARGE_BOUND),
            dl_q=torch.cat([dl, -v["ev"]], dim=-1),
            du_q=torch.cat([du, x.new_full((A, n_el), LARGE_BOUND)], dim=-1),
            J_q=(torch.cat([J, E.expand(A, m, n_el)], dim=-1) if m
                 else x.new_zeros((A, 0, n + n_el))))

        def solve_at(r, D):
            H0 = hessian(D["x"], D["y"], r, D["params"])
            H = primal_reg(H0) if use_primal_reg else H0
            Bq = H0.shape[0]
            g_q = torch.cat([r[:, None] * D["g"], D["g"].new_full((Bq, n_el), nu)], dim=-1)
            H_q = H0.new_zeros((Bq, n + n_el, n + n_el))
            H_q[:, :n, :n] = H
            # purification extracts multipliers against the UNREGULARIZED
            # Hessian (BQPD parity; see qp.py H_purify)
            Hp_q = H0.new_zeros((Bq, n + n_el, n + n_el))
            Hp_q[:, :n, :n] = H0
            return solve_qp_rel(g_q, H_q, D["J_q"], D["rl"], D["ru"], D["dl_q"],
                                D["du_q"], H_purify=Hp_q)

        def lin_res_of(D, d_full, kerr):
            """Linearized l1 infeasibility of the step, with per-row
            violations at or below the QP's own primal residual zeroed: BQPD
            returns exactly feasible subproblem solutions, so the
            reference's steering gates (l1Relaxation.cpp:117-118) compare
            true zeros, where the IP-QP leaves O(kkt_error) primal dust."""
            cl_lin = D["c"] + (_matvec(D["J"], d_full[:, :n]) if m else 0.0)
            viol = torch.where(has_cl, torch.clamp(cl - cl_lin, min=0.0), 0.0) + \
                torch.where(has_cu, torch.clamp(cl_lin - cu, min=0.0), 0.0)
            viol = torch.where(viol <= 10.0 * kerr[:, None], 0.0, viol)
            return vector_norm(viol, "L1")

        izero = torch.zeros((A,), dtype=torch.int64, device=x.device)
        bfalse = torch.zeros((A,), dtype=torch.bool, device=x.device)
        zvec = x.new_zeros((A, n + n_el))
        st = dict(
            stage=izero, rho=v["rho"], d=zvec, y_q=x.new_zeros((A, m)),
            zl_q=zvec, zu_q=zvec, qp_status=izero + QP_OPTIMAL,
            qp_obj=x.new_zeros((A,)), lin=x.new_full((A,), float("inf")),
            lowest=x.new_zeros((A,)), lowest_obj=x.new_zeros((A,)),
            y_f=v["y_f"], zl_f=v["zl_f"], zu_f=v["zu_f"], zl_el_f=v["zl_el"],
            have_f=bfalse, cd=izero, ce=izero, d_done=bfalse, nqp=izero,
            done=bfalse)

        def steer_body(t, D):
            stage = t["stage"]
            res = solve_at(torch.where(stage == 1, 0.0, t["rho"]), D)
            kerr = res.kkt_error
            lin = lin_res_of(D, res.d, kerr)
            out = dict(t)
            out["nqp"] = t["nqp"] + 1

            is0, is1 = stage == 0, stage == 1
            refresh = is0 | (stage == 2)
            # stage 0 / stage 2 refresh the CURRENT direction
            for key, val in (("d", res.d), ("y_q", res.y), ("zl_q", res.zl),
                             ("zu_q", res.zu), ("qp_status", res.status),
                             ("qp_obj", res.objective), ("lin", lin)):
                out[key] = _where(refresh, val, t[key])

            # stage 0 -> steer or exit (stage a: linearized residual small)
            if fixed_rho or m == 0:
                need = torch.zeros_like(is0)
            else:
                need = (t["rho"] > 0) & (lin > tol) & (res.status == QP_OPTIMAL)
            out["stage"] = torch.where(is0, need.to(stage.dtype), out["stage"])
            out["done"] = torch.where(is0, ~need, out["done"])

            # stage 1: the feasibility duals (they feed the FJ test,
            # l1Relaxation.cpp:130-131) and the aggressive cut (stage f).
            # The trivial-duals gate scales with the solve's exit error: the
            # reference compares BQPD's exact multipliers against 1e-10
            # (l1Relaxation.cpp:190), the IP-QP's are reliable to
            # O(kkt_error)
            zl_t, zu_t = res.zl[:, :n], res.zu[:, :n]
            dust_k = torch.clamp(1e3 * kerr, min=dust)
            nontrivial = (_max0(torch.abs(res.y)) > dust_k) | \
                (_max0(torch.abs(zl_t + zu_t)) > dust_k)
            grad_f = -JT(D["J"], res.y) - zl_t - zu_t
            err = torch.sum(torch.abs(grad_f), dim=-1)
            err = err + torch.sum(torch.abs(bound_compl(D["x"], zl_t, zu_t)), dim=-1) \
                + torch.sum(torch.abs(con_compl(D["c"], res.y)), dim=-1)
            pf_ = D["pf"]
            scaled = err / torch.clamp(pf_, min=1.0)
            # the cut detects proximity to an INFEASIBLE stationary point:
            # it is gated on the feasibility QP not restoring linearized
            # feasibility (lin <= small_thr), where BQPD would return the
            # exact-zero multipliers of the degenerate vertex solution
            rho_cut = torch.where(nontrivial & (lin > small_thr),
                                  torch.minimum(t["rho"], scaled * scaled), t["rho"])
            out["rho"] = torch.where(is1, rho_cut, out["rho"])
            out["lowest"] = torch.where(is1, lin, t["lowest"])
            # objective purification: the IP-QP's objective is reliable to
            # O(kkt_error); decrease dust of the wrong sign would flip the
            # stage-e descent test forever
            noise = 100.0 * kerr * torch.clamp(pf_, min=1.0)
            lo_obj = pf_ - res.objective
            lo_obj = torch.where(torch.abs(lo_obj) <= noise, 0.0, lo_obj)
            out["lowest_obj"] = torch.where(is1, lo_obj, t["lowest_obj"])
            for key, val in (("y_f", res.y), ("zl_f", zl_t), ("zu_f", zu_t),
                             ("zl_el_f", res.zl[:, n:])):
                out[key] = _where(is1, val, t[key])
            out["have_f"] = t["have_f"] | is1
            out["stage"] = torch.where(is1, 2, out["stage"])

            # stage 2 (after the refresh): stage d to exhaustion, THEN stage
            # e without re-checking d, the reference's two sequential loops
            # (l1Relaxation.cpp:217-263).  Where stage f leaves rho as it
            # was, the reference skips the re-solve (l1Relaxation.cpp:
            # 137-142) and this loop solves again at the same rho, as
            # uno_tpu does: one more QP, the same direction
            h_l1 = D["h_l1"]
            d_ok = torch.where(out["lowest"] <= small_thr, out["lin"] <= small_thr,
                               (h_l1 - out["lin"]) >= eps1 * (h_l1 - out["lowest"]))
            pred = pf_ - out["qp_obj"]
            pred = torch.where(torch.abs(pred) <= noise, 0.0, pred)
            e_ok = pred >= eps2 * out["lowest_obj"]
            rho_pos = out["rho"] > 0
            in2 = stage == 2
            d_phase = in2 & ~t["d_done"]
            dec_d = d_phase & ~d_ok & (t["cd"] < MAXD) & rho_pos
            # d latches done when it passes or can no longer decrease
            out["d_done"] = t["d_done"] | (d_phase & ~dec_d)
            e_phase = in2 & out["d_done"]
            dec_e = e_phase & ~e_ok & (t["ce"] < MAXD) & rho_pos
            out["cd"] = t["cd"] + dec_d.to(t["cd"].dtype)
            out["ce"] = t["ce"] + dec_e.to(t["ce"].dtype)
            out["rho"] = torch.where(dec_d | dec_e, out["rho"] / dec, out["rho"])
            out["done"] = torch.where(in2, ~(dec_d | dec_e), out["done"])
            return out

        # every trip adds one to an active instance's nqp, so max_qps trips
        # take every instance to the cap; one host read of the mask a trip
        for _ in range(max_qps):
            active = ~st["done"] & (st["nqp"] < max_qps)
            sel = torch.nonzero(active).squeeze(1)
            if sel.numel() == 0:
                break
            if sel.numel() == A:
                st = steer_body(st, qp_data)
            else:
                sub = steer_body({key: t.index_select(0, sel) for key, t in st.items()},
                                 {key: None if t is None else t.index_select(0, sel)
                                  for key, t in qp_data.items()})
                st = {key: st[key].index_copy(0, sel, sub[key]) for key in st}

        rho = st["rho"]
        dx, dev = st["d"][:, :n], st["d"][:, n:]
        y_new = st["y_q"]
        zl_new, zu_new = st["zl_q"][:, :n], st["zu_q"][:, :n]
        zl_el_new = st["zl_q"][:, n:]
        dir_norm = _max0(torch.abs(dx))
        qp_bad = (st["qp_status"] == QP_ERROR) | (st["qp_status"] == QP_UNBOUNDED)

        # ---- backtracking line search on the l1 merit (sigma = rho) -------
        gdx = torch.sum(g * dx, dim=-1)
        Jdx = _matvec(J, dx) if m else x.new_zeros((A, 0))
        lo_x = torch.where(has_xl, xl, -float("inf"))
        hi_x = torch.where(has_xu, xu, float("inf"))
        ls_data = dict(x=x, ev=v["ev"], dx=dx, dev=dev, c=c, Jdx=Jdx, gdx=gdx,
                       f=f, h_cur=h_cur, rho=rho, dir_norm=dir_norm, params=params)
        ls = dict(alpha=x.new_ones((A,)), trips=izero, accepted=bfalse,
                  failed=bfalse, x_t=x, ev_t=v["ev"], f_t=f, c_t=c)

        def ls_body(t, D):
            alpha = t["alpha"]
            x_t = torch.clamp(D["x"] + alpha[:, None] * D["dx"], lo_x, hi_x)
            ev_t = torch.clamp(D["ev"] + alpha[:, None] * D["dev"], min=0.0)
            f_t = nlp.objective(x_t, D["params"])
            c_t = nlp.constraints(x_t, D["params"])
            h_t = violation(c_t, pn)
            c_lin = D["c"] + alpha[:, None] * D["Jdx"]
            pred_h = D["h_cur"] - violation(c_lin, pn)
            pred_obj = alpha * (-D["gdx"])   # first-order model (uno_tpu's sqp.py)
            r, fc = D["rho"], D["f"]
            acc = flt.l1_merit_acceptable(
                D["h_cur"], r * fc, 0.0, h_t, r * f_t, 0.0,
                pred_h, r * pred_obj, 0.0, opts,
                roundoff * torch.abs(r * fc + D["h_cur"]))
            finite = torch.isfinite(f_t) & torch.all(torch.isfinite(c_t), dim=-1)
            acc = (acc & finite) | (D["dir_norm"] <= 1e-10)
            small = alpha < opts.LS_min_step_length
            return dict(alpha=torch.where(acc | small, alpha,
                                          alpha * opts.LS_backtracking_ratio),
                        trips=t["trips"] + 1, accepted=acc, failed=small & ~acc,
                        x_t=x_t, ev_t=ev_t, f_t=f_t, c_t=c_t)

        for _ in range(ls_max):
            active = ~ls["accepted"] & ~ls["failed"] & (ls["trips"] < ls_max)
            sel = torch.nonzero(active).squeeze(1)
            if sel.numel() == 0:
                break
            if sel.numel() == A:
                ls = ls_body(ls, ls_data)
            else:
                sub = ls_body({key: t.index_select(0, sel) for key, t in ls.items()},
                              {key: None if t is None else t.index_select(0, sel)
                               for key, t in ls_data.items()})
                ls = {key: ls[key].index_copy(0, sel, sub[key]) for key in ls}

        alpha = ls["alpha"]
        accepted = ls["accepted"] & ~qp_bad
        ls_failed = ls["failed"] | (~ls["accepted"] & ~qp_bad & (ls["trips"] >= ls_max))

        # trial duals (GlobalizationMechanism.cpp:11-31: bound duals full
        # step, constraint duals scaled when LS_scale_duals_with_step_length)
        da = alpha[:, None] if opts.LS_scale_duals_with_step_length else 1.0
        y_t = v["y"] + da * (y_new - v["y"])

        # small-step termination at the failed-LS trial (BacktrackingLineSearch
        # .cpp:91-95,115-124), evaluated once per outer iteration
        x_t, ev_t, f_t, c_t = ls["x_t"], ls["ev_t"], ls["f_t"], ls["c_t"]
        g_t = nlp.objective_gradient(x_t, params)
        J_t = nlp.constraint_jacobian(x_t, params) if m else J
        pf_t = violation(c_t, rn)
        stat_t = vector_norm(rho[:, None] * g_t - JT(J_t, y_t) - zl_new - zu_new, rn)
        compl_t = vector_norm(torch.cat([bound_compl(x_t, zl_new, zu_new),
                                         con_compl(c_t, y_t)], dim=-1), rn)
        ssc_t, csc_t = scalings(y_t, zl_new, zu_new)

        def kkt_t_ok(t):
            return ((stat_t / ssc_t <= t) & (pf_t <= t)
                    & (compl_t / csc_t <= t) & (rho > 0))

        small_opt = ls_failed & kkt_t_ok(tol)
        small_almost = ls_failed & ~small_opt & kkt_t_ok(loose)
        accepted = accepted | small_opt | small_almost
        status = v["status"]
        status = torch.where((status == RUNNING) & small_opt, OPTIMAL, status)
        status = torch.where((status == RUNNING) & small_almost, ALMOST_OPTIMAL, status)
        # a breakdown (QP error, exhausted LS) AT a loose-KKT point is the
        # loose-tolerance exit, not an algorithmic error
        breakdown = qp_bad | (ls_failed & ~small_opt & ~small_almost)
        status = torch.where((status == RUNNING) & breakdown & v["kkt_loose"],
                             ALMOST_OPTIMAL, status)
        status = torch.where((status == RUNNING) & breakdown & ~v["kkt_loose"],
                             ALGORITHMIC_ERROR, status)

        # ---- commit ---------------------------------------------------------
        def sel_(new, old):
            return _where(accepted, new, old)

        have_f = st["have_f"]
        trips = ls["trips"]
        return dict(
            x=sel_(x_t, x), ev=sel_(ev_t, v["ev"]), y=sel_(y_t, v["y"]),
            zl=sel_(zl_new, v["zl"]), zu=sel_(zu_new, v["zu"]),
            # the feasibility duals refresh whenever the steering solved the
            # feasibility QP (uno_tpu's sqp.py mutates the iterate in place)
            y_f=_where(have_f, st["y_f"], v["y_f"]),
            zl_f=_where(have_f, st["zl_f"], v["zl_f"]),
            zu_f=_where(have_f, st["zu_f"], v["zu_f"]),
            zl_el=sel_(zl_el_new, v["zl_el"]),
            f_cur=sel_(f_t, f), c_cur=sel_(c_t, c), rho=rho, status=status,
            # a trip counts as an iteration when it did work
            iteration=v["iteration"] + ((status == RUNNING) | accepted).to(izero.dtype),
            num_qp=v["num_qp"] + st["nqp"],
            num_obj_evals=v["num_obj_evals"] + trips + 1,
            num_con_evals=v["num_con_evals"] + trips + 1,
            num_hess=v["num_hess"] + st["nqp"],
        )

    return step


def make_initial_byrd_state(nlp: NLP, ws: FusedSQPWorkspace, opts: Options,
                            x0: torch.Tensor, params=None) -> ByrdFState:
    """The initial state of a batch: x0 (B, n) projected onto the bounds, f
    and c there, rho at its initial value."""
    n, m, n_el = ws.n, ws.m, ws.n_el
    B, dev = x0.shape[0], x0.device
    k = _tensors(ws, dev)
    x = torch.clamp(x0.to(torch.float64), k["xl"], k["xu"])
    f = nlp.objective(x, params)
    c = nlp.constraints(x, params)
    y0 = x.new_zeros((B, m)) if nlp.y0 is None else torch.as_tensor(
        np.asarray(nlp.y0, dtype=float), device=dev).expand(B, m).clone()
    z = x.new_zeros((B, n))
    izero = torch.zeros((B,), dtype=torch.int64, device=dev)
    inf = x.new_full((B,), float("inf"))
    return ByrdFState(
        x=x, ev=x.new_zeros((B, n_el)), y=y0, zl=z, zu=z,
        y_f=x.new_zeros((B, m)), zl_f=z, zu_f=z, zl_el=x.new_ones((B, n_el)),
        f_cur=f, c_cur=c,
        rho=x.new_full((B,), float(opts.l1_relaxation_initial_parameter)),
        status=izero + RUNNING, iteration=izero, loose_count=izero,
        stat=inf, stat_scaling=x.new_ones((B,)), compl=inf,
        compl_scaling=x.new_ones((B,)), primal_feas=inf,
        num_qp=izero, num_obj_evals=izero + 1, num_con_evals=izero + 1,
        num_hess=izero, params=params)


def build_byrd_fused(nlp: NLP, opts: Options):
    """Setup: scaling, fixed bounds as constraints, workspace, step;
    returns (prob, ws, step)."""
    scaled = transforms.scale_model(nlp, opts.function_scaling_threshold) \
        if opts.scale_functions else nlp
    prob = transforms.fixed_bounds_to_constraints(scaled)
    ws = _build_workspace(prob)
    return prob, ws, make_byrd_step(prob, ws, opts)


def run_byrd(step, state: ByrdFState, opts: Options, t0: float,
             on_iterate=None) -> ByrdFState:
    """The outer loop over a batch: a trip either counts an iteration or
    ends the instance, and the step stamps MAX_ITERATIONS at
    `max_iterations`, so the loop takes max_iterations + 1 trips at most."""
    return run_ipm(step, state, opts, t0, on_iterate,
                   max_steps=max(opts.max_iterations, 0) + 1)


def solve_byrd_fused(nlp: NLP, opts: Options, device, callbacks=None,
                     history=False) -> Result:
    """One instance of byrd, as the batch of one; num_subproblems_solved
    counts the steering QPs."""
    prob, ws, final, elapsed, trace = _solve_single(
        nlp, opts, device, callbacks, history, build_byrd_fused,
        make_initial_byrd_state, run_byrd)
    return _result(nlp, prob, ws, final, elapsed, trace, callbacks,
                   float(final.rho[0]))
