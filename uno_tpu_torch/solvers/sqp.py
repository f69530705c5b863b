"""The host SQP/SLP driver: inequality-constrained methods under any
globalization mechanism, constraint relaxation and strategy.

Counterpart of uno_tpu/solvers/sqp.py (reference InequalityConstrainedMethod,
TrustRegionStrategy.cpp:40-190, BacktrackingLineSearch.cpp:51-113,
FeasibilityRestoration.cpp:78-207, l1Relaxation.cpp:105-263,
FletcherFilterMethod / WaechterFilterMethod / FunnelMethod /
l1MeritFunction).  It runs every preset with sqp_driver="host" and the
mixes the fused drivers (solvers/sqp_fused.py) do not take: a line search
with feasibility restoration, a trust region with the l1 relaxation, the
l1 relaxation under a filter or the funnel.

As in uno_tpu, the outer loop, the trust-region and line-search loops, the
phase machine and the globalization strategies run on the host in numpy;
the model's evaluations (float64 torch.func derivatives) and the QP
subproblems (solvers/qp.py, the interior-point QP over the LDL^T kernels)
run on the chosen device, one instance at a time.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.model import transforms
from uno_tpu_torch.model.nlp import NLP
from uno_tpu_torch.options import Options
from uno_tpu_torch.solvers.ipm import (LARGE_BOUND, Result, _params_batch,
                                       map_fixed_bound_duals)
from uno_tpu_torch.solvers.qp import (QP_ERROR, QP_INFEASIBLE, QP_OPTIMAL,
                                      QP_UNBOUNDED, QPResult, QPStructure,
                                      build_qp_solver)
from uno_tpu_torch.utils.timer import over_time_limit

INF = np.inf


def _norm(v, kind):
    v = np.asarray(v)
    if v.size == 0:
        return 0.0
    if kind == "L1":
        return float(np.sum(np.abs(v)))
    if kind == "L2":
        return float(np.sqrt(np.sum(v * v)))
    if kind == "INF":
        return float(np.max(np.abs(v)))
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# globalization strategies (numpy, mirroring ingredients/filters.py)
# ---------------------------------------------------------------------------

class NumpyFilter:
    """Capacity-bounded sorted Pareto front (reference Filter.cpp)."""

    def __init__(self, opts: Options):
        self.capacity = opts.filter_capacity
        self.beta = opts.filter_beta
        self.gamma = opts.filter_gamma
        self.entries: list[tuple[float, float]] = []  # (h, phi) sorted by h
        self.ub = INF

    def reset(self):
        self.entries = []

    def smallest_infeasibility(self):
        return self.entries[0][0] if self.entries else self.ub

    def infeasibility_sufficient_reduction(self, h_ref, h_trial):
        return h_trial < self.beta * h_ref

    def objective_sufficient_reduction(self, phi_ref, phi_trial, h_trial):
        return phi_trial <= phi_ref - self.gamma * h_trial

    def acceptable(self, h, phi):
        if not self.infeasibility_sufficient_reduction(self.ub, h):
            return False
        pos = 0
        while pos < len(self.entries) and \
                not self.infeasibility_sufficient_reduction(self.entries[pos][0], h):
            pos += 1
        if pos == 0:
            return True
        return self.objective_sufficient_reduction(self.entries[pos - 1][1], phi, h)

    def acceptable_wrt(self, h_cur, phi_cur, h, phi):
        return self.infeasibility_sufficient_reduction(h_cur, h) or \
            self.objective_sufficient_reduction(phi_cur, phi, h)

    def add(self, h, phi):
        # remove dominated entries (h_i >= h and phi_i >= phi)
        self.entries = [(hi, pi) for hi, pi in self.entries if hi < h or pi < phi]
        if len(self.entries) >= self.capacity:
            largest = max(self.ub, self.entries[-1][0])
            self.ub = self.beta * largest
            self.entries.pop()
        self.entries.append((h, phi))
        self.entries.sort(key=lambda e: e[0])


class NonmonotoneNumpyFilter(NumpyFilter):
    """NonmonotoneFilter.cpp: acceptability tolerates up to N dominated
    entries; add() removes entries dominated by more than N others and drops
    the OLDEST entry when full (entries kept in insertion order)."""

    def __init__(self, opts: Options):
        super().__init__(opts)
        self.max_dominated = opts.nonmonotone_filter_number_dominated_entries

    def _dominated_count(self, h, phi):
        count = 0
        for hi, pi in self.entries:
            if not self.objective_sufficient_reduction(pi, phi, h) and \
                    not self.infeasibility_sufficient_reduction(hi, h):
                count += 1
            elif phi >= pi - self.gamma * h and h > self.beta * hi:
                count += 1
        return count

    def acceptable(self, h, phi):
        if not self.infeasibility_sufficient_reduction(self.ub, h):
            return False
        return self._dominated_count(h, phi) <= self.max_dominated

    def add(self, h, phi):
        kept = []
        for hi, pi in self.entries:
            dominated = 1 if (pi > phi and hi > h) else 0
            dominated += sum(1 for hj, pj in self.entries if pi > pj and hi > hj)
            if dominated <= self.max_dominated:
                kept.append((hi, pi))
        self.entries = kept
        if len(self.entries) >= self.capacity:
            self.entries.pop(0)
        self.entries.append((h, phi))


@dataclass
class Progress:
    infeasibility: float
    objective: float       # raw f(x); measure is sigma * objective
    auxiliary: float = 0.0

    def merit(self, sigma=1.0):
        return sigma * self.objective + self.auxiliary


class GlobalizationStrategyBase:
    def __init__(self, opts: Options):
        self.opts = opts

    def _armijo(self, predicted, actual):
        o = self.opts
        return actual >= o.armijo_decrease_fraction * max(0.0, predicted - o.armijo_tolerance)

    def _actual_reduction(self, cur_merit, trial_merit):
        red = cur_merit - trial_merit
        if self.opts.protect_actual_reduction_against_roundoff:
            red += 10.0 * np.finfo(float).eps * abs(cur_merit)
        return red

    def _switching(self, predicted, h_cur):
        o = self.opts
        return predicted > o.switching_delta * h_cur ** o.switching_infeasibility_exponent

    def is_iterate_acceptable(self, cur: Progress, tri: Progress, pred: Progress,
                              sigma: float) -> bool:
        if sigma == 0.0:
            # feasibility branch: Armijo on h + aux (SwitchingMethod.cpp:42-65)
            predicted = pred.infeasibility + pred.auxiliary
            actual = (cur.infeasibility + cur.auxiliary) - (tri.infeasibility + tri.auxiliary)
            return self._armijo(predicted, actual)
        return self.regular_acceptable(cur, tri, pred)

    # hooks
    def reset(self): ...
    def notify_switch_to_feasibility(self, cur: Progress): ...
    def notify_switch_to_optimality(self, cur: Progress): ...
    def is_infeasibility_sufficiently_reduced(self, ref: Progress, tri: Progress) -> bool: ...


class FletcherFilterStrategy(GlobalizationStrategyBase):
    """FletcherFilterMethod.cpp:15-66."""

    def __init__(self, opts):
        super().__init__(opts)
        self.filter = NonmonotoneNumpyFilter(opts) \
            if opts.filter_type == "nonmonotone" else NumpyFilter(opts)

    def initialize(self, initial: Progress):
        self.filter.ub = max(self.opts.filter_ubd,
                             self.opts.filter_fact * initial.infeasibility)

    def reset(self):
        self.filter.reset()

    def notify_switch_to_feasibility(self, cur):
        self.filter.add(cur.infeasibility, cur.merit(1.0))

    def notify_switch_to_optimality(self, cur):
        self.filter.add(cur.infeasibility, cur.merit(1.0))

    def regular_acceptable(self, cur, tri, pred):
        cm, tm, pm = cur.merit(1.0), tri.merit(1.0), pred.merit(1.0)
        f = self.filter
        if not f.acceptable(tri.infeasibility, tm):
            return False
        if not f.acceptable_wrt(cur.infeasibility, cm, tri.infeasibility, tm):
            return False
        if self._switching(pm, cur.infeasibility):
            return self._armijo(pm, self._actual_reduction(cm, tm))
        f.add(cur.infeasibility, cm)   # h-type
        return True

    def is_infeasibility_sufficiently_reduced(self, ref, tri):
        return self.filter.infeasibility_sufficient_reduction(
            self.filter.smallest_infeasibility(), tri.infeasibility)


class WaechterFilterStrategy(GlobalizationStrategyBase):
    """WaechterFilterMethod.cpp:25-90."""

    def __init__(self, opts):
        super().__init__(opts)
        self.filter = NonmonotoneNumpyFilter(opts) \
            if opts.filter_type == "nonmonotone" else NumpyFilter(opts)
        self.h_initial = 1.0

    def initialize(self, initial: Progress):
        self.h_initial = initial.infeasibility
        self.filter.ub = max(self.opts.filter_ubd,
                             self.opts.filter_fact * initial.infeasibility)

    def reset(self):
        self.filter.reset()

    def notify_switch_to_feasibility(self, cur):
        self.filter.add(cur.infeasibility, cur.merit(1.0))

    def notify_switch_to_optimality(self, cur):
        self.filter.add(cur.infeasibility, cur.merit(1.0))

    def regular_acceptable(self, cur, tri, pred):
        cm, tm, pm = cur.merit(1.0), tri.merit(1.0), pred.merit(1.0)
        f = self.filter
        if not f.acceptable(tri.infeasibility, tm):
            return False
        actual = self._actual_reduction(cm, tm)
        small_inf = cur.infeasibility <= 1e-4 * max(1.0, self.h_initial)
        switching = pm > 0.0 and self._switching(pm, cur.infeasibility)
        sufficient = self._armijo(pm, actual)
        if small_inf and switching:
            accept = sufficient
        else:
            accept = f.acceptable_wrt(cur.infeasibility, cm, tri.infeasibility, tm)
        if accept and (not switching or not sufficient):
            f.add(cur.infeasibility, cm)
        return accept

    def is_infeasibility_sufficiently_reduced(self, ref, tri):
        return (tri.infeasibility <=
                self.opts.filter_sufficient_infeasibility_decrease_factor * ref.infeasibility
                and self.filter.acceptable(tri.infeasibility, tri.merit(1.0)))


class FunnelStrategy(GlobalizationStrategyBase):
    """FunnelMethod.cpp + Funnel.cpp."""

    def __init__(self, opts):
        super().__init__(opts)
        self.width = opts.funnel_ubd
        self.margin = opts.funnel_beta
        self.kappa = opts.funnel_kappa
        self.update_strategy = opts.funnel_update_strategy
        self.require_wrt_current = opts.funnel_require_acceptance_wrt_current_iterate

    def initialize(self, initial: Progress):
        self.width = max(self.opts.funnel_ubd,
                         self.opts.funnel_fact * initial.infeasibility)

    def _in_funnel(self, h):
        return h <= self.width

    def _update(self, h_cur, h_tri):
        if self.update_strategy == 1:
            if h_tri <= h_cur:
                self.width = max(self.margin * self.width,
                                 self.kappa * h_cur + (1 - self.kappa) * h_tri)
            else:
                self.width = self.margin * self.width
        elif self.update_strategy == 2:
            self.width = self.kappa * self.width + (1 - self.kappa) * h_tri
        else:
            self.width = self.margin * self.width

    def regular_acceptable(self, cur, tri, pred):
        cm, tm, pm = cur.merit(1.0), tri.merit(1.0), pred.merit(1.0)
        if not self._in_funnel(tri.infeasibility):
            return False
        if self.require_wrt_current:
            ok_wrt = (tri.infeasibility < self.opts.funnel_beta * cur.infeasibility) or \
                (tm <= cm - self.opts.funnel_gamma * tri.infeasibility)
            if not ok_wrt:
                return False
        if self._switching(pm, cur.infeasibility):
            return self._armijo(pm, self._actual_reduction(cm, tm))
        if tri.infeasibility <= self.margin * self.width:   # h-type
            self._update(cur.infeasibility, tri.infeasibility)
            return True
        return False

    def notify_switch_to_optimality(self, cur):
        # funnel reduced after restoration (Funnel::update_restoration)
        self.width = self.kappa * self.width + (1 - self.kappa) * cur.infeasibility

    def is_infeasibility_sufficiently_reduced(self, ref, tri):
        return self._in_funnel(tri.infeasibility) and \
            tri.infeasibility <= self.opts.funnel_beta * ref.infeasibility


class L1MeritStrategy(GlobalizationStrategyBase):
    """l1MeritFunction.cpp."""

    def __init__(self, opts):
        super().__init__(opts)
        self.smallest_known_infeasibility = INF

    def initialize(self, initial: Progress): ...

    def is_iterate_acceptable(self, cur, tri, pred, sigma):
        predicted = pred.merit(sigma) + pred.infeasibility
        actual = self._actual_reduction(cur.merit(sigma) + cur.infeasibility,
                                        tri.merit(sigma) + tri.infeasibility)
        accept = self._armijo(predicted, actual)
        if accept:
            self.smallest_known_infeasibility = min(self.smallest_known_infeasibility,
                                                    tri.infeasibility)
        return accept

    def is_infeasibility_sufficiently_reduced(self, ref, tri):
        return tri.infeasibility <= 0.9 * self.smallest_known_infeasibility


def make_strategy(opts: Options) -> GlobalizationStrategyBase:
    name = opts.globalization_strategy
    if name == "fletcher_filter_method":
        return FletcherFilterStrategy(opts)
    if name == "waechter_filter_method":
        return WaechterFilterStrategy(opts)
    if name == "funnel_method":
        return FunnelStrategy(opts)
    if name == "l1_merit":
        return L1MeritStrategy(opts)
    raise ValueError(f"unknown globalization strategy {name!r}")


# ---------------------------------------------------------------------------
# problem machinery: evaluations + QP data for the model and its l1 relaxation
# ---------------------------------------------------------------------------

def _host_qp(res: QPResult) -> QPResult:
    """Instance 0 of a batched QPResult as numpy arrays and Python
    scalars."""
    return QPResult(d=res.d[0].cpu().numpy(), y=res.y[0].cpu().numpy(),
                    zl=res.zl[0].cpu().numpy(), zu=res.zu[0].cpu().numpy(),
                    status=int(res.status[0]), objective=float(res.objective[0]),
                    iterations=int(res.iterations[0]),
                    kkt_error=float(res.kkt_error[0]))


class SQPWorkspace:
    """The model's evaluations and QP solvers on `device`, for one model
    structure.  Arguments and results are numpy (float64)."""

    def __init__(self, nlp: NLP, opts: Options, use_tr: bool, device):
        self.nlp = nlp
        self.opts = opts
        self.device = torch.device(device)
        self.n, self.m = nlp.n, nlp.m
        self.has_xl = nlp.has_x_lb
        self.has_xu = nlp.has_x_ub
        self.xl = np.where(nlp.has_x_lb, nlp.x_lb, -LARGE_BOUND)
        self.xu = np.where(nlp.has_x_ub, nlp.x_ub, LARGE_BOUND)
        self.cl, self.cu = nlp.c_lb.copy(), nlp.c_ub.copy()
        self.is_eq = nlp.is_equality
        self.has_cl = np.isfinite(self.cl) & (self.cl > -1e20)
        self.has_cu = np.isfinite(self.cu) & (self.cu < 1e20)
        self._params = _params_batch(nlp.params, 1, self.device)

        # elastic layout (l1RelaxedProblem.cpp:16-34): one elastic per
        # inequality (negative part if lower bound finite else positive),
        # two per equality
        ineq_idx = np.nonzero(~self.is_eq)[0]
        eq_idx = np.nonzero(self.is_eq)[0]
        self.n_el = len(ineq_idx) + 2 * len(eq_idx)
        E = np.zeros((self.m, self.n_el))
        col = 0
        for j in ineq_idx:
            E[j, col] = 1.0 if self.has_cl[j] else -1.0
            col += 1
        for j in eq_idx:
            E[j, col] = 1.0
            E[j, col + 1] = -1.0
            col += 2
        self.E = E

        # evaluation counters feed Result (reference Iterate::number_eval_*,
        # Iterate.hpp:33-36 — the performance-profile budget metric)
        self.num_obj_evals = 0
        self.num_con_evals = 0
        self.num_hess_evals = 0

        # QP structures (static finiteness patterns)
        if use_tr:
            has_dl = np.ones(self.n, dtype=bool)
            has_du = np.ones(self.n, dtype=bool)
        else:
            has_dl = nlp.has_x_lb
            has_du = nlp.has_x_ub
        struct_opt = QPStructure(
            n=self.n, m=self.m, has_dl=has_dl, has_du=has_du,
            is_eq=self.is_eq, has_rl=self.has_cl, has_ru=self.has_cu)
        # relaxed QP: +n_el elastic columns, lower bounded at 0
        struct_rel = QPStructure(
            n=self.n + self.n_el, m=self.m,
            has_dl=np.concatenate([has_dl, np.ones(self.n_el, dtype=bool)]),
            has_du=np.concatenate([has_du, np.zeros(self.n_el, dtype=bool)]),
            is_eq=self.is_eq, has_rl=self.has_cl, has_ru=self.has_cu)
        self.solve_qp_opt = build_qp_solver(struct_opt, opts, tol=opts.tolerance * 1e-2)
        self.solve_qp_rel = build_qp_solver(struct_rel, opts, tol=opts.tolerance * 1e-2)
        # QP warm start (the reference's WarmstartInformation / BQPD
        # active-set reuse): the last optimal (d, y) per QP family, reused
        # only for a re-solve at the SAME iterate x (a smaller trust region,
        # penalty steering), as uno_tpu does
        self._warm_opt = None
        self._warm_rel = None

    # -- evaluations ----------------------------------------------------------

    def _t(self, a):
        """A (1, ...) float64 tensor of `a` on the workspace's device."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device)[None]

    def evaluate(self, x):
        """f, c, the gradient and the Jacobian at x."""
        self.num_obj_evals += 1
        self.num_con_evals += 1
        xt, p = self._t(x), self._params
        nlp = self.nlp
        return (float(nlp.objective(xt, p)[0]),
                nlp.constraints(xt, p)[0].cpu().numpy(),
                nlp.objective_gradient(xt, p)[0].cpu().numpy(),
                nlp.constraint_jacobian(xt, p)[0].cpu().numpy())

    def f_and_c(self, x):
        self.num_obj_evals += 1
        self.num_con_evals += 1
        xt, p = self._t(x), self._params
        return (float(self.nlp.objective(xt, p)[0]),
                self.nlp.constraints(xt, p)[0].cpu().numpy())

    def hessian(self, x, y, sigma):
        """The Hessian model: the exact Lagrangian Hessian of sigma f - y^T c,
        the identity or zero (reference HessianModelFactory.cpp)."""
        self.num_hess_evals += 1
        if self.opts.hessian_model == "zero":
            return np.zeros((self.n, self.n))
        if self.opts.hessian_model == "identity":
            return np.eye(self.n)
        s = torch.full((1,), float(sigma), dtype=torch.float64, device=self.device)
        return self.nlp.lagrangian_hessian(self._t(x), self._t(y), s,
                                           self._params)[0].cpu().numpy()

    # -- QP data builders ---------------------------------------------------

    def _strip_tr_duals(self, res, x, radius, n_extra=0):
        """Zero bound duals whose QP box side came from the TRUST REGION
        rather than the model bound.  BQPD returns exact zeros for inactive
        bounds, so the reference only resets the TR-ACTIVE case
        (TrustRegionStrategy.cpp:115-130); the QP-IPM leaves z = mu/width
        dust on every bound it saw, which the small trailing radii of a
        rejection streak inflate (uno_tpu's repair)."""
        tr_l = (self.xl - x) < -radius          # TR side strictly tighter
        tr_u = (self.xu - x) > radius
        if n_extra:
            pad = np.zeros(n_extra, dtype=bool)
            tr_l = np.concatenate([tr_l, pad])
            tr_u = np.concatenate([tr_u, pad])
        return res._replace(zl=np.where(tr_l, 0.0, res.zl),
                            zu=np.where(tr_u, 0.0, res.zu))

    def _solve(self, solver, warm, x, g, H, J, rl, ru, dl, du, H_purify=None):
        same_x = warm is not None and np.array_equal(warm[0], np.asarray(x))
        t = self._t
        res = _host_qp(solver(
            t(g), t(H), t(J), t(rl), t(ru), t(dl), t(du),
            warm_d=t(warm[1]) if same_x else None,
            warm_y=t(warm[2]) if same_x else None,
            H_purify=None if H_purify is None else t(H_purify)))
        new_warm = (np.asarray(x), res.d, res.y) if res.status == QP_OPTIMAL else None
        return res, new_warm

    def optimality_qp(self, x, c, g, J, H, radius):
        rl = self.cl - c
        ru = self.cu - c
        dl = np.maximum(-radius, self.xl - x)
        du = np.minimum(radius, self.xu - x)
        J_q = J if self.m else np.zeros((0, self.n))
        res, self._warm_opt = self._solve(self.solve_qp_opt, self._warm_opt, x,
                                          g, H, J_q, rl, ru, dl, du)
        return self._strip_tr_duals(res, x, radius)

    def relaxed_qp(self, x, ev, c, g, J, H, rho, nu, radius, H_orig=None):
        """l1RelaxedProblem QP: variables (d, de).  H_orig: unregularized
        Hessian for dual purification (qp.py H_purify, BQPD parity)."""
        c_rel = c + self.E @ ev
        rl = self.cl - c_rel
        ru = self.cu - c_rel
        g_q = np.concatenate([rho * g, np.full(self.n_el, nu)])
        H_q = np.zeros((self.n + self.n_el, self.n + self.n_el))
        # H is the Lagrangian Hessian already evaluated WITH objective
        # multiplier rho (rho*grad2 f - sum y_j grad2 c_j) — do not rescale
        H_q[: self.n, : self.n] = np.asarray(H)
        J_q = np.concatenate([np.asarray(J), self.E], axis=1) if self.m else \
            np.zeros((0, self.n + self.n_el))
        dl = np.concatenate([np.maximum(-radius, self.xl - x), -ev])
        du = np.concatenate([np.minimum(radius, self.xu - x),
                             np.full(self.n_el, LARGE_BOUND)])
        if H_orig is None:
            Hp_q = None
        else:
            Hp_q = np.zeros_like(H_q)
            Hp_q[: self.n, : self.n] = np.asarray(H_orig)
        res, self._warm_rel = self._solve(self.solve_qp_rel, self._warm_rel, x,
                                          g_q, H_q, J_q, rl, ru, dl, du, Hp_q)
        return self._strip_tr_duals(res, x, radius, n_extra=self.n_el)

    # -- measures and residuals ---------------------------------------------

    def violation(self, c, norm_kind):
        viol = np.maximum(self.cl - c, 0.0) + np.maximum(c - self.cu, 0.0)
        return _norm(viol, norm_kind)

    def row_violation(self, c):
        """Per-row bound violation (no norm)."""
        return np.maximum(self.cl - c, 0.0) + np.maximum(c - self.cu, 0.0)

    def progress_of(self, f, c):
        return Progress(self.violation(c, self.opts.progress_norm), float(f), 0.0)

    def constraint_complementarity(self, c, y):
        """Inequality-constraint complementarity entries
        (OptimizationProblem::complementarity_error)."""
        out = np.zeros(self.m)
        for j in range(self.m):
            if self.is_eq[j]:
                continue
            if y[j] > 0.0 and self.has_cl[j]:
                out[j] = y[j] * (c[j] - self.cl[j])
            elif y[j] < 0.0 and self.has_cu[j]:
                out[j] = y[j] * (c[j] - self.cu[j])
        return out

    def residuals(self, x, ev, f, c, g, J, y, zl, zu, y_f, zl_f, zu_f,
                  zl_el, sigma, nu):
        o = self.opts
        rn = o.residual_norm
        nlp = self.nlp
        # optimality residuals
        grad_lag = sigma * g - (J.T @ y if self.m else 0.0) - zl - zu
        stat = _norm(grad_lag, rn)
        primal_feas = self.violation(c, rn)
        bc = np.where(self.has_xl & (zl > 0), zl * (x - self.xl), 0.0) + \
            np.where(self.has_xu & (zu < 0), zu * (x - self.xu), 0.0)
        compl_entries = np.concatenate([bc, self.constraint_complementarity(c, y)])
        compl = _norm(compl_entries, rn)

        # feasibility (l1 relaxed rho=0) residuals incl elastic entries
        grad_lag_f = -(J.T @ y_f if self.m else 0.0) - zl_f - zu_f
        el_stat = np.zeros(self.n_el)
        col = 0
        for j in np.nonzero(~self.is_eq)[0]:
            sign = 1.0 if self.has_cl[j] else -1.0
            el_stat[col] = nu - sign * y_f[j] - zl_el[col]
            col += 1
        for j in np.nonzero(self.is_eq)[0]:
            el_stat[col] = nu - y_f[j] - zl_el[col]
            el_stat[col + 1] = nu + y_f[j] - zl_el[col + 1]
            col += 2
        feas_stat = _norm(np.concatenate([grad_lag_f, el_stat]), rn)
        bc_f = np.where(self.has_xl & (zl_f > 0), zl_f * (x - self.xl), 0.0) + \
            np.where(self.has_xu & (zu_f < 0), zu_f * (x - self.xu), 0.0)
        el_compl = np.where(zl_el > 0, zl_el * ev, 0.0)
        # feasibility-problem complementarity uses the RELAXED constraints
        # c + E e (the l1RelaxedProblem view, l1RelaxedProblem.cpp:67-86)
        c_rel = c + self.E @ ev if self.n_el else c
        feas_compl = _norm(np.concatenate(
            [bc_f, el_compl, self.constraint_complementarity(c_rel, y_f)]), rn)

        nb = int(nlp.has_x_lb.sum() + nlp.has_x_ub.sum())
        thr = o.residual_scaling_threshold

        def stat_scaling(yv, zlv, zuv):
            total = nb + self.m
            if total == 0:
                return 1.0
            return max(1.0, (np.abs(yv).sum() + np.abs(zlv).sum() + np.abs(zuv).sum())
                       / (thr * total))

        def compl_scaling(zlv, zuv):
            if nb == 0:
                return 1.0
            return max(1.0, (np.abs(zlv).sum() + np.abs(zuv).sum()) / (thr * nb))

        return dict(
            stat=stat, stat_scaling=stat_scaling(y, zl, zu),
            compl=compl, compl_scaling=compl_scaling(zl, zu),
            primal_feas=primal_feas,
            feas_stat=feas_stat, feas_compl=feas_compl,
            feas_stat_scaling=stat_scaling(y_f, zl_f, zu_f),
            feas_compl_scaling=compl_scaling(zl_f, zu_f),
        )

    def first_order_status(self, res, sigma, y_f, zl_f, zu_f, tol):
        stationarity = res["stat"] / res["stat_scaling"] <= tol
        pf_ok = res["primal_feas"] <= tol
        compl_ok = res["compl"] / res["compl_scaling"] <= tol
        if stationarity and pf_ok and sigma > 0 and compl_ok:
            return "optimal"
        nontrivial = np.max(np.abs(y_f), initial=0.0) > tol or \
            np.max(np.abs(zl_f + zu_f), initial=0.0) > tol
        if self.m and res["feas_stat"] <= tol and not pf_ok and \
                res["feas_compl"] <= tol and nontrivial:
            return "infeasible_stationary_point"
        return None


# ---------------------------------------------------------------------------
# iterate and constraint-relaxation strategies
# ---------------------------------------------------------------------------

@dataclass
class SQPIterate:
    x: np.ndarray          # model variables (n,)
    ev: np.ndarray         # elastic values (n_el,)
    y: np.ndarray          # constraint multipliers (m,)
    zl: np.ndarray         # bound duals on x (n,)
    zu: np.ndarray
    y_f: np.ndarray        # feasibility multipliers
    zl_f: np.ndarray
    zu_f: np.ndarray
    zl_el: np.ndarray      # elastic lower-bound duals (feasibility problem)
    f: float = 0.0
    c: np.ndarray = None
    g: np.ndarray = None
    J: np.ndarray = None
    progress: Progress = None


@dataclass
class SQPDirection:
    dx: np.ndarray
    dev: np.ndarray
    y_new: np.ndarray      # new multipliers (Uno: solver returns multipliers)
    zl_new: np.ndarray
    zu_new: np.ndarray
    zl_el_new: np.ndarray
    status: int
    objective: float
    norm: float
    feasibility: bool      # direction computed for the feasibility problem


class FeasibilityRestorationSQP:
    """FeasibilityRestoration.cpp phases for the SQP path."""

    def __init__(self, ws: SQPWorkspace, strategy, opts: Options):
        self.ws = ws
        self.strategy = strategy
        self.opts = opts
        self.phase = "OPT"
        self.nu = opts.l1_constraint_violation_coefficient
        self.reference_progress: Optional[Progress] = None

    @property
    def sigma(self):
        return 1.0 if self.phase == "OPT" else 0.0

    def switch_to_feasibility(self, it: SQPIterate):
        self.phase = "FEAS"
        self.strategy.notify_switch_to_feasibility(it.progress)
        self.reference_progress = it.progress
        # elastics reset (InequalityConstrainedMethod::set_elastic_variable_values)
        it.ev = np.zeros(self.ws.n_el)
        it.zl_el = np.ones(self.ws.n_el)
        it.zl_f = np.where(self.ws.nlp.has_x_lb, 1.0, 0.0)
        it.zu_f = np.where(self.ws.nlp.has_x_ub, -1.0, 0.0)

    def switch_to_optimality(self, it: SQPIterate):
        self.phase = "OPT"
        self.strategy.notify_switch_to_optimality(it.progress)

    def compute_direction(self, it: SQPIterate, radius, H) -> SQPDirection:
        ws = self.ws
        if self.phase == "OPT":
            res = ws.optimality_qp(it.x, it.c, it.g, it.J, H, radius)
            st = res.status
            if st == QP_OPTIMAL:
                return SQPDirection(
                    dx=res.d, dev=np.zeros(ws.n_el),
                    y_new=res.y, zl_new=res.zl, zu_new=res.zu, zl_el_new=it.zl_el,
                    status=st, objective=res.objective,
                    norm=_norm(res.d, "INF"), feasibility=False)
            if st == QP_INFEASIBLE and \
                    it.progress.infeasibility > self.opts.tolerance:
                # at a feasible iterate the linearized QP cannot be infeasible
                # (d=0 is feasible): such a report is a solver artifact and is
                # handled as an error (TR shrink) instead of restoration
                self.switch_to_feasibility(it)
                # fall through to the feasibility QP below
            else:
                if st == QP_INFEASIBLE:
                    st = QP_ERROR
                return SQPDirection(np.zeros(ws.n), np.zeros(ws.n_el), it.y, it.zl,
                                    it.zu, it.zl_el, st, 0.0, 0.0, False)
        # feasibility problem (l1 relaxed, rho = 0); Hessian with sigma=0 and
        # the feasibility multipliers
        H_f = ws.hessian(it.x, it.y_f, 0.0)
        res = ws.relaxed_qp(it.x, it.ev, it.c, it.g, it.J, H_f, 0.0, self.nu, radius)
        d_full = res.d
        return SQPDirection(
            dx=d_full[: ws.n], dev=d_full[ws.n:],
            y_new=res.y, zl_new=res.zl[: ws.n], zu_new=res.zu[: ws.n],
            zl_el_new=res.zl[ws.n:],
            status=res.status, objective=res.objective,
            norm=_norm(d_full[: ws.n], "INF"), feasibility=True)

    def accept(self, it: SQPIterate, trial: SQPIterate, direction: SQPDirection,
               step_length, pred: Progress) -> bool:
        accepted = self.strategy.is_iterate_acceptable(
            it.progress, trial.progress, pred, self.sigma)
        if self.phase == "FEAS" and accepted and \
                self.can_switch_back(it, trial, direction, step_length):
            self.switch_to_optimality(trial)
        return accepted

    def can_switch_back(self, it, trial, direction, step_length):
        # beta-reduction test vs the reference progress
        # (FeasibilityRestoration.cpp:156-162), or feasible to tolerance:
        # with an h=0 filter entry the beta test cannot hold (uno_tpu's
        # repair)
        reduced = self.strategy.is_infeasibility_sufficiently_reduced(
            self.reference_progress, trial.progress)
        if not reduced and trial.progress.infeasibility > self.opts.tolerance:
            return False
        if self.opts.switch_to_optimality_requires_linearized_feasibility:
            lin = it.c + step_length * (it.J @ direction.dx) if self.ws.m else it.c
            if self.ws.violation(lin, self.opts.residual_norm) > self.opts.tolerance:
                return False
        return True


def primal_regularize(H, opts, device):
    """PrimalRegularization (reference PrimalRegularization.hpp:80-140):
    H + delta*I until positive definite, the inertia counted by the LDL^T
    kernels on `device`; delta starts at max(initial, initial - min_diag)
    and grows by the increase factor."""
    n = H.shape[0]

    def positive_definite(M):
        fac = cuda_ldlt.ldlt_factor_cuda(torch.as_tensor(
            M, dtype=torch.float64, device=device)[None].contiguous())
        return int(fac.num_pos[0]) == n and int(fac.num_zero[0]) == 0

    if positive_definite(H):
        return H, 0.0
    min_diag = float(np.min(np.diag(H))) if n else 0.0
    delta = max(opts.regularization_initial_value,
                opts.regularization_initial_value - min_diag)
    for _ in range(80):
        if positive_definite(H + delta * np.eye(n)):
            return H + delta * np.eye(n), delta
        delta *= opts.regularization_increase_factor
    return H + delta * np.eye(n), delta


class L1RelaxationSQP:
    """l1Relaxation.cpp (byrd): Sl1QP with penalty steering."""

    def __init__(self, ws: SQPWorkspace, strategy, opts: Options):
        self.ws = ws
        self.strategy = strategy
        self.opts = opts
        self.rho = opts.l1_relaxation_initial_parameter
        self.nu = opts.l1_constraint_violation_coefficient
        self.phase = "OPT"  # informational

    @property
    def sigma(self):
        return self.rho

    def _solve_l1_qp(self, it, radius, rho):
        H0 = self.ws.hessian(it.x, it.y, rho)
        H = H0
        if self.opts.regularization_strategy == "primal":
            H, _ = primal_regularize(H0, self.opts, self.ws.device)
        return self.ws.relaxed_qp(it.x, it.ev, it.c, it.g, it.J, H, rho,
                                  self.nu, radius, H_orig=H0)

    def _linearized_residual(self, it, dx, kerr=0.0):
        # linearized violation of the MODEL constraints only — elastics do
        # not enter (reference: evaluations.constraints + jacobian *
        # direction.primals, l1Relaxation.cpp:114-115).  Per-row violations
        # at or below the IP-QP's own primal residual (kerr) are zeroed:
        # BQPD returns exactly-feasible subproblem solutions, so the
        # reference's steering gates compare true zeros
        c_lin = it.c + (it.J @ dx if self.ws.m else 0.0)
        viol = self.ws.row_violation(c_lin)
        viol = np.where(viol <= 10.0 * kerr, 0.0, viol)
        return float(np.sum(viol))

    def compute_direction(self, it: SQPIterate, radius, H_unused) -> SQPDirection:
        o = self.opts
        ws = self.ws
        res = self._solve_l1_qp(it, radius, self.rho)
        dx, dev = res.d[: ws.n], res.d[ws.n:]

        if self.rho > 0 and not o.l1_relaxation_fixed_parameter:
            lin_res = self._linearized_residual(it, dx, res.kkt_error)
            if lin_res > o.tolerance:
                current_rho = self.rho
                # stage c: ideal decrease (rho = 0)
                res_f = self._solve_l1_qp(it, radius, 0.0)
                lowest = self._linearized_residual(it, res_f.d[: ws.n],
                                                   res_f.kkt_error)
                # the feasibility QP's multipliers become the iterate's
                # feasibility multipliers (l1Relaxation.cpp:130-131); they
                # feed the FJ infeasibility test in first_order_status
                it.y_f = res_f.y
                it.zl_f = res_f.zl[: ws.n]
                it.zu_f = res_f.zu[: ws.n]
                it.zl_el = res_f.zl[ws.n:]
                # stage f: aggressive decrease from dual error; IP-QP duals
                # are reliable only to O(kkt_error), so the threshold
                # (DefaultOptions.cpp:157) grows with it
                y_trial = res_f.y
                zl_t = res_f.zl[: ws.n]
                zu_t = res_f.zu[: ws.n]
                dust = max(o.l1_small_duals_threshold, 1e3 * res_f.kkt_error)
                nontrivial = np.max(np.abs(y_trial), initial=0.0) > dust \
                    or np.max(np.abs(zl_t + zu_t), initial=0.0) > dust
                if nontrivial and lowest > o.l1_relaxation_residual_small_threshold:
                    err = self._infeasible_dual_error(it, y_trial, zl_t, zu_t)
                    scaled = err / max(1.0, ws.violation(it.c, o.residual_norm))
                    self.rho = min(self.rho, scaled * scaled)
                if self.rho < current_rho:
                    res = self._solve_l1_qp(it, radius, self.rho)
                    dx, dev = res.d[: ws.n], res.d[ws.n:]
                    lin_res = self._linearized_residual(it, dx, res.kkt_error)
                # stage d: sufficient linearized decrease
                h_cur = ws.violation(it.c, "L1")
                for _ in range(60):
                    if self.rho <= 0:
                        break
                    if lowest <= o.l1_relaxation_residual_small_threshold:
                        ok = lin_res <= o.l1_relaxation_residual_small_threshold
                    else:
                        ok = (h_cur - lin_res) >= o.l1_relaxation_epsilon1 * (h_cur - lowest)
                    if ok:
                        break
                    self.rho /= o.l1_relaxation_decrease_factor
                    res = self._solve_l1_qp(it, radius, self.rho)
                    dx, dev = res.d[: ws.n], res.d[ws.n:]
                    lin_res = self._linearized_residual(it, dx, res.kkt_error)
                # stage e: descent direction for the l1 merit function;
                # IP-QP objectives are reliable only to O(kkt_error), so
                # dust is snapped to 0 and cannot flip the descent test
                pf = ws.violation(it.c, o.residual_norm)

                def _snap(v, kerr):
                    return 0.0 if abs(v) <= 100.0 * kerr * max(1.0, pf) else v
                lowest_obj = _snap(pf - res_f.objective, res_f.kkt_error)
                for _ in range(60):
                    if self.rho <= 0:
                        break
                    pred = _snap(pf - res.objective, res.kkt_error)
                    if pred >= o.l1_relaxation_epsilon2 * lowest_obj:
                        break
                    self.rho /= o.l1_relaxation_decrease_factor
                    res = self._solve_l1_qp(it, radius, self.rho)
                    dx, dev = res.d[: ws.n], res.d[ws.n:]

        return SQPDirection(
            dx=dx, dev=dev, y_new=res.y,
            zl_new=res.zl[: ws.n], zu_new=res.zu[: ws.n],
            zl_el_new=res.zl[ws.n:],
            status=res.status, objective=res.objective,
            norm=_norm(dx, "INF"), feasibility=False)

    def _infeasible_dual_error(self, it, y, zl, zu):
        """l1Relaxation::compute_infeasible_dual_error (stationarity of the
        feasibility problem + complementarity), L1 norms."""
        ws = self.ws
        grad = -(it.J.T @ y if ws.m else 0.0) - zl - zu
        err = float(np.sum(np.abs(grad)))
        bc = np.where(ws.has_xl & (zl > 0), zl * (it.x - ws.xl), 0.0) + \
            np.where(ws.has_xu & (zu < 0), zu * (it.x - ws.xu), 0.0)
        err += float(np.sum(np.abs(bc)))
        err += float(np.sum(np.abs(ws.constraint_complementarity(it.c, y))))
        return err

    def accept(self, it, trial, direction, step_length, pred):
        return self.strategy.is_iterate_acceptable(
            it.progress, trial.progress, pred, self.sigma)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _make_trial(ws: SQPWorkspace, it: SQPIterate, direction: SQPDirection,
                alpha: float, dual_alpha: float) -> SQPIterate:
    x_t = np.clip(it.x + alpha * direction.dx, ws.xl, ws.xu)
    ev_t = np.maximum(it.ev + alpha * direction.dev, 0.0)
    # dual step: new multipliers are y + dual_alpha * (y_new - y); bound duals
    # take the full displacement (GlobalizationMechanism.cpp:11-31)
    if direction.feasibility:
        y = it.y.copy()
        zl, zu = it.zl.copy(), it.zu.copy()
        y_f = it.y_f + dual_alpha * (direction.y_new - it.y_f)
        zl_f, zu_f = direction.zl_new.copy(), direction.zu_new.copy()
    else:
        y = it.y + dual_alpha * (direction.y_new - it.y)
        zl, zu = direction.zl_new.copy(), direction.zu_new.copy()
        y_f, zl_f, zu_f = it.y_f.copy(), it.zl_f.copy(), it.zu_f.copy()
    zl_el = direction.zl_el_new.copy()
    f, c = ws.f_and_c(x_t)
    trial = SQPIterate(x=x_t, ev=ev_t, y=y, zl=zl, zu=zu, y_f=y_f,
                       zl_f=zl_f, zu_f=zu_f, zl_el=zl_el, f=f, c=c)
    trial.progress = ws.progress_of(f, c)
    return trial


def _predicted(ws: SQPWorkspace, it: SQPIterate, direction: SQPDirection,
               alpha: float, sigma_unused, H, first_order: bool) -> Progress:
    """compute_predicted_reductions (ConstraintRelaxationStrategy.cpp:91-98);
    objective part evaluated at multiplier 1 for filter/funnel merit."""
    c_lin = it.c + alpha * (it.J @ direction.dx) if ws.m else it.c
    pred_h = ws.violation(it.c, ws.opts.progress_norm) - \
        ws.violation(c_lin, ws.opts.progress_norm)
    dd = float(it.g @ direction.dx)
    quad = 0.0 if first_order else float(direction.dx @ (np.asarray(H) @ direction.dx))
    pred_obj = alpha * (-dd) - alpha * alpha / 2.0 * quad
    return Progress(pred_h, pred_obj, 0.0)


def _finalize(nlp_orig, scaled_nlp, it, res, status_name, iterations, t0,
              n_qp, ws=None, trace=None) -> Result:
    f_scale = scaled_nlp.f_scale
    c_scale = scaled_nlp.c_scale if scaled_nlp.c_scale is not None \
        else np.ones(max(scaled_nlp.m, 1))
    m0 = nlp_orig.m
    y_full = np.asarray(it.y) * c_scale[: np.asarray(it.y).shape[0]] / f_scale
    zl_out, zu_out = map_fixed_bound_duals(
        nlp_orig, y_full, it.zl[: nlp_orig.n] / f_scale,
        it.zu[: nlp_orig.n] / f_scale)
    x_t = torch.as_tensor(it.x[: nlp_orig.n], dtype=torch.float64)[None]
    f_val = float(nlp_orig.objective(x_t, _params_batch(nlp_orig.params, 1, "cpu"))[0])
    return Result(
        status=status_name, x=it.x[: nlp_orig.n].copy(),
        y=y_full[:m0] if m0 else np.zeros(0),
        zl=zl_out, zu=zu_out,
        objective=f_val,
        iterations=iterations,
        primal_feasibility=res["primal_feas"],
        stationarity=res["stat"] / res["stat_scaling"],
        complementarity=res["compl"] / res["compl_scaling"],
        cpu_time=time.monotonic() - t0,
        num_subproblems_solved=n_qp,
        num_factorizations=getattr(ws, "num_hess_evals", 0) if ws else 0,
        num_objective_evaluations=getattr(ws, "num_obj_evals", 0) if ws else 0,
        num_constraint_evaluations=getattr(ws, "num_con_evals", 0) if ws else 0,
        history=trace,
    )


def _evaluate_into(ws: SQPWorkspace, it: SQPIterate) -> None:
    """it's f, c, gradient, Jacobian and progress at it.x."""
    it.f, it.c, it.g, it.J = ws.evaluate(it.x)
    it.progress = ws.progress_of(it.f, it.c)


def solve_sqp(nlp_in: NLP, opts: Options, device, callbacks=None,
              history=False) -> Result:
    """Solve one NLP with the host driver on `device`."""
    t0 = time.monotonic()
    nlp = transforms.scale_model(nlp_in, opts.function_scaling_threshold) \
        if opts.scale_functions else nlp_in
    nlp = transforms.fixed_bounds_to_constraints(nlp)
    use_tr = opts.globalization_mechanism == "TR"
    ws = SQPWorkspace(nlp, opts, use_tr, device)
    strategy = make_strategy(opts)
    if opts.constraint_relaxation_strategy == "l1_relaxation":
        relaxation = L1RelaxationSQP(ws, strategy, opts)
    else:
        relaxation = FeasibilityRestorationSQP(ws, strategy, opts)

    # initial iterate
    x0 = np.clip(np.asarray(nlp.x0, dtype=float), ws.xl, ws.xu)
    it = SQPIterate(
        x=x0, ev=np.zeros(ws.n_el),
        y=np.asarray(nlp.y0, dtype=float).copy() if nlp.y0 is not None else np.zeros(ws.m),
        zl=np.zeros(ws.n), zu=np.zeros(ws.n),
        y_f=np.zeros(ws.m), zl_f=np.zeros(ws.n), zu_f=np.zeros(ws.n),
        zl_el=np.ones(ws.n_el))
    _evaluate_into(ws, it)
    strategy.initialize(it.progress)
    trace = [copy.deepcopy(it)] if history else None

    nu = opts.l1_constraint_violation_coefficient
    res = ws.residuals(it.x, it.ev, it.f, it.c, it.g, it.J, it.y, it.zl, it.zu,
                       it.y_f, it.zl_f, it.zu_f, it.zl_el, relaxation.sigma, nu)

    from uno_tpu_torch.utils.logger import LEVELS
    from uno_tpu_torch.utils.statistics import Statistics
    verbose = LEVELS.index(opts.logger) >= LEVELS.index("INFO")
    stats = Statistics()
    if verbose:
        for cname, w, order in (("iter", Statistics.INT_WIDTH, 1),
                                ("TR radius" if use_tr else "penalty",
                                 Statistics.DOUBLE_WIDTH - 5, 8),
                                ("phase", Statistics.INT_WIDTH, 20),
                                ("objective", Statistics.DOUBLE_WIDTH - 5, 100),
                                ("primal feas", Statistics.DOUBLE_WIDTH - 4, 101),
                                ("stationarity", Statistics.DOUBLE_WIDTH - 3, 104)):
            stats.add_column(cname, w, order)

    radius = opts.TR_radius
    n_qp = 0
    loose_count = 0
    status_name = "iteration_limit"
    iteration = 0

    while iteration < opts.max_iterations:
        if over_time_limit(t0, opts.time_limit):
            status_name = "time_limit"
            break
        iteration += 1
        sigma = relaxation.sigma
        H = ws.hessian(it.x, it.y, sigma)
        accepted = False
        terminal = None

        if use_tr:
            radius = max(radius, opts.TR_radius_reset_threshold)
            while True:
                direction = relaxation.compute_direction(it, radius, H)
                n_qp += 1
                if direction.status == QP_UNBOUNDED:
                    radius /= opts.TR_aggressive_decrease_factor
                elif direction.status == QP_ERROR:
                    radius /= opts.TR_decrease_factor
                else:
                    sigma = relaxation.sigma  # may have switched phase
                    trial = _make_trial(ws, it, direction, 1.0, 1.0)
                    # reset multipliers of TR-active bounds
                    act = opts.TR_activity_tolerance
                    for i in range(ws.n):
                        if abs(direction.dx[i] + radius) <= act and \
                                act < abs(trial.x[i] - ws.xl[i]):
                            trial.zl[i] = 0.0
                            trial.zl_f[i] = 0.0
                        if abs(direction.dx[i] - radius) <= act and \
                                act < abs(ws.xu[i] - trial.x[i]):
                            trial.zu[i] = 0.0
                            trial.zu_f[i] = 0.0
                    pred = _predicted(ws, it, direction, 1.0, sigma, H, False)
                    # zero primal step: accept and pick up the fresh multipliers
                    # (ConstraintRelaxationStrategy.cpp:110-115)
                    if direction.norm <= 1e-10:
                        accepted = True
                    else:
                        accepted = relaxation.accept(it, trial, direction, 1.0, pred)
                    if accepted:
                        if direction.norm >= radius - act:
                            radius *= opts.TR_increase_factor
                        break
                    if radius < opts.TR_min_radius:
                        # check_termination_with_small_step
                        if trial.progress.infeasibility <= opts.tolerance:
                            accepted = True
                            terminal = "feasible_small_step"
                            break
                        if relaxation.phase == "FEAS":
                            accepted = True
                            terminal = "infeasible_small_step"
                            break
                        terminal = "algorithmic_error"
                        break
                    radius = min(radius, direction.norm) / opts.TR_decrease_factor
                if radius < opts.TR_min_radius and not accepted:
                    # solver-error path at a small radius: the reference
                    # throws "Small radius" (TrustRegionStrategy.cpp:103-105);
                    # the small-step termination test runs at the CURRENT
                    # iterate instead (uno_tpu's choice)
                    if it.progress.infeasibility <= opts.tolerance:
                        terminal = "feasible_small_step"
                    elif relaxation.phase == "FEAS":
                        terminal = "infeasible_small_step"
                    else:
                        terminal = "algorithmic_error"
                    break
        else:  # line search
            small_step_status = None
            direction = relaxation.compute_direction(it, INF, H)
            n_qp += 1
            if direction.status in (QP_UNBOUNDED, QP_ERROR):
                terminal = "algorithmic_error"
            else:
                sigma = relaxation.sigma
                alpha = 1.0
                restarted = False
                while True:
                    dual_alpha = alpha if opts.LS_scale_duals_with_step_length else 1.0
                    trial = _make_trial(ws, it, direction, alpha, dual_alpha)
                    pred = _predicted(ws, it, direction, alpha, sigma, H, True)
                    if direction.norm <= 1e-10:
                        accepted = True
                    else:
                        accepted = relaxation.accept(it, trial, direction, alpha, pred)
                    if accepted:
                        break
                    if alpha >= opts.LS_min_step_length:
                        alpha *= opts.LS_backtracking_ratio
                        continue
                    # terminate_with_small_step_length (BacktrackingLineSearch
                    # .cpp:91-95,115-124): before failing, check termination
                    # at the trial iterate, which carries the QP's fresh duals
                    _evaluate_into(ws, trial)
                    res_t = ws.residuals(trial.x, trial.ev, trial.f, trial.c,
                                         trial.g, trial.J, trial.y, trial.zl,
                                         trial.zu, trial.y_f, trial.zl_f,
                                         trial.zu_f, trial.zl_el,
                                         relaxation.sigma, nu)
                    st_t = ws.first_order_status(
                        res_t, relaxation.sigma, trial.y_f, trial.zl_f,
                        trial.zu_f, opts.tolerance)
                    if not st_t:
                        st_l = ws.first_order_status(
                            res_t, relaxation.sigma, trial.y_f, trial.zl_f,
                            trial.zu_f, opts.loose_tolerance)
                        st_t = "almost_optimal" if st_l == "optimal" else st_l
                    if st_t:
                        accepted = True
                        small_step_status = st_t
                        break
                    # LS failed: switch to feasibility (restoration) or stop
                    if isinstance(relaxation, FeasibilityRestorationSQP) and \
                            relaxation.phase == "OPT" and ws.m and not restarted:
                        relaxation.switch_to_feasibility(it)
                        direction = relaxation.compute_direction(it, INF, H)
                        n_qp += 1
                        sigma = relaxation.sigma
                        alpha = 1.0
                        restarted = True
                        continue
                    terminal = "algorithmic_error"
                    break

        if accepted:
            it = trial
            _evaluate_into(ws, it)
            if callbacks is not None:
                callbacks.notify_acceptable_iterate(it.x, it.y, relaxation.sigma)
                callbacks.notify_new_primals(it.x[: nlp_in.n].copy())
                callbacks.notify_new_multipliers(it.y[: nlp_in.m].copy())
            if history:
                trace.append(copy.deepcopy(it))

        res = ws.residuals(it.x, it.ev, it.f, it.c, it.g, it.J, it.y, it.zl, it.zu,
                           it.y_f, it.zl_f, it.zu_f, it.zl_el, relaxation.sigma, nu)
        if verbose:
            stats.start_new_line()
            stats.set("iter", iteration)
            stats.set("TR radius" if use_tr else "penalty",
                      radius if use_tr else getattr(relaxation, "rho", 1.0))
            stats.set("phase", relaxation.phase)
            stats.set("objective", it.f)
            stats.set("primal feas", res["primal_feas"])
            stats.set("stationarity", res["stat"] / res["stat_scaling"])
            stats.print_current_line()
        st = ws.first_order_status(res, relaxation.sigma, it.y_f, it.zl_f,
                                   it.zu_f, opts.tolerance)
        if st:
            status_name = st
            break
        if not use_tr and small_step_status:
            # accepted via terminate_with_small_step_length
            status_name = small_step_status
            break
        if opts.loose_tolerance > opts.tolerance:
            st_loose = ws.first_order_status(res, relaxation.sigma, it.y_f, it.zl_f,
                                             it.zu_f, opts.loose_tolerance)
            loose_count = loose_count + 1 if st_loose else 0
            if loose_count >= opts.loose_tolerance_consecutive_iteration_threshold:
                status_name = "almost_optimal" if st_loose == "optimal" else st_loose
                break
        if it.f < opts.unbounded_objective_threshold:
            status_name = "unbounded"
            break
        if terminal == "feasible_small_step":
            status_name = "optimal" if ws.first_order_status(
                res, relaxation.sigma, it.y_f, it.zl_f, it.zu_f,
                opts.loose_tolerance) else "feasible_small_step"
            break
        if terminal == "infeasible_small_step":
            status_name = "infeasible_small_step"
            break
        if terminal == "algorithmic_error":
            status_name = "algorithmic_error"
            break

    if verbose:
        stats.print_footer()
    return _finalize(nlp_in, nlp, it, res, status_name, iteration, t0, n_qp,
                     ws=ws, trace=trace)
