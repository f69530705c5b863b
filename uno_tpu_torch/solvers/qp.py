"""QP/LP subproblem solver: primal-dual interior point with inertia
correction, batched.

Counterpart of uno_tpu/solvers/qp.py, the replacement of the reference's
BQPD (active-set QP) and HiGHS (LP) behind the QPSolver/LPSolver interface
(LPSolver.hpp:21-34): an interior-point method over the same dense LDL^T,
with indefinite Hessians convexified by the inertia correction.

Problem form, one per instance of the batch:
    min  g^T d + 1/2 d^T H d
    s.t. rl <= J d <= ru        (rows with rl == ru are equalities)
         dl <= d  <= du         (box: variable bounds intersected with TR)

Inequality rows get a slack with a barrier; the slack block is condensed
into the dual diagonal (-Sigma_s^{-1}), so the KKT matrix stays (n+m) with
the saddle inertia (n, m, 0).  uno_tpu's `lax.while_loop` of interior-point
iterations is a host loop over the instances that are still running, each
with its own status, iteration count and barrier parameter; an instance
that has stopped keeps its values, which is what `vmap(while_loop)` gives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from uno_tpu_torch.ingredients import barrier as bar
from uno_tpu_torch.ingredients.regularization import regularize_and_factor
from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.linalg.ldlt import ldlt_solve
from uno_tpu_torch.options import Options
from uno_tpu_torch.solvers.ipm import _max0, _where
from uno_tpu_torch.solvers.ipm import _matvec as _library_matvec

QP_OPTIMAL = 0
QP_INFEASIBLE = 1
QP_UNBOUNDED = 2
QP_ERROR = 3
QP_RUNNING = -1

HUGE = 1e25

# since the last reset_counts(): QP solves (calls of a solver), the
# instances they solved and the interior-point iterations of those
# instances, summed; read by chip_smoke.py for the iterations per QP
counts = {"solves": 0, "instances": 0, "iterations": 0}


def reset_counts() -> None:
    counts.update(dict.fromkeys(counts, 0))


def _matvec(A, x):
    """A @ x for each instance as XLA:CPU computes uno_tpu's jitted QP at
    its sizes (tools/xla_fma_census.py): each row a chain of fused
    multiply-adds from +0 over the columns in increasing order, which
    torch.addcmul gives on the CPU and on CUDA.  The chain decides whether
    a residual of terms of 1e10 cancels to below the QP's tolerance (cliff
    under filtersqp).  Above 32 columns, one batched matrix product."""
    if A.shape[-1] > 32:
        return _library_matvec(A, x)
    acc = A.new_zeros(A.shape[:-1])
    for k in range(A.shape[-1]):
        acc = torch.addcmul(acc, A[..., :, k], x[..., k:k + 1])
    return acc


def _rmatvec(A, y):
    """A^T y for each instance, as _matvec."""
    return _matvec(A.transpose(-1, -2), y)


class QPResult(NamedTuple):
    d: torch.Tensor        # primal solution (B, n)
    y: torch.Tensor        # constraint multipliers, Uno sign convention (B, m)
    zl: torch.Tensor       # bound duals on d (B, n)
    zu: torch.Tensor
    status: torch.Tensor   # (B,) int64
    objective: torch.Tensor
    iterations: torch.Tensor
    kkt_error: torch.Tensor


@dataclass(frozen=True)
class QPStructure:
    """Static bound structure of a QP family (numpy masks)."""
    n: int
    m: int
    has_dl: np.ndarray    # (n,) finite lower box bound
    has_du: np.ndarray
    is_eq: np.ndarray     # (m,) rows with rl == ru
    has_rl: np.ndarray    # (m,) finite row lower bound (inequality rows)
    has_ru: np.ndarray
    _cache: dict = field(default_factory=dict, init=False, compare=False,
                         repr=False)

    def masks(self, device):
        """(has_dl, has_du, is_eq, has_rl, has_ru) as bool tensors on
        `device`, has_rl and has_ru without the equality rows."""
        device = torch.device(device)
        out = self._cache.get(device)
        if out is None:
            t = lambda a: torch.as_tensor(np.asarray(a, dtype=bool), device=device)  # noqa: E731
            out = self._cache[device] = (
                t(self.has_dl), t(self.has_du), t(self.is_eq),
                t(self.has_rl & ~self.is_eq), t(self.has_ru & ~self.is_eq))
        return out


def take(tensors, idx):
    """The instances `idx` of every tensor (None stays None)."""
    return tuple(None if t is None else t.index_select(0, idx) for t in tensors)


def build_qp_solver(struct: QPStructure, opts: Options, tol: float = 1e-10,
                    max_iterations: int = 150, purify: bool = True):
    """Returns solve(g, H, J, rl, ru, dl, du, warm_d=None, warm_y=None,
    H_purify=None) -> QPResult over a batch: g (B, n), H (B, n, n),
    J (B, m, n), rl and ru (B, m), dl and du (B, n)."""
    n, m = struct.n, struct.m
    k1 = opts.barrier_push_variable_to_interior_k1
    k2 = opts.barrier_push_variable_to_interior_k2
    kkt32 = opts.kkt_dtype == "float32"
    # within one QP solve the Hessian is fixed, so the convexification delta
    # tracks its static need closely: /2 with x2 (x10 fast), uno_tpu's
    # schedule for the QP, keeps delta within a factor 2 of the minimum
    reg_opts = opts.replace(primal_regularization_decrease_factor=2.0,
                            primal_regularization_slow_increase_factor=2.0,
                            primal_regularization_fast_increase_factor=10.0)

    def solve(g, H, J, rl, ru, dl, du, warm_d=None, warm_y=None,
              H_purify=None) -> QPResult:
        """warm_d / warm_y: a primal / dual warm start (the interior-point
        analogue of BQPD's active-set reuse, BQPDSolver.cpp:246-258): the
        previous solution pushed interior, with a small initial barrier.

        H_purify: an optional unregularized Hessian for the dual
        purification's fit, when the caller convexified H itself."""
        has_dl, has_du, is_eq, has_rl, has_ru = struct.masks(g.device)
        is_ineq = ~is_eq
        B = g.shape[0]
        dl = torch.where(has_dl, dl, -HUGE)
        du = torch.where(has_du, du, HUGE)
        # slack bounds: inequality rows only; equality rows pin s = rl
        sl = torch.where(has_rl, rl, -HUGE)
        su = torch.where(has_ru, ru, HUGE)
        ones_n = torch.ones_like(g)

        if warm_d is None:
            d0 = bar.push_to_interior(torch.zeros_like(g), dl, du, k1, k2)
            y0 = g.new_zeros((B, m))
            mu0 = 0.1
            zl0 = torch.where(has_dl, ones_n, 0.0)
            zu0 = torch.where(has_du, -ones_n, 0.0)
        else:
            d0 = bar.push_to_interior(warm_d, dl, du, k1, k2)
            y0 = g.new_zeros((B, m)) if warm_y is None else warm_y.clone()
            mu0 = 1e-3
            # mu-centred bound duals at the warm point
            zl0 = torch.where(has_dl, torch.clamp(
                mu0 / torch.clamp(d0 - dl, min=1e-10), 1e-8, 1e8), 0.0)
            zu0 = torch.where(has_du, -torch.clamp(
                mu0 / torch.clamp(du - d0, min=1e-10), 1e-8, 1e8), 0.0)
        if m:
            s0 = torch.where(is_eq, rl, bar.push_to_interior(
                _matvec(J, d0), sl, su, k1, k2))
        else:
            s0 = g.new_zeros((B, 0))
        ones_m = s0.new_ones((B, m))
        wl0 = torch.where(has_rl, ones_m, 0.0)
        wu0 = torch.where(has_ru, -ones_m, 0.0)

        def kkt_error(data, d, s, y, zl, zu, wl, wu):
            g_, H_, J_, dl_, du_, sl_, su_ = data
            r_d = g_ + _matvec(H_, d) - (_rmatvec(J_, y) if m else 0.0) - zl - zu
            err = _max0(torch.abs(r_d))
            if m:
                r_c = _matvec(J_, d) - s
                err = torch.maximum(err, _max0(torch.abs(r_c)))
                # slack stationarity: y - wl - wu = 0 on inequality rows
                r_s = torch.where(is_ineq, y - wl - wu, 0.0)
                err = torch.maximum(err, _max0(torch.abs(r_s)))
            cl = bar.bound_complementarity_error(d, zl, zu, dl_, du_, has_dl, has_du)
            err = torch.maximum(err, _max0(torch.abs(cl)))
            if m:
                cs = bar.bound_complementarity_error(s, wl, wu, sl_, su_, has_rl, has_ru)
                err = torch.maximum(err, _max0(torch.abs(cs)))
            return err

        def body(data, carry):
            g_, H_, J_, dl_, du_, sl_, su_ = data
            d, s, y, zl, zu, wl, wu, mu, prev_delta, it, status, min_pres = carry

            Sigma_d = bar.barrier_hessian_diag(d, zl, zu, dl_, du_, has_dl, has_du)
            g_bar_d = g_ + _matvec(H_, d) \
                + bar.barrier_gradient(d, dl_, du_, has_dl, has_du, mu, 0.0)
            rhs_d = -(g_bar_d - (_rmatvec(J_, y) if m else 0.0))
            if m:
                Sigma_s = bar.barrier_hessian_diag(s, wl, wu, sl_, su_, has_rl, has_ru)
                g_bar_s = bar.barrier_gradient(s, sl_, su_, has_rl, has_ru, mu, 0.0)
                # slack stationarity residual r_s = g_bar_s + y
                r_s = g_bar_s + y
                inv_Ss = torch.where(is_ineq, 1.0 / torch.clamp(Sigma_s, min=1e-35), 0.0)
                r_c = _matvec(J_, d) - s
                rhs = torch.cat([rhs_d, -r_c - inv_Ss * r_s], dim=-1)
            else:
                rhs = rhs_d

            def assemble(delta, eps):
                Hd = H_ + torch.diag_embed(Sigma_d + delta[:, None])
                if m == 0:
                    return Hd
                dual_block = -torch.diag_embed(inv_Ss + eps[:, None])
                return torch.cat([torch.cat([Hd, J_.transpose(-1, -2)], dim=-1),
                                  torch.cat([J_, dual_block], dim=-1)], dim=-2)

            reg = regularize_and_factor(assemble, n, m, torch.sqrt(mu), prev_delta,
                                        reg_opts, block=opts.ldlt_block_size)
            if kkt32:
                sol = ldlt_solve(reg.fac, rhs.to(torch.float32)).to(rhs.dtype)
                K64 = assemble(reg.delta, reg.eps)
                for _ in range(2):
                    resid = rhs - _matvec(K64, sol)
                    sol = sol + ldlt_solve(reg.fac, resid.to(torch.float32)).to(rhs.dtype)
            else:
                sol = ldlt_solve(reg.fac, rhs)
            dd = sol[:, :n]
            w = sol[:, n:]
            dy = -w
            if m:
                ds = torch.where(is_ineq, inv_Ss * (-r_s + w), 0.0)
                dwl, dwu = bar.bound_dual_direction(s, ds, wl, wu, sl_, su_,
                                                    has_rl, has_ru, mu)
            else:
                ds = dwl = dwu = w
            dzl, dzu = bar.bound_dual_direction(d, dd, zl, zu, dl_, du_,
                                                has_dl, has_du, mu)

            tau = torch.clamp(1.0 - mu, min=0.99)
            a_p = bar.primal_fraction_to_boundary(d, dd, dl_, du_, has_dl, has_du, tau)
            a_z = bar.dual_fraction_to_boundary(zl, zu, dzl, dzu, has_dl, has_du, tau)
            if m:
                a_p = torch.minimum(a_p, bar.primal_fraction_to_boundary(
                    s, ds, sl_, su_, has_rl, has_ru, tau))
                a_z = torch.minimum(a_z, bar.dual_fraction_to_boundary(
                    wl, wu, dwl, dwu, has_rl, has_ru, tau))
            ap, az = a_p[:, None], a_z[:, None]
            d = d + ap * dd
            s = s + ap * ds
            y = y + az * dy
            zl, zu = zl + az * dzl, zu + az * dzu
            wl, wu = wl + az * dwl, wu + az * dwu

            # monotone barrier decrease
            err = kkt_error(data, d, s, y, zl, zu, wl, wu)
            mu = torch.where(err <= 10.0 * mu,
                             torch.clamp(torch.minimum(0.2 * mu, torch.pow(mu, 1.5)),
                                         min=tol / 10.0),
                             mu)

            it = it + 1
            finite = torch.all(torch.isfinite(d), dim=-1) & \
                torch.all(torch.isfinite(y), dim=-1)
            status = torch.where(err <= tol, QP_OPTIMAL, status)
            status = torch.where(_max0(torch.abs(d)) > 1e10, QP_UNBOUNDED, status)
            status = torch.where(reg.failed | ~finite, QP_ERROR, status)
            # the best primal feasibility ever reached (NaN-safe), for the
            # infeasibility classification below
            pres = _max0(torch.abs(_matvec(J_, d) - s)) if m else torch.zeros_like(mu)
            pres = torch.where(torch.isfinite(pres), pres, float("inf"))
            min_pres = torch.minimum(min_pres, pres)
            return (d, s, y, zl, zu, wl, wu, mu, reg.prev_delta, it, status,
                    min_pres)

        data = (g, H, J, dl, du, sl, su)
        izero = torch.zeros((B,), dtype=torch.int64, device=g.device)
        carry = (d0, s0, y0, zl0, zu0, wl0, wu0, g.new_full((B,), mu0),
                 g.new_zeros((B,)), izero, izero + QP_RUNNING,
                 g.new_full((B,), float("inf")))
        for _ in range(max_iterations):
            running = carry[10] == QP_RUNNING
            idx = torch.nonzero(running).squeeze(1)
            if idx.numel() == 0:
                break
            if idx.numel() == B:
                carry = body(data, carry)
            else:
                sub = body(take(data, idx), take(carry, idx))
                carry = tuple(full.index_copy(0, idx, part)
                              for full, part in zip(carry, sub))
        d, s, y, zl, zu, wl, wu, mu, _, it, status, min_pres = carry

        err = kkt_error(data, d, s, y, zl, zu, wl, wu)

        # ---- dual purification (BQPD parity, BQPDSolver.cpp:310-348) ------
        # an interior-point QP leaves dual dust on inactive constraints;
        # identify the eps-active set at d and refit the multipliers by
        # ridge-regularized least squares on the active gradients, keeping
        # the fit only when it does not worsen stationarity
        if purify:
            eps_a = 1e-6
            act_lo = has_dl & ((d - dl) <= eps_a * (1.0 + torch.abs(dl)))
            act_up = has_du & ((du - d) <= eps_a * (1.0 + torch.abs(du)))
            rvec = g + _matvec(H if H_purify is None else H_purify, d)
            diag_lo = torch.diag_embed(torch.where(act_lo, ones_n, 0.0))
            diag_up = torch.diag_embed(torch.where(act_up, ones_n, 0.0))
            if m:
                r_rows = _matvec(J, d)
                row_lo = has_rl & ((r_rows - rl) <= eps_a * (1.0 + torch.abs(rl)))
                row_up = has_ru & ((ru - r_rows) <= eps_a * (1.0 + torch.abs(ru)))
                act_row = is_eq | row_lo | row_up
                A = torch.cat([J.transpose(-1, -2) * act_row[:, None, :],
                               diag_lo, diag_up], dim=-1)
            else:
                A = torch.cat([diag_lo, diag_up], dim=-1)
            k = A.shape[-1]
            lam = 1e-10 * (1.0 + torch.amax(torch.abs(A), dim=(-2, -1)))
            At = A.transpose(-1, -2)
            AtA = At @ A + lam[:, None, None] * torch.eye(k, dtype=A.dtype,
                                                          device=A.device)
            # uno_tpu factors the fit with the column form at every dim;
            # the kernels' wrapper gives the same factors up to dim 64
            # (ldlt_warp, ldlt_column) and takes the panels above
            w = ldlt_solve(cuda_ldlt.ldlt_factor_cuda(AtA.contiguous()),
                           _matvec(At, rvec))
            if m:
                y_p = torch.where(act_row, w[:, :m], 0.0)
                # one-sided active inequality rows have signed multipliers
                y_p = torch.where(is_eq, y_p,
                                  torch.where(row_lo & ~row_up,
                                              torch.clamp(y_p, min=0.0),
                                              torch.where(row_up & ~row_lo,
                                                          torch.clamp(y_p, max=0.0),
                                                          y_p)))
                zl_p = torch.clamp(torch.where(act_lo, w[:, m:m + n], 0.0), min=0.0)
                zu_p = torch.clamp(torch.where(act_up, w[:, m + n:], 0.0), max=0.0)
            else:
                y_p = y
                zl_p = torch.clamp(torch.where(act_lo, w[:, :n], 0.0), min=0.0)
                zu_p = torch.clamp(torch.where(act_up, w[:, n:], 0.0), max=0.0)
            # active-bound duals below the solve's resolution are noise, and
            # so is what an inconsistent fit smears into small multipliers:
            # snap both to the exact zeros an active-set solver returns
            fit_res = _max0(torch.abs(rvec - (_rmatvec(J, y_p) if m else 0.0)
                                      - zl_p - zu_p))
            noise = torch.maximum(100.0 * err, fit_res)[:, None]
            if m:
                y_p = torch.where(torch.abs(y_p) <= noise, 0.0, y_p)
            zl_p = torch.where(torch.abs(zl_p) <= noise, 0.0, zl_p)
            zu_p = torch.where(torch.abs(zu_p) <= noise, 0.0, zu_p)
            stat_old = _max0(torch.abs(rvec - (_rmatvec(J, y) if m else 0.0) - zl - zu))
            stat_new = _max0(torch.abs(rvec - (_rmatvec(J, y_p) if m else 0.0)
                                       - zl_p - zu_p))
            # accept within 100x of the solver's exit error: the purified
            # duals are then BQPD-like at no meaningful loss
            better = stat_new <= torch.maximum(stat_old, 100.0 * err + tol)
            if m:
                y = _where(better, y_p, y)
            zl = _where(better, zl_p, zl)
            zu = _where(better, zu_p, zu)

        primal_res = _max0(torch.abs(_matvec(J, d) - s)) if m else torch.zeros_like(err)
        # iteration cap without tight convergence: accept at a loose
        # tolerance; INFEASIBLE only with a certificate-like signature
        # (stalled primal residual AND diverging duals), else ERROR
        status = torch.where((status == QP_RUNNING) & (err <= 1e-6), QP_OPTIMAL, status)
        ynorm = _max0(torch.abs(y)) if m else torch.zeros_like(err)
        if m:
            lo_set = has_rl | is_eq
            hi_set = has_ru | is_eq
            bscale = 1.0 + _max0(
                torch.where(lo_set, torch.abs(torch.where(lo_set, rl, 0.0)), 0.0)
                + torch.where(hi_set, torch.abs(torch.where(hi_set, ru, 0.0)), 0.0))
        else:
            bscale = torch.ones_like(err)
        status = torch.where(status == QP_RUNNING,
                             torch.where((min_pres > 1e-3 * bscale)
                                         | ((primal_res > 1e-6) & (ynorm > 1e4)),
                                         QP_INFEASIBLE, QP_ERROR),
                             status)
        # an ERROR exit while primal feasibility was never approached is the
        # infeasibility signature of an interior-point method; at least 5
        # iterations keep an early breakdown an ERROR
        status = torch.where((status == QP_ERROR) & (min_pres > 1e-3 * bscale)
                             & (it >= 5), QP_INFEASIBLE, status)
        counts["solves"] += 1
        counts["instances"] += B
        counts["iterations"] += int(torch.sum(it))
        objective = torch.sum(g * d, dim=-1) + 0.5 * torch.sum(d * _matvec(H, d), dim=-1)
        return QPResult(d=d, y=y, zl=zl, zu=zu, status=status,
                        objective=objective, iterations=it, kkt_error=err)

    return solve


def qp_structure_from_bounds(rl, ru, dl, du) -> QPStructure:
    """The static structure from representative bound arrays (the
    finiteness pattern must be the same across solves of the family)."""
    rl, ru = np.asarray(rl), np.asarray(ru)
    dl, du = np.asarray(dl), np.asarray(du)
    return QPStructure(
        n=dl.shape[0], m=rl.shape[0],
        has_dl=np.isfinite(dl) & (dl > -1e20),
        has_du=np.isfinite(du) & (du < 1e20),
        is_eq=(rl == ru) & np.isfinite(rl),
        has_rl=np.isfinite(rl) & (rl > -1e20),
        has_ru=np.isfinite(ru) & (ru < 1e20),
    )
