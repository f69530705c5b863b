"""Structured IPM for two-stage scenario NLPs over the Schur-complement KKT.

Counterpart of uno_tpu/solvers/structured.py (BASELINE.md config 5:
"block-arrow structured NLP (multi-scenario stochastic NLP) with
distributed Schur-complement KKT").  Problems of the form

    min  f0(x0) + sum_s fs(x0, x_s, p_s)
    s.t. cs(x0, x_s, p_s) = 0          (m per scenario, equalities)
         lb <= (x0, x_s) <= ub

whose barrier KKT system is block-arrow: one (ns+m) x (ns+m) saddle block
per scenario, coupled through the n0 first-stage variables, which
parallel/schur.py factors.  The algorithm is uno_tpu's, constant for
constant: a monotone Fiacco-McCormick barrier, primal-dual Newton steps
through the Schur KKT with a Haynsworth-inertia delta correction (at most
12 tries), fraction-to-boundary steps, residual-based backtracking (at most
5 halvings, the last trial kept), and a two-phase feasibility restoration
that minimizes sum_s 0.5 ||c_s||^2 under the same barrier with the same
block-arrow structure (the (rho, sigma) objective weights; reference
FeasibilityRestoration.cpp:78-143).  Restoration that converges while still
infeasible returns status "infeasible".

uno_tpu runs one `lax.while_loop`; here the outer iteration, the inertia
correction and the backtracking are host loops, as in solvers/ipm.run_ipm,
and the scalar state (mu, delta, the error, the phase) lives on the host.
The per-scenario derivative bundles are torch.func.vmap over grad, jacfwd
and hessian in float64, the scenario parameters a dict of arrays with the
scenario axis first.

With a process group (parallel/group.py) each rank holds a contiguous run
of the scenarios: its derivatives, its blocks of the Schur KKT and its part
of every sum over scenarios, which are all-reduced, as are the scenario
minima (step lengths) and maxima (errors); x0 and the scalars are the same
on every rank, and the result gathers xs and y in rank order.  This is the
counterpart of uno_tpu running the solver on inputs sharded over the
scenario axis.  Without a group it is uno_tpu's single-program solver.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from uno_tpu_torch.ingredients import barrier as bar
from uno_tpu_torch.options import Options
from uno_tpu_torch.parallel.schur import schur_factor, schur_solve
from uno_tpu_torch.solvers.batch import resolve_device

LARGE = 1e25
MAX_REGULARIZATIONS = 12     # inertia-correction tries a step
MAX_HALVINGS = 5             # backtracking halvings after the full step


@dataclass(frozen=True)
class ScenarioNLP:
    """Two-stage stochastic NLP: f0(x0) -> scalar, fs(x0, xs, p) -> scalar
    and cs(x0, xs, p) -> (m,) are torch functions of one scenario; `params`
    is a dict of arrays whose first axis is the scenario (S, ...)."""
    name: str
    n0: int                  # first-stage variables
    ns: int                  # second-stage variables per scenario
    m: int                   # equality constraints per scenario
    S: int                   # number of scenarios
    f0: Callable
    fs: Callable
    cs: Callable
    x0_lb: np.ndarray
    x0_ub: np.ndarray
    xs_lb: np.ndarray        # (ns,), shared across scenarios
    xs_ub: np.ndarray
    x0_init: np.ndarray
    xs_init: np.ndarray      # (S, ns)
    params: Any              # dict of (S, ...) arrays

    def _params(self, like):
        return {k: torch.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device)
                for k, v in self.params.items()}

    def objective(self, x0, xs):
        per = vmap(lambda x, p: self.fs(x0, x, p))(xs, self._params(xs))
        return self.f0(x0) + torch.sum(per)

    def constraints(self, x0, xs):
        return vmap(lambda x, p: self.cs(x0, x, p))(xs, self._params(xs))  # (S, m)


class StructuredResult(NamedTuple):
    status: str
    x0: np.ndarray
    xs: np.ndarray
    y: np.ndarray
    objective: float
    iterations: int
    kkt_error: float
    cpu_time: float


def _amax(v) -> torch.Tensor:
    """max |v| over every entry, 0 for an empty v (jnp.max(initial=0))."""
    return torch.amax(torch.abs(v)) if v.numel() else v.new_zeros(())


def solve_structured_ipm(snlp: ScenarioNLP, opts: Optional[Options] = None,
                         tol: float = 1e-8, max_iterations: int = 200,
                         device="cuda", group=None) -> StructuredResult:
    """The structured barrier solver on `device` (default the card), or on
    the group's devices with the scenarios split over its ranks."""
    opts = opts or Options()
    t_start = time.monotonic()
    dev = resolve_device(device) if group is None else group.device
    n0, ns, m, S = snlp.n0, snlp.ns, snlp.m, snlp.S
    lo, hi = (0, S) if group is None else group.local_range(S)
    f64 = torch.float64

    def tensor(a, dtype=f64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def finite_or(b, big):
        return tensor(np.where(np.isfinite(b), b, big))

    lb0, ub0 = finite_or(snlp.x0_lb, -LARGE), finite_or(snlp.x0_ub, LARGE)
    lbs, ubs = finite_or(snlp.xs_lb, -LARGE), finite_or(snlp.xs_ub, LARGE)
    h0l, h0u = (tensor(np.isfinite(b), torch.bool) for b in (snlp.x0_lb, snlp.x0_ub))
    hsl, hsu = (tensor(np.isfinite(b), torch.bool) for b in (snlp.xs_lb, snlp.xs_ub))
    params = {k: tensor(v)[lo:hi] for k, v in snlp.params.items()}
    eye_ns, eye_m, eye_n0 = (torch.eye(k, dtype=f64, device=dev) for k in (ns, m, n0))

    def reduce(t, op):
        return t if group is None else group.all_reduce(t, op)

    def lag_s(x0, xs, y, p, rho, sigma):
        # phase-weighted scenario Lagrangian (L = f - y^T c); sigma * c.c with
        # one factor held constant gives J^T c in the gradient and
        # sum_j c_j hess(c_j) in the Hessian: the Gauss-Newton J^T J part
        # comes from the -sigma I elastic block
        c = snlp.cs(x0, xs, p)
        return rho * (snlp.fs(x0, xs, p) - torch.dot(y, c)) \
            + sigma * torch.dot(c.detach(), c)

    def scenario_derivs(x0, xs, y, p, rho, sigma):
        g_xs = grad(lag_s, argnums=1)(x0, xs, y, p, rho, sigma)
        g_x0 = grad(lag_s, argnums=0)(x0, xs, y, p, rho, sigma)
        c = snlp.cs(x0, xs, p)
        J_s = jacfwd(snlp.cs, argnums=1)(x0, xs, p)              # (m, ns)
        J_0 = jacfwd(snlp.cs, argnums=0)(x0, xs, p)              # (m, n0)
        H_ss = hessian(lag_s, argnums=1)(x0, xs, y, p, rho, sigma)
        H_s0 = jacfwd(grad(lag_s, argnums=1), argnums=0)(x0, xs, y, p, rho, sigma)
        H_00 = hessian(lambda z: lag_s(z, xs, y, p, rho, sigma))(x0)
        return g_xs, g_x0, c, J_s, J_0, H_ss, H_s0, H_00

    def scenario_grads(x0, xs, y, p, rho, sigma):
        g_xs = grad(lag_s, argnums=1)(x0, xs, y, p, rho, sigma)
        g_x0 = grad(lag_s, argnums=0)(x0, xs, y, p, rho, sigma)
        return g_xs, g_x0, snlp.cs(x0, xs, p)

    def over_scenarios(fn, x0, xs, y, rho, sigma):
        return vmap(lambda xsi, yi, pi: fn(x0, xsi, yi, pi, rho, sigma))(xs, y, params)

    def step(st):
        x0, xs, y, z0l, z0u, zsl, zsu = st["iterate"]
        mu, delta, err, phase = st["mu"], st["delta"], st["err"], st["phase"]
        rho, sigma = 1.0 - phase, phase
        # barrier quantities
        Sig0 = bar.barrier_hessian_diag(x0, z0l, z0u, lb0, ub0, h0l, h0u)
        gbar0 = bar.barrier_gradient(x0, lb0, ub0, h0l, h0u, mu, 0.0)
        Sigs = bar.barrier_hessian_diag(xs, zsl, zsu, lbs, ubs, hsl, hsu)
        gbars = bar.barrier_gradient(xs, lbs, ubs, hsl, hsu, mu, 0.0)
        g_xs, g_x0, c, J_s, J_0, H_ss, H_s0, H_00 = over_scenarios(
            scenario_derivs, x0, xs, y, rho, sigma)
        gf0 = grad(snlp.f0)(x0)
        # the rhs gradients exclude sigma J^T c: the -sigma I elastic block
        # regenerates it in the condensed system
        g_xs_rhs = g_xs - sigma * torch.einsum("smn,sm->sn", J_s, c)
        g_x0_rhs = g_x0 - sigma * torch.einsum("smn,sm->sn", J_0, c)
        # the sums over scenarios, and the infeasibility at x
        sums = reduce(torch.cat([torch.sum(H_00, dim=0).reshape(-1),
                                 torch.sum(g_x0_rhs, dim=0)]), "sum")
        H00_sum, gx0_sum = sums[:n0 * n0].reshape(n0, n0), sums[n0 * n0:]
        h_cur = float(reduce(_amax(c).reshape(1), "max"))
        K0_base = H00_sum + rho * hessian(snlp.f0)(x0) + torch.diag(Sig0)
        Bs = torch.cat([H_s0, J_0], dim=1)                       # (S, nb, n0)
        # rhs: -(grad Lagrangian + barrier) per block, -c for the duals
        rhs_s = torch.cat([-(g_xs_rhs + gbars), -c], dim=1)      # (S, nb)
        rhs_0 = -(rho * gf0 + gx0_sum + gbar0)
        dual_block = -sigma * eye_m[None] * torch.ones((hi - lo, 1, 1), dtype=f64,
                                                      device=dev)

        def assemble_and_solve(dlt):
            # scenario blocks [[H_ss + Sig + dlt, J_s^T], [J_s, -sigma I]]
            Ks = torch.cat([
                torch.cat([H_ss + torch.diag_embed(Sigs) + dlt * eye_ns[None],
                           J_s.transpose(1, 2)], dim=2),
                torch.cat([J_s, dual_block], dim=2)], dim=1)
            K0 = K0_base + dlt * eye_n0
            fac = schur_factor(Ks, Bs, K0, block=32, group=group)
            dblk, dx0 = schur_solve(fac, Bs, rhs_s, rhs_0, group)
            good = bool((fac.num_pos == n0 + S * ns) & (fac.num_neg == S * m)
                        & (fac.num_zero == 0))
            return dx0, dblk, good

        # Haynsworth-inertia delta correction
        dlt, reg_ok, tries = max(delta / 3.0, 0.0), False, 0
        dx0, dblk = x0.new_zeros(n0), x0.new_zeros((hi - lo, ns + m))
        while not reg_ok and tries < MAX_REGULARIZATIONS:
            dx0, dblk, reg_ok = assemble_and_solve(dlt)
            dlt = dlt if reg_ok else max(dlt * 10.0, 1e-6)
            tries += 1

        dxs = dblk[:, :ns]
        # the restoration phase freezes the equality multipliers
        dy = -rho * dblk[:, ns:]
        dz0l, dz0u = bar.bound_dual_direction(x0, dx0, z0l, z0u, lb0, ub0, h0l, h0u, mu)
        dzsl, dzsu = bar.bound_dual_direction(xs, dxs, zsl, zsu, lbs, ubs, hsl, hsu, mu)

        tau = max(0.99, 1.0 - mu)
        mins = reduce(torch.stack([
            torch.amin(bar.primal_fraction_to_boundary(xs, dxs, lbs, ubs, hsl, hsu, tau)),
            torch.amin(bar.dual_fraction_to_boundary(zsl, zsu, dzsl, dzsu, hsl, hsu, tau))]),
            "min")
        a_p = torch.minimum(bar.primal_fraction_to_boundary(
            x0, dx0, lb0, ub0, h0l, h0u, tau), mins[0])
        a_z = torch.minimum(bar.dual_fraction_to_boundary(
            z0l, z0u, dz0l, dz0u, h0l, h0u, tau), mins[1])

        def trial_error(alpha):
            """The phase's KKT error at the trial point: the optimality phase
            measures the true problem (stationarity, feasibility,
            complementarity); restoration the stationarity of
            min 0.5 ||c||^2 + barrier, without feasibility."""
            x0_t = torch.clamp(x0 + alpha * a_p * dx0, lb0, ub0)
            xs_t = torch.clamp(xs + alpha * a_p * dxs, lbs, ubs)
            y_t = y + alpha * a_p * dy
            z0l_t, z0u_t = z0l + alpha * a_z * dz0l, z0u + alpha * a_z * dz0u
            zsl_t, zsu_t = zsl + alpha * a_z * dzsl, zsu + alpha * a_z * dzsu
            g_xs2, g_x02, c2 = over_scenarios(scenario_grads, x0_t, xs_t, y_t,
                                              rho, sigma)
            stat_s = g_xs2 - zsl_t - zsu_t
            stat_0 = rho * grad(snlp.f0)(x0_t) + reduce(torch.sum(g_x02, dim=0), "sum") \
                - z0l_t - z0u_t
            compl0 = bar.bound_complementarity_error(x0_t, z0l_t, z0u_t, lb0, ub0, h0l, h0u)
            compls = bar.bound_complementarity_error(xs_t, zsl_t, zsu_t, lbs, ubs, hsl, hsu)
            maxes = reduce(torch.stack([_amax(stat_s), _amax(c2), _amax(compls)]), "max")
            h_t = maxes[1]
            e = torch.amax(torch.stack([maxes[0], _amax(stat_0), rho * h_t,
                                        _amax(compl0), maxes[2]]))
            return float(e), float(h_t), (x0_t, xs_t, y_t, z0l_t, z0u_t, zsl_t, zsu_t)

        # residual-based backtracking: accept a step whose phase error does
        # not blow past the current one; halve at most MAX_HALVINGS times
        # and keep the last trial as the safeguard step
        limit = 10.0 * max(err, 10.0 * mu) + 10.0 * mu
        err_n, h_n, trial = trial_error(1.0)
        ls_ok, alpha, halvings = err_n <= limit, 0.5, 0
        while not ls_ok and halvings < MAX_HALVINGS:
            err_n, h_n, trial = trial_error(alpha)
            ls_ok = err_n <= limit
            alpha = alpha if ls_ok else alpha * 0.5
            halvings += 1

        # phase transitions (the functional FeasibilityRestoration)
        enter_feas = phase == 0.0 and (not reg_ok or not ls_ok) and h_cur > tol
        exit_feas = phase == 1.0 and h_n <= max(10.0 * tol, 0.1 * st["h_switch"])
        infeasible = phase == 1.0 and err_n <= max(tol, 1e-8) and h_n > 100.0 * tol
        phase_n = 1.0 if enter_feas else (0.0 if exit_feas else phase)
        if enter_feas:
            # discard the failed trial, keep x, raise mu to the infeasibility
            st["h_switch"] = h_cur
            mu_after = min(max(max(mu, h_cur), mu), 10.0)
        else:
            st["iterate"] = trial
            mu_after = mu
        if enter_feas or exit_feas:
            err_n = float("inf")
        if not enter_feas and err_n <= 10.0 * mu_after:
            mu_after = max(tol / 10.0, min(0.2 * mu_after, mu_after ** 1.5))
        st.update(mu=mu_after, delta=dlt, it=st["it"] + 1, err=err_n, phase=phase_n,
                  infeasible=infeasible,
                  done=(phase_n == 0.0 and err_n <= tol) or infeasible)

    # initial point
    k1 = opts.barrier_push_variable_to_interior_k1
    k2 = opts.barrier_push_variable_to_interior_k2
    x0_0 = bar.push_to_interior(tensor(snlp.x0_init), lb0, ub0, k1, k2)
    xs_0 = bar.push_to_interior(tensor(snlp.xs_init)[lo:hi], lbs, ubs, k1, k2)
    Sl = hi - lo
    st = {"iterate": (x0_0, xs_0, x0_0.new_zeros((Sl, m)),
                      torch.where(h0l, 1.0, 0.0).to(f64), torch.where(h0u, -1.0, 0.0).to(f64),
                      torch.where(hsl, 1.0, 0.0).to(f64).expand(Sl, ns).clone(),
                      torch.where(hsu, -1.0, 0.0).to(f64).expand(Sl, ns).clone()),
          "mu": 0.1, "delta": 0.0, "it": 0, "err": float("inf"), "phase": 0.0,
          "h_switch": 0.0, "infeasible": False, "done": False}
    while not st["done"] and st["it"] < max_iterations:
        step(st)

    x0_f, xs_f, y_f = st["iterate"][:3]
    per = vmap(lambda x, p: snlp.fs(x0_f, x, p))(xs_f, params)
    objective = float(snlp.f0(x0_f) + reduce(torch.sum(per).reshape(1), "sum")[0])
    if group is not None:
        xs_f, y_f = group.all_gather(xs_f), group.all_gather(y_f)
    err = st["err"]
    if st["infeasible"]:
        status = "infeasible"
    elif err <= tol:
        status = "optimal"
    else:
        status = "iteration_limit"
    return StructuredResult(
        status=status, x0=x0_f.cpu().numpy(), xs=xs_f.cpu().numpy(),
        y=y_f.cpu().numpy(), objective=objective, iterations=st["it"],
        kkt_error=err, cpu_time=time.monotonic() - t_start)
