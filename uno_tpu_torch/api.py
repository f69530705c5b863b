"""Top-level solve API (the reference's Uno::solve, Uno.cpp:44-98);
counterpart of uno_tpu/api.py.  Routes the interior-point method (the
ipopt preset, any strategy and Hessian model) to solvers/ipm.py; the SQP
family as uno_tpu does: the trust region with feasibility restoration
(filtersqp, funnelsqp, filterslp) to the fused trust-region driver, byrd
(line search, l1 relaxation, l1 merit) to the fused line-search driver,
and every other mechanism / relaxation / strategy mix, or any preset with
sqp_driver="host", to the host driver (solvers/sqp.py).
With auto_permute, a model without declared structure is probed and, when
RCM finds a band, solved permuted on the banded backend, its x, zl and zu
mapped back; under kkt_formulation="auto" an IPM solve of a structured
model that ends in an algorithmic error is retried with the augmented
formulation, as uno_tpu does, and the Result records it (retried_after)."""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from uno_tpu_torch.model import transforms
from uno_tpu_torch.model.nlp import NLP
from uno_tpu_torch.options import Options, preset as _preset
from uno_tpu_torch.solvers.batch import resolve_device
from uno_tpu_torch.solvers.ipm import Result, solve_ipm

def is_byrd_family(options: Options) -> bool:
    """True iff this configuration routes to the fused byrd driver (LS +
    l1 relaxation + l1 merit); solve() and solve_batch() route alike."""
    return (options.globalization_mechanism == "LS"
            and options.constraint_relaxation_strategy == "l1_relaxation"
            and options.globalization_strategy == "l1_merit")


def _preflight(nlp: NLP):
    """Initial-iterate screening (reference Uno.cpp:91-94): an empty bound
    box certifies infeasibility, and non-finite f/c both at the projected x0
    and at an interior push is an evaluation error.  Returns a Result to
    stop with, or None to proceed."""
    t0 = time.perf_counter()
    x_lb, x_ub = np.asarray(nlp.x_lb), np.asarray(nlp.x_ub)
    c_lb, c_ub = np.asarray(nlp.c_lb), np.asarray(nlp.c_ub)
    params = None if nlp.params is None else \
        torch.as_tensor(np.asarray(nlp.params), dtype=torch.float64)

    def result(status, x, f, c):
        viol = 0.0
        if nlp.m:
            c = np.asarray(c, dtype=np.float64)
            cv = np.where(np.isfinite(c),
                          np.maximum(np.maximum(c_lb - c, c - c_ub), 0.0), 0.0)
            viol = float(np.max(cv, initial=0.0))
        viol = max(viol, float(np.max(x_lb - x_ub, initial=0.0)),
                   float(np.max(c_lb - c_ub, initial=0.0)))
        return Result(
            status=status, x=np.asarray(x, dtype=np.float64),
            y=np.zeros(nlp.m), zl=np.zeros(nlp.n), zu=np.zeros(nlp.n),
            objective=float(f), iterations=0,
            primal_feasibility=viol, stationarity=np.inf,
            complementarity=0.0, cpu_time=time.perf_counter() - t0,
            num_subproblems_solved=0, num_factorizations=0,
            num_objective_evaluations=1, num_constraint_evaluations=1)

    def evaluate(x):
        xt = torch.as_tensor(x, dtype=torch.float64)
        f = float(nlp.f(xt, params))
        c = (nlp.c(xt, params).detach().numpy().astype(np.float64)
             if nlp.m else np.zeros(0))
        return f, c

    def evaluate_or_nan(x):
        # a user function that raises at x counts as an evaluation error
        try:
            return evaluate(x)
        except (ArithmeticError, ValueError, RuntimeError):
            return np.nan, np.full(nlp.m, np.nan)

    # 1. empty feasible box: some l > u
    if (x_lb > x_ub).any() or (c_lb > c_ub).any():
        x = np.clip(nlp.x0, np.minimum(x_lb, x_ub), np.maximum(x_lb, x_ub))
        f, c = evaluate_or_nan(x)
        return result("infeasible_stationary_point", x, f, c)

    # 2. evaluation error at the projected x0 AND at an interior push
    x_proj = np.clip(np.asarray(nlp.x0, dtype=np.float64), x_lb, x_ub)
    f, c = evaluate_or_nan(x_proj)
    if not (np.isfinite(f) and np.all(np.isfinite(c))):
        with np.errstate(invalid="ignore"):
            width = x_ub - x_lb
            pl = 1e-2 * np.maximum(1.0, np.abs(np.where(np.isfinite(x_lb), x_lb, 0.0)))
            pu = 1e-2 * np.maximum(1.0, np.abs(np.where(np.isfinite(x_ub), x_ub, 0.0)))
            cap = np.where(np.isfinite(width), 1e-2 * np.maximum(width, 0.0), np.inf)
            lo = np.where(np.isfinite(x_lb), x_lb + np.minimum(pl, cap), -np.inf)
            hi = np.where(np.isfinite(x_ub), x_ub - np.minimum(pu, cap), np.inf)
        f2, c2 = evaluate_or_nan(np.clip(x_proj, lo, hi))
        if not (np.isfinite(f2) and np.all(np.isfinite(c2))):
            return result("evaluation_error", x_proj, f, c)
    return None


def solve(nlp: NLP, options: Optional[Options] = None, preset: Optional[str] = None,
          callbacks=None, history=False, device="cuda", group=None,
          **overrides) -> Result:
    """Solve one NLP on `device` (default "cuda"; raises when there is no
    card).  Either pass `options`, or a `preset` name ("ipopt",
    "filtersqp", "byrd", "funnelsqp", "filterslp") with keyword
    overrides.  `group` (parallel/group.make_group) is the process group of
    the interior-point method's ldlt_backend="distributed"; the solve then
    runs on the group's device."""
    if options is None:
        options = _preset(preset or "ipopt", **overrides)
    elif overrides:
        options = options.replace(**overrides)
    device = resolve_device(device if group is None else group.device)
    if group is not None and options.inequality_handling_method != "primal_dual_interior_point":
        raise ValueError("a process group serves the interior-point method's "
                         "ldlt_backend='distributed'")
    if options.inequality_handling_method == "primal_dual_interior_point":
        if options.globalization_mechanism == "TR":
            # reference: PrimalDualInteriorPointMethod.cpp:117-119
            raise NotImplementedError(
                "The interior-point subproblem does not support a trust "
                "region; use globalization_mechanism='LS'")
        run = functools.partial(_solve_ipm_with_retry, group=group)
    else:
        byrd = is_byrd_family(options)
        fused = options.sqp_driver == "fused" or (
            options.sqp_driver == "auto"
            and (byrd or (options.globalization_mechanism == "TR"
                          and options.constraint_relaxation_strategy
                          == "feasibility_restoration")))
        if fused:
            from uno_tpu_torch.solvers import sqp_fused
            run = sqp_fused.solve_byrd_fused if byrd else sqp_fused.solve_sqp_fused
        else:
            from uno_tpu_torch.solvers import sqp
            run = sqp.solve_sqp
    early = _preflight(nlp)
    if early is not None:
        return early
    if options.auto_permute and nlp.structure is None:
        permuted, perm = transforms.detect_structure(nlp)
        if perm is not None:
            res = solve(permuted, options=options.replace(auto_permute=False),
                        callbacks=callbacks, history=history, device=device,
                        group=group)
            pos = np.empty(nlp.n, dtype=np.int64)
            pos[perm] = np.arange(nlp.n)
            return dataclasses.replace(res, x=np.asarray(res.x)[pos],
                                       zl=np.asarray(res.zl)[pos],
                                       zu=np.asarray(res.zu)[pos])
    return run(nlp, options, device, callbacks=callbacks, history=history)


def _solve_ipm_with_retry(nlp: NLP, options: Options, device, callbacks=None,
                          history=False, group=None) -> Result:
    """solve_ipm, and under kkt_formulation="auto" on a structured model
    that ends in algorithmic_error, solve_ipm again with the augmented
    formulation (uno_tpu/api.py:148-169): the condensed formulations square
    the KKT conditioning, and under heavy inertia correction (the catena
    family at its flat start) the augmented LDL^T is the robust one.  The
    retry's result is returned, with retried_after set, unless it ends in
    algorithmic_error too."""
    res = solve_ipm(nlp, options, device, callbacks=callbacks, history=history,
                    group=group)
    if (res.status == "algorithmic_error" and options.kkt_formulation == "auto"
            and nlp.structure is not None):
        from uno_tpu_torch.utils import logger
        logger.warning(f"{nlp.name}: the structured KKT solve ended in "
                       f"algorithmic_error after {res.iterations} iterations; "
                       "retrying with kkt_formulation='augmented'")
        res2 = solve_ipm(nlp, options.replace(kkt_formulation="augmented"),
                         device, callbacks=callbacks, history=history,
                         group=group)
        if res2.success or res2.status != "algorithmic_error":
            return dataclasses.replace(res2, retried_after={
                "status": res.status, "iterations": res.iterations})
    return res
