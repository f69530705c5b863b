"""Model reformulations as NLP -> NLP transforms.

Counterpart of uno_tpu/model/transforms.py (reference
ModelFactory.cpp:12-24):
  fixed_bounds_to_constraints  <-  FixedBoundsConstraintsModel.cpp:8-49
  homogenize                   <-  HomogeneousEqualityConstrainedModel.cpp:17-105
  relax_bounds                 <-  BoundRelaxedModel.cpp:16-24
  scale_model                  <-  ScaledModel.cpp:10-35 + preprocessing/Scaling.cpp

Each transform returns a new NLP whose per-instance callables close over
the original ones; torch.func differentiates through the composition.
"""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.model.nlp import INF, NLP, const


def fixed_bounds_to_constraints(nlp: NLP) -> NLP:
    """Move fixed variables (lb == ub) into general equality constraints."""
    fixed = nlp.fixed_variables
    idx = np.nonzero(fixed)[0]
    if idx.size == 0:
        return nlp
    f0, c0, m0 = nlp.f, nlp.c, nlp.m
    idx_list = idx.tolist()

    def c_new(x, p):
        base = c0(x, p) if m0 > 0 else x.new_zeros((0,))
        return torch.cat([base, x[idx_list]])

    x_lb = nlp.x_lb.copy()
    x_ub = nlp.x_ub.copy()
    vals = x_lb[idx].copy()
    x_lb[idx] = -INF
    x_ub[idx] = INF
    return NLP(
        name=nlp.name + "->no_fixed_bounds",
        n=nlp.n, m=m0 + idx.size, f=f0, c=c_new,
        x_lb=x_lb, x_ub=x_ub,
        c_lb=np.concatenate([nlp.c_lb, vals]),
        c_ub=np.concatenate([nlp.c_ub, vals]),
        x0=nlp.x0,
        y0=np.concatenate([nlp.y0 if nlp.y0 is not None else np.zeros(m0),
                           np.zeros(idx.size)]),
        params=nlp.params, n_orig=nlp.num_original_variables,
        f_scale=nlp.f_scale,
        c_scale=None if nlp.c_scale is None
        else np.concatenate([nlp.c_scale, np.ones(idx.size)]),
    )


def homogenize(nlp: NLP) -> NLP:
    """Equality-constrained reformulation: every inequality constraint gets a
    slack (c_i(x) - s_i = 0, s_i in [c_lb, c_ub]); equalities are shifted to 0.
    Slacks do not enter the objective, hence not the Hessian."""
    is_eq = nlp.is_equality
    ineq_idx = np.nonzero(~is_eq)[0]
    n_slacks = ineq_idx.size
    n_new = nlp.n + n_slacks
    f0, c0, m, n0 = nlp.f, nlp.c, nlp.m, nlp.n

    # rhs shift: equalities move to 0; inequalities use slack
    shift = np.where(is_eq, np.where(np.isfinite(nlp.c_lb), nlp.c_lb, 0.0), 0.0)
    ineq_list = ineq_idx.tolist()
    shift_cache: dict = {}
    idx_cache: dict = {}

    def f_new(z, p):
        return f0(z[:n0], p)

    def c_new(z, p):
        x, s = z[:n0], z[n0:]
        cx = c0(x, p) - const(shift_cache, shift, z)
        if n_slacks > 0:
            cx = cx.index_add(0, const(idx_cache, ineq_idx, z, torch.int64), -s)
        return cx

    slack_lb = nlp.c_lb[ineq_idx]
    slack_ub = nlp.c_ub[ineq_idx]
    slack_of_constraint = np.full(m, -1, dtype=np.int64)
    slack_of_constraint[ineq_list] = nlp.n + np.arange(n_slacks)

    # the initial slack value is set by the interior push in
    # solvers/ipm.make_initial_state; start from 0
    x0 = np.concatenate([nlp.x0, np.zeros(n_slacks)])
    return NLP(
        name=nlp.name + "->homogeneous",
        n=n_new, m=m, f=f_new, c=c_new,
        x_lb=np.concatenate([nlp.x_lb, slack_lb]),
        x_ub=np.concatenate([nlp.x_ub, slack_ub]),
        c_lb=np.zeros(m), c_ub=np.zeros(m),
        x0=x0, y0=nlp.y0, params=nlp.params,
        n_orig=nlp.num_original_variables,
        slack_of_constraint=slack_of_constraint,
        f_scale=nlp.f_scale, c_scale=nlp.c_scale,
    )


def relax_bounds(nlp: NLP, factor: float) -> NLP:
    """Relax finite variable bounds by factor*max(1,|bound|) (IPOPT trick)."""
    lb = np.where(nlp.has_x_lb, nlp.x_lb - factor * np.maximum(1.0, np.abs(nlp.x_lb)), nlp.x_lb)
    ub = np.where(nlp.has_x_ub, nlp.x_ub + factor * np.maximum(1.0, np.abs(nlp.x_ub)), nlp.x_ub)
    return NLP(
        name=nlp.name + "->bounds_relaxed",
        n=nlp.n, m=nlp.m, f=nlp.f, c=nlp.c,
        x_lb=lb, x_ub=ub, c_lb=nlp.c_lb, c_ub=nlp.c_ub,
        x0=nlp.x0, y0=nlp.y0, params=nlp.params,
        n_orig=nlp.num_original_variables,
        slack_of_constraint=nlp.slack_of_constraint,
        f_scale=nlp.f_scale, c_scale=nlp.c_scale,
    )


def scale_model(nlp: NLP, threshold: float = 100.0) -> NLP:
    """Gradient-based scaling at x0: s_f = min(1, thr/||grad f||inf),
    s_j = min(1, thr/||grad c_j||inf) (reference preprocessing/Scaling.cpp:16-27),
    with s_f floored at 1e-4 as in uno_tpu (PARITY deviation 11).  Evaluated
    on the CPU in float64 at nlp.x0 with nlp.params."""
    x0 = torch.as_tensor(nlp.x0, dtype=torch.float64)[None]
    p0 = None if nlp.params is None else \
        torch.as_tensor(np.asarray(nlp.params), dtype=torch.float64)[None]
    g = nlp.objective_gradient(x0, p0)[0].numpy()
    gnorm = np.max(np.abs(g)) if g.size else 0.0
    s_f = min(1.0, threshold / gnorm) if gnorm > 0 else 1.0
    s_f = max(s_f, 1e-4)
    if nlp.m > 0:
        J = nlp.constraint_jacobian(x0, p0)[0].numpy()
        jn = np.max(np.abs(J), axis=1)
        s_c = np.where(jn > 0, np.minimum(1.0, threshold / np.maximum(jn, 1e-300)), 1.0)
    else:
        s_c = np.zeros(0)
    f0, c0 = nlp.f, nlp.c
    consts: dict = {}

    def f_new(x, p):
        return s_f * f0(x, p)

    def c_new(x, p):
        return const(consts, s_c, x) * c0(x, p)

    return NLP(
        name=nlp.name + "->scaled",
        n=nlp.n, m=nlp.m, f=f_new, c=c_new,
        x_lb=nlp.x_lb, x_ub=nlp.x_ub,
        c_lb=s_c * nlp.c_lb, c_ub=s_c * nlp.c_ub,
        x0=nlp.x0, y0=nlp.y0, params=nlp.params,
        n_orig=nlp.num_original_variables,
        slack_of_constraint=nlp.slack_of_constraint,
        f_scale=s_f * nlp.f_scale,
        c_scale=s_c if nlp.c_scale is None else s_c * nlp.c_scale,
    )


def reformulate_for_interior_point(nlp: NLP, tolerance: float) -> NLP:
    """The reference's IPM chain (ModelFactory.cpp:12-24):
    fixed bounds -> slacks/homogenize -> bound relax."""
    out = fixed_bounds_to_constraints(nlp)
    out = homogenize(out)
    out = relax_bounds(out, tolerance)
    return out
