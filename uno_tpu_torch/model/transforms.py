"""Model reformulations as NLP -> NLP transforms.

Counterpart of uno_tpu/model/transforms.py (reference
ModelFactory.cpp:12-24):
  fixed_bounds_to_constraints  <-  FixedBoundsConstraintsModel.cpp:8-49
  homogenize                   <-  HomogeneousEqualityConstrainedModel.cpp:17-105
  relax_bounds                 <-  BoundRelaxedModel.cpp:16-24
  scale_model                  <-  ScaledModel.cpp:10-35 + preprocessing/Scaling.cpp

Each transform returns a new NLP whose per-instance callables close over
the original ones; torch.func differentiates through the composition.  A
declared NLPStructure is carried through (fixed-variable rows and the slack
columns rebuild it), and `detect_structure` finds one by RCM when the model
declares none.  The numpy of the structure code is uno_tpu's, to the random
draws and RCM's tie-breaking: the permutation decides the variable order and
so the iterates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uno_tpu_torch.model.nlp import INF, NLP, NLPStructure, const


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
    st = nlp.structure
    if st is not None:
        # the new rows x_idx = val touch one column each; the starts are
        # clamped to [0, max(n-w, 0)] so a window wider than a tiny model
        # stays in range
        old_starts = st.jac_starts if st.jac_starts is not None \
            else np.zeros(0, dtype=np.int64)
        w = max(st.jac_width, 1)
        starts = np.concatenate([old_starts, idx]).astype(np.int64)
        st = NLPStructure(hess_bandwidth=st.hess_bandwidth,
                          jac_starts=np.clip(starts, 0, max(nlp.n - w, 0)),
                          jac_width=w, jac_col_limit=st.jac_col_limit)
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
        structure=st,
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
    st = nlp.structure
    if st is not None:
        # the windows cover the original columns only: the slack columns
        # are analytic
        st = NLPStructure(hess_bandwidth=st.hess_bandwidth,
                          jac_starts=st.jac_starts, jac_width=st.jac_width,
                          jac_col_limit=nlp.n if st.jac_col_limit is None
                          else st.jac_col_limit)
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
        structure=st,
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
        structure=nlp.structure,
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
        structure=nlp.structure,
    )


def permute_variables(nlp: NLP, perm) -> NLP:
    """Reorder the variables: new_x[i] = old_x[perm[i]].  Objective values
    are invariant; a solve of the result gives x in the permuted order.  The
    structure is dropped: a declaration is in the old coordinates, so the
    caller declares one for the new order."""
    perm = np.asarray(perm, dtype=np.int64)
    assert perm.shape == (nlp.n,)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(nlp.n)
    f0, c0 = nlp.f, nlp.c
    cache: dict = {}

    def f_new(x, p):
        return f0(x[const(cache, inv, x, torch.int64)], p)

    def c_new(x, p):
        return c0(x[const(cache, inv, x, torch.int64)], p)

    return NLP(
        name=nlp.name + "->permuted",
        n=nlp.n, m=nlp.m, f=f_new, c=c_new,
        x_lb=nlp.x_lb[perm], x_ub=nlp.x_ub[perm],
        c_lb=nlp.c_lb, c_ub=nlp.c_ub,
        x0=nlp.x0[perm], y0=nlp.y0, params=nlp.params,
        n_orig=nlp.num_original_variables,
        slack_of_constraint=nlp.slack_of_constraint,
        f_scale=nlp.f_scale, c_scale=nlp.c_scale,
        structure=None,
    )


def reformulate_for_interior_point(nlp: NLP, tolerance: float) -> NLP:
    """The reference's IPM chain (ModelFactory.cpp:12-24):
    fixed bounds -> slacks/homogenize -> bound relax."""
    out = fixed_bounds_to_constraints(nlp)
    out = homogenize(out)
    out = relax_bounds(out, tolerance)
    return out


# ---------------------------------------------------------------------------
# structure detection: probe the sparsity, reduce the bandwidth with RCM
# ---------------------------------------------------------------------------

def rcm_order(n, edges_i, edges_j):
    """Reverse Cuthill-McKee ordering of the undirected graph on n nodes:
    perm with new_x[k] = old_x[perm[k]] (permute_variables' convention).
    BFS from the lowest-degree node of each component, neighbours by
    ascending degree (stable, as uno_tpu's)."""
    adj = [[] for _ in range(n)]
    for a, b in zip(edges_i, edges_j):
        a, b = int(a), int(b)
        if a != b:
            adj[a].append(b)
            adj[b].append(a)
    deg = np.array([len(set(a)) for a in adj])
    adj = [sorted(set(a), key=lambda v: deg[v]) for a in adj]
    visited = np.zeros(n, dtype=bool)
    order = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        queue = [int(start)]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            for w in adj[v]:
                if not visited[w]:
                    visited[w] = True
                    queue.append(w)
    return np.asarray(order[::-1], dtype=np.int64)


def detect_structure(nlp: NLP, max_n: int = 1536, samples: int = 2,
                     seed: int = 0):
    """Probe the Lagrangian-Hessian and Jacobian sparsity at `samples`
    random points (x0 + 0.37 N(0, 1), multipliers N(0, 1), from
    default_rng(seed)), order the variables by RCM and, when the permuted
    pattern is banded with windowed rows, return (the permuted NLP with its
    NLPStructure, perm); else (nlp, None).  Declines models that declare a
    structure, n > max_n or n < 8, a bandwidth above n/4 after RCM, and rows
    wider than max(2*bandwidth + 2, n/4).  The probes run on the CPU in
    float64."""
    if nlp.structure is not None or nlp.n > max_n or nlp.n < 8:
        return nlp, None
    rng = np.random.default_rng(seed)
    x0 = np.asarray(nlp.x0, dtype=np.float64)
    params = None if nlp.params is None else \
        torch.as_tensor(np.asarray(nlp.params), dtype=torch.float64)[None]
    one = torch.ones(1, dtype=torch.float64)
    hpat = np.zeros((nlp.n, nlp.n), dtype=bool)
    jpat = np.zeros((nlp.m, nlp.n), dtype=bool) if nlp.m else None
    for _ in range(samples):
        x = torch.as_tensor(x0 + 0.37 * rng.standard_normal(nlp.n))[None]
        y = torch.as_tensor(rng.standard_normal(nlp.m))[None] if nlp.m \
            else torch.zeros((1, 0), dtype=torch.float64)
        H = nlp.lagrangian_hessian(x, y, one, params)[0].numpy()
        hpat |= (H != 0.0) & np.isfinite(H)
        if nlp.m:
            J = nlp.constraint_jacobian(x, params)[0].numpy()
            jpat |= (J != 0.0) & np.isfinite(J)
    hpat |= hpat.T
    # the graph: Hessian edges and, per constraint row, a chain through its
    # support plus an edge first-to-last, so a row's columns land together
    ei, ej = np.nonzero(np.triu(hpat, 1))
    edges_i = [ei]
    edges_j = [ej]
    if nlp.m:
        for r in range(nlp.m):
            sup = np.nonzero(jpat[r])[0]
            if sup.size > 1:
                edges_i.append(sup[:-1])
                edges_j.append(sup[1:])
                edges_i.append(sup[:1])
                edges_j.append(sup[-1:])
    perm = rcm_order(nlp.n, np.concatenate(edges_i), np.concatenate(edges_j))
    pos = np.empty(nlp.n, dtype=np.int64)
    pos[perm] = np.arange(nlp.n)
    bandwidth = int(np.max(np.abs(pos[ei] - pos[ej]))) if ei.size else 0
    if bandwidth > nlp.n // 4:
        return nlp, None
    jac_starts = None
    jac_width = 0
    if nlp.m:
        starts = np.zeros(nlp.m, dtype=np.int64)
        width = 1
        for r in range(nlp.m):
            sup = pos[np.nonzero(jpat[r])[0]]
            if sup.size == 0:
                starts[r] = 0
                continue
            starts[r] = int(sup.min())
            width = max(width, int(sup.max() - sup.min() + 1))
        if width > max(2 * bandwidth + 2, nlp.n // 4):
            return nlp, None
        jac_width = width
        jac_starts = np.clip(starts, 0, max(nlp.n - jac_width, 0))
    out = permute_variables(nlp, perm)
    out = dataclasses.replace(out, structure=NLPStructure(
        hess_bandwidth=bandwidth, jac_starts=jac_starts,
        jac_width=jac_width, jac_col_limit=None))
    return out, perm
