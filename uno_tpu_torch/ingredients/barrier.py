"""Primal-dual barrier machinery, batched and mask-based.

Counterpart of uno_tpu/ingredients/barrier.py (reference
PrimalDualInteriorPointProblem.cpp): barrier gradient and Hessian terms with
damping for single-bounded variables, interior push, fraction-to-boundary
rules, bound-dual recovery, the k_sigma multiplier rescale and the
centrality error.

Vectors are (B, n); per-instance scalars (mu, tau) are (B,); bounds and
masks are (n,).  "Infinite" bounds are assumed already replaced by +/-huge,
and masked slots contribute zero.
"""

from __future__ import annotations

import torch

_INF = float("inf")


def _col(v):
    """A per-instance scalar (B,) as a column that broadcasts over (B, n)."""
    return v[..., None] if isinstance(v, torch.Tensor) and v.dim() else v


def _min_last(v):
    """min over the last axis, +inf for an empty one (jnp.min(initial=inf))."""
    if v.shape[-1] == 0:
        return v.new_full(v.shape[:-1], _INF)
    return torch.amin(v, dim=-1)


def push_to_interior(x, lb, ub, k1, k2):
    """x := clip into the strict interior (IPOPT Sect. 3.6):
    perturbation = min(k1*max(1,|bound|), k2*(ub-lb))."""
    rng = ub - lb
    pert_lb = torch.minimum(k1 * torch.clamp(torch.abs(lb), min=1.0), k2 * rng)
    pert_ub = torch.minimum(k1 * torch.clamp(torch.abs(ub), min=1.0), k2 * rng)
    return torch.minimum(torch.maximum(x, lb + pert_lb), ub - pert_ub)


def barrier_gradient(x, lb, ub, has_lb, has_ub, mu, damping):
    """-mu/(x-lb) (+damping*mu if only lower), -mu/(x-ub) (-damping*mu if
    only upper)."""
    mu = _col(mu)
    single_lb = has_lb & ~has_ub
    single_ub = has_ub & ~has_lb
    g = torch.where(has_lb, -mu / (x - lb) + torch.where(single_lb, damping * mu, 0.0), 0.0)
    g = g + torch.where(has_ub, -mu / (x - ub) - torch.where(single_ub, damping * mu, 0.0), 0.0)
    return g


def barrier_hessian_diag(x, zl, zu, lb, ub, has_lb, has_ub):
    """Primal-dual barrier Hessian diagonal: zl/(x-lb) + zu/(x-ub) (masked)."""
    d = torch.where(has_lb, zl / (x - lb), 0.0)
    d = d + torch.where(has_ub, zu / (x - ub), 0.0)
    return d


def barrier_auxiliary_measure(x, lb, ub, has_lb, has_ub, mu, damping):
    """mu * (-sum log(x-lb) - sum log(ub-x) + damping*(distances of single-
    bounded vars)), (B,); the IPM auxiliary progress measure."""
    single_lb = has_lb & ~has_ub
    single_ub = has_ub & ~has_lb
    terms = -torch.where(has_lb, torch.log(torch.clamp(x - lb, min=1e-35)), 0.0)
    terms = terms - torch.where(has_ub, torch.log(torch.clamp(ub - x, min=1e-35)), 0.0)
    terms = terms + torch.where(single_lb, damping * (x - lb), 0.0)
    terms = terms + torch.where(single_ub, damping * (ub - x), 0.0)
    return mu * torch.sum(terms, dim=-1)


def barrier_directional_derivative(x, d, lb, ub, has_lb, has_ub, mu, damping):
    """Directional derivative of the barrier terms along d, (B,)."""
    mu = _col(mu)
    single_lb = has_lb & ~has_ub
    single_ub = has_ub & ~has_lb
    dd = torch.where(has_lb, -mu / (x - lb) * d, 0.0)
    dd = dd + torch.where(has_ub, -mu / (x - ub) * d, 0.0)
    dd = dd + torch.where(single_lb, damping * mu * d, 0.0)
    dd = dd - torch.where(single_ub, damping * mu * d, 0.0)
    return torch.sum(dd, dim=-1)


def bound_dual_direction(x, dx, zl, zu, lb, ub, has_lb, has_ub, mu):
    """dz = (mu - dx*z)/(x-bound) - z on the active bound sets."""
    mu = _col(mu)
    dzl = torch.where(has_lb, (mu - dx * zl) / (x - lb) - zl, 0.0)
    dzu = torch.where(has_ub, (mu - dx * zu) / (x - ub) - zu, 0.0)
    return dzl, dzu


def primal_fraction_to_boundary(x, dx, lb, ub, has_lb, has_ub, tau):
    """max alpha in (0,1] with x + alpha*dx keeping tau-fraction
    interiority, (B,)."""
    tau = _col(tau)
    dist_lb = torch.where(has_lb & (dx < 0),
                          -tau * (x - lb) / torch.where(dx < 0, dx, -1.0), _INF)
    dist_ub = torch.where(has_ub & (dx > 0),
                          -tau * (x - ub) / torch.where(dx > 0, dx, 1.0), _INF)
    dist = torch.minimum(torch.where(dist_lb > 0, dist_lb, _INF),
                         torch.where(dist_ub > 0, dist_ub, _INF))
    return torch.clamp(_min_last(dist), max=1.0)


def dual_fraction_to_boundary(zl, zu, dzl, dzu, has_lb, has_ub, tau):
    """max alpha keeping zl > 0 (lower) and zu < 0 (upper) tau-fractionally."""
    tau = _col(tau)
    dist_l = torch.where(has_lb & (dzl < 0),
                         -tau * zl / torch.where(dzl < 0, dzl, -1.0), _INF)
    dist_u = torch.where(has_ub & (dzu > 0),
                         -tau * zu / torch.where(dzu > 0, dzu, 1.0), _INF)
    dist = torch.minimum(torch.where(dist_l > 0, dist_l, _INF),
                         torch.where(dist_u > 0, dist_u, _INF))
    return torch.clamp(_min_last(dist), max=1.0)


def k_sigma_rescale(x, zl, zu, lb, ub, has_lb, has_ub, mu, k_sigma):
    """Project bound duals into [mu/(k_sigma*(x-b)), k_sigma*mu/(x-b)]
    (IPOPT Eq. 16)."""
    mu = _col(mu)
    coef_l = mu / (x - lb)
    zl_new = torch.where(has_lb & torch.isfinite(coef_l),
                         torch.clamp(zl, coef_l / k_sigma, coef_l * k_sigma), zl)
    coef_u = mu / (x - ub)  # negative
    zu_new = torch.where(has_ub & torch.isfinite(coef_u),
                         torch.clamp(zu, coef_u * k_sigma, coef_u / k_sigma), zu)
    return zl_new, zu_new


def centrality_error(x, zl, zu, lb, ub, has_lb, has_ub, mu):
    """inf-norm of the mu-shifted bound complementarity over active
    multipliers, (B,)."""
    mu = _col(mu)
    e_l = torch.where(has_lb & (zl > 0), torch.abs(zl * (x - lb) - mu), 0.0)
    e_u = torch.where(has_ub & (zu < 0), torch.abs(zu * (x - ub) - mu), 0.0)
    e = torch.maximum(e_l, e_u)
    if e.shape[-1] == 0:
        return e.new_zeros(e.shape[:-1])
    return torch.clamp(torch.amax(e, dim=-1), min=0.0)


def bound_complementarity_error(x, zl, zu, lb, ub, has_lb, has_ub):
    """Unshifted bound complementarity per variable: zl*(x-lb) where zl>0,
    ELSE zu*(x-ub) where zu<0 (the lower product takes priority, reference
    OptimizationProblem.cpp:152-165)."""
    e = torch.where(has_ub & (zu < 0), zu * (x - ub), 0.0)
    e = torch.where(has_lb & (zl > 0), zl * (x - lb), e)
    return e
