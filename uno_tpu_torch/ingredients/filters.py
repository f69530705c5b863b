"""Globalization strategies over fixed-shape batched state.

Counterpart of uno_tpu/ingredients/filters.py (reference Filter.cpp,
NonmonotoneFilter.cpp, FletcherFilterMethod.cpp:15-66,
WaechterFilterMethod.cpp:25-90, SwitchingMethod.cpp, l1MeritFunction.cpp,
FunnelMethod.cpp / Funnel.cpp): a capacity-bounded Pareto front of
(infeasibility h, objective phi) pairs, kept as two (B, capacity) tensors
padded with +inf (sorted by h ascending for the standard filter, in
insertion order for the nonmonotone one), and the acceptance tests of the
filter methods, the l1 merit function and the funnel.  Per-instance
scalars are (B,).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = float("inf")


def _compact(h, phi, keep):
    """Stable partition: move `keep` entries to the front (relative order
    preserved), +inf padding behind."""
    cap = h.shape[-1]
    pos = torch.cumsum(keep.to(torch.int64), dim=-1) - 1   # target slot
    # dropped entries all go to a spare slot past the end, cut off below;
    # slots past the kept entries keep the +inf padding
    target = torch.where(keep, pos, cap)
    pad = h.new_full(h.shape[:-1] + (cap + 1,), BIG)
    return (pad.scatter(-1, target, h)[..., :cap],
            pad.scatter(-1, target, phi)[..., :cap])


def _sorted_insert(h, phi, h_new, phi_new):
    """Insert (h_new, phi_new) (B,) into h-ascending (B, cap) arrays whose
    last slot is free (+inf), keeping the sort.  Ties insert after equal-h
    entries."""
    cap = h.shape[-1]
    iota = torch.arange(cap, device=h.device)
    h_new = h_new[..., None]
    phi_new = phi_new[..., None]
    pos = torch.sum(h <= h_new, dim=-1, keepdim=True)   # insertion index
    h_prev = torch.cat([h[..., :1], h[..., :-1]], dim=-1)   # h[i-1]
    phi_prev = torch.cat([phi[..., :1], phi[..., :-1]], dim=-1)
    h_out = torch.where(iota < pos, h, torch.where(iota == pos, h_new, h_prev))
    phi_out = torch.where(iota < pos, phi,
                          torch.where(iota == pos, phi_new, phi_prev))
    return h_out, phi_out


class FilterState(NamedTuple):
    h: torch.Tensor    # (B, capacity) infeasibility, +inf for empty slots, sorted
    phi: torch.Tensor  # (B, capacity) objective measure (+inf for empty slots)
    ub: torch.Tensor   # (B,) infeasibility upper bound


def filter_init(batch: int, capacity: int, dtype=torch.float64,
                device=None) -> FilterState:
    return FilterState(
        h=torch.full((batch, capacity), BIG, dtype=dtype, device=device),
        phi=torch.full((batch, capacity), BIG, dtype=dtype, device=device),
        ub=torch.full((batch,), BIG, dtype=dtype, device=device),
    )


def filter_reset(f: FilterState) -> FilterState:
    """Clear entries, keep the upper bound (reference Filter::reset)."""
    return FilterState(torch.full_like(f.h, BIG), torch.full_like(f.phi, BIG), f.ub)


def filter_set_ub(f: FilterState, ub) -> FilterState:
    """`f` with the upper bound `ub` (a scalar or (B,)) for every instance."""
    return f._replace(ub=torch.as_tensor(ub, dtype=f.h.dtype,
                                         device=f.h.device).expand_as(f.ub).clone())


def filter_acceptable(f: FilterState, h_t, phi_t, beta, gamma):
    """Acceptability wrt the filter (Filter::acceptable): h_t < beta*ub, and
    either the trial dominates the whole front in h (position 0) or
    phi_t <= phi[position-1] - gamma*h_t, where position is the first entry
    with sufficient h-reduction."""
    ub_ok = h_t < beta * f.ub
    suff = h_t[..., None] < beta * f.h     # suffix of True (h sorted ascending)
    position = torch.sum(~suff, dim=-1)    # empty slots have h=+inf -> True
    idx = torch.clamp(position - 1, min=0)[..., None]
    phi_prev = torch.gather(f.phi, -1, idx)[..., 0]
    dominated_ok = (position == 0) | (phi_t <= phi_prev - gamma * h_t)
    return ub_ok & dominated_ok


def filter_acceptable_wrt(h_c, phi_c, h_t, phi_t, beta, gamma):
    """Acceptability wrt the current point
    (Filter::acceptable_wrt_current_iterate)."""
    return (h_t < beta * h_c) | (phi_t <= phi_c - gamma * h_t)


def filter_add(f: FilterState, h_c, phi_c, beta) -> FilterState:
    """Add (h_c, phi_c): drop dominated entries (h_i >= h_c and phi_i >= phi_c),
    make room if full (shrink ub to beta*max(ub, largest h), drop last),
    insert keeping h-ascending order (Filter::add)."""
    cap = f.h.shape[-1]
    keep = (f.h < h_c[..., None]) | (f.phi < phi_c[..., None])
    h, phi = _compact(f.h, f.phi, keep)
    n = torch.sum(keep, dim=-1)

    # if full after removal: shrink the upper bound and drop the largest-h
    # entry (slot cap-1 after compaction)
    full = n >= cap
    last = torch.arange(cap, device=f.h.device) == cap - 1
    largest = torch.where(full, torch.maximum(f.ub, h[..., cap - 1]), -BIG)
    ub = torch.where(full, beta * largest, f.ub)
    h = torch.where(full[..., None] & last, BIG, h)
    phi = torch.where(full[..., None] & last, BIG, phi)

    h, phi = _sorted_insert(h, phi, h_c, phi_c)
    return FilterState(h, phi, ub)


def filter_select(cond, a: FilterState, b: FilterState) -> FilterState:
    """Per instance: b where cond (B,), else a."""
    return FilterState(torch.where(cond[..., None], b.h, a.h),
                       torch.where(cond[..., None], b.phi, a.phi),
                       torch.where(cond, b.ub, a.ub))


def armijo_sufficient_decrease(predicted, actual, fraction, tolerance):
    """actual >= fraction * max(0, predicted - tolerance)
    (GlobalizationStrategy::armijo_sufficient_decrease)."""
    return actual >= fraction * torch.clamp(predicted - tolerance, min=0.0)


def switching_condition(predicted, h_current, delta, exponent):
    """predicted > delta * h^exponent (SwitchingMethod::switching_condition)."""
    return predicted > delta * torch.pow(h_current, exponent)


class WaechterDecisionLazy(NamedTuple):
    accept: torch.Tensor
    augment: torch.Tensor   # caller applies filter_add(h_cur, merit_cur) iff set


def waechter_is_acceptable(
    f: FilterState,
    h_cur, merit_cur,          # current (infeasibility, phi(1)+aux)
    h_tri, merit_tri,          # trial
    merit_pred,                # unconstrained predicted reduction
    h_initial,                 # infeasibility at the initial iterate
    opts,
    roundoff_protect_scale,
) -> WaechterDecisionLazy:
    """WaechterFilterMethod::is_regular_iterate_acceptable (.cpp:25-90).
    The filter add is returned as a flag: an accepted trial ends the line
    search, so the add runs once after the loop."""
    merit_actual = merit_cur - merit_tri + roundoff_protect_scale
    filter_ok = filter_acceptable(f, h_tri, merit_tri, opts.filter_beta,
                                  opts.filter_gamma)
    small_inf = h_cur <= 1e-4 * torch.clamp(h_initial, min=1.0)
    switching = (merit_pred > 0.0) & switching_condition(
        merit_pred, h_cur, opts.switching_delta,
        opts.switching_infeasibility_exponent)
    sufficient = armijo_sufficient_decrease(
        merit_pred, merit_actual, opts.armijo_decrease_fraction,
        opts.armijo_tolerance)

    f_type = small_inf & switching
    accept_f = f_type & sufficient
    accept_h = (~f_type) & filter_acceptable_wrt(
        h_cur, merit_cur, h_tri, merit_tri, opts.filter_beta, opts.filter_gamma)
    accept = filter_ok & (accept_f | accept_h)
    augment = accept & (~switching | ~sufficient)
    return WaechterDecisionLazy(accept, augment)


def feasibility_armijo_acceptable(h_cur, aux_cur, h_tri, aux_tri,
                                  pred_h, pred_aux, opts):
    """Feasibility-phase (objective multiplier 0) acceptance: Armijo on
    infeasibility + auxiliary (SwitchingMethod::is_feasibility_iterate_acceptable)."""
    predicted = pred_h + pred_aux
    actual = (h_cur + aux_cur) - (h_tri + aux_tri)
    return armijo_sufficient_decrease(predicted, actual,
                                      opts.armijo_decrease_fraction,
                                      opts.armijo_tolerance)


class FletcherDecision(NamedTuple):
    accept: torch.Tensor
    new_filter: FilterState


def fletcher_is_acceptable(
    f: FilterState,
    h_cur, merit_cur,
    h_tri, merit_tri,
    merit_pred,
    opts,
    roundoff_protect_scale,
) -> FletcherDecision:
    """FletcherFilterMethod::is_regular_iterate_acceptable (.cpp:15-66):
    acceptable to the filter AND wrt the current iterate; an f-type step
    needs switching + Armijo; an h-type step adds the current point to the
    filter."""
    merit_actual = merit_cur - merit_tri + roundoff_protect_scale
    acceptable_pair = filter_acceptable(
        f, h_tri, merit_tri, opts.filter_beta, opts.filter_gamma
    ) & filter_acceptable_wrt(h_cur, merit_cur, h_tri, merit_tri,
                              opts.filter_beta, opts.filter_gamma)
    switching = (merit_pred > 0.0) & switching_condition(
        merit_pred, h_cur, opts.switching_delta,
        opts.switching_infeasibility_exponent)
    sufficient = armijo_sufficient_decrease(
        merit_pred, merit_actual, opts.armijo_decrease_fraction,
        opts.armijo_tolerance)
    accept = acceptable_pair & torch.where(switching, sufficient, True)
    augment = accept & ~switching
    new_filter = filter_select(augment, f,
                               filter_add(f, h_cur, merit_cur, opts.filter_beta))
    return FletcherDecision(accept, new_filter)


def l1_merit_acceptable(h_cur, obj_cur, aux_cur, h_tri, obj_tri, aux_tri,
                        pred_h, pred_obj, pred_aux, opts, roundoff_protect_scale):
    """l1MeritFunction::is_iterate_acceptable: Armijo on
    objective(rho) + auxiliary + infeasibility."""
    predicted = pred_obj + pred_aux + pred_h
    cur = obj_cur + aux_cur + h_cur
    tri = obj_tri + aux_tri + h_tri
    actual = cur - tri + roundoff_protect_scale
    return armijo_sufficient_decrease(predicted, actual,
                                      opts.armijo_decrease_fraction,
                                      opts.armijo_tolerance)


# --------------------------------------------------------------------------
# nonmonotone filter (reference NonmonotoneFilter.cpp): an INSERTION-ordered
# front (eviction is oldest-first, and the nonmonotone Armijo test looks at
# the most recent entries)
# --------------------------------------------------------------------------

def nm_count_dominated(f: FilterState, h_t, phi_t, beta, gamma):
    """NonmonotoneFilter::compute_number_dominated_entries (.cpp:49-63):
    entry i counts against the trial if neither the objective nor the
    infeasibility sufficient-reduction margin holds.  (B,) int64."""
    h_t, phi_t = h_t[..., None], phi_t[..., None]
    valid = torch.isfinite(f.h)
    obj_suff = phi_t <= f.phi - gamma * h_t
    inf_suff = h_t < beta * f.h
    dom = (~obj_suff & ~inf_suff) | ((phi_t >= f.phi - gamma * h_t)
                                     & (h_t > beta * f.h))
    return torch.sum(dom & valid, dim=-1)


def nm_filter_acceptable(f: FilterState, h_t, phi_t, beta, gamma, max_dom):
    """NonmonotoneFilter::acceptable: upper bound, then tolerate up to
    max_dom dominating entries."""
    ub_ok = h_t < beta * f.ub
    return ub_ok & (nm_count_dominated(f, h_t, phi_t, beta, gamma) <= max_dom)


def nm_filter_acceptable_wrt(f: FilterState, h_c, phi_c, h_t, phi_t,
                             beta, gamma, max_dom):
    """NonmonotoneFilter::acceptable_wrt_current_iterate: the current point
    counts as one more potential dominator."""
    count = nm_count_dominated(f, h_t, phi_t, beta, gamma)
    cur_dom = (~(phi_t <= phi_c - gamma * h_t)) & (h_t > beta * h_c)
    return (count + cur_dom.to(count.dtype)) <= max_dom


def nm_filter_add(f: FilterState, h_c, phi_c, max_dom) -> FilterState:
    """NonmonotoneFilter::add (.cpp:15-47): drop entries dominated by more
    than max_dom others (the new point included), evict the second-oldest
    entry when full, append at the end (insertion order kept)."""
    cap = f.h.shape[-1]
    valid = torch.isfinite(f.h)
    # pairwise dominator counts among the entries and the incoming point
    dom_pair = (f.phi[..., :, None] > f.phi[..., None, :]) \
        & (f.h[..., :, None] > f.h[..., None, :])
    ndom = torch.sum(dom_pair & valid[..., None, :], dim=-1) \
        + ((f.phi > phi_c[..., None]) & (f.h > h_c[..., None])).to(torch.int64)
    keep = valid & (ndom <= max_dom)
    h, phi = _compact(f.h, f.phi, keep)
    n = torch.sum(keep, dim=-1)

    # full -> evict entry 1 (left_shift(1, 1): keeps the oldest, drops next)
    full = n >= cap
    pad = h.new_full(h.shape[:-1] + (1,), BIG)
    h_shift = torch.cat([h[..., :1], h[..., 2:], pad], dim=-1)
    phi_shift = torch.cat([phi[..., :1], phi[..., 2:], pad], dim=-1)
    h = torch.where(full[..., None], h_shift, h)
    phi = torch.where(full[..., None], phi_shift, phi)
    n = torch.where(full, n - 1, n)

    at = torch.arange(cap, device=h.device) == n[..., None]
    h = torch.where(at, h_c[..., None], h)
    phi = torch.where(at, phi_c[..., None], phi)
    return FilterState(h, phi, f.ub)


def nm_actual_objective_reduction(f: FilterState, merit_cur, h_cur, merit_tri,
                                  gamma, max_dom):
    """NonmonotoneFilter::compute_actual_objective_reduction: the
    nonmonotone actual reduction against the max 'dash objective' over the
    newest max_dom VALID entries (uno_tpu's reading of the reference)."""
    cap = f.h.shape[-1]
    valid = torch.isfinite(f.h)
    n = torch.sum(valid, dim=-1, keepdim=True)
    recent = valid & (torch.arange(cap, device=f.h.device) >= n - max_dom)
    h_cur = h_cur[..., None]
    gam = torch.where(h_cur < f.h, torch.full_like(f.h, 1.0 / gamma), gamma)
    dash = f.phi + gam * (f.h - h_cur)
    recent_max = torch.amax(torch.where(recent, dash, -BIG), dim=-1)
    return torch.maximum(merit_cur, recent_max) - merit_tri


def nm_smallest_infeasibility(f: FilterState):
    return torch.amin(f.h, dim=-1)


# --------------------------------------------------------------------------
# funnel (reference FunnelMethod.cpp / Funnel.cpp): the width as a carried
# (B,) scalar
# --------------------------------------------------------------------------

def funnel_update_width(width, h_cur, h_tri, margin, kappa, strategy: int):
    """Funnel::update (.cpp:33-55), strategy in {1, 2, 3}."""
    if strategy == 1:
        return torch.where(h_tri <= h_cur,
                           torch.maximum(margin * width,
                                         kappa * h_cur + (1.0 - kappa) * h_tri),
                           margin * width)
    if strategy == 2:
        return kappa * width + (1.0 - kappa) * h_tri
    return margin * width


class FunnelDecisionLazy(NamedTuple):
    accept: torch.Tensor
    h_type: torch.Tensor   # caller applies funnel_update_width iff set


def funnel_is_acceptable(width, h_cur, merit_cur, h_tri, merit_tri,
                         merit_pred, opts, roundoff_protect_scale):
    """FunnelMethod::is_regular_iterate_acceptable (.cpp:33-95).  The width
    update on an h-type acceptance is left to the caller."""
    in_funnel = h_tri <= width
    if opts.funnel_require_acceptance_wrt_current_iterate:
        ok_wrt = (h_tri < opts.funnel_beta * h_cur) | \
            (merit_tri <= merit_cur - opts.funnel_gamma * h_tri)
    else:
        ok_wrt = torch.ones_like(in_funnel)
    switching = (merit_pred > 0.0) & switching_condition(
        merit_pred, h_cur, opts.switching_delta,
        opts.switching_infeasibility_exponent)
    sufficient = armijo_sufficient_decrease(
        merit_pred, merit_cur - merit_tri + roundoff_protect_scale,
        opts.armijo_decrease_fraction, opts.armijo_tolerance)
    f_accept = switching & sufficient
    h_accept = ~switching & (h_tri <= opts.funnel_beta * width)
    accept = in_funnel & ok_wrt & (f_accept | h_accept)
    return FunnelDecisionLazy(accept, accept & h_accept & ~switching)
