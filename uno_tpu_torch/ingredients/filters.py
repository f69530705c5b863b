"""The Waechter filter method over fixed-shape batched state.

Counterpart of the standard filter and the Waechter acceptance test of
uno_tpu/ingredients/filters.py (reference Filter.cpp,
WaechterFilterMethod.cpp:25-90, SwitchingMethod.cpp): a capacity-bounded
Pareto front of (infeasibility h, objective phi) pairs, kept as two
(B, capacity) tensors padded with +inf and sorted by h ascending.
Per-instance scalars are (B,).
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
