"""Inertia-correcting regularization of the augmented KKT system, batched.

Counterpart of uno_tpu/ingredients/regularization.py (reference
PrimalDualRegularization.hpp:133-226): factorize [H + delta*I, J^T; J, -eps*I],
compare the pivot-sign inertia against the expected (n, m, 0), and escalate
delta on Uno's warm-started schedule.  The data-dependent refactorization
count is a host loop over the batch, capped at
`max_regularization_attempts`; each trip factors only the instances that
are still correcting, and the others keep their result, which is what
uno_tpu's vmapped while_loop computes.

`assemble` may return a dense (B, dim, dim) batch or a structured object
(a NamedTuple of tensors, e.g. linalg/banded_kkt.BandedKKT), and a
`factorizer` may replace the dense LDL^T (the lifted, banded and sparse
backends).  Every tensor of such an object, and of its factor, carries the
batch as its leading axis, so taking and putting back the instances that
are still correcting is a map over its leaves (`tree_map`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.linalg.ldlt import LDLT


def tree_map(fn, *trees):
    """fn over the tensors of equally shaped trees of NamedTuples and
    tuples; other leaves (None) pass through from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return first


def _cast(assembled, dtype):
    """Every floating tensor of the assembled KKT to the factor dtype,
    contiguous (the kernels' wrapper takes contiguous matrices)."""
    return tree_map(lambda t: (t.to(dtype) if t.is_floating_point() else t)
                    .contiguous(), assembled)


def pick_factorizer(dim: int, block: int = 32):
    """A factorizer of (B, dim, dim) batches: the CUDA kernel's wrapper,
    which launches the kernel for a CUDA tensor, whatever the dim and for
    both float32 and float64, and runs the plain version uno_tpu uses at
    this dim (`linalg.ldlt.plain_factorizer`) for a CPU tensor.  `dim`
    is read off the tensor; it stays in the signature as in uno_tpu."""
    def factorize(A: torch.Tensor) -> LDLT:
        return cuda_ldlt.ldlt_factor_cuda(A, block=block)

    return factorize


class RegularizedFactorization(NamedTuple):
    fac: object                  # LDLT, or the factorizer's factor object
    delta: torch.Tensor          # (B,) primal regularization actually used
    eps: torch.Tensor            # (B,) dual regularization actually used
    prev_delta: torch.Tensor     # (B,) warm-start value for the next KKT solve
    failed: torch.Tensor         # (B,) bool: UnstableRegularization
    singular: torch.Tensor       # (B,) bool: first factorization was singular
    attempts: torch.Tensor       # (B,) int: number of factorizations performed


def _put(fac, idx, sub):
    """`fac` with the instances `idx` replaced by `sub`'s."""
    return tree_map(lambda full, part: full.index_copy(0, idx, part), fac, sub)


def regularize_and_factor(
    assemble: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    expected_pos: int,
    expected_neg: int,
    dual_reg_parameter,          # (B,) mu^0.25 for the barrier problem
    prev_delta,                  # (B,)
    opts,
    block: int = 32,
    factorizer=None,
) -> RegularizedFactorization:
    """assemble(delta, eps) with (B,) delta and eps must build the batch of
    augmented KKTs with the regularization applied (+delta on the primal
    diagonal, -eps on the dual): dense (B, dim, dim) matrices, or a
    structured object for `factorizer`, which returns an object with
    (B,) num_pos/num_neg/num_zero fields."""
    factorize = factorizer if factorizer is not None else pick_factorizer(
        expected_pos + expected_neg, block)
    factor_dtype = getattr(torch, opts.kkt_dtype)

    def inertia_ok(fac):
        return (fac.num_pos == expected_pos) & (fac.num_neg == expected_neg) \
            & (fac.num_zero == 0)

    zero = torch.zeros_like(prev_delta)
    fac = factorize(_cast(assemble(zero, zero), factor_dtype))
    ok0 = inertia_ok(fac)
    singular0 = fac.num_zero > 0

    # initial regularization (PrimalDualRegularization.hpp:166-186); as in
    # uno_tpu the tiny dual eps applies on ANY failed first attempt
    eps = torch.where(~ok0, opts.dual_regularization_fraction * dual_reg_parameter, 0.0)
    delta = torch.where(
        prev_delta == 0.0,
        torch.full_like(prev_delta, opts.primal_regularization_initial_factor),
        torch.clamp(prev_delta / opts.primal_regularization_decrease_factor,
                    min=opts.primal_regularization_lb))
    attempts = torch.ones_like(prev_delta, dtype=torch.int64)
    done = ok0
    failed = torch.zeros_like(ok0)
    for _ in range(opts.max_regularization_attempts):
        active = ~done & ~failed & (attempts < opts.max_regularization_attempts)
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel() == 0:
            break
        K = tree_map(lambda t: t.index_select(0, idx), assemble(delta, eps))
        sub = factorize(_cast(K, factor_dtype))
        fac = _put(fac, idx, sub)
        attempts = attempts + active.to(attempts.dtype)
        good = inertia_ok(fac)
        # escalation factor (.hpp:203-209)
        fast = (prev_delta == 0.0) | (attempts > opts.threshold_unsuccessful_attempts)
        grown = torch.where(fast, delta * opts.primal_regularization_fast_increase_factor,
                            delta * opts.primal_regularization_slow_increase_factor)
        next_delta = torch.where(good, delta, grown)
        delta = torch.where(active, next_delta, delta)
        failed = torch.where(active, ~good & (next_delta > opts.regularization_failure_threshold),
                             failed)
        done = torch.where(active, good, done)

    used_delta = torch.where(ok0, 0.0, delta)
    used_eps = torch.where(ok0, 0.0, eps)
    # the warm start is only updated by a successful *regularized*
    # factorization (.hpp:199-201)
    new_prev = torch.where(ok0, prev_delta, torch.where(done, delta, prev_delta))
    return RegularizedFactorization(
        fac=fac, delta=used_delta, eps=used_eps, prev_delta=new_prev,
        failed=failed | ~done, singular=singular0, attempts=attempts,
    )
