"""Dense symmetric-indefinite LDL^T factorization with inertia, batched.

Counterpart of uno_tpu/linalg/ldlt.py, written as plain PyTorch over any
leading batch axes: (..., n, n) -> L (..., n, n), d (..., n) and the
inertia counts (...,).  Unpivoted right-looking LDL^T; the surrounding
primal-dual inertia correction repairs indefinite or singular pivots, and
the inertia is read off the signs of D.

Each rank-1 update a - dj * (l_i * l_k) rounds the product l_i * l_k and
then takes one fused multiply-add, a + (-dj) * p rounded once, as XLA:CPU
compiles uno_tpu's updates (tools/xla_fma_census.py reads its object code):
torch.addcmul(a, -dj, p) is that multiply-add on the CPU and on CUDA.

These are the plain versions of the CUDA kernel in linalg/cuda_ldlt.py: the
solver uses them only for tensors on the CPU, and chip_smoke.py holds the
kernel against them on the card.
  * `ldlt_factor`          column-at-a-time rank-1 updates
  * `ldlt_factor_unrolled` the same on the shrinking trailing block
  * `ldlt_factor_blocked`  panels of `block` columns + one matmul update each
`plain_factorizer(dim)` picks among them as uno_tpu's batch path does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LDLT(NamedTuple):
    L: torch.Tensor         # unit lower-triangular factor (..., n, n)
    d: torch.Tensor         # diagonal of D (..., n)
    num_pos: torch.Tensor   # inertia: positive pivots (...,)
    num_neg: torch.Tensor   # inertia: negative pivots
    num_zero: torch.Tensor  # inertia: |pivot| below threshold (singularity)


def _pivot_threshold(d, zero_pivot_rtol):
    """|pivot| below rtol * max(max|d|, 1) counts as zero (singular); the
    default rtol only catches essentially-exact zeros, since barrier KKT
    pivots legitimately span ~18 orders of magnitude."""
    scale = torch.maximum(torch.amax(torch.abs(d), dim=-1), d.new_ones(()))
    return zero_pivot_rtol * scale


def _safe(dj):
    # full_like, not a scalar tensor from the host: no copy to the device
    tiny = torch.full_like(dj, 1e-35)
    return torch.where(torch.abs(dj) < tiny, torch.where(dj < 0, -tiny, tiny), dj)


def _inertia(d, zero_pivot_rtol):
    thresh = _pivot_threshold(d, zero_pivot_rtol)
    zero = torch.abs(d) <= thresh[..., None]
    pos = torch.sum((d > 0) & ~zero, dim=-1)
    neg = torch.sum((d < 0) & ~zero, dim=-1)
    return pos, neg, torch.sum(zero, dim=-1)


def _finish(L, d, zero_pivot_rtol) -> LDLT:
    pos, neg, zero = _inertia(d, zero_pivot_rtol)
    return LDLT(L, d, pos, neg, zero)


def ldlt_factor(A: torch.Tensor, zero_pivot_rtol: float = 1e-32) -> LDLT:
    """Unpivoted LDL^T by sequential full-matrix rank-1 updates."""
    n = A.shape[-1]
    row_idx = torch.arange(n, device=A.device)
    M = A.clone()
    for j in range(n):
        dj = M[..., j, j]
        col = M[..., :, j]
        below = row_idx > j
        l = torch.where(below, col / _safe(dj)[..., None], 0.0)
        M = torch.addcmul(M, -dj[..., None, None], l[..., :, None] * l[..., None, :])
        M[..., :, j] = torch.where(below, l, col)
        M[..., j, j] = dj
    d = torch.diagonal(M, dim1=-2, dim2=-1).clone()
    L = torch.tril(M, -1) + torch.eye(n, dtype=A.dtype, device=A.device)
    return _finish(L, d, zero_pivot_rtol)


def ldlt_factor_unrolled(A: torch.Tensor, zero_pivot_rtol: float = 1e-32) -> LDLT:
    """LDL^T on the shrinking trailing block (half the flops of the
    full-matrix rank-1 form); the form uno_tpu uses for dim <= 32."""
    n = A.shape[-1]
    M = A
    L = torch.zeros_like(A)
    d = A.new_empty(A.shape[:-1])
    for j in range(n):
        dj = M[..., 0, 0]
        l = M[..., 1:, 0] / _safe(dj)[..., None]
        d[..., j] = dj
        L[..., j + 1:, j] = l
        M = torch.addcmul(M[..., 1:, 1:], -dj[..., None, None],
                          l[..., :, None] * l[..., None, :])
    L = L + torch.eye(n, dtype=A.dtype, device=A.device)
    return _finish(L, d, zero_pivot_rtol)


def ldlt_factor_blocked(A: torch.Tensor, block: int = 32,
                        zero_pivot_rtol: float = 1e-32) -> LDLT:
    """Blocked right-looking LDL^T: sequential panel factorization (width
    `block`), then one (n, b) x (b, n) matmul trailing update per panel.

    The matrix is padded with a +1 identity tail to a multiple of `block`;
    the padded pivots are dropped before the inertia is counted."""
    n0 = A.shape[-1]
    nb = -(-max(n0, 1) // block)
    n = nb * block
    pad = n - n0
    if pad:
        A = torch.nn.functional.pad(A, (0, pad, 0, pad))
        A.diagonal(dim1=-2, dim2=-1)[..., n0:].fill_(1.0)
    row_idx = torch.arange(n, device=A.device)
    M = A
    L = torch.zeros_like(A)
    d = A.new_zeros(A.shape[:-1])
    for k in range(nb):
        k0 = k * block
        Pm = M[..., :, k0:k0 + block]
        P = torch.zeros_like(Pm)
        dpan = Pm.new_zeros(Pm.shape[:-2] + (block,))
        for jj in range(block):
            j = k0 + jj
            col = Pm[..., :, jj]
            dj = col[..., j]
            below = row_idx > j
            l = torch.where(below, col / _safe(dj)[..., None], 0.0)
            lpan = l[..., k0:k0 + block]
            Pm = torch.addcmul(Pm, -dj[..., None, None], l[..., :, None] * lpan[..., None, :])
            P[..., :, jj] = l
            dpan[..., jj] = dj
        M = M - (P * dpan[..., None, :]) @ P.transpose(-1, -2)
        L[..., :, k0:k0 + block] = P
        d[..., k0:k0 + block] = dpan
    L = torch.tril(L, -1) + torch.eye(n, dtype=A.dtype, device=A.device)
    return _finish(L[..., :n0, :n0], d[..., :n0].clone(), zero_pivot_rtol)


def plain_factorizer(dim: int, block: int = 32):
    """The plain version uno_tpu's batch path uses at this dim: unrolled up
    to 32, the column loop up to 64, panels of `block` above."""
    if dim <= 32:
        return ldlt_factor_unrolled
    if dim <= 64:
        return ldlt_factor
    b = min(block, -(-dim // 8) * 8)
    return lambda A, zero_pivot_rtol=1e-32: ldlt_factor_blocked(
        A, block=b, zero_pivot_rtol=zero_pivot_rtol)


def ldlt_solve(fac: LDLT, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A x = rhs for every instance, given A = L D L^T; rhs is (..., n).

    Small systems (n <= 32) use unrolled forward/backward substitution, as
    uno_tpu does, z_i = rhs_i - dot(L_i, z) and x_i = z_i - dot(L[:, i], x)
    over whole rows and columns, with each dot as XLA:CPU compiles a jitted
    instance's: a chain of fused multiply-adds from +0 in increasing index
    (tools/xla_fma_census.py).  The forward chains run a column at a time
    over the rows below; a row's zero terms (k >= i) come last and only turn
    a -0 into +0.  The backward chain of a column starts at its last-known
    entry, so it runs an entry at a time.  Larger systems use
    torch.linalg.solve_triangular."""
    n = rhs.shape[-1]
    if n <= 32:
        L = fac.L
        acc = torch.zeros_like(rhs)
        z = torch.empty_like(rhs)
        for k in range(n):
            z[..., k] = rhs[..., k] - (acc[..., k] + 0.0)
            if k + 1 < n:
                acc[..., k + 1:] = torch.addcmul(acc[..., k + 1:], L[..., k + 1:, k],
                                                 z[..., k:k + 1])
        z = z / _safe(fac.d)
        x = torch.empty_like(rhs)
        for i in range(n - 1, -1, -1):
            s = torch.zeros_like(rhs[..., i])
            for k in range(i + 1, n):
                s = torch.addcmul(s, L[..., k, i], x[..., k])
            x[..., i] = z[..., i] - s
        return x
    z = torch.linalg.solve_triangular(fac.L, rhs[..., None], upper=False,
                                      unitriangular=True)
    z = z / _safe(fac.d)[..., None]
    x = torch.linalg.solve_triangular(fac.L.transpose(-1, -2), z, upper=True,
                                      unitriangular=True)
    return x[..., 0]


def ldlt_refine(A: torch.Tensor, fac: LDLT, rhs: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """One step of iterative refinement (MA57's option, reference
    MA57Solver.cpp:137-145); essential for f32 factorizations."""
    r = rhs - (A @ x[..., None])[..., 0]
    return x + ldlt_solve(fac, r)
