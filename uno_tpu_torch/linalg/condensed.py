"""Condensed-space (lifted) KKT backend: Cholesky instead of LDL^T, batched.

Counterpart of uno_tpu/linalg/condensed.py.  With the dual block -C
(C = the elastics' condensation + the dual regularization) lifted by a
small relaxation tau,

    [ Hd  J^T ] [dx]   [r_x]          M = Hd + J^T diag(1/(C+tau)) J
    [ J   -C  ] [ w] = [r_c]    =>    M dx = r_x + J^T (r_c / (C+tau))
                                      w = (J dx - r_c) / (C+tau)

M is positive definite whenever the augmented matrix has inertia (n, m, 0),
so a successful Cholesky is the inertia test: a failure reports the
inertia (0, 0, n+m) and drives the regularization loop.  The factorization
is `torch.linalg.cholesky_ex`, a library call (uno_tpu's is
`jnp.linalg.cholesky`, outside Pallas too); failure is read off its `info`
and the factor's finiteness, on the symmetrized input as jnp's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uno_tpu_torch.linalg.banded import _cholesky

# factorizations and solves since the last reset_counts(), summed over the
# batch's calls: what shows that a solve went through this backend
counts = {"factorizations": 0, "solves": 0}


def reset_counts() -> None:
    counts.update(factorizations=0, solves=0)



class LiftedKKT(NamedTuple):
    L: torch.Tensor           # (B, n, n) Cholesky factor of M (0 where failed)
    J: torch.Tensor           # (B, m, n), kept for the back-out
    cinv: torch.Tensor        # (B, m) 1 / (C + tau)
    num_pos: torch.Tensor     # (B,) inertia: (n, m, 0) on success
    num_neg: torch.Tensor
    num_zero: torch.Tensor


def make_lifted_kkt_backend(n: int, m: int, tau: float = 1e-8):
    """(factorize, solve) over the assembled (B, n+m, n+m) augmented
    matrices, with the contract of the dense factorizer and `ldlt_solve`."""

    def factorize(A) -> LiftedKKT:
        counts["factorizations"] += 1
        Hd = A[:, :n, :n]
        if m:
            J = A[:, n:, :n]
            C = -torch.diagonal(A[:, n:, n:], dim1=-2, dim2=-1)
            cinv = 1.0 / (C + tau)
            M = Hd + (J.transpose(-1, -2) * cinv[:, None, :]) @ J
        else:
            J = A.new_zeros((A.shape[0], 0, n))
            cinv = A.new_zeros((A.shape[0], 0))
            M = Hd
        L, ok = _cholesky(M)
        pos = torch.where(ok, n, 0)
        return LiftedKKT(torch.where(ok[:, None, None], L, 0.0), J, cinv,
                         pos, torch.where(ok, m, 0),
                         torch.where(ok, 0, n + m))

    def solve(fac: LiftedKKT, rhs):
        counts["solves"] += 1
        r_x, r_c = rhs[:, :n], rhs[:, n:]
        b = r_x + (fac.J.transpose(-1, -2) @ (r_c * fac.cinv)[..., None])[..., 0] \
            if m else r_x
        z = torch.linalg.solve_triangular(fac.L, b[..., None], upper=False)
        dx = torch.linalg.solve_triangular(fac.L.transpose(-1, -2), z, upper=True)[..., 0]
        if m:
            w = ((fac.J @ dx[..., None])[..., 0] - r_c) * fac.cinv
            return torch.cat([dx, w], dim=-1)
        return dx

    return factorize, solve
