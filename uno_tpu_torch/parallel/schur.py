"""Schur-complement KKT solver for block-arrow systems, on one card or split
over a process group.

Counterpart of uno_tpu/parallel/schur.py.  The symmetric block-arrow system

    K = [ K_1          B_1 ]
        [     ...      ... ]
        [         K_S  B_S ]
        [ B_1^T .. B_S^T K_0 ]

of multi-scenario stochastic NLPs is factored block by block: the scenario
blocks K_s together as one batch (S, nb, nb), the coupling Schur complement
S_0 = K_0 - sum_s B_s^T K_s^{-1} B_s as a batch of one (1, n0, n0), both
through linalg/cuda_ldlt.ldlt_factor_cuda, so on the card through
ldlt_warp, ldlt_column or ldlt_panel by dim (on the CPU through their plain
versions).  The inertia of K is the sum of the block inertias and that of
S_0 (Haynsworth), so the inertia-corrected regularization applies as it is.

With a process group (parallel/group.py) each rank holds a contiguous run
of the scenarios, as uno_tpu's P(axis) gives each device, and the coupling
sum, the Schur right-hand side and the three inertia counts are
all-reduced; K_0, S_0 and x0 are replicated.  The sums over ranks are
taken in another order than one einsum over s, so a world of N ranks
agrees with one rank to rounding.  The einsums are torch products, as
uno_tpu computes them outside Pallas.

Entry points:
  schur_factor(Ks, Bs, K0, group=None)      -> SchurFactorization
  schur_solve(fac, Bs, rhs_s, rhs0, group=None) -> (xs, x0)
  make_sharded_schur_solver(group, nb, n0)  -> factor + solve on a rank's run
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uno_tpu_torch.linalg.cuda_ldlt import ldlt_factor_cuda
from uno_tpu_torch.linalg.ldlt import LDLT, _safe, ldlt_solve


class SchurFactorization(NamedTuple):
    block_fac: LDLT          # the K_s factored (S, nb, nb): the rank's run with a group
    Y: torch.Tensor          # K_s^{-1} B_s (S, nb, n0)
    fac0: LDLT               # the Schur complement factored, a batch of one (1, n0, n0)
    num_pos: torch.Tensor    # total inertia of K (0-dim int64, over every rank)
    num_neg: torch.Tensor
    num_zero: torch.Tensor


def solve_columns(fac: LDLT, rhs: torch.Tensor) -> torch.Tensor:
    """K^{-1} rhs for a batch of factors and a matrix right-hand side
    (..., n, k): the triangular solves uno_tpu's ldlt_solve takes for a
    2-D rhs."""
    z = torch.linalg.solve_triangular(fac.L, rhs, upper=False, unitriangular=True)
    z = z / _safe(fac.d)[..., None]
    return torch.linalg.solve_triangular(fac.L.transpose(-1, -2), z, upper=True,
                                         unitriangular=True)


def schur_factor(Ks: torch.Tensor, Bs: torch.Tensor, K0: torch.Tensor,
                 block: int = 32, group=None) -> SchurFactorization:
    """Factor the block-arrow K given its scenario blocks Ks (S, nb, nb),
    couplings Bs (S, nb, n0) and K0 (n0, n0); with a group, Ks and Bs are
    this rank's scenarios and K0 is the same on every rank.  `block` is the
    plain panels' width on the CPU."""
    facs = ldlt_factor_cuda(Ks.contiguous(), block=block)
    Y = solve_columns(facs, Bs)
    contrib = torch.einsum("sij,sik->jk", Bs, Y)            # sum_s B_s^T Y_s
    counts = torch.stack([facs.num_pos.sum(), facs.num_neg.sum(),
                          facs.num_zero.sum()])
    if group is not None:
        group.all_reduce(contrib)
        group.all_reduce(counts)
    fac0 = ldlt_factor_cuda((K0 - contrib)[None].contiguous(), block=block)
    return SchurFactorization(
        block_fac=facs, Y=Y, fac0=fac0,
        num_pos=counts[0] + fac0.num_pos[0],
        num_neg=counts[1] + fac0.num_neg[0],
        num_zero=counts[2] + fac0.num_zero[0])


def schur_solve(fac: SchurFactorization, Bs: torch.Tensor, rhs_s: torch.Tensor,
                rhs0: torch.Tensor, group=None):
    """Solve K [x_s; x0] = [rhs_s; rhs0] given schur_factor's result; rhs_s
    (S, nb) (the rank's scenarios with a group), rhs0 (n0,)."""
    r = ldlt_solve(fac.block_fac, rhs_s)                    # K_s^{-1} rhs_s
    coupled = torch.einsum("sij,si->j", Bs, r)
    if group is not None:
        group.all_reduce(coupled)
    x0 = ldlt_solve(fac.fac0, (rhs0 - coupled)[None])[0]
    xs = r - torch.einsum("sij,j->si", fac.Y, x0)
    return xs, x0


def make_sharded_schur_solver(group, nb: int, n0: int, block: int = 32):
    """solve(Ks, Bs, K0, rhs_s, rhs0) -> (xs, x0, pos, neg, zero) over the
    group: Ks (S_r, nb, nb), Bs (S_r, nb, n0) and rhs_s (S_r, nb) are this
    rank's contiguous run of scenarios (`group.local_range(S)`), K0 and rhs0
    the same on every rank; xs comes back for the rank's run, x0 and the
    inertia of the whole K on every rank."""
    def solve(Ks, Bs, K0, rhs_s, rhs0):
        if Ks.shape[1:] != (nb, nb) or Bs.shape[1:] != (nb, n0) \
                or K0.shape != (n0, n0) or rhs_s.shape[1:] != (nb,) \
                or rhs0.shape != (n0,):
            raise ValueError(f"shapes {tuple(Ks.shape)}, {tuple(Bs.shape)}, "
                             f"{tuple(K0.shape)}, {tuple(rhs_s.shape)}, "
                             f"{tuple(rhs0.shape)} do not fit nb={nb}, n0={n0}")
        fac = schur_factor(Ks, Bs, K0, block, group)
        xs, x0 = schur_solve(fac, Bs, rhs_s, rhs0, group)
        return xs, x0, fac.num_pos, fac.num_neg, fac.num_zero

    return solve


def random_block_arrow_system(S, nb, n0, seed=0, definite=True):
    """Test and timing generator: a symmetric block-arrow system with known
    structure (saddle blocks unless definite), as numpy arrays; uno_tpu's
    draws from the same seed."""
    rng = np.random.default_rng(seed)
    Ks = []
    for _ in range(S):
        A = rng.standard_normal((nb, nb))
        K = (A + A.T) / 2 + (nb * np.eye(nb) if definite else 0.0)
        Ks.append(K)
    Bs = rng.standard_normal((S, nb, n0)) / np.sqrt(nb)
    A0 = rng.standard_normal((n0, n0))
    K0 = (A0 + A0.T) / 2 + (n0 + S) * np.eye(n0)
    return np.stack(Ks), Bs, K0


def dense_from_blocks(Ks, Bs, K0):
    """The dense K of a block-arrow system (numpy)."""
    S, nb, _ = Ks.shape
    n0 = K0.shape[0]
    N = S * nb + n0
    K = np.zeros((N, N))
    for s in range(S):
        K[s * nb:(s + 1) * nb, s * nb:(s + 1) * nb] = Ks[s]
        K[s * nb:(s + 1) * nb, S * nb:] = Bs[s]
        K[S * nb:, s * nb:(s + 1) * nb] = Bs[s].T
    K[S * nb:, S * nb:] = K0
    return K
