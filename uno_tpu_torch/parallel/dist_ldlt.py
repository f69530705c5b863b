"""Distributed dense symmetric-indefinite LDL^T with inertia, over a process
group.

Counterpart of uno_tpu/parallel/dist_ldlt.py: the KKT systems with no
block structure to exploit that are too large in work for one card.  A
right-looking LDL^T, 1-D block-cyclic over columns: panel g (`block`
columns) lives on rank g % P in local slot g // P, so that the trailing
work stays balanced over the ranks.  At step g the owner factors its
panel in place (`panel_factor`: the `dist_panel` kernel on the card, csrc/
dist_ldlt.cu, and `panel_factor_plain` on the CPU) and broadcasts it with
its pivots; every rank then updates its own columns of the panels after g
with one torch.matmul.  The pivots d arrive on every rank as they are
made, so the inertia and the IPM's inertia-corrected regularization work
as on one card.  The solves keep L distributed: forward and backward
substitution walk the panels, the owner does the small unit-triangular
solve and its matrix-vector product, and broadcasts the change to the
replicated right-hand side.  Unpivoted, as the single-card kernels are.

uno_tpu's masked `psum`s only carry the owner's data, so they are
broadcasts here and exact: every rank holds the same d and the same
solution.  A world of P ranks splits the trailing products into other
matrix shapes than one rank does, so P ranks agree with one to rounding.

Entry points:
  make_dist_ldlt(group, n, block) -> (factor, solve, perm)
    factor(A_loc) -> DistLDLT   A_loc = A[:, perm] restricted to this rank's
                                n / P columns (group.local_range(n))
    solve(fac, rhs) -> x        rhs and x (n,), the same on every rank
  make_dist_kkt_backend(group, n_kkt, block) -> (factorize, solve)
    the IPM's KKT backend (ldlt_backend="distributed"): the padding and the
    permutation inside, a batch of one in and out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.linalg.ldlt import _inertia, _safe


class DistLDLT(NamedTuple):
    L_cyc: torch.Tensor      # (n, n / P): this rank's columns of L[:, perm], zero diagonal
    d: torch.Tensor          # (n,) pivots, global order, on every rank
    num_pos: torch.Tensor
    num_neg: torch.Tensor
    num_zero: torch.Tensor


def cyclic_permutation(n: int, nproc: int, block: int) -> np.ndarray:
    """perm such that A[:, perm] cut into nproc contiguous column runs gives
    rank p the global panels {p, p + nproc, p + 2 nproc, ...}."""
    assert n % (nproc * block) == 0
    spp = n // (nproc * block)          # slots per rank
    perm = np.empty(n, dtype=np.int64)
    pos = 0
    for p in range(nproc):
        for s in range(spp):
            g = p + s * nproc
            perm[pos:pos + block] = np.arange(g * block, (g + 1) * block)
            pos += block
    return perm


def panel_factor_plain(C: torch.Tensor, row0: int):
    """The unblocked LDL^T panel factor of uno_tpu's _panel_factor: C (n,
    block) holds global columns row0 .. row0+block-1 of the working matrix,
    whose pivots lie on rows row0 + jj.  Returns (the L panel, unit diagonal
    implied and zeros above it, the block's pivots).  The plain version of
    dist_panel, in its order: the reciprocal of the pivot, then both update
    factors from the same column, dj * (l_col * l_pan), taken off in one
    fused multiply-add as XLA:CPU compiles it (linalg/ldlt.py)."""
    n, block = C.shape
    rows = torch.arange(n, device=C.device)
    C = C.clone()
    d = C.new_zeros(block)
    for jj in range(block):
        pr = row0 + jj
        dj = C[pr, jj]
        inv = torch.reciprocal(_safe(dj))
        l_col = torch.where(rows > pr, C[:, jj] * inv, 0.0)
        l_pan = l_col[row0:row0 + block]
        C = torch.addcmul(C, -dj, l_col[:, None] * l_pan[None, :])
        C[:, jj] = l_col
        d[jj] = dj
    return C, d


def panel_factor(work: torch.Tensor, col0: int, row0: int, block: int) -> torch.Tensor:
    """Factor the slab work[:, col0:col0+block] of a contiguous (n, ld) tensor
    in place, its pivots on rows row0 .. row0+block-1; returns the pivots.
    The dist_panel kernel for a CUDA tensor, the plain version for a CPU one."""
    if work.device.type == "cpu":
        C, d = panel_factor_plain(work[:, col0:col0 + block], row0)
        work[:, col0:col0 + block] = C
        return d
    d = work.new_empty(block)
    cuda_ldlt.launch_dist_panel(work, col0, row0, block, d)
    return d


def make_dist_ldlt(group, n: int, block: int = 64, zero_pivot_rtol: float = 1e-32):
    """(factor, solve, perm) over the group's ranks; see the module doc.
    Requires n % (P * block) == 0 (pad with an identity tail upstream: its
    +1 pivots are easy to take out of the inertia)."""
    nproc, rank = group.size, group.rank
    if n % (nproc * block):
        raise ValueError(f"n={n} is not a multiple of {nproc} ranks x block {block}")
    if group.device.type == "cuda" and block not in cuda_ldlt.DIST_PANEL_BLOCKS:
        raise ValueError(f"block {block}: dist_panel takes panels of "
                         f"{cuda_ldlt.DIST_PANEL_BLOCKS} columns")
    G = n // block
    nloc = n // nproc
    spp = nloc // block
    lidx = np.arange(nloc)
    gcol = (rank + (lidx // block) * nproc) * block + lidx % block
    gcol_t = torch.as_tensor(gcol, device=group.device)

    def factor(A_loc: torch.Tensor) -> DistLDLT:
        if A_loc.shape != (n, nloc):
            raise ValueError(f"A_loc {tuple(A_loc.shape)}: expected ({n}, {nloc})")
        # uno_tpu's trailing products are exact float32; TF32 would break that
        assert not (A_loc.is_cuda and torch.backends.cuda.matmul.allow_tf32), \
            "torch.backends.cuda.matmul.allow_tf32 must stay False"
        work = A_loc.clone(memory_format=torch.contiguous_format)
        d_full = work.new_zeros(n)
        buf = work.new_empty((n + 1) * block)
        for g in range(G):
            owner, slot, row0 = g % nproc, g // nproc, g * block
            msg = buf[:(n - row0 + 1) * block].view(n - row0 + 1, block)
            if rank == owner:
                dpan = panel_factor(work, slot * block, row0, block)
                msg[:n - row0] = work[row0:, slot * block:(slot + 1) * block]
                msg[n - row0] = dpan
            group.broadcast(msg, src=owner)
            panel, dpan = msg[:n - row0], msg[n - row0]
            d_full[row0:row0 + block] = dpan
            # trailing update of this rank's columns in panels > g, rows
            # below the panel: one matmul
            first = max(0, -(-(g + 1 - rank) // nproc))      # first local slot past g
            r1 = row0 + block
            if first < spp and r1 < n:
                cols = slice(first * block, nloc)
                prow = panel.index_select(0, gcol_t[cols] - row0)
                work[r1:, cols] -= (panel[block:] * dpan) @ prow.T
        pos, neg, zero = _inertia(d_full, zero_pivot_rtol)
        return DistLDLT(work, d_full, pos, neg, zero)

    def solve(fac: DistLDLT, rhs: torch.Tensor) -> torch.Tensor:
        L_loc, d_full = fac.L_cyc, fac.d
        y = rhs.clone()
        change = y.new_empty(n)
        # forward: (I + strict_lower(L)) y = rhs, panels left to right
        for g in range(G):
            owner, slot, r0 = g % nproc, g // nproc, g * block
            r1 = r0 + block
            delta = change[:n - r0]
            if rank == owner:
                pnl = L_loc[:, slot * block:(slot + 1) * block]
                y_blk = torch.linalg.solve_triangular(
                    pnl[r0:r1], y[r0:r1, None], upper=False, unitriangular=True)[:, 0]
                delta[:block] = 0.0 - (y_blk - y[r0:r1])
                delta[block:] = pnl[r1:] @ y_blk
            group.broadcast(delta, src=owner)
            y[r0:] = y[r0:] - delta
        x = y / _safe(d_full)
        # backward: (I + strict_lower(L))^T x = y / d, panels right to left
        step = change[:block]
        for g in reversed(range(G)):
            owner, slot, r0 = g % nproc, g // nproc, g * block
            r1 = r0 + block
            if rank == owner:
                pnl = L_loc[:, slot * block:(slot + 1) * block]
                x_blk = x[r0:r1] - pnl[r1:].T @ x[r1:]
                x_blk = torch.linalg.solve_triangular(
                    pnl[r0:r1].T, x_blk[:, None], upper=True, unitriangular=True)[:, 0]
                step.copy_(x_blk - x[r0:r1])
            group.broadcast(step, src=owner)
            x[r0:r1] = x[r0:r1] + step
        return x

    return factor, solve, cyclic_permutation(n, nproc, block)


def make_dist_kkt_backend(group, n_kkt: int, block: int = 64,
                          zero_pivot_rtol: float = 1e-32):
    """The IPM's KKT backend (factorize, solve) over the group, with the
    contract of the dense factorizer and ldlt_solve on a batch of one:
    factorize(A (1, n_kkt, n_kkt)) -> DistLDLT with a leading axis of one,
    solve(fac, rhs (1, n_kkt)) -> (1, n_kkt).  Pads to a multiple of
    P * block with a +1 identity tail (its pivots are taken out of the
    inertia) and applies the block-cyclic permutation inside, so callers
    pass the matrix and the right-hand side in global order.  The matrix is
    assembled on every rank; this backend spreads the O(n^3) work of the
    factorization, not the O(n^2) memory of the assembly."""
    unit = group.size * block
    n_pad = -(-max(n_kkt, 1) // unit) * unit
    pad = n_pad - n_kkt
    factor_p, solve_p, perm = make_dist_ldlt(group, n_pad, block, zero_pivot_rtol)
    lo, hi = group.local_range(n_pad)
    local_cols = torch.as_tensor(perm[lo:hi], device=group.device)

    def factorize(A: torch.Tensor) -> DistLDLT:
        if A.dim() != 3 or A.shape[0] != 1 or A.shape[1:] != (n_kkt, n_kkt):
            raise ValueError(f"the distributed backend factors one ({n_kkt}, "
                             f"{n_kkt}) matrix, a batch of one; got {tuple(A.shape)}")
        A = A[0]
        if pad:
            A = torch.nn.functional.pad(A, (0, pad, 0, pad))
            A.diagonal()[n_kkt:] = 1.0
        fac = factor_p(A.index_select(1, local_cols))
        return DistLDLT(fac.L_cyc[None], fac.d[None], (fac.num_pos - pad)[None],
                        fac.num_neg[None], fac.num_zero[None])

    def solve(fac: DistLDLT, rhs: torch.Tensor) -> torch.Tensor:
        r = rhs[0]
        if pad:
            r = torch.nn.functional.pad(r, (0, pad))
        x = solve_p(DistLDLT(*(t[0] for t in fac)), r)
        return x[:n_kkt][None]

    return factorize, solve
