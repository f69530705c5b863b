"""Banded symmetric linear algebra: block-tridiagonal Cholesky, batched.

Counterpart of uno_tpu/linalg/banded.py.  A banded matrix (half-bandwidth
b, dim n) is cut into blocks of size nb > b, which makes it
block-tridiagonal:

    A = [D_0  E_0^T           ]
        [E_0  D_1   E_1^T     ]      N = ceil(n / nb) blocks
        [      E_1  D_2   ... ]

and factored either by a sequential sweep over the N blocks (one nb x nb
Cholesky, one triangular solve and one matmul each: `btd_cholesky`) or by
cyclic reduction, log2 N levels of batched Cholesky, triangular solves and
matmuls (`btd_cholesky_cr`).  Every tensor carries a leading batch axis;
the single instance is the batch of one.

Positive definiteness is the inertia test: a failed Cholesky in any block,
or any level, fails the whole factorization, which reports num_zero = N*nb
and drives the regularization loop.  `torch.linalg.cholesky_ex` leaves a
finite partial factor where jnp's Cholesky leaves NaN, so failure is read
off its `info` and the factor's finiteness; the input is symmetrized as
jnp's Cholesky does.

Band storage is lower, band[:, d, j] = A[j + d, j] for d in [0, b];
columns beyond n are padded to N*nb with a unit diagonal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def pick_block_size(bandwidth: int) -> int:
    """The smallest multiple of 8 strictly above the half-bandwidth, as
    band_to_blocks requires (uno_tpu's rule, kept because the block size
    decides the route)."""
    return (int(bandwidth) // 8 + 1) * 8


def _sym(A):
    """(A + A^T) / 2, the symmetrization jnp's Cholesky applies."""
    return (A + A.transpose(-1, -2)) / 2


def _cholesky(A):
    """(factor, ok): the Cholesky factor of sym(A) and whether it
    succeeded (info == 0 and every entry finite), per matrix."""
    L, info = torch.linalg.cholesky_ex(_sym(A))
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
    return L, ok


def _trsm(L, X, upper=False):
    return torch.linalg.solve_triangular(L, X, upper=upper)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def band_matvec(band: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Symmetric banded matvec: band (B, b+1, n) lower storage, v (B, n)."""
    b = band.shape[-2] - 1
    n = band.shape[-1]
    out = band[:, 0] * v
    for d in range(1, b + 1):
        # A[j+d, j] couples v[j] -> out[j+d] and v[j+d] -> out[j]
        lo = band[:, d, : n - d]
        out[:, d:] += lo * v[:, : n - d]
        out[:, : n - d] += lo * v[:, d:]
    return out


class BTDFactor(NamedTuple):
    """Block-tridiagonal Cholesky factor, batched.

    L:  (B, N, nb, nb) lower-triangular diagonal blocks (0 where failed)
    Ct: (B, N, nb, nb), Ct[:, i] = L_i^{-1} E_i^T
    num_pos/num_neg/num_zero: (B,) inertia (N*nb, 0, 0) on success,
        (0, 0, N*nb) on failure"""
    L: torch.Tensor
    Ct: torch.Tensor
    num_pos: torch.Tensor
    num_neg: torch.Tensor
    num_zero: torch.Tensor


def _counts(ok, n_dim):
    pos = torch.where(ok, n_dim, 0)
    return pos, torch.zeros_like(pos), n_dim - pos


def band_to_blocks(band: torch.Tensor, nb: int):
    """(B, b+1, n) lower band -> (D, E), both (B, N, nb, nb): the diagonal
    blocks and the subdiagonal blocks E[:, i] = A[(i+1)nb:(i+2)nb,
    i nb:(i+1)nb] (E[:, N-1] is zero).  Padded columns get a unit
    diagonal.  The blocks are gathered from T[d, i, c] = band[d, i nb + c]:
    D[i][r, c] = band[r-c, i nb + c] (0 <= r-c <= b) and E[i][r, c] =
    band[nb+r-c, i nb + c] (nb+r-c <= b)."""
    B, b1, n = band.shape
    b = b1 - 1
    assert b < nb, f"bandwidth {b} must be < block size {nb}"
    N = -(-n // nb)
    n_pad = N * nb
    if n_pad > n:
        pad = band.new_zeros((B, b + 1, n_pad - n))
        pad[:, 0] = 1.0
        band = torch.cat([band, pad], dim=-1)
    Tp = band.reshape(B, b + 1, N, nb).permute(0, 2, 1, 3)   # (B, N, b+1, nb)
    r = np.arange(nb)[:, None]
    c = np.arange(nb)[None, :]

    def place(offsets, blocks):
        valid = (offsets >= 0) & (offsets <= b)
        idx = torch.as_tensor(np.where(valid, offsets, 0), device=band.device)
        out = torch.gather(blocks, 2, idx.expand(B, blocks.shape[1], nb, nb))
        return torch.where(torch.as_tensor(valid, device=band.device), out, 0.0)

    Dl = place(r - c, Tp)
    D = Dl + torch.triu(Dl.transpose(-1, -2), 1)
    E = band.new_zeros((B, N, nb, nb))
    if N > 1:
        E[:, :-1] = place(nb + r - c, Tp[:, :-1])
    return D, E


def btd_cholesky(D: torch.Tensor, E: torch.Tensor) -> BTDFactor:
    """Cholesky of the block-tridiagonal (D, E) by a sweep over the N
    blocks; a failure in any block fails the factorization."""
    B, N, nb, _ = D.shape
    Ssub = D.new_zeros((B, nb, nb))                 # C_{i-1} C_{i-1}^T
    ok = torch.ones(B, dtype=torch.bool, device=D.device)
    Ls, Cts = [], []
    for i in range(N):
        L_i, ok_i = _cholesky(D[:, i] - Ssub)
        ok = ok & ok_i
        Ct_i = _trsm(L_i, E[:, i].transpose(-1, -2))
        Ssub = Ct_i.transpose(-1, -2) @ Ct_i
        Ls.append(L_i)
        Cts.append(Ct_i)
    L = torch.stack(Ls, 1)
    return BTDFactor(torch.where(ok[:, None, None, None], L, 0.0),
                     torch.stack(Cts, 1), *_counts(ok, N * nb))


def _pad_rhs(rhs, n_pad):
    n = rhs.shape[-1]
    return torch.nn.functional.pad(rhs, (0, n_pad - n)) if n_pad > n else rhs


def btd_solve(fac: BTDFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A x = rhs (B, n) with the sweep's factor."""
    B, N, nb, _ = fac.L.shape
    n = rhs.shape[-1]
    rb = _pad_rhs(rhs, N * nb).reshape(B, N, nb)
    # forward: L_i y_i = r_i - C_{i-1} y_{i-1}, C_{i-1} = Ct_{i-1}^T
    y_prev = rhs.new_zeros((B, nb))
    ys = []
    for i in range(N):
        r_i = rb[:, i] if i == 0 else \
            rb[:, i] - _mv(fac.Ct[:, i - 1].transpose(-1, -2), y_prev)
        y_prev = _trsm(fac.L[:, i], r_i[..., None])[..., 0]
        ys.append(y_prev)
    # backward: L_i^T x_i = y_i - Ct_i x_{i+1}
    x_next = rhs.new_zeros((B, nb))
    xs = [None] * N
    for i in range(N - 1, -1, -1):
        t = ys[i] - _mv(fac.Ct[:, i], x_next)
        x_next = _trsm(fac.L[:, i].transpose(-1, -2), t[..., None], upper=True)[..., 0]
        xs[i] = x_next
    return torch.stack(xs, 1).reshape(B, -1)[:, :n]


def band_cholesky_solve(band, rhs, nb: int):
    """Factor and solve in one call (tests, one-shot uses)."""
    D, E = band_to_blocks(band, nb)
    fac = btd_cholesky(D, E)
    return btd_solve(fac, rhs), fac


# ---------------------------------------------------------------------------
# block cyclic reduction: log2 N levels
# ---------------------------------------------------------------------------

class CRFactor(NamedTuple):
    """Cyclic-reduction factorization of an SPD block-tridiagonal matrix.

    levels: per level a tuple (Co, M1, M2, Lo, LT_next) of (B, N_l/2, nb,
        nb) tensors: the odd blocks' Cholesky factors (0 where failed) and
        the reduction operators; top_chol (B, nb, nb) the last block's
        factor.  num_pos/num_neg/num_zero as BTDFactor's."""
    levels: tuple
    top_chol: torch.Tensor
    num_pos: torch.Tensor
    num_neg: torch.Tensor
    num_zero: torch.Tensor


def _swapT(A):
    return A.transpose(-1, -2)


def _chol_solve_b(chol, X):
    """Batched D^{-1} X through the Cholesky factor of D."""
    return _trsm(_swapT(chol), _trsm(chol, X), upper=True)


def btd_cholesky_cr(D: torch.Tensor, E: torch.Tensor) -> CRFactor:
    """Cyclic reduction of the SPD block-tridiagonal (D, E) (btd_cholesky's
    inputs).  Per level, with L[i] coupling row i to x_{i-1}, odd blocks
    2k+1 and even blocks 2k:
      M1_k = L_{2k} D_{2k-1}^{-1} (0 for k = 0),  M2_k = L_{2k+1}^T D_{2k+1}^{-1}
      D'_k = D_{2k} - M1_k L_{2k}^T - M2_k L_{2k+1},  L'_k = -M1_k L_{2k-1}
    eliminating every odd block at once."""
    B, N, nb, _ = D.shape
    n_dim = N * nb
    N2 = 1 << max((N - 1).bit_length(), 1)
    if N2 != N:
        pad = N2 - N
        eye = torch.eye(nb, dtype=D.dtype, device=D.device).expand(B, pad, nb, nb)
        D = torch.cat([D, eye], 1)
        E = torch.cat([E, E.new_zeros((B, pad, nb, nb))], 1)
    zero_blk = D.new_zeros((B, 1, nb, nb))
    L = torch.cat([zero_blk, E[:, :-1]], 1)
    levels = []
    ok = torch.ones(B, dtype=torch.bool, device=D.device)
    Ncur = N2
    while Ncur > 1:
        De, Do = D[:, 0::2], D[:, 1::2]
        Le, Lo = L[:, 0::2], L[:, 1::2]
        Co, ok_blk = _cholesky(Do)
        ok = ok & ok_blk.all(1)
        Co_safe = torch.where(ok_blk[..., None, None] & torch.isfinite(Co), Co, 0.0)
        M1_tail = _swapT(_chol_solve_b(Co_safe[:, :-1], _swapT(Le[:, 1:])))
        M1 = torch.cat([zero_blk, M1_tail], 1)
        M2 = _swapT(_chol_solve_b(Co_safe, Lo))
        D_new = De - M1 @ _swapT(Le) - M2 @ Lo
        Lo_shift = torch.cat([zero_blk, Lo[:, :-1]], 1)
        L_new = -M1 @ Lo_shift
        # back-substitution data: x_odd needs L_{o+1}^T = Le[k+1]^T
        LT_next = _swapT(torch.cat([Le[:, 1:], zero_blk], 1))
        levels.append((Co_safe, M1, M2, Lo, LT_next))
        D, L = D_new, L_new
        Ncur //= 2
    top, ok_top = _cholesky(D[:, 0])
    ok = ok & ok_top
    top = torch.where(ok_top[:, None, None] & torch.isfinite(top), top, 0.0)
    return CRFactor(tuple(levels), top, *_counts(ok, n_dim))


def btd_solve_cr(fac: CRFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A x = rhs (B, n) with the cyclic-reduction factor."""
    B, nb = fac.top_chol.shape[0], fac.top_chol.shape[-1]
    n = rhs.shape[-1]
    N2 = 1 << len(fac.levels)
    r = _pad_rhs(rhs, N2 * nb).reshape(B, -1, nb)
    zero_row = rhs.new_zeros((B, 1, nb))
    # forward: r'_k = r_{2k} - M1_k r_{2k-1} - M2_k r_{2k+1}
    saved = []
    for (Co, M1, M2, Lo, LT_next) in fac.levels:
        ro, re = r[:, 1::2], r[:, 0::2]
        saved.append(ro)
        ro_prev = torch.cat([zero_row, ro[:, :-1]], 1)
        r = re - _mv(M1, ro_prev) - _mv(M2, ro)
    x = _chol_solve_b(fac.top_chol, r[:, 0][..., None])[..., 0]
    xs = x[:, None, :]
    # backward: the odd unknowns, level by level in reverse
    for (Co, M1, M2, Lo, LT_next), ro in zip(reversed(fac.levels), reversed(saved)):
        x_next = torch.cat([xs[:, 1:], zero_row], 1)
        t = ro - _mv(Lo, xs) - _mv(LT_next, x_next)
        x_odd = _chol_solve_b(Co, t[..., None])[..., 0]
        xs = torch.stack([xs, x_odd], dim=2).reshape(B, -1, nb)
    return xs.reshape(B, -1)[:, :n]
