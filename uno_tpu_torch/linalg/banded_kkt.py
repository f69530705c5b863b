"""Structured (banded) condensed KKT backend for the interior-point method,
batched.

Counterpart of uno_tpu/linalg/banded_kkt.py.  The model declares a banded
Lagrangian Hessian and windowed Jacobian rows (model/nlp.NLPStructure).
The IPM's augmented system over (x0, s, w), x0 the structural variables, s
the inequality slacks (homogenize) and w the dual step, is

    [ B     0     J0^T ] [dx0]   [r0]      B  = H00 + Sigma_0 + delta I
    [ 0   sig_s  -E^T  ] [ds ] = [rs]      sig_s = Sigma_s + delta
    [ J0   -E    -C    ] [ w ]   [rc]      C  = D_e + eps

Slack k of row i enters only through E[i, k] = 1, so it eliminates
analytically:
    ds = (rs + E^T w) / sig_s
    w  = (J0 dx0 - rc') / denom,   rc' = rc + E (rs / sig_s),
                                   denom = C + E sig_s^{-1} E^T + tau
    M dx0 = r0 + J0^T (rc' / denom),  M = B + J0^T diag(1/denom) J0
M has half-bandwidth max(hess_bw, jac_width - 1) and is positive definite
exactly when the augmented matrix has inertia (n, m, 0), so the
block-tridiagonal Cholesky (linalg/banded.py) is the inertia test.  tau is
the lifted relaxation; the IPM's refinement against the exact augmented
operator (`matvec`) removes its error.

Sums over overlapping windows (J0^T diag J0 and J0^T u) are gathered
segment sums in the order uno_tpu's scatter-add applies them, with no
atomics, so two runs on the card give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uno_tpu_torch.linalg.banded import (CRFactor, band_matvec,
                                         band_to_blocks, btd_cholesky,
                                         btd_cholesky_cr,
                                         btd_solve, btd_solve_cr,
                                         pick_block_size)

# uno_tpu's switch from the sweep to cyclic reduction, in blocks (measured
# on TPU v5e; kept because the route decides the rounding of the factors)
CR_MIN_BLOCKS = 64

# factorizations and solves since the last reset_counts(), summed over the
# batch's calls: what shows that a solve went through this backend
counts = {"factorizations": 0, "solves": 0}


def reset_counts() -> None:
    counts.update(factorizations=0, solves=0)



class BandedKKT(NamedTuple):
    """The assembled structured KKT, batched; every leaf a tensor with the
    batch as its leading axis."""
    H_band: torch.Tensor     # (B, bh+1, n0) Lagrangian Hessian band
    diag0: torch.Tensor      # (B, n0) Sigma_0 + prox + delta
    sig_s: torch.Tensor      # (B, ns) slack diagonal Sigma_s + prox_s + delta
    J_local: torch.Tensor    # (B, m, w) windowed Jacobian rows
    C: torch.Tensor          # (B, m) dual diagonal D_e + eps


class BandedKKTFactor(NamedTuple):
    btd: object              # BTDFactor (sweep) or CRFactor (cyclic reduction)
    kkt: BandedKKT           # kept for the back-out
    denom: torch.Tensor      # (B, m) C + E sig_s^{-1} E^T + tau
    num_pos: torch.Tensor    # (B,) inertia: (n_full, m, 0) on success
    num_neg: torch.Tensor
    num_zero: torch.Tensor


class SegmentSum:
    """out[:, j] = the sum of src[:, k] over the k with targets[k] == j,
    added one after another in the order of k, as a scatter-add applies
    them: a gather into (size, width) slots and `width` adds, no atomics.
    Targets outside [0, size) are dropped."""

    def __init__(self, targets, size: int):
        targets = np.asarray(targets, dtype=np.int64).reshape(-1)
        k = np.arange(targets.size)
        keep = (targets >= 0) & (targets < size)
        t, k = targets[keep], k[keep]
        order = np.argsort(t, kind="stable")
        t, k = t[order], k[order]
        per_target = np.bincount(t, minlength=size)
        self.width = max(int(per_target.max(initial=0)), 1)
        first = np.concatenate([[0], np.cumsum(per_target)[:-1]])
        idx = np.full((size, self.width), targets.size, dtype=np.int64)
        idx[t, np.arange(t.size) - first[t]] = k
        self.idx = idx
        self._cache: dict = {}

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        """src (B, K) -> (B, size)."""
        idx = self._cache.get(src.device)
        if idx is None:
            idx = self._cache[src.device] = torch.as_tensor(self.idx, device=src.device)
        g = torch.nn.functional.pad(src, (0, 1))[:, idx]     # slot K holds 0
        out = torch.zeros_like(g[..., 0])
        for r in range(self.width):
            out = out + g[..., r]
        return out


class Windows:
    """The static geometry of (m, w) windowed Jacobian rows over n0
    columns: the column of each (row, offset), and the segment sums of
    J0^T-type products, by column and by band diagonal."""

    def __init__(self, starts_np: np.ndarray, w: int, n0: int, bw: int):
        starts = np.asarray(starts_np, dtype=np.int64)
        cols = starts[:, None] + np.arange(w)[None]
        self.cols = np.clip(cols, 0, max(n0 - 1, 0))
        self.mtv = SegmentSum(cols, n0)
        # band diagonal d: entries (row = start+t+d, col = start+t)
        self.diag = [SegmentSum(starts[:, None] + np.arange(w - d)[None], n0)
                     for d in range(min(w, bw + 1))]
        self._cache: dict = {}

    def col_index(self, device):
        t = self._cache.get(device)
        if t is None:
            t = self._cache[device] = torch.as_tensor(self.cols, device=device)
        return t


def jtdj_band(J_local, win: Windows, dinv, bw: int, n0: int):
    """J0^T diag(dinv) J0 in (B, bw+1, n0) lower-band storage."""
    B, m, w = J_local.shape
    band = J_local.new_zeros((B, bw + 1, n0))
    if m == 0:
        return band
    JD = J_local * dinv[..., None]
    for d in range(min(w, bw + 1)):
        # entries (row = start+t+d, col = start+t): J[i, t+d] * J[i, t]
        vals = JD[:, :, d:] * J_local[:, :, : w - d]
        band[:, d] = win.diag[d](vals.reshape(B, -1))
    return band


def win_mv(J_local, win: Windows, v):
    """J0 @ v from the windowed rows."""
    if J_local.shape[1] == 0:
        return v.new_zeros((v.shape[0], 0))
    return torch.sum(J_local * v[:, win.col_index(v.device)], dim=-1)


def win_mtv(J_local, win: Windows, u, n0: int):
    """J0^T @ u from the windowed rows."""
    B, m, w = J_local.shape
    if m == 0:
        return u.new_zeros((B, n0))
    return win.mtv((J_local * u[..., None]).reshape(B, -1))


def dense_from_windows(J_local, starts_np, n: int, slack_cols_np):
    """The dense (B, m, n) Jacobian: the x0 windows and the slack columns
    (coefficient -1), for the parts of the IPM that take a plain matrix
    (rhs, line search, residuals).  A row's window columns are distinct, so
    the scatter has no repeated target."""
    B, m, w = J_local.shape
    J = J_local.new_zeros((B, m, n))
    if m == 0:
        return J
    dev = J_local.device
    rows = torch.as_tensor(np.repeat(np.arange(m), w), device=dev)
    cols = torch.as_tensor((np.asarray(starts_np)[:, None]
                            + np.arange(w)[None]).reshape(-1), device=dev)
    J[:, rows, cols] = J_local.reshape(B, -1)
    has = slack_cols_np >= 0
    if np.any(has):
        r = torch.as_tensor(np.nonzero(has)[0], device=dev)
        c = torch.as_tensor(slack_cols_np[has], device=dev)
        J[:, r, c] = -1.0
    return J


def make_banded_kkt_backend(n_full: int, n0: int, m: int,
                            starts_np: np.ndarray,
                            slack_of_constraint: np.ndarray,
                            hess_bw: int, jac_w: int,
                            tau: float = 1e-8):
    """(factorize, solve, matvec) over batched BandedKKT objects.

    slack_of_constraint: (m,) column (in the full variable vector) of each
    row's slack, -1 for none.  The solution is laid out as the dense
    backends' [dx_full, w] with dy = -w."""
    ns = n_full - n0
    bw = max(hess_bw, max(jac_w - 1, 0)) if m else hess_bw
    nb = pick_block_size(bw)
    has_slack = slack_of_constraint >= 0
    # slack k (columns n0..n_full in order) belongs to row slack_row[k]
    order = np.argsort(slack_of_constraint[has_slack], kind="stable")
    slack_row_np = np.nonzero(has_slack)[0][order]
    assert np.array_equal(np.sort(slack_of_constraint[has_slack]),
                          np.arange(n0, n_full)), \
        "slack columns must be contiguous after x0"
    win = Windows(starts_np, jac_w, n0, bw) if m else None
    rows_cache: dict = {}

    def slack_rows(device):
        t = rows_cache.get(device)
        if t is None:
            t = rows_cache[device] = torch.as_tensor(slack_row_np, device=device)
        return t

    def scatter_slack(vals_k):
        """(B, ns) per-slack values -> (B, m) per row, 0 where no slack."""
        out = vals_k.new_zeros((vals_k.shape[0], m))
        if ns:
            out[:, slack_rows(vals_k.device)] = vals_k
        return out

    def gather_slack(vals_m):
        return vals_m[:, slack_rows(vals_m.device)]

    def factorize(kkt: BandedKKT) -> BandedKKTFactor:
        counts["factorizations"] += 1
        B = kkt.H_band.shape[0]
        if m:
            W = scatter_slack(1.0 / kkt.sig_s)
            denom = kkt.C + W + tau
            band = jtdj_band(kkt.J_local, win, 1.0 / denom, bw, n0)
        else:
            denom = kkt.C.new_zeros((B, 0))
            band = kkt.H_band.new_zeros((B, bw + 1, n0))
        band[:, : kkt.H_band.shape[1]] += kkt.H_band
        band[:, 0] += kkt.diag0
        D, E = band_to_blocks(band, nb)
        btd = btd_cholesky_cr(D, E) if D.shape[1] >= CR_MIN_BLOCKS \
            else btd_cholesky(D, E)
        ok = btd.num_zero == 0
        pos = torch.where(ok, n_full, 0)
        return BandedKKTFactor(btd=btd, kkt=kkt, denom=denom, num_pos=pos,
                               num_neg=torch.where(ok, m, 0),
                               num_zero=torch.where(ok, 0, n_full + m))

    def solve(fac: BandedKKTFactor, rhs):
        counts["solves"] += 1
        kkt = fac.kkt
        r0, rs, rc = rhs[:, :n0], rhs[:, n0:n_full], rhs[:, n_full:]
        if m:
            rc1 = rc + scatter_slack(rs / kkt.sig_s) if ns else rc
            b = r0 + win_mtv(kkt.J_local, win, rc1 / fac.denom, n0)
        else:
            rc1, b = rc, r0
        solve_fn = btd_solve_cr if isinstance(fac.btd, CRFactor) else btd_solve
        dx0 = solve_fn(fac.btd, b)
        if m:
            w = (win_mv(kkt.J_local, win, dx0) - rc1) / fac.denom
            ds = (rs + gather_slack(w)) / kkt.sig_s if ns else rs
        else:
            w, ds = rc, rs
        return torch.cat([dx0, ds, w], dim=-1)

    def matvec(kkt: BandedKKT, sol):
        """The exact augmented operator A @ [dz; w] (the dense assembly's
        matrix), for the refinement."""
        dx0, ds, w = sol[:, :n0], sol[:, n0:n_full], sol[:, n_full:]
        out0 = band_matvec(kkt.H_band, dx0) + kkt.diag0 * dx0
        if m:
            out0 = out0 + win_mtv(kkt.J_local, win, w, n0)
        outs = kkt.sig_s * ds - gather_slack(w) if ns else ds[:, :0]
        if m:
            outc = win_mv(kkt.J_local, win, dx0) - scatter_slack(ds) - kkt.C * w
        else:
            outc = w[:, :0]
        return torch.cat([out0, outs, outc], dim=-1)

    return factorize, solve, matvec
