"""General static-sparsity supernodal LDL^T with exact inertia, batched.

Counterpart of uno_tpu/linalg/sparse_ldlt.py.

* The symbolic phase is uno_tpu's numpy, copied: a minimum-degree ordering
  of the KKT graph in which a zero-diagonal dual row is eliminated only
  after one of its neighbours (so its pivot has had a Schur update), the
  symbolic Cholesky, supernodes amalgamated under a padding budget and a
  static update schedule (`build_plan`, `SparsePlan`).  Its arrays equal
  uno_tpu's.
* The numeric phase is torch operations on the tensors' device, in
  uno_tpu's order, a host loop over the supernodes: gather the panel from
  the permuted matrix, subtract the updates of the earlier supernodes in
  one batched einsum, factor the panel by its rank-1 steps; the solve is a
  forward and a backward sweep over the supernodes.  Loops skip the
  padding uno_tpu's static scan carries (the dummy updaters and the
  inactive columns), whose terms are zero.  The inertia is read off the
  pivots by `linalg.ldlt._inertia` (rtol 1e-32, `_safe` 1e-35), the dense
  backends' contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from uno_tpu_torch.linalg.ldlt import _inertia, _safe

# factorizations and solves since the last reset_counts(), summed over the
# batch's calls: what shows that a solve went through this backend
counts = {"factorizations": 0, "solves": 0}


def reset_counts() -> None:
    counts.update(factorizations=0, solves=0)



# ---------------------------------------------------------------------------
# symbolic phase (host, numpy, once per structure)
# ---------------------------------------------------------------------------

def minimum_degree(pattern: np.ndarray, eliminate_late=None) -> np.ndarray:
    """Minimum-degree ordering of the graph of `pattern` (N, N bool).

    eliminate_late: optional (N,) bool — nodes that may only be eliminated
    after receiving at least one Schur update from an eliminated neighbor
    (zero-structural-diagonal dual rows; see module docstring).  Returns
    perm with the usual convention: permuted node k is original perm[k].

    Dense-matrix quotient-free variant: adequate for KKT dimensions up to a
    few thousand, runs once per problem structure.
    """
    A = np.asarray(pattern, dtype=bool)
    A = A | A.T
    np.fill_diagonal(A, False)
    N = A.shape[0]
    late = (np.zeros(N, dtype=bool) if eliminate_late is None
            else np.asarray(eliminate_late, dtype=bool).copy())
    alive = np.ones(N, dtype=bool)
    updated = np.zeros(N, dtype=bool)
    deg = A.sum(axis=1).astype(np.int64)
    order = np.empty(N, dtype=np.int64)
    for k in range(N):
        elig = alive & (~late | updated)
        cand = np.nonzero(elig)[0]
        if cand.size == 0:
            cand = np.nonzero(alive)[0]  # isolated late nodes: last resort
        i = cand[np.argmin(deg[cand])]
        order[k] = i
        alive[i] = False
        nb = np.nonzero(A[i] & alive)[0]
        if nb.size:
            # eliminate i: neighbors form a clique
            A[np.ix_(nb, nb)] = True
            A[nb, nb] = False
            A[nb, i] = False
            A[i, nb] = False
            updated[nb] = True
            deg[nb] = A[nb][:, alive].sum(axis=1)
    return order


def _symbolic_cholesky(pattern_perm: np.ndarray):
    """Exact symbolic factorization of the permuted pattern.

    Returns a list of sorted numpy arrays: below-diagonal row structure of
    each column of L (column-merge algorithm: struct(L_j) accumulates into
    its elimination-tree parent min(struct(L_j)))."""
    N = pattern_perm.shape[0]
    A = pattern_perm | pattern_perm.T
    cols = [set(np.nonzero(A[j + 1:, j])[0] + j + 1) for j in range(N)]
    for j in range(N):
        s = cols[j]
        if s:
            parent = min(s)
            cols[parent] |= s - {parent}
    return [np.array(sorted(s), dtype=np.int64) for s in cols]


@dataclass(frozen=True)
class SparsePlan:
    """Static supernodal elimination plan (all numpy, host-resident)."""
    N: int
    w_max: int              # supernode width cap (panel column count)
    r_max: int              # panel row count = w_max + max below-rows
    u_max: int              # max updaters of any supernode
    perm: np.ndarray        # (N,) permuted k holds original perm[k]
    iperm: np.ndarray       # (N,) inverse
    col_start: np.ndarray   # (K,) first permuted column of supernode s
    width: np.ndarray       # (K,) actual width
    col_ids: np.ndarray     # (K, w_max) permuted col ids, sentinel N
    row_ids: np.ndarray     # (K, r_max) permuted row ids (diag rows first,
                            # then below rows), sentinel N
    upd_t: np.ndarray       # (K, u_max) updater supernode id, dummy K
    upd_selI: np.ndarray    # (K, u_max, r_max) row-position map into the
                            # updater's padded panel rows, dummy r_max
    upd_selJ: np.ndarray    # (K, u_max, w_max) col-position map, dummy r_max
    nnz_factor: int         # true |L| (for cost reporting)
    padded_cells: int       # sum of padded panel cells

    @property
    def num_supernodes(self) -> int:
        return self.col_start.shape[0]

    def padded_flops(self) -> float:
        """Scheduled (padded) flop estimate of one numeric factorization."""
        K = self.num_supernodes
        upd = 2.0 * K * self.u_max * self.r_max * self.w_max * self.w_max
        panel = 2.0 * K * self.w_max * self.r_max * self.w_max
        return upd + panel

    def dense_flops(self) -> float:
        return self.N ** 3 / 3.0 * 2.0


def build_plan(pattern: np.ndarray, is_dual=None, w_cap: int = 16,
               amalgamation_waste: float = 0.35) -> SparsePlan:
    """Symbolic analysis: ordering + fill + supernodes + update schedule.

    pattern: (N, N) bool KKT sparsity (diagonal assumed present).
    is_dual: (N,) bool — zero-structural-diagonal rows (constraint duals).
    """
    N = pattern.shape[0]
    perm = minimum_degree(pattern, is_dual)
    iperm = np.empty(N, dtype=np.int64)
    iperm[perm] = np.arange(N)
    pp = pattern[np.ix_(perm, perm)]
    Lcols = _symbolic_cholesky(pp)
    nnz_factor = int(sum(len(c) for c in Lcols) + N)

    # fundamental supernodes: columns j, j+1 merge when
    # struct(L_j) == {j+1} ∪ struct(L_{j+1})
    bounds = [0]
    for j in range(1, N):
        prev, cur = Lcols[j - 1], Lcols[j]
        fundamental = (prev.size == cur.size + 1 and prev.size > 0
                       and prev[0] == j and np.array_equal(prev[1:], cur))
        if not fundamental or (j - bounds[-1]) >= w_cap:
            bounds.append(j)
    bounds.append(N)
    sn = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]

    def below(snode):
        a, b = snode
        rows = set()
        for j in range(a, b):
            rows.update(Lcols[j].tolist())
        return np.array(sorted(r for r in rows if r >= b), dtype=np.int64)

    # greedy amalgamation of consecutive supernodes under a waste budget
    merged = [sn[0]]
    for cur in sn[1:]:
        a0, b0 = merged[-1]
        a1, b1 = cur
        if b1 - a0 <= w_cap:
            r_old = (len(below((a0, b0))) + (b0 - a0)) * (b0 - a0) \
                + (len(below((a1, b1))) + (b1 - a1)) * (b1 - a1)
            rows_m = below((a0, b1))
            r_new = (len(rows_m) + (b1 - a0)) * (b1 - a0)
            # relative waste budget plus an absolute slack: merging tiny
            # supernodes (arrow chains) costs little in padded cells but
            # shortens the sequential sweep over the supernodes, which
            # bounds the numeric phase (one host trip per supernode here)
            if r_new <= max((1.0 + amalgamation_waste) * r_old, r_old + 128):
                merged[-1] = (a0, b1)
                continue
        merged.append(cur)
    sn = merged
    K = len(sn)
    w_max = max(b - a for a, b in sn)
    belows = [below(s) for s in sn]
    b_max = max((b.size for b in belows), default=0)
    r_max = w_max + b_max

    col_start = np.array([a for a, _ in sn], dtype=np.int32)
    width = np.array([b - a for a, b in sn], dtype=np.int32)
    col_ids = np.full((K, w_max), N, dtype=np.int32)
    row_ids = np.full((K, r_max), N, dtype=np.int32)
    # position of permuted row r inside supernode s's padded panel
    pos_of = np.full(N, -1, dtype=np.int64)
    sn_of_col = np.empty(N, dtype=np.int64)
    for s, ((a, b), br) in enumerate(zip(sn, belows)):
        w = b - a
        col_ids[s, :w] = np.arange(a, b)
        row_ids[s, :w] = np.arange(a, b)
        row_ids[s, w_max:w_max + br.size] = br
        sn_of_col[a:b] = s

    # update schedule: supernode t updates s iff some below-row of t is a
    # column of s
    updaters = [[] for _ in range(K)]
    for t in range(K):
        hit = np.unique(sn_of_col[belows[t]])
        for s in hit:
            updaters[int(s)].append(t)
    u_max = max((len(u) for u in updaters), default=0)
    u_max = max(u_max, 1)
    upd_t = np.full((K, u_max), K, dtype=np.int32)
    upd_selI = np.full((K, u_max, r_max), r_max, dtype=np.int32)
    upd_selJ = np.full((K, u_max, w_max), r_max, dtype=np.int32)
    for s in range(K):
        a, b = sn[s]
        for u, t in enumerate(updaters[s]):
            upd_t[s, u] = t
            # below-row r of t sits at padded position w_max + k
            tb = belows[t]
            pos_of[tb] = w_max + np.arange(tb.size)
            rs = row_ids[s]
            valid = rs < N
            sel = np.full(r_max, r_max, dtype=np.int32)
            rr = rs[valid].astype(np.int64)
            in_t = np.isin(rr, tb)
            sel_valid = np.full(rr.shape, r_max, dtype=np.int32)
            sel_valid[in_t] = pos_of[rr[in_t]]
            sel[valid] = sel_valid
            upd_selI[s, u] = sel
            cj = col_ids[s]
            cvalid = cj < N
            selj = np.full(w_max, r_max, dtype=np.int32)
            cc = cj[cvalid].astype(np.int64)
            in_tc = np.isin(cc, tb)
            selj_valid = np.full(cc.shape, r_max, dtype=np.int32)
            selj_valid[in_tc] = pos_of[cc[in_tc]]
            selj[cvalid] = selj_valid
            upd_selJ[s, u] = selj
            pos_of[tb] = -1

    padded_cells = int(K * r_max * w_max)
    # uno_tpu's compact index dtypes, so that the plans are equal array for
    # array: selI/selJ index panel rows (< r_max+1), ids index N+1
    if r_max + 1 < 2 ** 15:
        upd_selI = upd_selI.astype(np.int16)
        upd_selJ = upd_selJ.astype(np.int16)
    if N + 1 < 2 ** 15:
        col_ids = col_ids.astype(np.int16)
        row_ids = row_ids.astype(np.int16)
    return SparsePlan(N=N, w_max=w_max, r_max=r_max, u_max=u_max,
                      perm=perm, iperm=iperm, col_start=col_start,
                      width=width, col_ids=col_ids, row_ids=row_ids,
                      upd_t=upd_t, upd_selI=upd_selI, upd_selJ=upd_selJ,
                      nnz_factor=nnz_factor, padded_cells=padded_cells)




# ---------------------------------------------------------------------------
# numeric phase (torch, on the tensors' device)
# ---------------------------------------------------------------------------

class SparseLDLT(NamedTuple):
    P: torch.Tensor       # (B, K+1, r_max+1, w_max) padded panels: the unit
                          # lower diagonal block and the L rows below it
    dvec: torch.Tensor    # (B, N) pivots in permuted order
    num_pos: torch.Tensor
    num_neg: torch.Tensor
    num_zero: torch.Tensor


class _Schedule:
    """The plan's per-supernode index tensors on one device, trimmed to the
    real rows, columns and updaters."""

    def __init__(self, plan: SparsePlan, device):
        K, N, w_max = plan.num_supernodes, plan.N, plan.w_max
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)  # noqa: E731
        self.perm = as_t(plan.perm)
        self.iperm = as_t(plan.iperm)
        self.steps = []
        for s in range(K):
            wd = int(plan.width[s])
            ts = plan.upd_t[s]
            nu = int(np.sum(ts < K))
            below = np.asarray(plan.row_ids[s][w_max:], dtype=np.int64)
            nbl = int(np.sum(below < N))
            self.steps.append(dict(
                wd=wd, nbl=nbl,
                rids=as_t(plan.row_ids[s]), cids=as_t(plan.col_ids[s]),
                cols=as_t(plan.col_ids[s][:wd]), below=as_t(below[:nbl]),
                ts=as_t(ts[:nu]),
                selI=as_t(plan.upd_selI[s, :nu]),
                selJ=as_t(plan.upd_selJ[s, :nu])))
        cids = np.asarray(plan.col_ids, dtype=np.int64).reshape(-1)
        real = cids < N
        self.d_src = as_t(np.nonzero(real)[0])     # flat (s, j) of real columns
        self.d_dst = as_t(cids[real])


def make_sparse_ldlt(plan: SparsePlan, zero_pivot_rtol: float = 1e-32):
    """(factorize, solve): factorize(K) of the assembled (B, N, N) matrices
    in the ORIGINAL order (the permutation is internal) -> SparseLDLT;
    solve(fac, rhs (B, N)) -> x."""
    N, K = plan.N, plan.num_supernodes
    w_max, r_max = plan.w_max, plan.r_max
    schedules: dict = {}

    def schedule(device):
        sch = schedules.get(device)
        if sch is None:
            sch = schedules[device] = _Schedule(plan, device)
        return sch

    def factorize(Kmat: torch.Tensor) -> SparseLDLT:
        counts["factorizations"] += 1
        sch = schedule(Kmat.device)
        B = Kmat.shape[0]
        Kperm = Kmat[:, sch.perm][:, :, sch.perm]
        Kp = torch.nn.functional.pad(Kperm, (0, 1, 0, 1))  # sentinel N -> 0
        Pbuf = Kmat.new_zeros((B, K + 1, r_max + 1, w_max))
        dbuf = Kmat.new_zeros((B, K + 1, w_max))
        rows = torch.arange(r_max, device=Kmat.device)
        for s, st in enumerate(sch.steps):
            # panel assembly: A at (rows x cols); sentinels hit the zero pad
            F = Kp[:, st["rids"][:, None], st["cids"][None, :]]
            if st["ts"].numel():
                # the updates of the earlier supernodes, one batched einsum
                Pts = Pbuf[:, st["ts"]]                        # (B, u, r+1, w)
                dts = dbuf[:, st["ts"]]                        # (B, u, w)
                u = st["ts"].numel()
                PI = torch.gather(Pts, 2, st["selI"][None, :, :, None]
                                  .expand(B, u, r_max, w_max))
                PJ = torch.gather(Pts, 2, st["selJ"][None, :, :, None]
                                  .expand(B, u, w_max, w_max))
                F = F - torch.einsum("zuaw,zubw->zab", PI * dts[:, :, None, :], PJ)
            # the panel's rank-1 steps (its active columns; uno_tpu's
            # inactive steps leave the zero padding columns as they are)
            d = F.new_zeros((B, w_max))
            for j in range(st["wd"]):
                dj = F[:, j, j]
                col = F[:, :, j]
                l = torch.where(rows > j, col / _safe(dj)[:, None], 0.0)
                F = F - dj[:, None, None] * l[:, :, None] * l[:, None, :w_max]
                l[:, j] = 1.0
                F[:, :, j] = l
                d[:, j] = dj
            Pbuf[:, s, :r_max] = F
            dbuf[:, s] = d
        # the pivots in permuted order: each real column is active in
        # exactly one supernode
        dvec = Kmat.new_zeros((B, N))
        dvec[:, sch.d_dst] = dbuf[:, :K].reshape(B, -1)[:, sch.d_src]
        pos, neg, zero = _inertia(dvec, zero_pivot_rtol)
        return SparseLDLT(P=Pbuf, dvec=dvec, num_pos=pos, num_neg=neg,
                          num_zero=zero)

    def solve(fac: SparseLDLT, rhs: torch.Tensor) -> torch.Tensor:
        counts["solves"] += 1
        sch = schedule(rhs.device)
        dt = rhs.dtype
        b = rhs[:, sch.perm]                                 # a copy
        P_all = fac.P.to(dt)
        # the diagonal block of supernode s is P[:wd, :wd] (unit lower), its
        # L rows below are P[w_max:w_max+nbl, :wd]; the other rows and
        # columns are padding, zero in the factor
        for s, st in enumerate(sch.steps):
            wd, nbl = st["wd"], st["nbl"]
            P = P_all[:, s]
            zc = torch.linalg.solve_triangular(
                P[:, :wd, :wd], b[:, st["cols"], None], upper=False,
                unitriangular=True)[..., 0]
            b[:, st["cols"]] = zc
            if nbl:
                upd = (P[:, w_max:w_max + nbl, :wd] @ zc[..., None])[..., 0]
                b[:, st["below"]] = b[:, st["below"]] - upd
        z = b / _safe(fac.dvec.to(dt))
        for s in range(K - 1, -1, -1):
            st = sch.steps[s]
            wd, nbl = st["wd"], st["nbl"]
            P = P_all[:, s]
            xc = z[:, st["cols"]]
            if nbl:
                xc = xc - (P[:, w_max:w_max + nbl, :wd].transpose(-1, -2)
                           @ z[:, st["below"], None])[..., 0]
            z[:, st["cols"]] = torch.linalg.solve_triangular(
                P[:, :wd, :wd].transpose(-1, -2), xc[..., None], upper=True,
                unitriangular=True)[..., 0]
        return z[:, sch.iperm]

    return factorize, solve
