"""Sparse-KKT backend: the supernodal LDL^T (linalg/sparse_ldlt.py) in the
IPM's kkt_backend seam, and the decision whether to take it.

Counterpart of uno_tpu/linalg/sparse_kkt.py.  The reformulated problem's
Lagrangian-Hessian and Jacobian sparsity is probed at a couple of random
points (structural with probability 1), the augmented-KKT pattern built,
the symbolic analysis run, and the route chosen from the scheduled
(padded) flop count against the dense factorization's:
  * "sparse": the plan is built and its padded flops beat dense by the
    margin; the backend replaces the dense LDL^T in regularize_and_factor
    (the same inertia contract);
  * "dense": the pattern is dense (elec/chandheq-class all-pairs coupling),
    the size is outside the window, or the schedule does not beat dense.
The constants are uno_tpu's: they decide the route and so the iterates.
`last_detection_report` records the last decision.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from uno_tpu_torch.linalg.sparse_ldlt import build_plan, make_sparse_ldlt


@dataclass
class SparseDetectionReport:
    """Why the last solve did or did not take the sparse-KKT path."""
    route: str              # "sparse" | "dense"
    reason: str
    N: int = 0
    density: float = 0.0
    nnz_factor: int = 0
    padded_flops: float = 0.0
    dense_flops: float = 0.0
    num_supernodes: int = 0


# overwritten by every try_make_sparse_kkt_backend call
last_detection_report: Optional[SparseDetectionReport] = None


def probe_kkt_pattern(prob, m: int, samples: int = 2, seed: int = 0):
    """(N, N) bool pattern of the augmented KKT [H+Sigma, J^T; J, -C] of the
    reformulated problem, and the is_dual mask.  The Hessians and Jacobians
    of the `samples` points (x0 + 0.37 N(0, 1), multipliers N(0, 1), from
    default_rng(seed)) are one batch, on the CPU in float64.  Diagonals are
    structural."""
    rng = np.random.default_rng(seed)
    n = prob.n
    x0 = np.asarray(prob.x0, dtype=np.float64)
    xs = torch.as_tensor(x0[None] + 0.37 * rng.standard_normal((samples, n)))
    ys = torch.as_tensor(rng.standard_normal((samples, m)))
    params = None if prob.params is None else torch.as_tensor(
        np.asarray(prob.params), dtype=torch.float64).expand(
            (samples,) + np.shape(prob.params)).contiguous()
    H = prob.lagrangian_hessian(xs, ys, torch.ones(samples, dtype=torch.float64),
                                params)
    hpat = torch.any((H != 0.0) & torch.isfinite(H), dim=0).numpy()
    if m:
        J = prob.constraint_jacobian(xs, params)
        jpat = torch.any((J != 0.0) & torch.isfinite(J), dim=0).numpy()
    hpat = hpat | hpat.T
    N = n + m
    pat = np.zeros((N, N), dtype=bool)
    pat[:n, :n] = hpat
    if m:
        pat[n:, :n] = jpat
        pat[:n, n:] = jpat.T
    np.fill_diagonal(pat, True)
    is_dual = np.zeros(N, dtype=bool)
    is_dual[n:] = True
    return pat, is_dual


def try_make_sparse_kkt_backend(prob, m: int, opts, force: bool = False,
                                max_n: int = 8192,
                                density_cutoff: float = 0.25,
                                flop_margin: float = 0.6,
                                min_n_auto: int = 3072):
    """Probe, analyse, decide: (factorize, solve) over the dense-assembled
    augmented matrices (the IPM keeps its dense assembly and refinement;
    only the factorization and the solve take the supernodal schedule), or
    None for dense.
    force=True (kkt_formulation="sparse") skips the economics and builds
    the backend whenever the dimension allows a plan.  min_n_auto, the
    density cutoff and the flop margin are uno_tpu's (measured on TPU v5e,
    SPARSE_KKT_r05.json); what the H100 measures on each side of them is in
    PERF.md."""
    global last_detection_report
    N = prob.n + m
    if N > max_n:
        last_detection_report = SparseDetectionReport(
            route="dense", reason=f"N={N} above sparse-analysis probe "
            f"range (dense O(N^2) probing)", N=N)
        if force:
            raise ValueError(
                f"kkt_formulation='sparse': KKT dimension {N} above the "
                f"supported probe range (<= {max_n})")
        return None
    if N < min_n_auto and not force:
        last_detection_report = SparseDetectionReport(
            route="dense",
            reason=(f"N={N} below the auto route's minimum ({min_n_auto}), "
                    "uno_tpu's measured crossover"),
            N=N)
        return None
    pat, is_dual = probe_kkt_pattern(prob, m)
    density = float(pat.sum()) / float(N * N)
    if density > density_cutoff and not force:
        last_detection_report = SparseDetectionReport(
            route="dense",
            reason=(f"pattern density {density:.2f} > {density_cutoff}: "
                    "genuinely dense coupling (elec/chandheq class)"),
            N=N, density=density)
        return None
    plan = build_plan(pat, is_dual)
    padded = plan.padded_flops()
    dense = plan.dense_flops()
    if padded > flop_margin * dense and not force:
        last_detection_report = SparseDetectionReport(
            route="dense",
            reason=(f"scheduled flops {padded:.3g} vs dense {dense:.3g}: "
                    "the padded supernodal schedule does not beat the "
                    "dense factorization at this size"),
            N=N, density=density, nnz_factor=plan.nnz_factor,
            padded_flops=padded, dense_flops=dense,
            num_supernodes=plan.num_supernodes)
        return None
    last_detection_report = SparseDetectionReport(
        route="sparse",
        reason=f"padded/dense flop ratio {padded / dense:.3f}",
        N=N, density=density, nnz_factor=plan.nnz_factor,
        padded_flops=padded, dense_flops=dense,
        num_supernodes=plan.num_supernodes)
    return make_sparse_ldlt(plan)
