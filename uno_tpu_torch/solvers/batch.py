"""Batched drivers with per-instance convergence masks: the IPM (ipopt,
under any globalization strategy, Hessian model and line-search width)
and the fused SQP drivers (filtersqp, funnelsqp, filterslp, byrd).

Counterpart of uno_tpu/solvers/batch.py: B independent instances of one NLP
(same functions and shapes, different x0 / params) solved together.  The
batch is the leading axis of every tensor and the outer loop steps the
instances that are still running (solvers/ipm.run_ipm), which is the
semantics of uno_tpu's `vmap(while_loop)`.  That loop already retires
converged instances, so the bucketed drivers (IPM and SQP) are the plain
ones under uno_tpu's signatures.  The IPM batch takes every KKT backend of
build_ipm (the lifted one included); each carries the batch axis.

As in uno_tpu, gradient-based function scaling (scale_functions) uses the
template instance's scaling (nlp.params at nlp.x0) for the whole batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from uno_tpu_torch.model.nlp import NLP
from uno_tpu_torch.options import Options, preset as _preset
from uno_tpu_torch.solvers import ipm as ipm_mod
from uno_tpu_torch.solvers.ipm import build_ipm, make_initial_state, run_ipm


def resolve_device(device) -> torch.device:
    """The device a solve runs on.  "cuda" with no card raises: nothing
    carries on quietly on the CPU unless the caller asks for device="cpu"."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: the port runs on cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclass
class BatchResult:
    status: np.ndarray        # (B,) int status codes
    x: np.ndarray             # (B, n_orig)
    objective: np.ndarray     # (B,)
    iterations: np.ndarray    # (B,)
    primal_feasibility: np.ndarray
    stationarity: np.ndarray
    cpu_time: float

    @property
    def num_solved(self) -> int:
        return int(np.sum((self.status == ipm_mod.OPTIMAL)
                          | (self.status == ipm_mod.ALMOST_OPTIMAL)))

    def status_names(self):
        from uno_tpu_torch.solvers.sqp_fused import SQP_STATUS_NAMES
        return [SQP_STATUS_NAMES[int(s)] for s in self.status]


def build_batch_ipm(nlp: NLP, opts: Options, device="cuda"):
    """Returns (prob, run) where run(x0_batch, params_batch=None) -> the
    final IPMState of the batch.  x0_batch is (B, n) in the ORIGINAL
    variable space (slacks are initialized internally); params_batch is
    None or has the batch as its leading axis."""
    device = resolve_device(device)
    prob, ws, step = build_ipm(nlp, opts)
    n_slack = prob.n - nlp.n

    def run(x0_batch, params_batch=None):
        t0 = time.monotonic()
        x0 = torch.as_tensor(x0_batch, dtype=torch.float64, device=device)
        if n_slack:
            x0 = torch.cat([x0, x0.new_zeros((x0.shape[0], n_slack))], dim=-1)
        params = None if params_batch is None else torch.as_tensor(
            params_batch, dtype=torch.float64, device=device)
        state = make_initial_state(prob, ws, opts, x0, params)
        return run_ipm(step, state, opts, t0)

    return prob, run


def build_bucketed_batch_ipm(nlp: NLP, opts: Options, params_example=None,
                             segment: int = 4, min_bucket: int = 1024,
                             device="cuda"):
    """uno_tpu's iteration-count bucketing of the batched IPM
    (uno_tpu/solvers/batch.py:300), which retires converged lanes of a
    vmapped loop.  The port's loop steps only the running instances
    already, so this is build_batch_ipm; the bucketing arguments are
    accepted and have no effect."""
    return build_batch_ipm(nlp, opts, device)


def build_batch_sqp(nlp: NLP, opts: Options, device="cuda"):
    """The fused SQP drivers on a batch: the trust-region family
    (filtersqp, funnelsqp, filterslp) or byrd, by the options; returns
    (prob, run) like build_batch_ipm, x0_batch (B, n) in the original
    variable space."""
    from uno_tpu_torch.api import is_byrd_family
    from uno_tpu_torch.solvers import sqp_fused
    if is_byrd_family(opts):
        build, make_initial, run_loop = (sqp_fused.build_byrd_fused,
                                         sqp_fused.make_initial_byrd_state,
                                         sqp_fused.run_byrd)
    else:
        build, make_initial, run_loop = (sqp_fused.build_sqp_fused,
                                         sqp_fused.make_initial_sqp_state,
                                         sqp_fused.run_sqp)
    device = resolve_device(device)
    prob, ws, step = build(nlp, opts)

    def run(x0_batch, params_batch=None):
        t0 = time.monotonic()
        x0 = torch.as_tensor(x0_batch, dtype=torch.float64, device=device)
        params = None if params_batch is None else torch.as_tensor(
            params_batch, dtype=torch.float64, device=device)
        state = make_initial(prob, ws, opts, x0, params)
        return run_loop(step, state, opts, t0)

    return prob, run


def build_bucketed_batch_sqp(nlp: NLP, opts: Options, params_example=None,
                             segment: int = 8, min_bucket: int = 64,
                             device="cuda"):
    """uno_tpu's iteration-count bucketing of the batched SQP, which retires
    converged lanes of a vmapped loop.  The port's loop steps only the
    running instances already, so this is build_batch_sqp; the bucketing
    arguments are accepted and have no effect."""
    return build_batch_sqp(nlp, opts, device)


def solve_batch(nlp: NLP, x0_batch, params_batch=None,
                opts: Optional[Options] = None, preset: Optional[str] = None,
                device="cuda", **overrides) -> BatchResult:
    """Solve a batch of instances on `device` (default "cuda"; raises when
    there is no card): the ipopt interior-point method, or the fused SQP
    drivers (filtersqp, funnelsqp, filterslp, byrd), by the options'
    inequality handling."""
    if opts is None:
        opts = _preset(preset or "ipopt", **overrides)
    elif overrides:
        opts = opts.replace(**overrides)
    t0 = time.monotonic()
    B = int(np.shape(x0_batch)[0])
    if params_batch is None and nlp.params is not None:
        p = np.asarray(nlp.params, dtype=np.float64)
        params_batch = np.broadcast_to(p, (B,) + p.shape)
    if opts.inequality_handling_method == "inequality_constrained":
        _, run = build_batch_sqp(nlp, opts, device)
    else:
        _, run = build_batch_ipm(nlp, opts, device)
    final = run(x0_batch, params_batch)
    x_orig = final.x[:, : nlp.n]
    fvals = nlp.objective(x_orig, final.params)
    return BatchResult(
        status=final.status.cpu().numpy(),
        x=x_orig.cpu().numpy(),
        objective=fvals.cpu().numpy(),
        iterations=final.iteration.cpu().numpy(),
        primal_feasibility=final.primal_feas.cpu().numpy(),
        stationarity=(final.stat / final.stat_scaling).cpu().numpy(),
        cpu_time=time.monotonic() - t0,
    )
