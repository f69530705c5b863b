"""Instance sharding over a process group.

Counterpart of uno_tpu/parallel/sharding.py: a batch of independent NLP
instances laid over the ranks of a process group (parallel/group.py), as
uno_tpu lays it over a 1-D mesh axis.  Each rank solves its contiguous run
of the batch with the port's batched IPM on its own card; every instance's
factorization stays on one card.  The results are gathered in rank order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from uno_tpu_torch.model.nlp import NLP
from uno_tpu_torch.options import Options
from uno_tpu_torch.parallel.group import Group, make_group
from uno_tpu_torch.solvers import ipm as ipm_mod
from uno_tpu_torch.solvers.batch import BatchResult, build_batch_ipm


def build_sharded_batch_ipm(nlp: NLP, opts: Options, group: Group):
    """(prob, solve): solve(x0_batch, params_batch=None) runs this rank's
    contiguous run of the batch (the batch must be a multiple of the world
    size) to the end on the group's device and returns its final IPMState
    and its run (start, stop)."""
    prob, run = build_batch_ipm(nlp, opts, device=group.device)

    def solve(x0_batch, params_batch=None):
        lo, hi = group.local_range(int(np.shape(x0_batch)[0]))
        params = None if params_batch is None else np.asarray(params_batch)[lo:hi]
        return run(np.asarray(x0_batch)[lo:hi], params), (lo, hi)

    return prob, solve


def solve_batch_sharded(nlp: NLP, opts: Options, x0_batch, params_batch=None,
                        group: Group | None = None) -> BatchResult:
    """solve_batch's result for the whole batch, each rank solving its run
    on its card; every rank returns the whole result (gathered in rank
    order).  The default group is make_group()'s, on the card."""
    t0 = time.monotonic()
    group = group if group is not None else make_group()
    B = int(np.shape(x0_batch)[0])
    if params_batch is None and nlp.params is not None:
        p = np.asarray(nlp.params, dtype=np.float64)
        params_batch = np.broadcast_to(p, (B,) + p.shape)
    _, solve = build_sharded_batch_ipm(nlp, opts, group)
    final, _ = solve(x0_batch, params_batch)
    x_orig = final.x[:, : nlp.n]
    local = {"status": final.status, "x": x_orig,
             "objective": nlp.objective(x_orig, final.params),
             "iterations": final.iteration,
             "primal_feasibility": final.primal_feas,
             "stationarity": final.stat / final.stat_scaling}
    out = {k: group.all_gather(v).cpu().numpy() for k, v in local.items()}
    solved = (final.status == ipm_mod.OPTIMAL) | (final.status == ipm_mod.ALMOST_OPTIMAL)
    num_solved = int(group.all_reduce(solved.sum()[None]).item())
    res = BatchResult(cpu_time=time.monotonic() - t0, **out)
    if res.num_solved != num_solved:
        raise RuntimeError(f"the ranks gathered {res.num_solved} solved instances "
                           f"but count {num_solved}")
    return res
