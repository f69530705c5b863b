"""The multi-card dry run: the counterpart of uno_tpu's
__graft_entry__.dryrun_multichip.

    python -m uno_tpu_torch.parallel.dryrun [--device cpu]          one process
    torchrun --nproc_per_node N -m uno_tpu_torch.parallel.dryrun    N cards

On the process group (parallel/group.py: NCCL on the cards, Gloo with
--device cpu) it runs the flagship family at 2 instances a rank: one IPM
step of the rank's instances with the converged count all-reduced; the
whole batch to convergence through solve_batch_sharded; then the IPM with
the KKT factorization split over the ranks (ldlt_backend="distributed",
max_iterations=30) on instance 0, to convergence.  Raises if any of them
fails; prints one line each (rank 0) and returns what it measured.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from uno_tpu_torch.model.library import flagship
from uno_tpu_torch.options import preset
from uno_tpu_torch.parallel.group import make_group
from uno_tpu_torch.parallel.sharding import solve_batch_sharded
from uno_tpu_torch.solvers.ipm import (ALMOST_OPTIMAL, OPTIMAL, RUNNING, build_ipm,
                                       make_initial_state, run_ipm)


def dryrun(group=None, device="cuda") -> dict:
    group = group if group is not None else make_group(device)
    dev, say = group.device, (print if group.rank == 0 else (lambda *a, **k: None))
    opts = preset("ipopt", scale_functions=False)
    batch = 2 * group.size
    nlp, x0, params = flagship(batch)

    # one step of the rank's instances, the converged count over the group
    prob, ws, step = build_ipm(nlp, opts)
    lo, hi = group.local_range(batch)
    x0_full = torch.zeros((hi - lo, prob.n), dtype=torch.float64, device=dev)
    x0_full[:, : nlp.n] = torch.as_tensor(x0[lo:hi], device=dev)
    p_local = torch.as_tensor(params[lo:hi], dtype=torch.float64, device=dev)
    state1 = step(make_initial_state(prob, ws, opts, x0_full, p_local))
    if state1.x.shape != (hi - lo, prob.n):
        raise AssertionError(f"one step gave x of shape {tuple(state1.x.shape)}")
    done = int(group.all_reduce((state1.status != RUNNING).sum()[None])[0])
    say(f"dryrun({group.size}): one sharded IPM step ok, converged={done}/{batch}",
        flush=True)

    # the batch to convergence
    t0 = time.monotonic()
    res = solve_batch_sharded(nlp, opts, x0, params, group)
    batch_s = time.monotonic() - t0
    if res.num_solved != batch:
        raise AssertionError(f"only {res.num_solved}/{batch} converged")
    say(f"dryrun({group.size}): sharded batch ran to convergence "
        f"({res.num_solved}/{batch} optimal, mean iters "
        f"{float(np.mean(res.iterations)):.1f})", flush=True)

    # one instance, its KKT factorization over the group
    opts_d = preset("ipopt", scale_functions=False, ldlt_backend="distributed",
                    max_iterations=30)
    prob_d, ws_d, step_d = build_ipm(nlp, opts_d, group)
    x0_d = torch.as_tensor(prob_d.x0, dtype=torch.float64, device=dev)[None]
    p0 = torch.as_tensor(params[:1], dtype=torch.float64, device=dev)
    t0 = time.monotonic()
    final = run_ipm(step_d, make_initial_state(prob_d, ws_d, opts_d, x0_d, p0),
                    opts_d, t0)
    dist_s = time.monotonic() - t0
    status, iters = int(final.status[0]), int(final.iteration[0])
    if final.x.shape != (1, prob_d.n) or status not in (OPTIMAL, ALMOST_OPTIMAL):
        raise AssertionError(f"distributed solve status {status}")
    say(f"dryrun({group.size}): distributed-KKT IPM ran to convergence "
        f"(status={status}, iters={iters})", flush=True)
    return {"world": group.size, "backend": group.backend, "step_converged": done,
            "batch": batch, "solved": res.num_solved,
            "iterations": res.iterations.tolist(), "batch_s": batch_s,
            "x": res.x.tolist(), "dist_status": status, "dist_iterations": iters,
            "dist_x": final.x[0, : nlp.n].cpu().tolist(), "dist_s": dist_s}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, the default) or cpu (Gloo)")
    args = parser.parse_args(argv)
    group = make_group(args.device)
    try:
        out = dryrun(group)
        if group.rank == 0:
            print(json.dumps({k: out[k] for k in ("world", "backend", "solved",
                                                  "batch", "dist_status",
                                                  "dist_iterations", "batch_s",
                                                  "dist_s")}), flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
