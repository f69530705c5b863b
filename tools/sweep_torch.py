#!/usr/bin/env python
"""Full-library preset sweep of the port (uno_tpu_torch): every problem of
the registry under the solver presets, with the solved counts and
objective-evaluation budgets of tools/sweep.py, in the same row and
summary schema (tools/merge_sweeps.py and tools/union_sweeps.py read its
output unchanged).

Usage:
  python tools/sweep_torch.py [preset ...]          # default: all five presets
  python tools/sweep_torch.py ipopt --slice 0:48    # problems [0, 48) only
  python tools/sweep_torch.py --out SWEEP.json      # also write the full rows
  python tools/sweep_torch.py --max-n 200           # skip instances with n+m > N
  python tools/sweep_torch.py --device cpu          # the CPU (default: cuda)

Options as tools/sweep.py: --names a,b,c  --min-n N  --sqp-cap N (default
150: the SQP presets skip instances with n+m > N)  --wall-cap S (SIGALRM
per problem, counted as "timeout(wall_cap)")  --time-limit S (the solver's
own wall-clock limit)  --skip-done FILE (skip the rows FILE already has)
--order-by-size; and --shard I/K (every K-th problem from the I-th, after
--slice: K processes sharing one card).  Prints a per-preset table, the device and the LDL^T
kernel launches by route, and a JSON summary line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

PRESETS = ("ipopt", "filtersqp", "funnelsqp", "byrd", "filterslp")
# the end-to-end tolerance of tools/sweep.py (the reference's CI tolerance)
RTOL = 1e-4
# the reference's default max_iterations, for every preset (tools/sweep.py)
MAX_ITER = {"ipopt": 2000, "filtersqp": 2000, "funnelsqp": 2000,
            "byrd": 2000, "filterslp": 2000}


def objective_error(f, optima):
    """Relative distance of f to the nearest acceptable optimum, NaN when
    there is none or f is not finite."""
    if optima and np.isfinite(f):
        return min(abs(f - fs) / max(1.0, abs(fs)) for fs in optima)
    return np.nan


def is_solved(status, success, primal_feasibility, f, optima):
    """tools/sweep.py's rule: a successful termination, or a feasible small
    step where optima are known, at one of the optima within RTOL when the
    registry knows any."""
    if str(status).startswith(("error", "timeout")):
        return False
    terminated_ok = success or (status == "feasible_small_step"
                                and primal_feasibility <= 1e-5 and bool(optima))
    return bool(terminated_ok and (not optima
                                   or objective_error(f, optima) <= RTOL))


def run_preset(preset, names, device, sqp_cap=150, max_n=None, min_n=None,
               flush=None, skip=(), wall_cap=None, time_limit=None):
    import signal

    import uno_tpu_torch
    from uno_tpu_torch.model.library import acceptable_optima, get_problem

    class _WallCap(Exception):
        pass

    def _alarm(signum, frame):
        raise _WallCap()

    if wall_cap:
        signal.signal(signal.SIGALRM, _alarm)
    rows = []
    for name in names:
        if name in skip:
            continue
        if flush is not None and len(rows) % 10 == 9:
            flush(preset, rows)
        nlp = get_problem(name)
        if max_n is not None and nlp.n + nlp.m > max_n:
            continue
        if min_n is not None and nlp.n + nlp.m <= min_n:
            continue
        if preset != "ipopt" and nlp.n + nlp.m > sqp_cap:
            continue
        t0 = time.perf_counter()
        res = None
        try:
            if wall_cap:
                signal.alarm(wall_cap)
            kw = {"time_limit": float(time_limit)} if time_limit else {}
            res = uno_tpu_torch.solve(nlp, preset=preset, device=device,
                                      max_iterations=MAX_ITER[preset], **kw)
            status = res.status
            f = float(res.objective)
            nit = int(res.iterations)
            nf = int(res.num_objective_evaluations)
        except _WallCap:
            status, f, nit, nf = "timeout(wall_cap)", np.nan, 0, 0
        except Exception as exc:  # noqa: BLE001 -- the sweep records it
            status, f, nit, nf = f"error({type(exc).__name__})", np.nan, 0, 0
        finally:
            if wall_cap:
                signal.alarm(0)
        wall = time.perf_counter() - t0
        optima = acceptable_optima(name)
        ok = res is not None and is_solved(status, res.success,
                                           res.primal_feasibility, f, optima)
        rows.append(dict(name=name, status=str(status), f=f,
                         err=objective_error(f, optima), iters=nit, nfev=nf,
                         wall=wall, solved=ok))
    return rows


def main():
    argv = sys.argv[1:]

    def popopt(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            val = argv[i + 1]
            del argv[i:i + 2]
            return val
        return default

    sl = popopt("--slice")
    shard = popopt("--shard")
    names_opt = popopt("--names")
    out_file = popopt("--out")
    max_n = popopt("--max-n")
    max_n = int(max_n) if max_n else None
    min_n = popopt("--min-n")
    min_n = int(min_n) if min_n else None
    sqp_cap = int(popopt("--sqp-cap", "150"))
    wall_cap = popopt("--wall-cap")
    wall_cap = int(wall_cap) if wall_cap else None
    time_limit = popopt("--time-limit")
    time_limit = float(time_limit) if time_limit else None
    skip_done = popopt("--skip-done")
    device = popopt("--device", "cuda")

    import torch

    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import get_problem, problem_names
    from uno_tpu_torch.solvers.batch import resolve_device
    device = resolve_device(device)          # "cuda" without a card raises
    names = problem_names()
    done = {}
    if skip_done:
        with open(skip_done) as fh:
            for preset, rows_ in json.load(fh).get("rows", {}).items():
                done[preset] = {r["name"] for r in rows_}
    if sl:
        start, stop = sl.split(":")
        names = names[int(start):int(stop)]
    if shard:
        i, k = (int(v) for v in shard.split("/"))
        names = names[i::k]
    if "--order-by-size" in argv:
        argv.remove("--order-by-size")
        names = sorted(names, key=lambda nm: (lambda p: p.n + p.m)(
            get_problem(nm)))
    if names_opt:
        wanted = names_opt.split(",")
        names = [n for n in names if n in wanted]
    presets = argv or list(PRESETS)
    platform = "gpu" if device.type == "cuda" else "cpu"
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    summary = {}
    all_rows = {}

    def flush(preset, rows):
        if out_file:
            cur = dict(all_rows)
            cur[preset] = rows
            with open(out_file, "w") as fh:
                json.dump({"summary": summary, "rows": cur, "partial": True},
                          fh, indent=1)

    for preset in presets:
        cuda_ldlt.reset_counts()
        t0 = time.perf_counter()
        rows = run_preset(preset, names, device, sqp_cap=sqp_cap, max_n=max_n,
                          min_n=min_n, flush=flush,
                          skip=done.get(preset, ()), wall_cap=wall_cap,
                          time_limit=time_limit)
        wall = time.perf_counter() - t0
        all_rows[preset] = rows
        solved = [r for r in rows if r["solved"]]
        launches = {k: v for k, v in cuda_ldlt.launches.items() if v}
        print(f"\n== {preset}: {len(solved)}/{len(rows)} solved "
              f"(rtol {RTOL} vs known optima) on {kind}, {wall:.1f} s; "
              f"LDL^T launches by route {launches} ==")
        for r in rows:
            if not r["solved"]:
                print(f"  FAIL {r['name']:<24} status={r['status']:<20} "
                      f"f={r['f']:.6g} err={r['err']:.2g} iters={r['iters']}")
        summary[preset] = {
            "platform": platform, "device": kind,
            "solved": len(solved), "total": len(rows),
            "total_obj_evals": int(sum(r["nfev"] for r in solved)),
            "median_iters": float(np.median([r["iters"] for r in solved]))
            if solved else None,
            "wall_seconds": wall, "ldlt_launches": launches,
        }
        if out_file:  # incremental flush: long sweeps survive timeouts
            with open(out_file, "w") as fh:
                json.dump({"summary": summary, "rows": all_rows,
                           "partial": True}, fh, indent=1)
    print("\n" + json.dumps({"sweep": summary}))
    if out_file:
        with open(out_file, "w") as fh:
            json.dump({"summary": summary, "rows": all_rows}, fh, indent=1)
        print(f"wrote {out_file}")


if __name__ == "__main__":
    main()
