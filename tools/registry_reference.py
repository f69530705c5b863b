"""uno_tpu's ipopt results over the small tier of its problem registry, for
chip_smoke.py's `registry` phase and tests/test_torch_sweep.py to hold the
port against on a machine without JAX.

The tier is every key of uno_tpu.model.library.problem_names() whose
instance has n + m <= 30.  Each key is solved with uno_tpu.solve(nlp,
preset="ipopt", max_iterations=2000) on the CPU, as tools/sweep.py solves
it, and the row records the status, iterations, objective, ||x||_2, the
primal feasibility, `success` and tools/sweep_torch.py's solved rule.

    JAX_PLATFORMS=cpu python3 tools/registry_reference.py [--jobs 4] \
        [--max-nm 30] [--out tests/fixtures/torch_registry_ref.json]

Each worker process solves a share of the keys (XLA compiles each problem's
solver once, 5-17 s a key on the CPU).
"""

import argparse
import json
import multiprocessing as mp
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

DEFAULT_OUT = REPO / "tests" / "fixtures" / "torch_registry_ref.json"


def _setup_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(REPO / "tests"))
    from conftest import _cpu_fingerprint
    jax.config.update("jax_compilation_cache_dir",
                      str(REPO / f".jax_cache_cpu_{_cpu_fingerprint()}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def tier(max_nm):
    """The registry keys with n + m <= max_nm, in problem_names() order."""
    _setup_jax()
    from uno_tpu.model.library import get_problem, problem_names
    out = []
    for name in problem_names():
        nlp = get_problem(name)
        if nlp.n + nlp.m <= max_nm:
            out.append(name)
    return out


def solve_one(name):
    _setup_jax()
    import numpy as np

    import uno_tpu
    from sweep_torch import MAX_ITER, is_solved
    from uno_tpu.model.library import acceptable_optima, get_problem
    nlp = get_problem(name)
    res = uno_tpu.solve(nlp, preset="ipopt", max_iterations=MAX_ITER["ipopt"])
    f = float(res.objective)
    return name, {
        "n": nlp.n, "m": nlp.m, "status": str(res.status),
        "iterations": int(res.iterations), "objective": f,
        "x_norm": float(np.linalg.norm(np.asarray(res.x))),
        "primal_feasibility": float(res.primal_feasibility),
        "success": bool(res.success),
        "solved": is_solved(str(res.status), bool(res.success),
                            float(res.primal_feasibility), f,
                            acceptable_optima(name)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--max-nm", type=int, default=30)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()
    names = tier(args.max_nm)
    print(f"{len(names)} keys with n + m <= {args.max_nm}", flush=True)
    rows = {}
    # a fresh worker every 16 keys bounds the memory XLA's compiled solvers
    # hold
    with mp.get_context("spawn").Pool(args.jobs, maxtasksperchild=16) as pool:
        for k, (name, row) in enumerate(pool.imap_unordered(solve_one, names)):
            rows[name] = row
            print(f"[{k + 1}/{len(names)}] {name} {row['status']} "
                  f"{row['iterations']} {row['objective']:.10g}", flush=True)
    out = {"source": "uno_tpu.solve(preset='ipopt', max_iterations=2000), "
                     "JAX on the CPU, tools/registry_reference.py",
           "max_nm": args.max_nm, "rows": rows}
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {args.out}: {len(rows)} keys, "
          f"{sum(r['solved'] for r in rows.values())} solved")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
