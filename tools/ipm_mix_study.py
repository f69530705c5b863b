#!/usr/bin/env python3
"""Two readings behind chip_smoke.py's ipm_mixes phase, taken on one
NVIDIA card with uno_tpu_torch.

    python3 tools/ipm_mix_study.py gaps [--reps 3]
    python3 tools/ipm_mix_study.py time [--label NAME] [--solves 5]

  * gaps  the card's iterate against the CPU's at every iteration
          (max |x| difference, solve(..., history=True)) for the
          ill-conditioned singles: lukvle1_n100 on the banded backend under
          the identity and zero Hessians (12 iterations) and hs021 under
          the zero Hessian (60), each card run `--reps` times against one
          CPU run.  The phase holds a single only for as many iterations
          as these gaps stay within its x limit.
  * time  the main path (ipopt, flagship B=65,536, chip_smoke's options)
          through solve_batch: one cold solve, then `--solves` warm ones,
          wall seconds between synchronizations, with the IPM's step and
          line-search-trip counts.  Run it from the root of each tree to
          compare (an earlier tree from `git archive`), in one call,
          alternating the trees.

Prints the card's name and power limit first, then one JSON object per
reading.  Imports torch, numpy, chip_smoke and uno_tpu_torch only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path.cwd()))

GAP_RUNS = (("lukvle1_n100", dict(hessian_model="identity", max_iterations=12)),
            ("lukvle1_n100", dict(hessian_model="zero", max_iterations=12)),
            ("hs021", dict(hessian_model="zero", max_iterations=60)))


def _iterates(res):
    return np.array([s.x[0].detach().cpu().numpy() for s in res.history])


def study_gaps(reps):
    import uno_tpu_torch
    from uno_tpu_torch.model.library import get_problem
    for name, over in GAP_RUNS:
        cpu = uno_tpu_torch.solve(get_problem(name), preset="ipopt", device="cpu",
                                  history=True, **over)
        xc = _iterates(cpu)
        for rep in range(reps):
            card = uno_tpu_torch.solve(get_problem(name), preset="ipopt",
                                       device="cuda", history=True, **over)
            xg = _iterates(card)
            gaps = [float(np.max(np.abs(a - b))) for a, b in zip(xg, xc)]
            print(json.dumps({"study": "gaps", "problem": name, **over, "rep": rep,
                              "status": [card.status, cpu.status],
                              "iterations": [card.iterations, cpu.iterations],
                              "final_x_gap": float(np.max(np.abs(card.x - cpu.x))),
                              "gap_per_iteration": gaps}), flush=True)


def study_time(label, solves):
    import torch

    import chip_smoke
    import uno_tpu_torch
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.solvers import ipm
    nlp, x0, params = flagship(chip_smoke.MAIN_BATCH)
    opts = chip_smoke.main_path_options()
    walls = []
    for _ in range(solves + 1):
        ipm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = uno_tpu_torch.solve_batch(nlp, x0, params, opts=opts, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    print(json.dumps({"study": "time", "tree": label, "cold_s": walls[0],
                      "warm_s": walls[1:], "warm_median_s": float(np.median(walls[1:])),
                      "solved": int(res.num_solved),
                      "mean_iterations": float(np.mean(res.iterations)),
                      "counts": dict(ipm.counts)}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("study", choices=("gaps", "time"))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--label", default=str(Path.cwd()))
    parser.add_argument("--solves", type=int, default=5)
    args = parser.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    import chip_smoke
    chip_smoke.phase_build()
    if args.study == "gaps":
        study_gaps(args.reps)
    else:
        study_time(args.label, args.solves)


if __name__ == "__main__":
    main()
