"""Slice 4 on several cards: the dry run, the Schur-complement solver with
the scenarios split over the ranks, the distributed dense LDL^T and the
IPM on the distributed route, timed on this world.

    torchrun --nproc_per_node N tools/multicard_study.py [--out FILE]
    torchrun --nproc_per_node N tools/multicard_study.py --device cpu --small

Each rank drives its card (cuda:LOCAL_RANK, NCCL; Gloo with --device cpu).
Rank 0 prints one JSON object (and writes it to --out):
  * dryrun: uno_tpu_torch.parallel.dryrun on the world;
  * schur: chip_smoke.py's block-arrow system (S=2,048 blocks of 64, n0=256,
    float64) through make_sharded_schur_solver, each rank its run of
    scenarios; factor + solve timed (the slowest rank, after a barrier,
    median of 5), x against rank 0's single-program solve of the whole
    system on its own card;
  * dist_ldlt: make_dist_ldlt's factor and solve of seeded KKT-like
    matrices (chip_smoke.barrier_kkt_like) at n = 1,280 and 8,192, panels
    of 64, timed the same way, with the inertia and the solve's residual;
    and the panel step split (`panel_step`): one factor under
    torch.profiler on every rank, its card time by kernel class (the
    dist_panel kernel, the owner's pack of the panel into the broadcast
    buffer and the copies of the pivots, the NCCL broadcast, the trailing
    product's GEMM and its element-wise operations and gather), summed
    over the factor and per panel step, with the factor's time between
    CUDA events and the share of it the card was idle;
  * dist_kkt: chip_smoke.py's dim-1280 instance with
    ldlt_backend="distributed", its iterations and wall time;
  * sharded_scaling: the flagship batch (chip_smoke.py's main path, n=8,
    B=65,536, its options) through solve_batch_sharded on the first 1, 2,
    4, ... ranks of the world (parallel.subgroup; the other ranks wait),
    each warm, median of 3: solves per second and the efficiency against
    one rank, tp(P) / (P tp(1)) (the batch axis of tools/bench_scaling.py;
    its Schur axis is the `schur` study).
Run it at one and at four ranks in the same call to compare them.
`--package DIR` imports uno_tpu_torch from DIR instead (an earlier tree,
e.g. `git archive <commit> uno_tpu_torch | tar -x -C DIR`), so that two
trees are timed by the same studies in one call; `--only` picks studies.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
if "--package" in sys.argv:        # before uno_tpu_torch is imported
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--package") + 1]).resolve()))

import chip_smoke  # noqa: E402
import uno_tpu_torch  # noqa: E402
from uno_tpu_torch.linalg import cuda_ldlt  # noqa: E402
from uno_tpu_torch.model.library import flagship  # noqa: E402
from uno_tpu_torch.options import preset  # noqa: E402
from uno_tpu_torch.parallel import make_group, solve_batch_sharded, subgroup  # noqa: E402
from uno_tpu_torch.parallel.dist_ldlt import make_dist_ldlt  # noqa: E402
from uno_tpu_torch.parallel.dryrun import dryrun  # noqa: E402
from uno_tpu_torch.parallel.schur import (make_sharded_schur_solver,  # noqa: E402
                                          random_block_arrow_system, schur_factor,
                                          schur_solve)


STUDIES = ("dryrun", "schur", "dist_ldlt", "dist_kkt", "sharded_scaling")


def timed(group, fn, repeats=5):
    """Median over `repeats` of the slowest rank's seconds for fn(), each
    started after a barrier and ended with the device's work."""
    out = None
    times = []
    for _ in range(repeats):
        torch.distributed.barrier()
        if group.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if group.device.type == "cuda":
            torch.cuda.synchronize()
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=group.device)
        times.append(float(group.all_reduce(t, "max")[0]))
    return out, float(np.median(times))


def study_schur(group, S, nb, n0):
    Ks, Bs, K0 = random_block_arrow_system(S, nb, n0, seed=chip_smoke.SCHUR_SEED)
    rng = np.random.default_rng(chip_smoke.SCHUR_SEED + 1)
    rhs_s, rhs0 = rng.standard_normal((S, nb)), rng.standard_normal(n0)
    lo, hi = group.local_range(S)
    dev = group.device
    local = [torch.as_tensor(a, device=dev) for a in (Ks[lo:hi], Bs[lo:hi], K0,
                                                      rhs_s[lo:hi], rhs0)]
    solve = make_sharded_schur_solver(group, nb, n0)
    cuda_ldlt.reset_counts()
    solve(*local)
    launches = dict(cuda_ldlt.launches)
    (xs, x0, pos, neg, zero), seconds = timed(group, lambda: solve(*local))
    xs = group.all_gather(xs)
    row = {"S": S, "nb": nb, "n0": n0, "scenarios_per_rank": hi - lo,
           "factor_solve_s": seconds, "inertia": [int(pos), int(neg), int(zero)],
           "launches_by_route": launches}
    if group.rank == 0:
        full = [torch.as_tensor(a, device=dev) for a in (Ks, Bs, K0, rhs_s, rhs0)]
        fac = schur_factor(*full[:3])
        xs1, x01 = schur_solve(fac, full[1], *full[3:])
        row["x_max_abs_diff_vs_one_program"] = max(float((xs - xs1).abs().amax()),
                                                   float((x0 - x01).abs().amax()))
    return row


# the kernel classes of a distributed panel step, by substrings of the
# kernels' names (lower case), first match wins: the owner's panel factor,
# the NCCL broadcast of the panel, the trailing product's GEMM, the copies
# (the owner's pack of the panel and its pivots into the broadcast buffer,
# the pivots into d), the trailing update's element-wise work and gather
STEP_CLASSES = (("dist_panel", ("dist_panel_kernel",)),
                ("broadcast", ("nccl",)),
                ("trailing_gemm", ("gemm", "xmma", "cutlass", "nvjet")),
                ("pack_and_copies", ("copy",)),
                ("trailing_elementwise", ("mul", "add", "sub", "index")))


def step_class(name):
    low = name.lower()
    return next((cls for cls, keys in STEP_CLASSES if any(k in low for k in keys)), "other")


def panel_step_split(group, fn, steps, top=12):
    """fn() once under torch.profiler on every rank (after a warm call and
    a barrier): the card's ms by STEP_CLASSES, summed over the call and a
    panel step's mean, the call's ms between CUDA events, the card's idle
    share of it outside the broadcast; every rank's, rank order.  Rank 0's row adds the host's
    `top` operations and CUDA runtime calls by their own time, per step
    (the profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.distributed.barrier()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    classes = [cls for cls, _ in STEP_CLASSES] + ["other"]
    # the broadcast's kernel holds the card while it waits for the owner,
    # so the busy time and the idle share leave it out
    ms = dict.fromkeys(classes, 0.0)
    launches = dict.fromkeys(classes, 0)
    host = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            cls = step_class(e.key)
            ms[cls] += e.self_device_time_total / 1e3
            launches[cls] += e.count
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total / 1e3 / steps, e.count / steps, e.key))
    call_ms = start.elapsed_time(end)
    local = torch.tensor([[call_ms, *(ms[c] for c in classes)]], dtype=torch.float64,
                         device=group.device)
    rows = group.all_gather(local).tolist()
    out = []
    for rank, (wall, *per) in enumerate(rows):
        busy = sum(v for c, v in zip(classes, per) if c != "broadcast")
        out.append({"rank": rank, "call_ms": wall, "busy_ms": busy,
                    "idle_share": 1.0 - busy / wall,
                    "ms": dict(zip(classes, per)),
                    "ms_a_step": {c: v / steps for c, v in zip(classes, per)},
                    "call_ms_a_step": wall / steps})
    out[group.rank]["launches"] = launches
    out[group.rank]["host_top_a_step"] = [
        {"self_ms": t, "count": c, "name": name[:60]} for t, c, name in sorted(host)[::-1][:top]]
    return out


def study_dist_ldlt(group, n, block=64):
    K, expected = chip_smoke.barrier_kkt_like(1, n, seed=n)
    factor, solve, perm = make_dist_ldlt(group, n, block)
    lo, hi = group.local_range(n)
    A_loc = torch.as_tensor(K[0][:, perm][:, lo:hi], device=group.device).contiguous()
    rhs = torch.as_tensor(np.random.default_rng(n + 1).standard_normal(n),
                          device=group.device)
    cuda_ldlt.reset_counts()
    factor(A_loc)
    launches = dict(cuda_ldlt.launches)
    fac, factor_s = timed(group, lambda: factor(A_loc))
    x, solve_s = timed(group, lambda: solve(fac, rhs))
    split = (panel_step_split(group, lambda: factor(A_loc), n // block)
             if group.device.type == "cuda" else None)
    Kt = torch.as_tensor(K[0], device=group.device)
    resid = float(torch.linalg.vector_norm(Kt @ x - rhs) / torch.linalg.vector_norm(rhs))
    inertia = [int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)]
    return {"n": n, "block": block, "panels": n // block, "factor_s": factor_s,
            "solve_s": solve_s, "inertia": inertia,
            "inertia_expected": [int(expected[0][0]), int(expected[0][1]), 0],
            "relative_residual": resid, "launches_by_route": launches,
            "panel_step": split}


def study_dist_kkt(group, n):
    nlp = flagship(1, n=n)[0]
    cuda_ldlt.reset_counts()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    res = uno_tpu_torch.solve(nlp, options=preset("ipopt", ldlt_backend="distributed"),
                              group=group)
    return {"n": n, "status": res.status, "iterations": res.iterations,
            "objective": res.objective, "wall_s": time.perf_counter() - t0,
            "launches_by_route": dict(cuda_ldlt.launches)}


def study_sharded_scaling(group, batch, repeats=3):
    """The flagship batch on the first P ranks, P = 1, 2, 4, ... up to the
    world: solves per second (the slowest member's warm seconds, median of
    `repeats`) and the efficiency against one rank."""
    opts = chip_smoke.main_path_options()
    nlp, x0, params = flagship(batch)
    rows = []
    sizes = [p for p in (1, 2, 4, 8, 16) if p <= group.size and batch % p == 0]
    for size in sizes:
        sub = subgroup(group, range(size))
        res = solve_batch_sharded(nlp, opts, x0, params, sub) if sub else None
        times = []
        for _ in range(repeats):
            group.barrier()
            if group.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if sub is not None:
                res = solve_batch_sharded(nlp, opts, x0, params, sub)
            if group.device.type == "cuda":
                torch.cuda.synchronize()
            t = torch.tensor([time.perf_counter() - t0 if sub else 0.0],
                             dtype=torch.float64, device=group.device)
            times.append(float(group.all_reduce(t, "max")[0]))
        seconds = float(np.median(times))
        solved = torch.tensor([res.num_solved if (sub and sub.rank == 0) else 0],
                              device=group.device)
        rows.append({"ranks": size, "batch": batch, "instances_per_rank": batch // size,
                     "seconds": seconds, "times": times, "solves_per_s": batch / seconds,
                     "solved": int(group.all_reduce(solved, "max")[0])})
    for row in rows:
        row["efficiency"] = row["solves_per_s"] / (row["ranks"] * rows[0]["solves_per_s"])
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true",
                        help="small sizes, for a rehearsal on the CPU")
    parser.add_argument("--out")
    parser.add_argument("--package", type=Path,
                        help="import uno_tpu_torch from this directory (an earlier tree)")
    parser.add_argument("--only", nargs="+", choices=STUDIES, default=STUDIES)
    args = parser.parse_args(argv)
    group = make_group(args.device)
    try:
        if group.device.type == "cuda":
            assert not torch.backends.cuda.matmul.allow_tf32
        small = args.small
        out = {"world": group.size, "backend": group.backend}
        if group.device.type == "cuda":
            out["device"] = torch.cuda.get_device_name(group.device)
            out["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()
        out["package"] = str(Path(uno_tpu_torch.__file__).parent)
        if "dryrun" in args.only:
            out["dryrun"] = {k: v for k, v in dryrun(group).items()
                             if k not in ("x", "dist_x", "iterations")}
        if "schur" in args.only:
            sizes = ((64, 16, 8) if small else
                     (chip_smoke.SCHUR_S, chip_smoke.SCHUR_NB, chip_smoke.SCHUR_N0))
            out["schur"] = study_schur(group, *sizes)
        if "dist_ldlt" in args.only:
            out["dist_ldlt"] = [study_dist_ldlt(group, n, 32 if small else 64)
                                for n in ((256,) if small else (1280, 8192))]
        if "dist_kkt" in args.only:
            out["dist_kkt"] = study_dist_kkt(group, 60 if small else chip_smoke.LARGE_N)
        if "sharded_scaling" in args.only:
            out["sharded_scaling"] = study_sharded_scaling(
                group, 16 if small else chip_smoke.MAIN_BATCH)
        if group.rank == 0:
            print(json.dumps(out), flush=True)
            if args.out:
                Path(args.out).write_text(json.dumps(out, indent=1))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
