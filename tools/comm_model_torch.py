"""The collectives of the port's multi-card paths, and what they cost on the
cards at hand: the counterpart of tools/comm_model.py, with PyTorch only.

    torchrun --nproc_per_node N tools/comm_model_torch.py [--out FILE]
    torchrun --nproc_per_node N tools/comm_model_torch.py --device cpu --small

Inventory.  Each workload runs once warm, then once under torch.profiler
(record_shapes) on every rank; rank 0's trace (the `nccl:*` / `gloo:*`
events torch.distributed records with each collective's input dims and
type) gives every collective's op, dtype, shape and bytes (its input on
one rank) with its count, per iteration:
  * sharded_batch: solve_batch_sharded of the flagship batch (chip_smoke.py's
    main path at B = 8,192 a rank; --small 4), per IPM iteration of its
    slowest instance;
  * dist_ldlt: make_dist_ldlt's factor and solve of chip_smoke.py's
    dim-1280 KKT-like matrix (panels of 64; --small 256, panels of 32), per
    factorization and per panel step;
  * dist_kkt: the dim-1280 flagship instance solved with
    ldlt_backend="distributed", per IPM iteration;
  * schur: make_sharded_schur_solver on chip_smoke.py's block-arrow system
    (2,048 blocks of 64, n0 = 256; --small 64 of 16, n0 = 8), per factor
    and solve.
Rates.  Not from a spec sheet: an all-reduce of float64 tensors of 8 B to
16 MiB (powers of 8; --small 2 MiB) is timed on this world (median of 10 after a warm
one, the slowest rank, host synchronisation included); alpha is the
8-byte time and beta the slope to the largest, t = alpha + bytes / beta; each inventory is priced at
sum(count * (alpha + bytes / beta)), no overlap assumed.  Rank 0 prints
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import uno_tpu_torch  # noqa: E402
from uno_tpu_torch.model.library import flagship  # noqa: E402
from uno_tpu_torch.options import preset  # noqa: E402
from uno_tpu_torch.parallel import make_group, solve_batch_sharded  # noqa: E402
from uno_tpu_torch.parallel.dist_ldlt import make_dist_ldlt  # noqa: E402
from uno_tpu_torch.parallel.schur import (make_sharded_schur_solver,  # noqa: E402
                                          random_block_arrow_system)

ITEMSIZE = {"double": 8, "float": 4, "long int": 8, "long": 8, "int": 4, "bool": 1,
            "c10::half": 2, "half": 2, "c10::bfloat16": 2, "bfloat16": 2,
            "unsigned char": 1, "byte": 1, "signed char": 1, "char": 1}


def _sync(group):
    if group.device.type == "cuda":
        torch.cuda.synchronize()


def _collectives(trace):
    """(op, dtype, shape) of each collective in a profiler chrome trace: the
    `nccl:*` / `gloo:*` events with their input's dims and type, or, where a
    build records none, the record_param_comms events with the collective's
    name, dtype and element count."""
    named, params = [], []
    for e in trace["traceEvents"]:
        name, args = e.get("name", ""), e.get("args", {})
        if name.startswith(("nccl:", "gloo:")) and args.get("Input Dims"):
            dims = args["Input Dims"][0] or []
            named.append((name.split(":", 1)[1], str(args.get("Input type", [""])[0]),
                          tuple(dims)))
        elif "Collective name" in args and "In msg nelems" in args:
            params.append((str(args["Collective name"]), str(args.get("dtype", "")),
                           (int(args["In msg nelems"]),)))
    return named or params


def inventory(group, fn):
    """fn() once warm, once under the profiler; this rank's collectives as
    rows (op, dtype, shape, bytes, count)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    fn()
    group.barrier()
    _sync(group)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if group.device.type == "cuda" else [])
    with profile(activities=acts, record_shapes=True) as prof:
        out = fn()
        _sync(group)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            seen = Counter(_collectives(json.load(fh)))
    finally:
        os.remove(path)
    rows = []
    for (op, dtype, shape), count in sorted(seen.items()):
        nbytes = int(np.prod(shape, dtype=np.int64)) * ITEMSIZE.get(dtype.lower(), 8)
        rows.append({"op": op, "dtype": dtype, "shape": list(shape), "bytes": nbytes,
                     "count": count})
    return rows, out


def per(rows, k):
    """The inventory divided by k (per iteration or per step)."""
    return [dict(r, count=r["count"] / k) for r in rows]


def allreduce_rates(group, max_bytes, repeats=10):
    """(alpha s, beta bytes/s, the points): a timed float64 all-reduce at
    8 B .. max_bytes, the slowest rank's median; t = alpha + b/beta through
    the smallest and the largest."""
    points = []
    nbytes = 8
    while nbytes <= max_bytes:
        t = torch.zeros(nbytes // 8, dtype=torch.float64, device=group.device)
        group.all_reduce(t)
        times = []
        for _ in range(repeats):
            group.barrier()
            _sync(group)
            t0 = time.perf_counter()
            group.all_reduce(t)
            _sync(group)
            dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                              device=group.device)
            times.append(float(group.all_reduce(dt, "max")[0]))
        points.append((nbytes, float(np.median(times))))
        nbytes *= 8
    (b0, alpha), (b1, t1) = points[0], points[-1]
    beta = (b1 - b0) / (t1 - alpha) if t1 > alpha else float("inf")
    return alpha, beta, [{"bytes": int(x), "s": y} for x, y in points]


def priced(rows, alpha, beta):
    return sum(r["count"] * (alpha + r["bytes"] / beta) for r in rows)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    group = make_group(args.device)
    small = args.small
    try:
        out = {"world": group.size, "backend": group.backend}
        if group.device.type == "cuda":
            out["device"] = torch.cuda.get_device_name(group.device)
            out["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30,
                check=True).stdout.strip().splitlines()
        alpha, beta, points = allreduce_rates(group, (2 if small else 16) << 20)
        out["allreduce"] = {"alpha_s": alpha, "beta_bytes_per_s": beta, "points": points}
        work = {}

        batch = (4 if small else 8192) * group.size
        nlp, x0, params = flagship(batch)
        opts = chip_smoke.main_path_options()
        rows, res = inventory(group, lambda: solve_batch_sharded(nlp, opts, x0, params, group))
        its = int(np.max(res.iterations))
        work["sharded_batch"] = {"batch": batch, "iterations": its,
                                 "per_iteration": per(rows, its)}

        n, block = (256, 32) if small else (chip_smoke.LARGE_KKT_DIM, chip_smoke.DIST_BLOCK)
        K, _ = chip_smoke.barrier_kkt_like(1, n, seed=n)
        factor, solve, perm = make_dist_ldlt(group, n, block)
        lo, hi = group.local_range(n)
        A_loc = torch.as_tensor(K[0][:, perm][:, lo:hi], device=group.device).contiguous()
        rhs = torch.as_tensor(np.random.default_rng(n + 1).standard_normal(n),
                              device=group.device)
        rows, _ = inventory(group, lambda: solve(factor(A_loc), rhs))
        work["dist_ldlt"] = {"n": n, "block": block, "panels": n // block,
                             "per_factor_and_solve": rows,
                             "per_panel_step": per(rows, n // block)}

        nk = 60 if small else chip_smoke.LARGE_N
        inst = flagship(1, n=nk)[0]
        dopts = preset("ipopt", ldlt_backend="distributed")
        rows, res = inventory(group, lambda: uno_tpu_torch.solve(inst, options=dopts,
                                                                 group=group))
        work["dist_kkt"] = {"n": nk, "iterations": res.iterations, "status": res.status,
                            "per_iteration": per(rows, max(res.iterations, 1))}

        S, nb, n0 = (64, 16, 8) if small else (chip_smoke.SCHUR_S, chip_smoke.SCHUR_NB,
                                               chip_smoke.SCHUR_N0)
        Ks, Bs, K0 = random_block_arrow_system(S, nb, n0, seed=chip_smoke.SCHUR_SEED)
        rng = np.random.default_rng(chip_smoke.SCHUR_SEED + 1)
        rhs_s, rhs0 = rng.standard_normal((S, nb)), rng.standard_normal(n0)
        slo, shi = group.local_range(S)
        local = [torch.as_tensor(a, device=group.device)
                 for a in (Ks[slo:shi], Bs[slo:shi], K0, rhs_s[slo:shi], rhs0)]
        ssolve = make_sharded_schur_solver(group, nb, n0)
        rows, _ = inventory(group, lambda: ssolve(*local))
        work["schur"] = {"S": S, "nb": nb, "n0": n0, "per_factor_and_solve": rows}

        for name, w in work.items():
            inv = next(v for k, v in w.items() if k.startswith("per_"))
            w["bytes"] = sum(r["count"] * r["bytes"] for r in inv)
            w["collectives"] = sum(r["count"] for r in inv)
            w["modelled_comm_s"] = priced(inv, alpha, beta)
        out["workloads"] = work
        if group.rank == 0:
            print(json.dumps(out), flush=True)
            if args.out:
                Path(args.out).write_text(json.dumps(out, indent=1))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
