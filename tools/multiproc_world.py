#!/usr/bin/env python
"""Multi-process evidence on torch.distributed: the counterpart of
tools/multiproc_mesh.py.  The sharded-batch IPM and the distributed-KKT IPM
run across processes grouped as nodes, with the collectives crossing the
process (and node) boundary.

    python tools/multiproc_world.py --device cpu     2 processes, Gloo
    python tools/multiproc_world.py                  2 nodes x 2 cards, NCCL

The launcher starts nodes x per_node worker processes on this machine
(rank r on node r // per_node, cuda:r on the card), joined through
tcp://127.0.0.1 on a free port; each runs:
  * sharded_batch: the flagship family at 2 instances a rank through
    solve_batch_sharded on the whole world, to convergence;
  * weak_scaling: the same per-rank load (--per-rank, default 256 on the
    CPU, 8,192 on the card, chip_smoke.py's main-path options) solved (a)
    by each node on its own ranks (parallel.subgroup: no traffic between
    nodes) and (b) by the whole world, warm; efficiency T_local / T_global
    (1.0: adding nodes at constant load a rank costs no wall time);
  * distributed_kkt: the flagship instance with ldlt_backend="distributed"
    (max_iterations=30) factored over the whole world.
Rank 0 writes the report to --out (MULTICHIP_torch.json at the repo's
root), with the cards' name and power limit on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(args):
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    import uno_tpu_torch
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.options import preset
    from uno_tpu_torch.parallel import make_group, solve_batch_sharded, subgroup

    if args.device == "cpu":
        torch.set_num_threads(1)
    group = make_group(args.device)
    sync = torch.cuda.synchronize if group.device.type == "cuda" else (lambda: None)
    node = group.rank // args.per_node
    report = {"rank": group.rank, "node": node, "world": group.size,
              "backend": group.backend, "device": str(group.device)}

    opts = preset("ipopt", scale_functions=False)
    batch = 2 * group.size
    nlp, x0, params = flagship(batch)
    t0 = time.perf_counter()
    res = solve_batch_sharded(nlp, opts, x0, params, group)
    report["sharded_batch"] = {"batch": batch, "solved": int(res.num_solved),
                               "mean_iterations": float(np.mean(res.iterations)),
                               "wall_s": time.perf_counter() - t0,
                               "ok": int(res.num_solved) == batch}

    nodes = [subgroup(group, range(k * args.per_node, (k + 1) * args.per_node))
             for k in range(args.nodes)]
    mine = nodes[node]
    wopts = chip_smoke.main_path_options()

    def timed(g, total):
        nlp_w, x0_w, p_w = flagship(total)
        solve_batch_sharded(nlp_w, wopts, x0_w, p_w, g)          # warm
        group.barrier()
        sync()
        t = time.perf_counter()
        r = solve_batch_sharded(nlp_w, wopts, x0_w, p_w, g)
        sync()
        dt = torch.tensor([time.perf_counter() - t], dtype=torch.float64,
                          device=group.device)
        return int(r.num_solved), float(group.all_reduce(dt, "max")[0])

    local_solved, t_local = timed(mine, args.per_rank * args.per_node)
    global_solved, t_global = timed(group, args.per_rank * group.size)
    report["weak_scaling"] = {
        "per_rank_batch": args.per_rank, "node_batch": args.per_rank * args.per_node,
        "node_solved": local_solved, "node_wall_s": t_local,
        "world_batch": args.per_rank * group.size, "world_solved": global_solved,
        "world_wall_s": t_global, "efficiency": t_local / max(t_global, 1e-12)}

    dopts = preset("ipopt", scale_functions=False, ldlt_backend="distributed",
                   max_iterations=30)
    t0 = time.perf_counter()
    dres = uno_tpu_torch.solve(flagship(1)[0], options=dopts, group=group)
    report["distributed_kkt"] = {"status": dres.status, "iterations": dres.iterations,
                                 "objective": dres.objective,
                                 "wall_s": time.perf_counter() - t0,
                                 "ok": dres.status in ("optimal", "almost_optimal")}
    gathered = [None] * group.size
    torch.distributed.all_gather_object(gathered, report)
    if group.rank == 0:
        out = {"ok": all(r["sharded_batch"]["ok"] and r["distributed_kkt"]["ok"]
                         for r in gathered),
               "nodes": args.nodes, "ranks_per_node": args.per_node,
               "backend": group.backend, "ranks": gathered}
        if group.device.type == "cuda":
            out["device"] = torch.cuda.get_device_name(group.device)
            out["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30,
                check=True).stdout.strip().splitlines()
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps({k: v for k, v in out.items() if k != "ranks"}
                         | {"rank0": gathered[0]}), flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nodes", type=int, default=2)
    parser.add_argument("--per-node", type=int, default=None,
                        help="ranks a node (default 1 on the CPU, 2 on the card)")
    parser.add_argument("--per-rank", type=int, default=None,
                        help="weak scaling's instances a rank (256 CPU, 8,192 card)")
    parser.add_argument("--out", default=str(REPO / "MULTICHIP_torch.json"))
    parser.add_argument("--timeout", type=float, default=1500.0)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    cpu = args.device == "cpu"
    args.per_node = args.per_node or (1 if cpu else 2)
    args.per_rank = args.per_rank or (256 if cpu else 8192)
    if args.worker:
        worker(args)
        return
    world = args.nodes * args.per_node
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        if cpu:
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", "--device", args.device,
             "--nodes", str(args.nodes), "--per-node", str(args.per_node),
             "--per-rank", str(args.per_rank), "--out", args.out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    rc = 0
    deadline = time.monotonic() + args.timeout
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            print(f"--- rank {rank} (rc={p.returncode}) ---")
            print(out[-3000:])
            rc |= p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc |= 1
    sys.exit(rc)


if __name__ == "__main__":
    main()
