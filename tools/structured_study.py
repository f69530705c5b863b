#!/usr/bin/env python3
"""Both sides of uno_tpu's structured-KKT routing rules, timed on one
NVIDIA card with uno_tpu_torch.

    python3 tools/structured_study.py [--only STUDY ...] [--out results.json]

The rules were measured on TPU v5e and the port keeps them, because the
route decides the iterates.  Each study times the alternatives on the same
inputs, eager calls between CUDA events (chip_smoke.eager_ms: the host's
issue of the launches is part of these functions):

  * cr_switch    the block-tridiagonal factorize+solve by the sweep and by
                 cyclic reduction at 16 to 512 blocks (linalg/banded_kkt's
                 switch is at 64 blocks), float64, blocks of 8 and 32;
  * block_size   pick_block_size's smallest multiple of 8 above the
                 bandwidth against larger blocks, at n=4,096, float64, with
                 the route the block count gives;
  * sparse_auto  the supernodal LDL^T against the dense LDL^T wrapper
                 (ldlt_panel) on steering's KKT pattern at 100 to 800
                 stages (N from 913 to 7,213), float64: where the auto
                 route's minimum of 3,072 and its flop margin sit on the
                 card.  The matrices have the probed pattern, primal
                 diagonal 10 + U(0, 1), off-diagonal N(0, 1) and a dual
                 diagonal of -1e-2;
  * sparse_kkt   tools/bench_sparse_kkt.py's cases: the supernodal LDL^T
                 against the dense one, factorize + solve, float32, on the
                 probed KKT patterns of steering_n306, polygon_k25 and
                 vanderpol_ctrl_n183 and on band-plus-arrow patterns (band
                 4, two dense rows and columns) at N = 2,048, 4,096 and
                 8,192; its matrices (kkt_matrix_from_pattern: N(0, 1)
                 entries symmetrized, primal diagonal 10 + U(0, 1), dual
                 -(1 + U(0, 1))), with the supernode count, the factor's
                 nonzeros, padded and dense flops and the solutions' gap.

Prints the card's name and power limit first, then one JSON object per
measurement.  Imports torch, numpy, chip_smoke and uno_tpu_torch only.
`--device cpu` runs the studies on CPU tensors, timed by the host's clock
(median of 3 groups of calls), as a rehearsal: `--small` cuts sparse_kkt
to its probed patterns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STUDIES = ("cr_switch", "block_size", "sparse_auto", "sparse_kkt")
SPARSE_KKT_PROBLEMS = ("steering_n306", "polygon_k25", "vanderpol_ctrl_n183")
SPARSE_KKT_BAND_N = (2048, 4096, 8192)


def host_ms(fn, groups=3, calls=3):
    """ms per call of fn on CPU tensors: median over `groups` of the mean
    of `calls` back-to-back calls, by the host's clock, after one warm."""
    import time
    fn()
    times = []
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    return float(np.median(times))


def kkt_matrix_from_pattern(pat, is_dual, rng):
    """bench_sparse_kkt.py's matrix on a pattern: N(0, 1) entries where the
    pattern has them, symmetrized, primal diagonal 10 + U(0, 1), dual
    -(1 + U(0, 1))."""
    N = pat.shape[0]
    A = np.where(pat, rng.standard_normal((N, N)), 0.0)
    A = (A + A.T) / 2
    A[np.diag_indices(N)] = np.where(is_dual, -(1.0 + rng.random(N)), 10.0 + rng.random(N))
    return A


def band_arrow_pattern(N, bw=4, spikes=2):
    pat = np.zeros((N, N), dtype=bool)
    for o in range(bw + 1):
        idx = np.arange(N - o)
        pat[idx, idx + o] = True
        pat[idx + o, idx] = True
    pat[-spikes:, :] = True
    pat[:, -spikes:] = True
    return pat, np.zeros(N, dtype=bool)


def problem_pattern(name):
    from uno_tpu_torch.linalg.sparse_kkt import probe_kkt_pattern
    from uno_tpu_torch.model import transforms
    from uno_tpu_torch.model.library import get_problem
    from uno_tpu_torch.options import preset
    opts = preset("ipopt")
    prob = transforms.reformulate_for_interior_point(
        transforms.scale_model(get_problem(name), opts.function_scaling_threshold),
        opts.tolerance)
    return probe_kkt_pattern(prob, prob.m)


def study_sparse_kkt(device="cuda", small=False):
    import torch
    from chip_smoke import eager_ms
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.linalg.ldlt import ldlt_solve
    from uno_tpu_torch.linalg.sparse_ldlt import build_plan, make_sparse_ldlt
    timer = eager_ms if device == "cuda" else host_ms
    cases = [(name, *problem_pattern(name)) for name in SPARSE_KKT_PROBLEMS]
    cases += [(f"band_arrow_n{N}", *band_arrow_pattern(N))
              for N in (() if small else SPARSE_KKT_BAND_N)]
    rows = []
    for name, pat, is_dual in cases:
        N = pat.shape[0]
        rng = np.random.default_rng(0)
        A = kkt_matrix_from_pattern(pat, is_dual, rng)
        At = torch.as_tensor(A[None], dtype=torch.float32, device=device)
        rhs = torch.as_tensor(rng.standard_normal((1, N)), dtype=torch.float32,
                              device=device)
        plan = build_plan(pat, is_dual)
        fac, solve = make_sparse_ldlt(plan)
        with cuda_ldlt.uncounted():
            sparse_ms = timer(lambda: solve(fac(At), rhs))
            dense_ms = timer(lambda: ldlt_solve(cuda_ldlt.ldlt_factor_cuda(At), rhs))
            sp = solve(fac(At), rhs)
            de = ldlt_solve(cuda_ldlt.ldlt_factor_cuda(At), rhs)
        row = {"study": "sparse_kkt", "case": name, "N": N, "device": device,
               "dtype": "float32", "density": float(pat.sum()) / (N * N),
               "supernodes": plan.num_supernodes, "nnz_factor": plan.nnz_factor,
               "padded_flops": plan.padded_flops(), "dense_flops": plan.dense_flops(),
               "sparse_ms": sparse_ms, "dense_ms": dense_ms,
               "speedup": dense_ms / sparse_ms,
               "solution_gap": float((sp - de).abs().amax() / de.abs().amax())}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _banded_ms(n, bw, nb, route, dtype):
    import torch
    from chip_smoke import bench_band, eager_ms
    from uno_tpu_torch.linalg import banded
    band, rhs = bench_band(n, bw)
    bt = torch.as_tensor(band[None], dtype=dtype, device="cuda")
    rt = torch.as_tensor(rhs[None], dtype=dtype, device="cuda")

    def call():
        D, E = banded.band_to_blocks(bt, nb)
        if route == "cr":
            return banded.btd_solve_cr(banded.btd_cholesky_cr(D, E), rt)
        return banded.btd_solve(banded.btd_cholesky(D, E), rt)

    return eager_ms(call)


def study_cr_switch():
    import torch
    rows = []
    for nb, bw in ((8, 2), (32, 31)):
        for blocks in (16, 32, 64, 128, 256, 512):
            n = blocks * nb
            row = {"study": "cr_switch", "n": n, "bw": bw, "block": nb,
                   "blocks": blocks, "dtype": "float64",
                   "sweep_ms": _banded_ms(n, bw, nb, "sweep", torch.float64),
                   "cr_ms": _banded_ms(n, bw, nb, "cr", torch.float64)}
            row["sweep_again_ms"] = _banded_ms(n, bw, nb, "sweep", torch.float64)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def study_block_size():
    import torch
    from uno_tpu_torch.linalg.banded import pick_block_size
    from uno_tpu_torch.linalg.banded_kkt import CR_MIN_BLOCKS
    rows = []
    n = 4096
    for bw in (2, 31):
        for nb in sorted({pick_block_size(bw), 16, 32, 64, 128}):
            if nb <= bw:
                continue
            blocks = -(-n // nb)
            route = "cr" if blocks >= CR_MIN_BLOCKS else "sweep"
            row = {"study": "block_size", "n": n, "bw": bw, "block": nb,
                   "picked": nb == pick_block_size(bw), "blocks": blocks,
                   "route": route, "dtype": "float64",
                   "ms": _banded_ms(n, bw, nb, route, torch.float64)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def study_sparse_auto():
    import torch
    from chip_smoke import eager_ms
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.linalg.ldlt import ldlt_solve
    from uno_tpu_torch.linalg.sparse_kkt import probe_kkt_pattern
    from uno_tpu_torch.linalg.sparse_ldlt import build_plan, make_sparse_ldlt
    from uno_tpu_torch.model import transforms
    from uno_tpu_torch.model.library_cutest import cutest_problem
    from uno_tpu_torch.options import preset
    rows = []
    opts = preset("ipopt")
    for stages in (100, 200, 400, 800):
        nlp = cutest_problem("steering", 5 * (stages + 1) + 1)
        prob = transforms.reformulate_for_interior_point(
            transforms.scale_model(nlp, opts.function_scaling_threshold), opts.tolerance)
        pat, is_dual = probe_kkt_pattern(prob, prob.m)
        N = pat.shape[0]
        plan = build_plan(pat, is_dual)
        rng = np.random.default_rng(stages)
        A = np.where(pat, rng.standard_normal((N, N)), 0.0)
        A = (A + A.T) / 2
        A[np.diag_indices(N)] = np.where(is_dual, -1e-2, 10.0 + rng.random(N))
        At = torch.as_tensor(A[None], device="cuda")
        rhs = torch.as_tensor(rng.standard_normal((1, N)), device="cuda")
        fac, solve = make_sparse_ldlt(plan)
        with cuda_ldlt.uncounted():
            row = {"study": "sparse_auto", "stages": stages, "N": N,
                   "supernodes": plan.num_supernodes,
                   "padded_over_dense_flops": plan.padded_flops() / plan.dense_flops(),
                   "dtype": "float64",
                   "sparse_ms": eager_ms(lambda: solve(fac(At), rhs), groups=1),
                   "dense_ms": eager_ms(lambda: ldlt_solve(
                       cuda_ldlt.ldlt_factor_cuda(At), rhs)),
                   "dense_launches": cuda_ldlt.plan(1, N, At.dtype).launches}
        sp, de = solve(fac(At), rhs), ldlt_solve(cuda_ldlt.ldlt_factor_cuda(At), rhs)
        row["solution_gap"] = float((sp - de).abs().amax() / de.abs().amax())
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+", choices=STUDIES, default=list(STUDIES))
    parser.add_argument("--out", help="also write the rows here as JSON")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--small", action="store_true")
    args = parser.parse_args(argv)
    if args.device == "cpu":
        out = {"card": None, "device": "cpu"}
        for name in args.only:
            if name != "sparse_kkt":
                raise SystemExit(f"{name} times the card only")
            out[name] = study_sparse_kkt("cpu", args.small)
    else:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this study measures the card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        from uno_tpu_torch.linalg import cuda_ldlt
        cuda_ldlt.build()
        out = {"card": card}
        for name in args.only:
            out[name] = globals()[f"study_{name}"]()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
