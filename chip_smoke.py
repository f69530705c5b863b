#!/usr/bin/env python3
"""Smoke run of uno_tpu_torch on one NVIDIA H100: the quickest proof that
the port builds and runs on the card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each with its own wall-clock budget (a phase that fails or
overruns raises, and the script exits non-zero):
  1. device       a CUDA card is there; prints nvidia-smi's name and power limit
  2. build        nvcc builds csrc/*.cu (one nvcc each, at once) and g++
                  csrc/nlread.cpp (timed); prints each kernel's registers
                  and spills as ptxas reports them
  3. kernels      the LDL^T kernels (ldlt_warp up to dim 32, ldlt_column up
                  to 64, ldlt_panel above) against their plain PyTorch
                  versions on the card, at dims 12 to 516 (the route edges
                  31/32/33/64/65 among them) in float32 and float64;
                  ldlt_column's factors must equal the column form's bit for
                  bit, and ldlt_panel is timed at its shapes too; times with
                  CUDA events, and counts the kernels a call launches;
                  ldlt_column timed the same way at the first and last dim
                  of each of its buckets (B=1 and a ragged batch) and at the
                  batches where plan() changes its threads per instance;
                  ldlt_column against the column form, bit for bit, at every
                  dim 33-64 at B=1, 777 and 4,096; then the kernels against the
                  column form, bit for bit, at the dims of the SQP's
                  multiplier fits
  4. kernels_large  the same for single instances of dim 640 and 1280
  5. main path    the flagship family (n=8, m=2) at B=65,536 through
                  solve_batch, with the kernels' launch counts; the first
                  64 instances again on the CPU through the plain versions
  6. n32          the flagship family at n=32 (KKT dim 36, ldlt_column),
                  B=8,192, the same way; 8 instances again on the CPU
  7. n512         the flagship family at n=512 (KKT dim 516), B=132, the
                  same way; 2 instances again on the CPU
  8. single       solve(hs015, preset="ipopt") on the card
  9. single_large solve() of one flagship-family instance at n=1276 (KKT
                  dim 1280, float64), held against its closed-form optimum
 10. sqp_batch    filtersqp on the flagship family (n=8) at B=8,192 through
                  solve_batch; the first 64 instances again on the CPU
 11. sqp_single   filtersqp on hs071, funnelsqp and filterslp on hs015, on
                  the card and on the CPU
 12. byrd_batch   byrd on the flagship family (n=8) at B=8,192 the same way
 13. byrd_single  byrd on hs015 and hs071, on the card and on the CPU
 14. nl           three .nl fixtures and a binary twin read with read_nl and
                  solved with ipopt on the card and on the CPU; then the
                  command line (uno_tpu_torch.__main__.main) with byrd on a
                  copy of a fixture in a temporary directory
 14b. registry    every key of the problem registry with n + m <= 30 (249)
                  solved with ipopt on the card by 4 worker processes,
                  each held to uno_tpu's CPU result in
                  tests/fixtures/torch_registry_ref.json (status,
                  iterations, objective; the keys of REGISTRY_PARTS, which
                  part from uno_tpu by rounding, its solved verdict) and
                  the solved count by tools/sweep_torch.py's rule equal to
                  uno_tpu's; launches by route
 15. structured_kernels  bench.py's structured factorize+solve pairs: the
                  block-tridiagonal Cholesky at n=4,096, half-bandwidth 31
                  (cyclic reduction), float32 and float64, and the
                  supernodal LDL^T at N=8,192 (band 4, two dense rows),
                  float32, each against the same code on the CPU, timed
                  with its kernel launches and bound, beside the dense
                  wrapper (ldlt_panel) at the same dims
 16. banded       lukvle1 at n=4,096 (banded backend) against the CPU and
                  uno_tpu's result; at n=10,000 on the card alone, with its
                  initial multipliers' ldlt_panel call (dim 19,998) timed;
                  catena_n298's banded attempt and augmented retry
 17. lifted       the flagship batch (B=8,192) through the lifted Cholesky
                  in float64, 64 instances again on the CPU; hs015 lifted
 18. sparse       steering at N=400 stages under the supernodal LDL^T
                  against uno_tpu's result and route report, and the
                  card's augmented run; chwood_eq_n1000 under
                  auto_permute (detected band, banded backend)
 19. ipm_mixes    the IPM's ingredient mixes on the flagship family with the
                  main path's options: the funnel at B=65,536, the Fletcher
                  filter, the l1 merit, the nonmonotone filter and
                  LS_batch_candidates=4 at B=8,192 (beside the standard
                  filter, which the last must equal), each held to
                  uno_tpu's unsolved set and 64 CPU reruns; hs021 under the
                  identity and zero Hessians and lukvle1_n100 banded under
                  the identity, against the CPU
 20. sqp_host     the host SQP driver: hs015 and hs071 under the five
                  presets with sqp_driver="host", filtersqp with a line
                  search and byrd with a trust region, on the card and on
                  the CPU, held to uno_tpu's CPU results
 21. sharded      the main path's batch through solve_batch_sharded on a
                  one-process NCCL group, equal to main_path's solve_batch
                  result bit for bit in status, iterations and x
 22. dist_kkt     single_large's instance with ldlt_backend="distributed"
                  on that group (20 panels of 64 on dist_panel), held to
                  single_large's standard and timed beside it; dist_panel
                  against panel_factor_plain bit for bit at (1280, 64) and
                  (8192, 64), float32 and float64, timed with its bound
 23. schur        the Schur-complement factor and solve of a block-arrow
                  system (S=2,048 blocks of 64, n0=256, float64: the blocks
                  on ldlt_column, S_0 on ldlt_panel) against the CPU, with
                  its residual and times
 24. structured   the two-stage scenario IPM at S=4,096 (blocks on
                  ldlt_warp) against the CPU and uno_tpu's recorded result
 25. summary      the {"kernels": [...]} line (each kernel's launches and
                  wrapper calls on its path, as cuda_ldlt counted them),
                  then the last line {"ok": true, "device": {...}}
With --profile, the flagship batches of the main path and the filtersqp
path (phase profile), then of the byrd path (phase profile_byrd), and
lukvle1 at n=4,096 (phase profile_structured) run once more under
torch.profiler, which prints where their time goes (device busy share,
kernels and host operators by time).

The structured backends' factorizations are library calls and torch
operations (cholesky_ex, triangular solves, matmuls), as uno_tpu's are
outside Pallas; their paths still run the LDL^T kernels for the initial
multipliers and catena's retry.

Imports torch, numpy, uno_tpu_torch and tools/sweep_torch.py's solved
rule only.  Starts no child process other than nvidia-smi, nvcc, g++ and
the registry phase's REGISTRY_JOBS workers (a pool it closes before the
next phase), and no thread of its own (the one-process NCCL group of
phases 21-22 runs NCCL's, and is destroyed before the last lines).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import signal
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

# seconds per phase; the whole script stays well inside 20 minutes
BUDGETS = {"device": 60, "build": 320, "kernels": 300, "kernels_large": 300,
           "main_path": 360, "n32": 240, "n512": 240, "single": 120,
           "single_large": 180, "sqp_batch": 360, "sqp_single": 180,
           "byrd_batch": 360, "byrd_single": 180, "nl": 300, "registry": 300,
           "structured_kernels": 300, "banded": 600, "lifted": 300,
           "sparse": 600, "ipm_mixes": 300, "sqp_host": 300,
           "sharded": 240, "dist_kkt": 300, "schur": 300, "structured": 300,
           "profile": 600, "profile_byrd": 450,
           "profile_structured": 300}
# the route edges 31/32/33 and 64/65, and 34 and 66, where float64 rows
# end two elements into a 16-byte vector
KERNEL_DIMS = (12, 31, 32, 33, 34, 40, 64, 65, 66, 132, 260, 516)
# instances per dim in the kernel phase: the main path's batch at dim 12,
# then about two instances per SM for the large dims
KERNEL_BATCH = {12: 65536, 31: 4096, 32: 4096, 33: 4096, 34: 4096, 40: 4096,
                64: 2048, 65: 2048, 66: 2048, 132: 512, 260: 264, 516: 132}
# single instances in the Pallas single-instance kernel's range
LARGE_DIMS = (640, 1280)
# and the initial-multiplier matrix of lukvle1 at n=4,096 (dim n + m), float64
STRUCT_INIT_DIM = 8190
# above this dim the plain version is timed eagerly, not in a CUDA graph
PLAIN_GRAPH_MAX_DIM = 4096
# ldlt_column, which is compiled for each bucket of 8 dims: the first and
# last dim of every bucket, timed at B=1 and at a ragged batch beside
# ldlt_panel; the dims of the n=32 path and of the largest bucket timed on
# both sides of each batch where plan() changes their threads per
# instance; and every dim 33-64, untimed, against the column form bit for
# bit at B=1 and the ragged batch (64 threads an instance) and at the
# largest switch batch, where every dim takes its smallest group (16
# threads up to dim 40, 32 in float64 above 56): every kernel of the route
COLUMN_EDGE_DIMS = (33, 40, 41, 48, 49, 56, 57, 63, 64)
COLUMN_SWITCH_DIMS = (36, 64)
COLUMN_RAGGED_BATCH = 777
COLUMN_EXACT_BATCHES = (1, COLUMN_RAGGED_BATCH, 4096)
# the dims of the QP multiplier fits' normal equations (m + 2n of each QP)
# on the SQP paths: hs015's, hs071's and the flagship's optimality and
# restoration QPs (byrd's relaxed QPs have the restoration QPs' widths:
# 10, 16 and 22), and byrd's on hs015like_n10.nl in the nl phase (35);
# uno_tpu factors them with the column form
FIT_DIMS = (6, 10, 16, 18, 22, 35)
# the kernel against its plain version on the same inputs, entry by entry:
# |L_k - L_p| <= FACTOR_RTOL * max(|L_p|, 1), and the same for d.  On these
# matrices a float32 factorization lies up to 4.1e-6 from the float64 one
# (the plain versions on the CPU, dim 12, 65,536 instances), so two float32
# ones lie within about 1e-5 of each other.  Every float64 row also checks
# that float32 factors fail the float64 limit.
FACTOR_RTOL = {"float32": 5e-5, "float64": 1e-11}
# componentwise backward error of every instance, entry by entry:
# |L D L^T - A| <= BACKWARD_LIMIT * dim * eps * (|L| |D| |L^T|).  Unpivoted
# elimination meets it with dim * eps / 2 (Higham, Accuracy and Stability of
# Numerical Algorithms, thm 9.3); the plain versions reach at most 0.24 of
# dim * eps here
BACKWARD_LIMIT = 1.0
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s; float32 outside
# the tensor cores and float64 on the tensor cores, FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
MAIN_BATCH = 65536
MAIN_KKT_DIM = 12
MAIN_MAX_ITERATIONS = 100
CPU_RERUN = 64
# the CPU rerun of the first instances: statuses and iterations equal, x
# within X_ATOL.  The card and the CPU factor in float32 with different
# instruction sequences (fused multiply-adds, reduction orders), but the
# float64 refinement makes the steps agree: every one of the 64 instances
# took the same iterations, with x within 2.2e-14
ITERATION_SLACK = 0
X_ATOL = 1e-10
HS015_ITERATIONS = 17
HS015_OPTIMUM = 306.5
# the n=32 point of the main path (bench.py's n=32 batch, KKT dim 36, the
# ldlt_column route), held to the flagship's limits
N32 = 32
N32_BATCH = 8192
N32_KKT_DIM = 36
N32_RERUN = 8
# the n=512 point of the main path (KKT dim 516, ldlt_panel) at the kernel
# sweep's batch for dim 516, every instance solved; held to the flagship's
# limits.  The card's panels give the plain version's factors bit for bit
# at dims above 64, and an H100 run measured equal iterations on both CPU
# reruns, with x within 2.8e-17 (PERF.md)
N512 = 512
N512_BATCH = 132
N512_KKT_DIM = 516
N512_RERUN = 2
N512_ITERATION_SLACK = 0
N512_X_ATOL = 1e-10
# one flagship-family instance (params 0) with KKT dim 1280: min x^T Q x with
# Q = I + 0.05 (super- and subdiagonal), s.t. sum(x) >= 1; the bounds and
# the norm constraint are inactive at its optimum, 1 / (1^T Q^-1 1).  The
# port's CPU solve of it, solve(flagship(1, n=1276)[0], preset="ipopt",
# device="cpu"), takes 21 iterations and ends 2.3e-9 above that value.  The
# card's float64 panels give the plain version's factors bit for bit at
# dim 1280, and an H100 run took the same 21 iterations (PERF.md)
LARGE_N = 1276
LARGE_KKT_DIM = 1280
LARGE_CPU_ITERATIONS = 21
LARGE_ITERATION_SLACK = 0
LARGE_F_ATOL = 1e-8
# the fused SQP path: filtersqp on the flagship family with uno_tpu's
# bench options for it (bench.py:113-114), its optimality QP's KKT of dim
# n + m = 10 in float32 and its multiplier fit's normal equations of dim
# m + 2n = 18 in float64; held to the flagship's limits
SQP_BATCH = 8192
SQP_RERUN = 64
SQP_MAX_ITERATIONS = 60
SQP_KKT_DIM = 10
SQP_FIT_DIM = 18
# single instances of the three presets: the card's run against the CPU's,
# equal status and iterations, objective within SQP_F_ATOL
SQP_SINGLE = (("filtersqp", "hs071"), ("funnelsqp", "hs015"),
              ("filterslp", "hs015"))
SQP_SINGLE_KKT_DIM = 6       # hs071's optimality QP, n + m, float64
SQP_F_ATOL = 1e-8
# byrd: its relaxed QP has width n + n_el (the elastics: one per inequality,
# two per equality), so the flagship's KKT has dim 8 + 2 + 2 = 12 (float32
# in the batch) and its multiplier fit dim 2 + 2 * 10 = 22 (float64);
# hs071's KKT dim 4 + 3 + 2 = 9 (float64), the largest of the single runs
BYRD_KKT_DIM = 12
BYRD_FIT_DIM = 22
BYRD_SINGLE = (("byrd", "hs015"), ("byrd", "hs071"))
# the flagship instances of the B=8,192 batch that byrd does not solve: the
# port and uno_tpu, both on the CPU, end exactly these 9 at the 60-iteration
# cap (8,183 solved; uno_tpu's TPU bench recorded 8,183 too, BENCH_r05.json),
# so the byrd phase holds the card to this set in place of a solved share
BYRD_UNSOLVED = (653, 2605, 2666, 4010, 4812, 5402, 6092, 6811, 8057)
BYRD_SINGLE_KKT_DIM = 9
# the .nl path: fixtures read by the port's parser and solved with ipopt
# (KKT dims 100, 73 and 50, float64: ldlt_panel, ldlt_panel, ldlt_column),
# the binary twin of one of them; then the command line with byrd on a copy
# of hs015like_n10.nl (relaxed-QP KKT dim 10 + 5 + 5 = 20, fit dim 35).
# Card against CPU: equal status and iterations, objective within
# NL_F_TOL * max(|f|, 1); the command line's .sol x against solve()'s on
# the card, within NL_SOL_ATOL
NL_DIR = Path(__file__).resolve().parent / "tests" / "fixtures" / "nl"
NL_FIXTURES = ("hs015like_n50.nl", "catena_n48.nl", "srosenbr_n50.nl",
               "catena_n48.bin.nl")
NL_KKT_DIMS = {"ldlt_panel": 100, "ldlt_column": 50}
NL_CLI_FIXTURE = "hs015like_n10.nl"
NL_CLI_KKT_DIM = 20
NL_F_TOL = 1e-8
NL_SOL_ATOL = 1e-12
# the registry phase: every key of the problem registry with n + m <= 30,
# under ipopt as tools/sweep_torch.py solves it, held to uno_tpu's CPU
# results recorded by tools/registry_reference.py
REGISTRY_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_registry_ref.json"
# seconds one key's solve may take on the card (the slowest, hs101, took
# 9.1 s alone and 8.0 s beside three other workers); going past it fails
# the phase
REGISTRY_KEY_WALL = 20.0
# worker processes solving the keys, each with its own CUDA context
REGISTRY_JOBS = 4
REGISTRY_F_RTOL = 1e-8
# the keys whose run on the card may part from uno_tpu's recorded run (and
# must still get uno_tpu's solved verdict): key -> (the first iteration at
# which the port's iterates leave uno_tpu's on the CPU, the quantity that
# parts them).  Each is backed by a CPU test of
# tests/test_torch_registry_parts.py: uno_tpu's own run parting the same
# way when x0 moves by one ulp (hs009, whose x0 is 0: by 1e-16), and for
# hs061 the pivot itself; any other mismatch is a port fault
REGISTRY_PARTS = {
    "biggs6": (26, "x, by 1e-10 (77 iterations on the card, 76 in uno_tpu)"),
    "genhumps_n10": (26, "x, by 1e-10"),
    "genhumps_n30": (24, "x, by 1e-10"),
    "hs009": (4, "stationarity at the termination test (uno_tpu ends "
                 "almost_optimal in 17 iterations, the port optimal in 4)"),
    "hs050": (1, "x, by O(1): the first step"),
    "hs061": (0, "the least-squares initial multipliers: the last pivot of "
                 "[I J^T; J 0], exactly singular at x0, is -8.9e-16 under "
                 "XLA's fused multiply-add and 0 in the port, which then "
                 "rejects them (filed in ROADMAP.md queue 3)"),
    "meyer": (20, "x, by 1e-10"),
    "noncvxun_n10": (10, "x, by 1e-10"),
    "penalty2_n10": (29, "x, by 1e-10"),
    "powell_bs": (43, "x, by 1e-10"),
}
# the structured KKT backends.  bench.py's structured shapes: the banded
# matrix at n=4,096, half-bandwidth 31 (bench.py:372-380; blocks of 32, 128
# of them, so cyclic reduction) and the sparse one at N=8,192, band 4 plus
# two dense rows and columns (bench.py:433-444), from STRUCT_SEED.  Card
# against the CPU running the same code: the solution within STRUCT_TOL of
# max |x_cpu|, and |A x - b| / |b| within it
STRUCT_BANDED_N, STRUCT_BANDED_BW = 4096, 31
STRUCT_SPARSE_N, STRUCT_SPARSE_BW = 8192, 4
STRUCT_SEED = 12
STRUCT_TOL = {"float32": 1e-4, "float64": 1e-10}
# uno_tpu's CPU results (JAX_PLATFORMS=cpu, kkt_formulation="auto"):
# lukvle1 at n=4,096 optimal in 6 iterations (as at n=1,000 and n=100);
# catena_n298's banded attempt ends in an algorithmic error, its augmented
# retry optimal in 16
LUKVLE1_N = 4096
LUKVLE1_LARGE_N = 10000
LUKVLE1_ITERATIONS = 6
LUKVLE1_OPTIMUM = 6.2324586324379885
CATENA_NAME = "catena_n298"
CATENA_ITERATIONS = 16
CATENA_OPTIMUM = -68.33955182986908
# catena's augmented retry: KKT dim n + m = 298 + 150
CATENA_KKT_DIM = 448
# the flagship batch under the lifted backend in float64: uno_tpu on the CPU
# solves all 8,192 of these instances (mean 9.30, max 16 iterations)
LIFTED_BATCH = 8192
LIFTED_RERUN = 64
LIFTED_UNSOLVED = ()
# steering at N=400 stages (n=2,006, m=1,600): uno_tpu's CPU run with
# kkt_formulation="sparse" is optimal in 20 iterations, and its route report
# reads KKT N=3,613 (1,607 rows with the 7 fixed variables), 231
# supernodes, padded/dense flop ratio 0.047
STEERING_N = 2006
STEERING_REF = {"iterations": 20, "objective": 0.5545724135923553, "N": 3613,
                "supernodes": 231, "flop_ratio": 0.047}
# its initial multipliers' dense KKT (dim N), float64
STEERING_KKT_DIM = 3613
# auto_permute's detection finds a band here (uno_tpu: Jacobian windows of
# width 4) and the banded backend solves it
CHWOOD_NAME = "chwood_eq_n1000"
# the IPM's ingredient mixes on the flagship family with the main path's
# options: the funnel at the main path's batch, the others at B=8,192.
# uno_tpu's CPU run of each of these batches (uno_tpu.solvers.batch.
# build_batch_ipm over the same instances, JAX_PLATFORMS=cpu) solves every
# instance (mean 9.28 iterations for the funnel at B=65,536; 9.30, 9.24,
# 9.35 and 9.30 for the others, max 16), so each batch is held to an empty
# unsolved set; the port's CPU run equals uno_tpu's there instance for
# instance
IPM_MIX_BATCHES = {"funnel_method": dict(globalization_strategy="funnel_method"),
                   "fletcher_filter_method": dict(globalization_strategy="fletcher_filter_method"),
                   "l1_merit": dict(globalization_strategy="l1_merit"),
                   "nonmonotone": dict(filter_type="nonmonotone"),
                   "LS_batch_candidates=4": dict(LS_batch_candidates=4)}
IPM_MIX_FULL = "funnel_method"
IPM_MIX_BATCH = 8192
IPM_MIX_UNSOLVED = dict.fromkeys(IPM_MIX_BATCHES, ())
# single instances of the Hessian models, card against CPU (status,
# iterations, x within IPM_MIX_X_ATOL, objective within 1e-10 relative):
# hs021 under the identity model as uno_tpu's test runs it (optimal in 372
# iterations); the two ill-conditioned runs only as long as the card's
# iterates stay within IPM_MIX_X_ATOL of the CPU's.  hs021 under the zero
# model: trajectories that part by one ulp stay within 1e-8 for about 30
# iterations, as uno_tpu's own run from a moved x0 does on the CPU; card
# against CPU on an H100 80GB HBM3 (700 W), the same in two runs: 2.5e-10
# at iteration 30, 5.5e-8 at 31.  lukvle1_n100 on the banded backend under
# the identity model, card against CPU there, the same in three runs:
# 1.0e-11 at iteration 2, 7.3e-11 at 3, 4.0e-8 at 4, 5.7e-7 at 10 (its
# CPU banded iterate is 5.3e-6 from its augmented one at 10)
IPM_MIX_SINGLES = (("hs021", dict(hessian_model="identity", max_iterations=500)),
                   ("hs021", dict(hessian_model="zero", max_iterations=30)),
                   ("lukvle1_n100", dict(hessian_model="identity", max_iterations=3)))
IPM_MIX_X_ATOL = 1e-8
# the host SQP driver: hs015 and hs071 under the five presets with
# sqp_driver="host" (ipopt takes its interior-point method, which has no
# SQP driver), and the two mixes only the host driver runs; uno_tpu's CPU
# results (uno_tpu.solve, JAX_PLATFORMS=cpu): status, iterations, QPs,
# objective
SQP_HOST_REF = {
    ("ipopt", "hs015", "host"): ("optimal", 17, 17, 306.4999756105925),
    ("filtersqp", "hs015", "host"): ("optimal", 6, 6, 306.5000000050118),
    ("funnelsqp", "hs015", "host"): ("optimal", 6, 6, 306.5000000050118),
    ("filterslp", "hs015", "host"): ("optimal", 3, 3, 306.5000000200015),
    ("byrd", "hs015", "host"): ("optimal", 6, 6, 306.50004824488906),
    ("ipopt", "hs071", "host"): ("optimal", 8, 8, 17.01401714517916),
    ("filtersqp", "hs071", "host"): ("optimal", 5, 5, 17.014017291672168),
    ("funnelsqp", "hs071", "host"): ("optimal", 5, 5, 17.014017291672168),
    ("filterslp", "hs071", "host"): ("feasible_small_step", 183, 224, 17.014017381025575),
    ("byrd", "hs071", "host"): ("optimal", 47, 47, 17.014017291003842),
    ("filtersqp", "hs015", "LS"): ("algorithmic_error", 5, 5, 221.18821547430997),
    ("filtersqp", "hs071", "LS"): ("optimal", 5, 5, 17.014017291672168),
    ("byrd", "hs015", "TR"): ("optimal", 6, 6, 306.50004824713056),
    ("byrd", "hs071", "TR"): ("optimal", 47, 47, 17.014017291003842),
}
# hs071 under filterslp: its LPs' interior-point solutions agree across
# implementations to about 1e-11 (their tolerance is 1e-8), and near
# iteration 175 of 183 a trust-region radius test falls either way: the
# port's CPU run ends at 180 iterations and 220 LPs, uno_tpu's at 183 and
# 224, both feasible_small_step at the optimum.  This run is held to the
# status and to the objective within SQP_HOST_SENSITIVE_F_RTOL
SQP_HOST_SENSITIVE = {("filterslp", "hs071", "host")}
SQP_HOST_SENSITIVE_F_RTOL = 1e-6
# slice 4, multi-card on torch.distributed, each path on a one-process
# group (NCCL on the card, parallel/group.make_group).  sharded: the main
# path's batch through solve_batch_sharded, equal to main_path's
# solve_batch bit for bit in status, iterations and x.  dist_kkt: the
# dim-1280 instance of single_large with ldlt_backend="distributed" (its
# 20 panels of dist_ldlt_block = 64 on dist_panel), held to single_large's
# standard; dist_panel against panel_factor_plain bit for bit on a
# (rows, rows) rank storage at these heights, float32 and float64, its
# first panel (row0 0, the most work) timed and a middle one and the last
# checked; untimed, the same on rank 1's storage of DIST_PANEL_RANKS ranks
# (ld = rows / 4, col0 > 0) and on panels with a NaN pivot and an infinite
# multiplier (dist_panel_storage's `nonfinite`)
DIST_PANEL_ROWS = (1280, 8192)
DIST_BLOCK = 64
DIST_PANEL_RANKS = 4
DIST_PANEL_NONFINITE = ("nan_pivot", "inf_multiplier")
# schur: random_block_arrow_system(S, nb, n0) in float64 (K_s 67 MB, B_s and
# Y 268 MB each), the blocks on ldlt_column (2048, 64), S_0 on ldlt_panel
# (1, 256); card against the same code on the CPU: equal inertia, x within
# SCHUR_X_ATOL; |K x - r| / |r| within SCHUR_RESIDUAL on the card
SCHUR_S, SCHUR_NB, SCHUR_N0 = 2048, 64, 256
SCHUR_SEED = 21
SCHUR_X_ATOL = 1e-10
SCHUR_RESIDUAL = 1e-10
# structured: the two-stage family of tests/test_structured.py (seed 0) at
# STRUCTURED_S scenarios, the scenario blocks (S, 4, 4) on ldlt_warp; card
# against the port on the CPU (status and iterations equal, x0 and xs
# within STRUCTURED_X_ATOL) and against uno_tpu's CPU result, made by
# `JAX_PLATFORMS=cpu python3 tools/structured_reference.py 4096`: status,
# iterations, objective, x0, and the sum and sum of squares of xs
STRUCTURED_S = 4096
STRUCTURED_X_ATOL = 1e-8
STRUCTURED_REF = {"status": "optimal", "iterations": 17,
                  "objective": 1690.9452075648258,
                  "x0": (2.0279941158736876, 1.0),
                  "xs_sum": 6755.414269402402, "xs_sumsq": 5909.606268944565}


class PhaseTimeout(Exception):
    pass


def _on_alarm(signum, frame):
    raise PhaseTimeout("phase budget exhausted")


# seconds each phase took, in the order they ran (in --out's JSON)
phase_seconds = {}


def run_phase(name, fn, *args, **kwargs):
    """Run one phase under its budget; raises if it fails or overruns."""
    budget = BUDGETS[name]
    print(f"== {name} (budget {budget} s)", flush=True)
    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(budget)
    t0 = time.monotonic()
    try:
        out = fn(*args, **kwargs)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    took = time.monotonic() - t0
    phase_seconds[name] = took
    print(f"== {name} done in {took:.3f} s", flush=True)
    if took > budget:
        raise PhaseTimeout(f"phase {name} took {took:.1f} s > {budget} s")
    return out


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def ptxas_report(log):
    """Each kernel's registers and spill bytes from nvcc -Xptxas=-v's
    output, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def phase_build():
    from uno_tpu_torch.io import nl as nl_io
    from uno_tpu_torch.linalg import cuda_ldlt
    t0 = time.monotonic()
    path = cuda_ldlt.build()
    seconds = time.monotonic() - t0
    print(f"built {path.name} in {seconds:.2f} s", flush=True)
    kernels = ptxas_report(cuda_ldlt.build_log)
    for name, info in kernels.items():
        print(f"  {name}: {info}", flush=True)
    t0 = time.monotonic()
    nl_path = nl_io.build()
    nl_seconds = time.monotonic() - t0
    print(f"built {nl_path.name} in {nl_seconds:.2f} s", flush=True)
    return {"seconds": seconds, "library": path.name, "ptxas": kernels,
            "nlread_seconds": nl_seconds, "nlread_library": nl_path.name}


# ---------------------------------------------------------------------------
# 3. the kernel against its plain version
# ---------------------------------------------------------------------------

def barrier_kkt_like(batch, dim, seed):
    """Seeded barrier-KKT-like matrices (after tests/test_ldlt.py's
    _barrier_kkt_like): H + Sigma with diagonal 1..1e3 and small symmetric
    coupling, a Gaussian J, a -eps dual block of 1e-8..1e-2.  Every second
    instance has a non-convex H (30% of its diagonal negated, those columns
    of J zero), the case the inertia correction exists for.  All are
    indefinite; returns (K, expected (num_pos, num_neg))."""
    rng = np.random.default_rng(seed)
    m = max(1, dim // 6) if dim > 1 else 0
    n = dim - m
    H = rng.standard_normal((batch, n, n)) * (0.1 / np.sqrt(n))
    H = (H + np.swapaxes(H, 1, 2)) / 2
    diag = 10.0 ** rng.uniform(0, 3, (batch, n))
    neg = (rng.uniform(size=(batch, n)) < 0.3) & (np.arange(batch) % 2 == 1)[:, None]
    idx = np.arange(n)
    H[:, idx, idx] = np.where(neg, -diag, diag)
    J = rng.standard_normal((batch, m, n))
    J = np.where(neg[:, None, :], 0.0, J)
    K = np.zeros((batch, dim, dim))
    K[:, :n, :n] = H
    K[:, n:, :n] = J
    K[:, :n, n:] = np.swapaxes(J, 1, 2)
    K[:, np.arange(n, dim), np.arange(n, dim)] = -(10.0 ** rng.uniform(-8, -2, (batch, m)))
    num_neg = neg.sum(axis=1) + m
    return K, np.stack([dim - num_neg, num_neg], axis=1)


def _timed_calls(call, groups, calls):
    """Median over `groups` of the mean ms of `calls` back-to-back calls
    between two CUDA events."""
    import torch
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _calls_for(call, target_ms):
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    call()
    torch.cuda.synchronize()
    first_ms = (time.monotonic() - t0) * 1e3
    return int(min(50, max(1, target_ms // max(first_ms, 1e-3))))


def time_ms(fn, groups=3, target_ms=50.0):
    """The card's time for one call of fn, in ms: fn is captured once in a
    CUDA graph (after a warm-up on a side stream) and its replays are timed
    between CUDA events, so the host's time to issue the launches does not
    count; median of `groups` groups of back-to-back replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    try:
        return _timed_calls(graph.replay, groups, _calls_for(graph.replay, target_ms))
    finally:
        del graph


def eager_ms(fn, groups=3, target_ms=50.0):
    """ms per eager call of fn, host issue time included (CUDA events around
    back-to-back calls)."""
    fn()
    return _timed_calls(fn, groups, _calls_for(fn, target_ms))


def bound_ms(batch, dim, itemsize, dtype_name):
    """The least time for the work: what the function must move over the
    memory rate (the lower triangle of A read, dim(dim+1)/2 elements; the
    dense L and d that the API returns written, dim^2 + dim, and the three
    int64 inertia counts), against batch*dim^3/3 flops over the peak rate;
    the larger of the two."""
    bytes_moved = batch * ((dim * (dim + 1) // 2 + dim * dim + dim) * itemsize + 3 * 8)
    flops = batch * dim ** 3 / 3.0
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def factor_gap(fk, fp):
    """max over every entry of L and d of |kernel - plain| / max(|plain|, 1)."""
    return max(float(((a - b).abs() / b.abs().clamp(min=1.0)).amax())
               for a, b in ((fk.L, fp.L), (fk.d, fp.d)))


def backward_error(fac, A):
    """max over instances and entries of |L D L^T - A| / (dim * eps *
    |L| |D| |L^T|), in float64, with eps that of A's dtype: at most
    BACKWARD_LIMIT for a sound factorization."""
    import torch
    L, d, A64 = fac.L.double(), fac.d.double(), A.double()
    R = (L * d[:, None, :]) @ L.transpose(1, 2) - A64
    S = (L.abs() * d.abs()[:, None, :]) @ L.abs().transpose(1, 2)
    S = S * (A.shape[-1] * torch.finfo(A.dtype).eps)
    return float((R.abs() / S.clamp(min=torch.finfo(torch.float64).tiny)).amax())


def check_kernel(batch, dim, dtype_name, seed=0, expected=None, K=None):
    """Run the kernels and their plain version on the same card tensors;
    raise unless each meets the backward-error limit, the two agree entry
    by entry within FACTOR_RTOL, they give the same inertia, and the
    kernels' own inertia equals _inertia over their d.  Returns the
    measurements: `ms` is the kernels' launches alone, inertia included;
    `kernel_launches` the kernels one call launched, as the wrapper counted
    them (it must be the plan's number).  Its launches leave the wrapper's
    counts as they were."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.linalg.ldlt import plain_factorizer

    dtype = getattr(torch, dtype_name)
    if K is None:
        K, expected = barrier_kkt_like(batch, dim, seed)
    A = torch.as_tensor(K, dtype=dtype, device="cuda").contiguous()
    plain = plain_factorizer(dim)
    with cuda_ldlt.uncounted():
        before = sum(cuda_ldlt.launches.values())
        fk = cuda_ldlt.ldlt_factor_cuda(A)
        launched = sum(cuda_ldlt.launches.values()) - before
        return _check_kernel(A, fk, plain, launched, batch, dim, dtype_name, expected)


def _check_kernel(A, fk, plain, launched, batch, dim, dtype_name, expected):
    """check_kernel's checks and timings of the kernels' factors fk of A,
    of which one call launched `launched` kernels."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.linalg.ldlt import LDLT, _inertia

    dtype = A.dtype
    fp = plain(A)
    torch.cuda.synchronize()
    tag = f"dim {dim} {dtype_name}"
    row = {"batch": batch, "dim": dim, "dtype": dtype_name}
    plan = cuda_ldlt.plan(batch, dim, dtype)
    row["route"], row["kernel_launches"] = plan.route, launched
    if launched != plan.launches:
        raise AssertionError(f"{tag}: a call launched {launched} kernels, "
                             f"its plan {plan.launches}")
    for name, fac in (("backward_error", fk), ("plain_backward_error", fp)):
        row[name] = backward_error(fac, A)
        if not row[name] <= BACKWARD_LIMIT:
            raise AssertionError(f"{tag}: {name} {row[name]:.3e} > {BACKWARD_LIMIT}")
    row["factor_gap"] = factor_gap(fk, fp)
    if not row["factor_gap"] <= FACTOR_RTOL[dtype_name]:
        raise AssertionError(f"{tag}: kernel and plain L, d differ by "
                             f"{row['factor_gap']:.3e} > {FACTOR_RTOL[dtype_name]:g}")
    if plan.route == "ldlt_column" and row["factor_gap"] != 0.0:
        # the column form's operations in its order: equal bit for bit
        raise AssertionError(f"{tag}: ldlt_column's factors differ from the "
                             f"column form's by {row['factor_gap']:.3e}")
    upper = torch.triu(fk.L, 1).abs().amax()
    unit = (torch.diagonal(fk.L, dim1=1, dim2=2) - 1).abs().amax()
    if float(upper) != 0.0 or float(unit) != 0.0:
        raise AssertionError(f"kernel {tag}: L is not unit lower triangular")
    fused = _inertia(fk.d, 1e-32)
    for k, name in enumerate(("num_pos", "num_neg", "num_zero")):
        if not torch.equal(getattr(fk, name), fused[k]):
            raise AssertionError(f"{tag}: the kernel's {name} differs from "
                                 "_inertia over its own d")
        if not torch.equal(getattr(fk, name), getattr(fp, name)):
            raise AssertionError(f"{tag}: {name} differs between kernel and "
                                 "plain version")
    if expected is not None:
        got = torch.stack([fk.num_pos, fk.num_neg], 1).cpu().numpy()
        if not np.array_equal(got, expected):
            raise AssertionError(f"{tag}: inertia != expected")
    if dtype == torch.float64:
        # the float64 limits reject float32 factors of the same matrices
        f32 = cuda_ldlt.ldlt_factor_cuda(A.float())
        f32 = f32._replace(L=f32.L.double(), d=f32.d.double())
        row["f32_factor_gap"] = factor_gap(f32, fp)
        row["f32_backward_error"] = backward_error(f32, A)
        if not (row["f32_factor_gap"] > FACTOR_RTOL["float64"]
                and row["f32_backward_error"] > BACKWARD_LIMIT):
            raise AssertionError(f"{tag}: the float64 limits pass float32 factors")
    row["max_abs_err"] = float(torch.maximum((fk.L - fp.L).abs().amax(),
                                             (fk.d - fp.d).abs().amax()))
    L, d = torch.empty_like(A), torch.empty((batch, dim), dtype=dtype, device="cuda")
    counts = [torch.empty(batch, dtype=torch.int64, device="cuda") for _ in range(3)]
    row["ms"] = time_ms(lambda: cuda_ldlt.launch(A, L, d, *counts))
    if plan.route == "ldlt_column":
        # ldlt_panel, which took these dims before, in turns with it
        panel = (torch.empty_like(A), torch.empty_like(d), *(torch.empty_like(c)
                                                             for c in counts))
        cuda_ldlt.launch(A, *panel, route="ldlt_panel")
        row["panel_factor_gap"] = factor_gap(LDLT(*panel), fp)
        row["panel_ms"] = time_ms(lambda: cuda_ldlt.launch(A, L, d, *counts,
                                                           route="ldlt_panel"))
        row["ms_again"] = time_ms(lambda: cuda_ldlt.launch(A, L, d, *counts))
    if dim <= PLAIN_GRAPH_MAX_DIM:
        row["plain_ms"] = time_ms(lambda: plain(A))
    else:
        # the plain panels' many full-size temporaries would all be held by
        # a CUDA graph's capture: timed eagerly, the host's issue included
        row["plain_ms"] = eager_ms(lambda: plain(A), groups=1, target_ms=1.0)
        row["plain_timed"] = "eager"
    row["eager_ms"] = eager_ms(lambda: cuda_ldlt.ldlt_factor_cuda(A))
    row["bound_ms"], row["bound_by"] = bound_ms(batch, dim, A.element_size(), dtype_name)
    print(json.dumps(row), flush=True)
    return row


def fit_like(batch, dim, seed):
    """Seeded normal equations A^T A + lam I of the QP multiplier fit's
    kind: A holds Gaussian constraint gradients, then unit columns of the
    active bounds, and lam = 1e-10 (1 + max |A|) (solvers/qp.py)."""
    rng = np.random.default_rng(seed)
    m = max(1, dim // 5)
    n = (dim - m) // 2
    A = np.zeros((batch, n, dim))
    A[:, :, :m] = rng.standard_normal((batch, n, m)) * (rng.uniform(size=(batch, 1, m)) < 0.7)
    act = rng.uniform(size=(batch, n, 2)) < 0.4
    idx = np.arange(n)
    A[:, idx, m + idx] = act[:, :, 0]
    A[:, idx, m + n + idx] = act[:, :, 1]
    lam = 1e-10 * (1.0 + np.abs(A).max(axis=(1, 2)))
    return np.swapaxes(A, 1, 2) @ A + lam[:, None, None] * np.eye(dim)


def check_fit_exact(batch, dim, seed=0):
    """The kernels' factors of multiplier-fit matrices (float64) against
    uno_tpu's choice for the fit, the column form, at any dim: equal bit for
    bit, with equal inertia.  Returns the route and the gap (0)."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.linalg.ldlt import ldlt_factor
    A = torch.as_tensor(fit_like(batch, dim, seed), device="cuda").contiguous()
    with cuda_ldlt.uncounted():
        fk = cuda_ldlt.ldlt_factor_cuda(A)
    fc = ldlt_factor(A)
    torch.cuda.synchronize()
    gap = max(float((fk.L - fc.L).abs().amax()), float((fk.d - fc.d).abs().amax()))
    same = all(torch.equal(getattr(fk, k), getattr(fc, k))
               for k in ("num_pos", "num_neg", "num_zero"))
    row = {"check": "fit", "batch": batch, "dim": dim,
           "route": cuda_ldlt.plan(batch, dim, A.dtype).route,
           "max_abs_err": gap, "inertia_equal": same}
    print(json.dumps(row), flush=True)
    if gap != 0.0 or not same:
        raise AssertionError(f"fit dim {dim}: the kernel differs from the "
                             f"column form by {gap:.3e} (inertia equal: {same})")
    return row


def column_batches():
    """The batches ldlt_column is checked at: 1, 2, a ragged one, and each
    batch where plan() changes its threads per instance with the one just
    under it."""
    from uno_tpu_torch.linalg import cuda_ldlt
    out = {1, 2, COLUMN_RAGGED_BATCH}
    for least in cuda_ldlt.COLUMN_SWITCH_BATCHES:
        out |= {least - 1, least}
    return sorted(out)


def check_column_exact(batches, dims, dtype_name):
    """ldlt_column's L, d and inertia against the column form's, bit for
    bit (torch.equal), at every batch and dim; raises on the first that
    differs.  Returns the cases checked."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.linalg.ldlt import ldlt_factor
    dtype = getattr(torch, dtype_name)
    for batch in batches:
        for dim in dims:
            K, _ = barrier_kkt_like(batch, dim, seed=batch + dim)
            A = torch.as_tensor(K, dtype=dtype, device="cuda").contiguous()
            with cuda_ldlt.uncounted():
                fk = cuda_ldlt.ldlt_factor_cuda(A)
            fc = ldlt_factor(A)
            if cuda_ldlt.plan(batch, dim, dtype).route != "ldlt_column" or not all(
                    torch.equal(x, y) for x, y in zip(fk, fc)):
                raise AssertionError(f"ldlt_column ({batch}, {dim}) {dtype_name}: "
                                     "differs from the column form")
    row = {"check": "column_exact", "dtype": dtype_name, "dims": list(dims),
           "batches": list(batches), "cases": len(batches) * len(dims)}
    print(json.dumps(row), flush=True)
    return row


def phase_kernels():
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    rows = []
    for dtype_name in ("float32", "float64"):
        for dim in KERNEL_DIMS:
            rows.append(check_kernel(KERNEL_BATCH[dim], dim, dtype_name))
    batches = column_batches()
    for dtype_name in ("float32", "float64"):
        for dim in COLUMN_EDGE_DIMS:
            for batch in (1, COLUMN_RAGGED_BATCH):
                rows.append(check_kernel(batch, dim, dtype_name, seed=dim))
        dtype = getattr(torch, dtype_name)
        for dim in COLUMN_SWITCH_DIMS:
            for batch in batches:
                if batch > 1 and (cuda_ldlt.plan(batch - 1, dim, dtype).group
                                  != cuda_ldlt.plan(batch, dim, dtype).group):
                    rows += [check_kernel(b, dim, dtype_name, seed=dim)
                             for b in (batch - 1, batch)]
        rows.append(check_column_exact(COLUMN_EXACT_BATCHES, range(33, 65), dtype_name))
    rows += [check_fit_exact(SQP_BATCH, dim, seed=dim) for dim in FIT_DIMS]
    return rows


def phase_kernels_large():
    return [check_kernel(1, dim, dtype_name)
            for dtype_name in ("float32", "float64") for dim in LARGE_DIMS] \
        + [check_kernel(1, STRUCT_INIT_DIM, "float64")]


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------

def main_path_options(max_iterations=MAIN_MAX_ITERATIONS):
    """uno_tpu's bench options for the flagship (bench.py:194)."""
    from uno_tpu_torch.options import preset
    return preset("ipopt", scale_functions=False, kkt_dtype="float32",
                  LS_batch_candidates=1, filter_capacity=8,
                  max_iterations=max_iterations)


def phase_main_path(device="cuda", batch=MAIN_BATCH, rerun=CPU_RERUN, n=8,
                    kkt_dim=MAIN_KKT_DIM, route="ldlt_warp", min_solved=0.999,
                    iteration_slack=ITERATION_SLACK, x_atol=X_ATOL, keep=None):
    """Solve the flagship batch (n variables) on `device` through
    solve_batch, then the first `rerun` instances on the CPU; raise unless
    the results are finite, at least `min_solved` of them solved, the
    kernel `route` launched, and the CPU run agrees (equal status,
    iterations within `iteration_slack`, x within `x_atol`).  `keep`, a
    dict, receives the BatchResult under "result"."""
    import torch
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.model.transforms import reformulate_for_interior_point

    nlp, x0, params = flagship(batch, n=n)
    opts = main_path_options()
    prob = reformulate_for_interior_point(nlp, opts.tolerance)
    if prob.n + prob.m != kkt_dim:      # n variables + 2 slacks + 2 rows
        raise AssertionError(f"flagship n={n} KKT dim {prob.n + prob.m} != {kkt_dim}")
    cuda_ldlt.reset_counts()
    t0 = time.monotonic()
    res = uno_tpu_torch.solve_batch(nlp, x0, params, opts=opts, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if keep is not None:
        keep["result"] = res
    by_route = dict(cuda_ldlt.launches)
    launches = sum(by_route.values())
    out = {"batch": batch, "n": n, "kkt_dim": kkt_dim, "solved": res.num_solved,
           "mean_iterations": float(np.mean(res.iterations)),
           "max_iterations": int(np.max(res.iterations)),
           "wall_s": wall, "solves_per_s": batch / wall,
           "launches": launches, "launches_by_route": by_route,
           "calls_by_route": dict(cuda_ldlt.calls),
           "launches_per_iteration": launches / max(int(np.max(res.iterations)), 1)}
    print(json.dumps(out), flush=True)
    if torch.device(device).type == "cuda" and by_route[route] <= 0:
        raise AssertionError(f"the main path launched {route} 0 times")
    if res.x.shape != (batch, nlp.n) or not np.all(np.isfinite(res.x)) \
            or not np.all(np.isfinite(res.objective)):
        raise AssertionError("main path: non-finite or misshapen solutions")
    if res.num_solved < min_solved * batch:
        raise AssertionError(f"main path: only {res.num_solved}/{batch} solved")

    k = min(rerun, batch)
    ref = uno_tpu_torch.solve_batch(nlp, x0[:k], params[:k], opts=opts,
                                    device="cpu")
    diff = np.abs(ref.iterations - res.iterations[:k])
    x_err = float(np.max(np.abs(ref.x - res.x[:k])))
    out.update(cpu_rerun=k, status_equal=int(np.sum(ref.status == res.status[:k])),
               iterations_equal=int(np.sum(diff == 0)),
               iterations_max_diff=int(diff.max()), x_max_abs_diff=x_err)
    print(json.dumps({key: out[key] for key in (
        "cpu_rerun", "status_equal", "iterations_equal", "iterations_max_diff",
        "x_max_abs_diff")}), flush=True)
    if not np.array_equal(ref.status, res.status[:k]):
        raise AssertionError("main path: status differs from the CPU run")
    if diff.max() > iteration_slack:
        raise AssertionError(f"main path: iterations differ by {diff.max()} "
                             "from the CPU run")
    if not x_err <= x_atol:
        raise AssertionError(f"main path: x differs by {x_err:.3e} from the CPU run")
    return out


def phase_n32(device="cuda", batch=N32_BATCH, rerun=N32_RERUN):
    """The n=32 point of the main path, through ldlt_column on the card."""
    return phase_main_path(device, batch, rerun, n=N32, kkt_dim=N32_KKT_DIM,
                           route="ldlt_column")


def phase_n512(device="cuda", batch=N512_BATCH, rerun=N512_RERUN):
    """The n=512 point of the main path: every instance solved, through
    ldlt_panel on the card."""
    return phase_main_path(device, batch, rerun, n=N512, kkt_dim=N512_KKT_DIM,
                           route="ldlt_panel", min_solved=1.0,
                           iteration_slack=N512_ITERATION_SLACK,
                           x_atol=N512_X_ATOL)


# ---------------------------------------------------------------------------
# 5. the single instance
# ---------------------------------------------------------------------------

def phase_single(device="cuda"):
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import hs015

    cuda_ldlt.reset_counts()
    t0 = time.monotonic()
    res = uno_tpu_torch.solve(hs015(), preset="ipopt", device=device)
    out = {"status": res.status, "objective": res.objective,
           "iterations": res.iterations, "wall_s": time.monotonic() - t0,
           "launches": sum(cuda_ldlt.launches.values()),
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls)}
    print(json.dumps(out), flush=True)
    if device != "cpu" and out["launches_by_route"]["ldlt_warp"] <= 0:
        raise AssertionError("hs015 launched ldlt_warp 0 times")
    if res.status != "optimal" or res.iterations != HS015_ITERATIONS \
            or abs(res.objective - HS015_OPTIMUM) > 1e-6 * HS015_OPTIMUM:
        raise AssertionError(f"hs015: {res}")
    return out


def large_optimum(n=LARGE_N):
    """1 / (1^T Q^-1 1) and x = Q^-1 1 / (1^T Q^-1 1), Q = I + 0.05 (super-
    and subdiagonal): the optimum of the flagship family at params 0 while
    x > 0 and |x|^2 < 2 there, which the function checks."""
    Q = np.eye(n)
    i = np.arange(n - 1)
    Q[i, i + 1] = Q[i + 1, i] = 0.05
    y = np.linalg.solve(Q, np.ones(n))
    x = y / y.sum()
    if not (x.min() > 0 and x @ x < 2):
        raise AssertionError("the closed form's inactive constraints are active")
    return 1.0 / y.sum(), x


def phase_single_large(device="cuda", n=LARGE_N):
    """solve() of one flagship-family instance (params 0) whose float64 KKT
    has dim 1280: the single-instance path through ldlt_panel; raise unless
    it is optimal at its closed-form optimum."""
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.model.transforms import reformulate_for_interior_point
    from uno_tpu_torch.options import preset

    nlp = flagship(1, n=n)[0]
    opts = preset("ipopt")
    prob = reformulate_for_interior_point(nlp, opts.tolerance)
    if prob.n + prob.m != LARGE_KKT_DIM:
        raise AssertionError(f"KKT dim {prob.n + prob.m} != {LARGE_KKT_DIM}")
    f_star, x_star = large_optimum(n)
    cuda_ldlt.reset_counts()
    t0 = time.monotonic()
    res = uno_tpu_torch.solve(nlp, options=opts, device=device)
    out = {"n": n, "kkt_dim": LARGE_KKT_DIM, "kkt_dtype": opts.kkt_dtype,
           "status": res.status, "objective": res.objective,
           "objective_gap": res.objective - f_star,
           "x_max_abs_diff": float(np.max(np.abs(res.x - x_star))),
           "iterations": res.iterations, "cpu_iterations": LARGE_CPU_ITERATIONS,
           "wall_s": time.monotonic() - t0,
           "launches": sum(cuda_ldlt.launches.values()),
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls)}
    print(json.dumps(out), flush=True)
    if device != "cpu" and out["launches_by_route"]["ldlt_panel"] <= 0:
        raise AssertionError("the large instance launched ldlt_panel 0 times")
    if res.status != "optimal" or not abs(out["objective_gap"]) <= LARGE_F_ATOL \
            or abs(res.iterations - LARGE_CPU_ITERATIONS) > LARGE_ITERATION_SLACK:
        raise AssertionError(f"large instance: {out}")
    return out


def sqp_options(preset="filtersqp"):
    """uno_tpu's bench options for the fused SQP batches (bench.py:113-114
    for filtersqp, bench.py:126-127 for byrd)."""
    from uno_tpu_torch.options import preset as make
    return make(preset, scale_functions=False, kkt_dtype="float32",
                max_iterations=SQP_MAX_ITERATIONS)


def phase_sqp_batch(device="cuda", batch=SQP_BATCH, rerun=SQP_RERUN,
                    min_solved=0.999, preset="filtersqp", unsolved=None):
    """`preset` (filtersqp or byrd) on the flagship batch (n=8) on `device`
    through solve_batch, then the first `rerun` instances on the CPU; raise
    unless the results are finite, at least `min_solved` of them solved
    (or, where `unsolved` is given, every instance solved but exactly
    those), ldlt_warp launched, and the CPU run agrees (equal status and
    iterations, x within X_ATOL)."""
    import torch
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.solvers import qp
    from uno_tpu_torch.solvers.ipm import ALMOST_OPTIMAL, OPTIMAL

    nlp, x0, params = flagship(batch)
    opts = sqp_options(preset)
    tag = f"SQP path ({preset})"
    cuda_ldlt.reset_counts()
    qp.reset_counts()
    t0 = time.monotonic()
    res = uno_tpu_torch.solve_batch(nlp, x0, params, opts=opts, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    by_route = dict(cuda_ldlt.launches)
    calls = dict(cuda_ldlt.calls)
    qp_counts = dict(qp.counts)
    iterations = int(np.sum(res.iterations))
    out = {"preset": preset, "batch": batch, "n": 8,
           "qp_kkt_dim": BYRD_KKT_DIM if preset == "byrd" else SQP_KKT_DIM,
           "fit_dim": BYRD_FIT_DIM if preset == "byrd" else SQP_FIT_DIM,
           "solved": res.num_solved,
           "statuses": {k: int(v) for k, v in zip(*np.unique(
               res.status_names(), return_counts=True))},
           "mean_iterations": float(np.mean(res.iterations)),
           "max_iterations": int(np.max(res.iterations)),
           "wall_s": wall, "solves_per_s": batch / wall,
           "qp_solves": qp_counts["solves"],
           "qps_per_instance": qp_counts["instances"] / batch,
           "qps_per_iteration": qp_counts["instances"] / max(iterations, 1),
           "qp_iterations_per_qp":
               qp_counts["iterations"] / max(qp_counts["instances"], 1),
           "launches": sum(by_route.values()), "launches_by_route": by_route,
           "calls_by_route": calls}
    failed = np.nonzero((res.status != OPTIMAL) & (res.status != ALMOST_OPTIMAL))[0]
    out["unsolved"] = failed.tolist()[:32]
    print(json.dumps(out), flush=True)
    if torch.device(device).type == "cuda" and by_route["ldlt_warp"] <= 0:
        raise AssertionError(f"the {tag} launched ldlt_warp 0 times")
    if res.x.shape != (batch, nlp.n) or not np.all(np.isfinite(res.x)) \
            or not np.all(np.isfinite(res.objective)):
        raise AssertionError(f"{tag}: non-finite or misshapen solutions")
    if unsolved is not None:
        if tuple(failed.tolist()) != tuple(i for i in unsolved if i < batch):
            raise AssertionError(f"{tag}: unsolved {failed.tolist()[:32]}, "
                                 f"expected {list(unsolved)}")
    elif res.num_solved < min_solved * batch:
        raise AssertionError(f"{tag}: only {res.num_solved}/{batch} solved")

    k = min(rerun, batch)
    ref = uno_tpu_torch.solve_batch(nlp, x0[:k], params[:k], opts=opts,
                                    device="cpu")
    diff = np.abs(ref.iterations - res.iterations[:k])
    x_err = float(np.max(np.abs(ref.x - res.x[:k])))
    out.update(cpu_rerun=k, status_equal=int(np.sum(ref.status == res.status[:k])),
               iterations_equal=int(np.sum(diff == 0)),
               iterations_max_diff=int(diff.max()), x_max_abs_diff=x_err)
    print(json.dumps({key: out[key] for key in (
        "cpu_rerun", "status_equal", "iterations_equal", "iterations_max_diff",
        "x_max_abs_diff")}), flush=True)
    if not np.array_equal(ref.status, res.status[:k]):
        raise AssertionError(f"{tag}: status differs from the CPU run")
    if diff.max() > ITERATION_SLACK:
        raise AssertionError(f"{tag}: iterations differ by {diff.max()} "
                             "from the CPU run")
    if not x_err <= X_ATOL:
        raise AssertionError(f"{tag}: x differs by {x_err:.3e} from the CPU run")
    return out


def phase_byrd_batch(device="cuda", batch=SQP_BATCH, rerun=SQP_RERUN):
    """byrd on the flagship batch, as phase_sqp_batch runs filtersqp, held
    to the reference's unsolved instances."""
    return phase_sqp_batch(device, batch, rerun, preset="byrd",
                           unsolved=BYRD_UNSOLVED)


def phase_sqp_single(device="cuda", runs=SQP_SINGLE):
    """Each (preset, problem) of `runs` through solve() on `device` and on
    the CPU: equal status and iterations, objectives within SQP_F_ATOL,
    ldlt_warp launched on the card."""
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import get_problem

    done = []
    cuda_ldlt.reset_counts()
    t0 = time.monotonic()
    for preset, name in runs:
        res = uno_tpu_torch.solve(get_problem(name), preset=preset, device=device)
        done.append((preset, name, res))
    wall = time.monotonic() - t0
    out = {"wall_s": wall, "launches": sum(cuda_ldlt.launches.values()),
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls), "runs": []}
    for preset, name, res in done:
        ref = uno_tpu_torch.solve(get_problem(name), preset=preset, device="cpu")
        out["runs"].append({"preset": preset, "problem": name,
                            "status": res.status, "iterations": res.iterations,
                            "qps": res.num_subproblems_solved,
                            "objective": res.objective,
                            "cpu_status": ref.status,
                            "cpu_iterations": ref.iterations,
                            "cpu_qps": ref.num_subproblems_solved,
                            "objective_diff": res.objective - ref.objective})
    print(json.dumps(out), flush=True)
    if device != "cpu" and out["launches_by_route"]["ldlt_warp"] <= 0:
        raise AssertionError("the SQP single instances launched ldlt_warp 0 times")
    for r in out["runs"]:
        if (r["status"], r["iterations"], r["qps"]) \
                != (r["cpu_status"], r["cpu_iterations"], r["cpu_qps"]) \
                or not abs(r["objective_diff"]) <= SQP_F_ATOL \
                or r["status"] != "optimal":
            raise AssertionError(f"SQP single instance: {r}")
    return out


def phase_byrd_single(device="cuda"):
    """byrd on hs015 and hs071, as phase_sqp_single runs the other presets."""
    return phase_sqp_single(device, BYRD_SINGLE)


def read_sol_x(path, n):
    """The primal values of a .sol file that __main__.write_sol wrote: its
    last n lines."""
    return np.array([float(v) for v in Path(path).read_text().splitlines()[-n:]])


def phase_nl(device="cuda"):
    """The .nl path: NL_FIXTURES read with the port's parser and solved
    with ipopt on `device`, then the command line with preset=byrd on a
    copy of NL_CLI_FIXTURE in a temporary directory (its .sol is written
    there) and solve() of the same model; then the ipopt solves again on
    the CPU.  Raise unless the card and the CPU agree (equal status and
    iterations, objective within NL_F_TOL), the command line exits 0 with
    the .sol's x within NL_SOL_ATOL of solve()'s, and the card launched
    ldlt_panel, ldlt_column and ldlt_warp."""
    import uno_tpu_torch
    from uno_tpu_torch import __main__ as cli
    from uno_tpu_torch.io import read_nl
    from uno_tpu_torch.linalg import cuda_ldlt

    cuda_ldlt.reset_counts()
    t0 = time.monotonic()
    runs = []
    for name in NL_FIXTURES:
        nlp = read_nl(NL_DIR / name)
        runs.append((name, nlp, uno_tpu_torch.solve(nlp, preset="ipopt", device=device)))
    with tempfile.TemporaryDirectory() as tmp:
        model = Path(tmp) / NL_CLI_FIXTURE
        shutil.copy(NL_DIR / NL_CLI_FIXTURE, model)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main([str(model), "-AMPL", "preset=byrd", f"device={device}"])
        nlp_cli = read_nl(model)
        x_sol = read_sol_x(model.with_suffix(".sol"), nlp_cli.n)
        direct = uno_tpu_torch.solve(nlp_cli, preset="byrd", device=device)
    wall = time.monotonic() - t0
    out = {"wall_s": wall, "launches": sum(cuda_ldlt.launches.values()),
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls), "runs": [],
           "cli": {"model": NL_CLI_FIXTURE, "preset": "byrd", "exit_code": rc,
                   "status": direct.status, "iterations": direct.iterations,
                   "objective": direct.objective,
                   "sol_x_max_abs_diff": float(np.max(np.abs(x_sol - direct.x))),
                   "printed": [line for line in printed.getvalue().splitlines()
                               if line.startswith(("status", "objective", "iterations"))]}}
    for name, nlp, res in runs:
        ref = uno_tpu_torch.solve(nlp, preset="ipopt", device="cpu")
        out["runs"].append({"model": name, "n": nlp.n, "m": nlp.m,
                            "status": res.status, "iterations": res.iterations,
                            "objective": res.objective, "cpu_status": ref.status,
                            "cpu_iterations": ref.iterations,
                            "objective_diff": res.objective - ref.objective,
                            "objective_tol": NL_F_TOL * max(abs(ref.objective), 1.0)})
    print(json.dumps(out), flush=True)
    if device != "cpu":
        for route in ("ldlt_panel", "ldlt_column", "ldlt_warp"):
            if out["launches_by_route"][route] <= 0:
                raise AssertionError(f"the nl path launched {route} 0 times")
    for r in out["runs"]:
        if (r["status"], r["iterations"]) != (r["cpu_status"], r["cpu_iterations"]) \
                or not abs(r["objective_diff"]) <= r["objective_tol"] \
                or r["status"] != "optimal":
            raise AssertionError(f"nl path: {r}")
    c = out["cli"]
    if c["exit_code"] != 0 or c["status"] != "optimal" \
            or not c["sol_x_max_abs_diff"] <= NL_SOL_ATOL:
        raise AssertionError(f"nl path, command line: {c}")
    return out


def _registry_solve(job):
    """One key of the registry phase, in a worker process: solve(name) with
    ipopt on `device`, every count zeroed just before it; the row, the
    kernel and backend counts of that solve, and the largest shape each
    LDL^T route was given."""
    name, device = job
    import uno_tpu_torch
    from uno_tpu_torch.linalg import banded_kkt, cuda_ldlt, sparse_ldlt
    from uno_tpu_torch.model.library import acceptable_optima, get_problem
    from sweep_torch import MAX_ITER, is_solved

    nlp = get_problem(name)
    for mod in (banded_kkt, sparse_ldlt, cuda_ldlt):
        mod.reset_counts()
    with largest_factorizations() as largest:
        t0 = time.monotonic()
        res = uno_tpu_torch.solve(nlp, preset="ipopt", device=device,
                                  max_iterations=MAX_ITER["ipopt"])
        wall = time.monotonic() - t0
    return name, {
        "n": nlp.n, "m": nlp.m, "status": res.status, "iterations": res.iterations,
        "objective": res.objective, "wall_s": wall,
        "solved": is_solved(res.status, res.success, res.primal_feasibility,
                            res.objective, acceptable_optima(name))}, {
        "launches_by_route": dict(cuda_ldlt.launches),
        "calls_by_route": dict(cuda_ldlt.calls), "banded": dict(banded_kkt.counts),
        "sparse": dict(sparse_ldlt.counts), "largest_by_route": dict(largest)}


def _registry_worker(device):
    """A registry worker's start: tools/ on the path for sweep_torch, and
    one solve of hs015 on `device`, so that the card's context, the kernels'
    library and torch's first launches are not timed as a key's solve."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import uno_tpu_torch
    from uno_tpu_torch.model.library import get_problem
    uno_tpu_torch.solve(get_problem("hs015"), preset="ipopt", device=device)


def phase_registry(device="cuda", ref_path=REGISTRY_REF, jobs=REGISTRY_JOBS):
    """Every key of torch_registry_ref.json (the registry's n + m <= 30
    tier) solved with ipopt on `device`, max_iterations as
    tools/sweep_torch.py sets it, by `jobs` worker processes sharing the
    card (each solve is host-bound; each worker first solves hs015 once,
    untimed).  Raise unless each key has uno_tpu's
    sizes, takes at most REGISTRY_KEY_WALL s, and ends with uno_tpu's
    status and iterations and its objective within REGISTRY_F_RTOL of
    max(1, |f|) (a key of REGISTRY_PARTS: with uno_tpu's solved verdict),
    unless the sweep's solved rule counts as many solved as uno_tpu's, and
    unless the card launched ldlt_warp and ldlt_column."""
    import multiprocessing as mp

    with open(ref_path) as fh:
        ref = json.load(fh)["rows"]
    rows = {}
    totals = {"launches_by_route": {}, "calls_by_route": {}, "banded": {}, "sparse": {}}
    largest = {}
    t_start = time.monotonic()
    with mp.get_context("spawn").Pool(jobs, initializer=_registry_worker,
                                      initargs=(device,)) as pool:
        for name, row, counts in pool.imap_unordered(
                _registry_solve, [(name, device) for name in sorted(ref)]):
            rows[name] = row
            for key, total in totals.items():
                for k, v in counts[key].items():
                    total[k] = total.get(k, 0) + v
            for route, shape in counts["largest_by_route"].items():
                old = largest.get(route)
                if old is None or (shape[1], shape[0]) > (old[1], old[0]):
                    largest[route] = shape
    wall = time.monotonic() - t_start
    mismatched, allowed = [], []
    for name in sorted(rows):
        row, r = rows[name], ref[name]
        if (row["n"], row["m"]) != (r["n"], r["m"]):
            raise AssertionError(f"registry: {name} has n, m = {row['n']}, {row['m']}; "
                                 f"uno_tpu {r['n']}, {r['m']}")
        same = ((row["status"], row["iterations"]) == (r["status"], r["iterations"])
                and abs(row["objective"] - r["objective"])
                <= REGISTRY_F_RTOL * max(1.0, abs(r["objective"])))
        if not same:
            entry = {"key": name, "status": row["status"],
                     "iterations": row["iterations"], "objective": row["objective"],
                     "uno_tpu": [r["status"], r["iterations"], r["objective"]]}
            if name in REGISTRY_PARTS and row["solved"] == r["solved"]:
                allowed.append(entry | {"parts": REGISTRY_PARTS[name]})
            else:
                mismatched.append(entry)
    slow = sorted(rows, key=lambda k: -rows[k]["wall_s"])
    out = {"keys": len(rows), "jobs": jobs,
           "solved": sum(r["solved"] for r in rows.values()),
           "uno_tpu_solved": sum(r["solved"] for r in ref.values()),
           "iterations_equal": sum(rows[k]["iterations"] == ref[k]["iterations"]
                                   for k in rows),
           "status_equal": sum(rows[k]["status"] == ref[k]["status"] for k in rows),
           "mismatched": mismatched, "allowed_parts": allowed, "wall_s": wall,
           "solve_s": sum(r["wall_s"] for r in rows.values()),
           "iterations": sum(r["iterations"] for r in rows.values()),
           "slowest": [[k, rows[k]["wall_s"], rows[k]["iterations"]] for k in slow[:8]],
           "launches": sum(totals["launches_by_route"].values()), **totals,
           "largest_by_route": largest, "rows": rows}
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}), flush=True)
    too_slow = [k for k in rows if rows[k]["wall_s"] > REGISTRY_KEY_WALL]
    if too_slow:
        raise AssertionError(f"registry: over {REGISTRY_KEY_WALL} s: "
                             f"{[(k, rows[k]['wall_s']) for k in too_slow]}")
    if mismatched:
        raise AssertionError(f"registry: {len(mismatched)} keys part from uno_tpu: "
                             f"{mismatched}")
    if out["solved"] != out["uno_tpu_solved"]:
        raise AssertionError(f"registry: {out['solved']} solved, uno_tpu "
                             f"{out['uno_tpu_solved']}")
    if device != "cpu":
        for route in ("ldlt_warp", "ldlt_column"):
            if out["launches_by_route"].get(route, 0) <= 0:
                raise AssertionError(f"the registry path launched {route} 0 times")
    return out


def phase_profile(top=12):
    """The flagship batch of the main path and of the filtersqp path once
    more each, under torch.profiler.  The SQP path's host operators are not
    traced: their million-odd host events would take the profiler longer to
    sum than the phase's budget."""
    return {"ipopt": profile_batch(MAIN_BATCH, main_path_options(), top),
            "filtersqp": profile_batch(SQP_BATCH, sqp_options("filtersqp"), top,
                                       host_ops=False)}


def phase_profile_byrd(top=12):
    """The byrd flagship batch once more under torch.profiler, device
    activity only, as phase_profile profiles filtersqp's (the profiler's
    summing of its events takes most of the phase)."""
    return {"byrd": profile_batch(SQP_BATCH, sqp_options("byrd"), top,
                                  host_ops=False)}


def cholesky_ms(batch, n, seed=11):
    """ms of an eager torch.linalg.cholesky_ex call (the host's launch time
    included: the library's batched Cholesky need not be capturable in a CUDA graph)
    on `batch` seeded positive-definite (n, n) float64 matrices on the
    card, byrd's test of its Hessians in the primal regularization (a
    library call, not a kernel of the port)."""
    import torch
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, n, n))
    H = torch.as_tensor(M @ np.swapaxes(M, 1, 2) + n * np.eye(n), device="cuda")
    return eager_ms(lambda: torch.linalg.cholesky_ex(H))


# device kernels summed by name under --profile: the port's LDL^T kernels,
# and the library Cholesky (cuSOLVER's potrf) of byrd's primal
# regularization, which uno_tpu computes outside Pallas too
KERNEL_GROUPS = {"ldlt (csrc/ldlt.cu)": ("ldlt",),
                 "cholesky_ex (library)": ("potrf", "potf", "chol")}


def profile_batch(batch, opts, top, host_ops=True):
    """The flagship batch under torch.profiler: the device's busy time (the
    sum of its kernels' times; one stream, so they do not overlap) against
    the wall time, the kernels of each KERNEL_GROUPS group summed, and the
    kernels and (with `host_ops`) the host operators that take the most
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import uno_tpu_torch
    from uno_tpu_torch.model.library import flagship

    nlp, x0, params = flagship(batch)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.monotonic()
        res = uno_tpu_torch.solve_batch(nlp, x0, params, opts=opts, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    device_rows, host_rows = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if str(e.device_type).endswith("CUDA"):
            device_rows.append((dev_us / 1e3, e.count, e.key))
        else:
            host_rows.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    device_rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in device_rows)
    groups = {}
    for group, keys in KERNEL_GROUPS.items():
        rows = [r for r in device_rows if any(k in r[2].lower() for k in keys)]
        groups[group] = {"ms": sum(r[0] for r in rows),
                         "launches": int(sum(r[1] for r in rows)),
                         "kernels": sorted({r[2][:60] for r in rows})}
    out = {"batch": batch, "iterations_max": int(np.max(res.iterations)),
           "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernel_launches": int(sum(r[1] for r in device_rows)),
           "groups": groups,
           "device_top": [{"ms": r[0], "count": r[1], "name": r[2][:90]}
                          for r in device_rows[:top]],
           "host_top": [{"self_ms": r[0], "count": r[1], "name": r[2][:60]}
                        for r in host_rows[:top]]}
    print(json.dumps(out, indent=1), flush=True)
    if busy_ms <= 0.0:
        raise AssertionError("the profiler saw no device time")
    return out


# ---------------------------------------------------------------------------
# 6. the structured KKT backends (banded, lifted, sparse)
# ---------------------------------------------------------------------------

def _kernel_launches(call):
    """The CUDA kernels one call of `call` launches, as torch.profiler sees
    them on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")))


def bench_band(n, bw, seed=STRUCT_SEED):
    """bench.py:372-380's banded matrix (half-bandwidth bw, diagonally
    dominant) in lower band storage, and a right-hand side."""
    rng = np.random.default_rng(seed)
    band = np.zeros((bw + 1, n))
    for d in range(bw + 1):
        band[d, : n - d] = rng.standard_normal(n - d) * 0.1
    band[0] = np.abs(band).sum(0) * 2 + 2.0
    return band, rng.standard_normal(n)


def bench_sparse(N, bw, seed=STRUCT_SEED):
    """bench.py:433-444's sparse matrix: a band of half-width bw plus two
    dense last rows and columns, diagonal 10 + U(0, 1); its pattern and a
    right-hand side."""
    rng = np.random.default_rng(seed)
    pat = np.zeros((N, N), dtype=bool)
    for o in range(bw + 1):
        idx = np.arange(N - o)
        pat[idx, idx + o] = True
        pat[idx + o, idx] = True
    pat[-2:, :] = True
    pat[:, -2:] = True
    A = np.where(pat, rng.standard_normal((N, N)), 0.0)
    A = (A + A.T) / 2
    A[np.diag_indices(N)] = 10.0 + rng.random(N)
    return A, pat, rng.standard_normal(N)


def band_dense(band):
    n = band.shape[1]
    A = np.zeros((n, n))
    for d in range(band.shape[0]):
        i = np.arange(n - d)
        A[i + d, i] = A[i, i + d] = band[d, : n - d]
    return A


def _dense_wrapper_row(A_np, device, dtype_name="float32"):
    """The port's dense LDL^T wrapper (ldlt_panel) on the same matrix: the
    launches of one call alone, timed in a CUDA graph as check_kernel
    times them, and the launches a call makes."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    dtype = getattr(torch, dtype_name)
    A = torch.as_tensor(A_np[None], dtype=dtype, device=device).contiguous()
    dim = A.shape[-1]
    if torch.device(device).type != "cuda":
        return {"dim": dim, "dtype": dtype_name, "ms": None, "kernel_launches": 0}
    plan = cuda_ldlt.plan(1, dim, dtype)
    L, d = torch.empty_like(A), torch.empty((1, dim), dtype=dtype, device=device)
    counts = [torch.empty(1, dtype=torch.int64, device=device) for _ in range(3)]
    with cuda_ldlt.uncounted():
        return {"dim": dim, "dtype": dtype_name, "route": plan.route,
                "kernel_launches": plan.launches,
                "ms": time_ms(lambda: cuda_ldlt.launch(A, L, d, *counts))}


def banded_flops(n, bw):
    """A band Cholesky's flops, n (bw^2 + 3 bw), and its two band
    triangular solves', 4 n bw (Golub and Van Loan, Matrix Computations,
    4th ed., alg. 4.3.5 and 4.3.2)."""
    return n * (bw * bw + 3 * bw) + 4 * n * bw


def sparse_flops(plan, pattern):
    """The supernodal factorization's work on this pattern: sum over the
    columns of L of c_j (c_j + 3) (c_j below-diagonal entries of column j:
    the scaling and the symmetric rank-1 update), and 4 nnz(L) for the two
    triangular solves; nnz(L) from the plan's symbolic Cholesky."""
    from uno_tpu_torch.linalg.sparse_ldlt import _symbolic_cholesky
    cols = _symbolic_cholesky(pattern[np.ix_(plan.perm, plan.perm)])
    c = np.array([len(col) for col in cols], dtype=np.float64)
    return float(np.sum(c * (c + 3.0)) + 4.0 * (c.sum() + len(cols)))


def structured_bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _structured_row(name, call, call_cpu, x_ref_check, device, dtype_name,
                    bytes_moved, flops, tol):
    """One factorize+solve pair on `device` against the same code on the
    CPU: the solution's gap relative to max |x_cpu| within `tol`, and the
    residual check `x_ref_check(x)`; its time (CUDA events around
    back-to-back eager calls, the host's issue included: the host loops
    are part of these functions), its kernel launches and its bound."""
    import torch
    x = call()
    x_cpu = call_cpu()
    row = {"name": name, "dtype": dtype_name,
           "gap_to_cpu": float((x.cpu() - x_cpu).abs().amax()
                               / x_cpu.abs().amax().clamp(min=1e-300)),
           "residual": x_ref_check(x.cpu().double().numpy()[0])}
    row["bound_ms"], row["bound_by"] = structured_bound(bytes_moved, flops, dtype_name)
    if torch.device(device).type == "cuda":
        row["ms"] = eager_ms(call)
        row["kernel_launches"] = _kernel_launches(call)
    print(json.dumps(row), flush=True)
    if not (row["gap_to_cpu"] <= tol and row["residual"] <= tol):
        raise AssertionError(f"{name}: {row}")
    return row


def phase_structured_kernels(device="cuda", band_n=STRUCT_BANDED_N,
                             band_bw=STRUCT_BANDED_BW, sparse_n=STRUCT_SPARSE_N,
                             sparse_bw=STRUCT_SPARSE_BW):
    """The structured factorize+solve pairs at bench.py's shapes: the
    block-tridiagonal Cholesky (cyclic reduction at this block count) of
    the banded matrix in float32 and float64, and the supernodal LDL^T of
    the sparse one in float32, each against the same code on the CPU and
    timed; the port's dense wrapper (ldlt_panel) at the same dims in
    float32 beside them."""
    import torch
    from uno_tpu_torch.linalg import banded
    from uno_tpu_torch.linalg.banded_kkt import CR_MIN_BLOCKS
    from uno_tpu_torch.linalg.sparse_ldlt import build_plan, make_sparse_ldlt

    out = {"banded": [], "sparse": []}
    band_np, rhs_np = bench_band(band_n, band_bw)
    nb = banded.pick_block_size(band_bw)
    blocks = -(-band_n // nb)
    cr = blocks >= CR_MIN_BLOCKS
    A_band = band_dense(band_np)

    def banded_pair(dev, dtype):
        bt = torch.as_tensor(band_np[None], dtype=dtype, device=dev)
        rt = torch.as_tensor(rhs_np[None], dtype=dtype, device=dev)

        def call():
            D, E = banded.band_to_blocks(bt, nb)
            if cr:
                return banded.btd_solve_cr(banded.btd_cholesky_cr(D, E), rt)
            return banded.btd_solve(banded.btd_cholesky(D, E), rt)
        return call

    def band_residual(x):
        return float(np.abs(A_band @ x - rhs_np).max() / np.abs(rhs_np).max())

    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        size = np.dtype(dtype_name).itemsize
        row = _structured_row(
            f"banded n={band_n} b={band_bw}", banded_pair(device, dtype),
            banded_pair("cpu", dtype), band_residual, device, dtype_name,
            ((band_bw + 1) * band_n + 2 * band_n) * size,
            banded_flops(band_n, band_bw), STRUCT_TOL[dtype_name])
        row.update(n=band_n, bw=band_bw, block=nb, blocks=blocks,
                   route="cyclic reduction" if cr else "sweep")
        out["banded"].append(row)
    out["banded_dense"] = _dense_wrapper_row(A_band, device)

    A_sp, pat, rhs_sp = bench_sparse(sparse_n, sparse_bw)
    t0 = time.monotonic()
    plan = build_plan(pat, np.zeros(sparse_n, dtype=bool))
    plan_s = time.monotonic() - t0
    fac_fn, solve_fn = make_sparse_ldlt(plan)

    def sparse_pair(dev):
        At = torch.as_tensor(A_sp[None], dtype=torch.float32, device=dev)
        rt = torch.as_tensor(rhs_sp[None], dtype=torch.float32, device=dev)
        return lambda: solve_fn(fac_fn(At), rt)

    def sparse_residual(x):
        return float(np.abs(A_sp @ x - rhs_sp).max() / np.abs(rhs_sp).max())

    row = _structured_row(
        f"sparse N={sparse_n}", sparse_pair(device), sparse_pair("cpu"),
        sparse_residual, device, "float32",
        (int(np.count_nonzero(np.tril(pat))) + 2 * sparse_n) * 4,
        sparse_flops(plan, pat), STRUCT_TOL["float32"])
    row.update(N=sparse_n, supernodes=plan.num_supernodes, w_max=plan.w_max,
               r_max=plan.r_max, u_max=plan.u_max, nnz_factor=plan.nnz_factor,
               padded_over_dense_flops=plan.padded_flops() / plan.dense_flops(),
               plan_s=plan_s)
    out["sparse"].append(row)
    out["sparse_dense"] = _dense_wrapper_row(A_sp, device)
    print(json.dumps({k: out[k] for k in ("banded_dense", "sparse_dense")}), flush=True)
    # two runs give the same bits: the banded KKT's window sums (repeated
    # window starts included) and the sparse factorization use no atomics
    kkt_call = banded_kkt_pair(band_n, device)
    same = {"banded_kkt": bool(torch.equal(kkt_call(), kkt_call())),
            "sparse": bool(torch.equal(sparse_pair(device)(), sparse_pair(device)()))}
    out["bit_identical_reruns"] = same
    print(json.dumps({"bit_identical_reruns": same}), flush=True)
    if not all(same.values()):
        raise AssertionError(f"a rerun on {device} changed the bits: {same}")
    return out


def banded_kkt_pair(n0, device, seed=STRUCT_SEED):
    """A factorize+solve of the banded KKT backend on a seeded lukvle1-like
    system (n0 columns, n0 - 2 rows in windows of 3, every third row with a
    slack, the first two windows starting together), as a call."""
    import torch
    from uno_tpu_torch.linalg import banded_kkt
    rng = np.random.default_rng(seed)
    m, w, bh = n0 - 2, 3, 2
    starts = np.arange(m, dtype=np.int64)
    starts[1] = 0
    soc = np.full(m, -1, dtype=np.int64)
    ns = len(range(0, m, 3))
    soc[0::3] = n0 + np.arange(ns)
    band, _ = bench_band(n0, bh, seed)
    leaves = (band, 1.0 + rng.random(n0), 1.0 + rng.random(ns),
              rng.standard_normal((m, w)), 1e-3 + rng.random(m))
    kkt = banded_kkt.BandedKKT(*(torch.as_tensor(a[None], device=device)
                                 for a in leaves))
    rhs = torch.as_tensor(rng.standard_normal((1, n0 + ns + m)), device=device)
    fac, solve, _ = banded_kkt.make_banded_kkt_backend(n0 + ns, n0, m, starts,
                                                       soc, bh, w)
    return lambda: solve(fac(kkt), rhs)


def _peak_gib(device):
    import torch
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _solve_counted(nlp, device, **kw):
    """solve() on `device` with the kernel and backend counts zeroed just
    before it; returns (result, wall s, counts)."""
    import torch
    import uno_tpu_torch
    from uno_tpu_torch.linalg import banded_kkt, condensed, cuda_ldlt, sparse_ldlt
    for mod in (banded_kkt, condensed, sparse_ldlt, cuda_ldlt):
        mod.reset_counts()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = uno_tpu_torch.solve(nlp, preset="ipopt", device=device, **kw)
    wall = time.monotonic() - t0
    counts = {"launches_by_route": dict(cuda_ldlt.launches),
              "calls_by_route": dict(cuda_ldlt.calls),
              "banded": dict(banded_kkt.counts), "lifted": dict(condensed.counts),
              "sparse": dict(sparse_ldlt.counts), "peak_gib": _peak_gib(device)}
    return res, wall, counts


@contextlib.contextmanager
def largest_factorizations():
    """Inside, every launch of the LDL^T kernels is noted; yields a dict
    that holds, by route, the largest [batch, dim, dtype] launched (by dim,
    then batch), so that the kernels line can hold each route against its
    plain version at the largest shape a path gave it."""
    from uno_tpu_torch.linalg import cuda_ldlt
    largest = {}
    launch = cuda_ldlt.launch

    def noted(A, *args, **kwargs):
        p = launch(A, *args, **kwargs)
        if p is not None:
            shape = [A.shape[0], A.shape[-1], str(A.dtype).removeprefix("torch.")]
            old = largest.get(p.route)
            if old is None or (shape[1], shape[0]) > (old[1], old[0]):
                largest[p.route] = shape
        return p

    cuda_ldlt.launch = noted
    try:
        yield largest
    finally:
        cuda_ldlt.launch = launch


def _against_cpu(tag, res, ref, f_rtol, x_atol=None):
    """Equal status and iterations, objective within f_rtol of max(|f|, 1),
    x within x_atol (when given); the gaps."""
    f_gap = abs(res.objective - ref.objective) / max(abs(ref.objective), 1.0)
    out = {"cpu_status": ref.status, "cpu_iterations": ref.iterations,
           "cpu_objective": ref.objective, "objective_rel_gap": f_gap}
    if x_atol is not None:
        out["x_max_abs_diff"] = float(np.max(np.abs(res.x - ref.x)))
    if (res.status, res.iterations) != (ref.status, ref.iterations) \
            or not f_gap <= f_rtol \
            or (x_atol is not None and not out["x_max_abs_diff"] <= x_atol):
        raise AssertionError(f"{tag}: the card and the CPU differ: {out}")
    return out


def _held_to(tag, res, iterations, objective, f_rtol):
    """uno_tpu's CPU result: optimal, its iterations, objective within
    f_rtol relative."""
    gap = abs(res.objective - objective) / abs(objective)
    if res.status != "optimal" or res.iterations != iterations or not gap <= f_rtol:
        raise AssertionError(f"{tag}: {res.status}, {res.iterations} iterations, "
                             f"objective {res.objective!r}; uno_tpu: optimal, "
                             f"{iterations}, {objective!r}")
    return gap


def phase_banded(device="cuda", n=LUKVLE1_N, large_n=LUKVLE1_LARGE_N,
                 catena=CATENA_NAME):
    """lukvle1 at n under the ipopt preset's auto route, which takes the
    banded backend, against uno_tpu's CPU result;
    lukvle1 at large_n on the card alone (optimal; iterations, objective,
    wall and peak memory printed; with its initial multipliers' dense
    matrix of dim 2 large_n - 2 on ldlt_panel, timed beside its plain
    version); catena under auto, whose banded attempt ends in an
    algorithmic error and is retried augmented, held to uno_tpu's result."""
    import torch
    from uno_tpu_torch.model.library import get_problem
    from uno_tpu_torch.model.library_cutest import cutest_problem

    out = {}
    nlp = cutest_problem("lukvle1", n)
    res, wall, counts = _solve_counted(nlp, device)
    row = {"problem": nlp.name, "n": n, "m": nlp.m, "status": res.status,
           "iterations": res.iterations, "objective": res.objective,
           "uno_tpu_objective": LUKVLE1_OPTIMUM, "wall_s": wall,
           "init_kkt_dim": n + nlp.m,
           "dense_jacobian_mib": 8 * n * nlp.m / 2 ** 20,
           "init_kkt_mib": 8 * (n + nlp.m) ** 2 / 2 ** 20, **counts}
    if counts["banded"]["factorizations"] <= 0:
        raise AssertionError(f"{nlp.name}: the banded backend did not run")
    # held to uno_tpu's CPU result alone: no CPU rerun of the port here,
    # for the script's time limit (PERF.md, the cuts)
    row["uno_tpu_objective_rel_gap"] = _held_to(
        nlp.name, res, LUKVLE1_ITERATIONS, LUKVLE1_OPTIMUM, 1e-9)
    print(json.dumps(row), flush=True)
    out["lukvle1"] = row
    if device != "cpu" and counts["launches_by_route"]["ldlt_panel"] <= 0:
        raise AssertionError("lukvle1's initial multipliers launched ldlt_panel 0 times")

    if large_n:
        big = cutest_problem("lukvle1", large_n)
        res, wall, counts = _solve_counted(big, device)
        row = {"problem": big.name, "n": large_n, "m": big.m, "status": res.status,
               "iterations": res.iterations, "objective": res.objective,
               "uno_tpu_objective_n4096": LUKVLE1_OPTIMUM, "wall_s": wall,
               "init_kkt_dim": large_n + big.m,
               "dense_jacobian_mib": 8 * large_n * big.m / 2 ** 20,
               "init_kkt_mib": 8 * (large_n + big.m) ** 2 / 2 ** 20, **counts}
        if res.status != "optimal" or counts["banded"]["factorizations"] <= 0:
            raise AssertionError(f"{big.name}: {row}")
        row["init_multipliers_ldlt_panel"] = init_multiplier_kernel_row(big, device)
        print(json.dumps(row), flush=True)
        out["lukvle1_large"] = row
        torch.cuda.empty_cache()

    cat = get_problem(catena)
    res, wall, counts = _solve_counted(cat, device)
    row = {"problem": catena, "status": res.status, "iterations": res.iterations,
           "objective": res.objective, "retried_after": res.retried_after,
           "wall_s": wall, **counts}
    print(json.dumps(row), flush=True)
    if res.retried_after is None or res.retried_after["status"] != "algorithmic_error" \
            or counts["banded"]["factorizations"] <= 0:
        raise AssertionError(f"{catena}: the banded attempt and its retry: {row}")
    row["uno_tpu_objective_rel_gap"] = _held_to(
        catena, res, CATENA_ITERATIONS, CATENA_OPTIMUM, 1e-8)
    if device != "cpu" and counts["launches_by_route"]["ldlt_panel"] <= 0:
        raise AssertionError(f"{catena}'s retry launched ldlt_panel 0 times")
    out["catena"] = row
    return out


def uno_tpu_torch_solve_cpu(nlp, **kw):
    import uno_tpu_torch
    return uno_tpu_torch.solve(nlp, preset="ipopt", device="cpu", **kw)


def init_multiplier_kernel_row(nlp, device):
    """The dense [I J^T; J 0] of the initial least-square multipliers at the
    interior-pushed x0 (solvers/ipm.make_initial_state) on ldlt_panel: the
    launches of one call in a CUDA graph, against its plain version (eager,
    one call), with the launches a call makes and the bound."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.linalg.ldlt import plain_factorizer
    from uno_tpu_torch.model.transforms import reformulate_for_interior_point
    from uno_tpu_torch.options import preset
    opts = preset("ipopt")
    prob = reformulate_for_interior_point(nlp, opts.tolerance)
    x = torch.as_tensor(prob.x0, device=device)[None]
    J = prob.constraint_jacobian(x)
    n, m = prob.n, prob.m
    K = torch.zeros((1, n + m, n + m), dtype=torch.float64, device=device)
    K[0, :n, :n] = torch.eye(n, dtype=torch.float64, device=device)
    K[0, n:, :n] = J[0]
    K[0, :n, n:] = J[0].T
    del J
    dim = n + m
    plan = cuda_ldlt.plan(1, dim, K.dtype)
    L, d = torch.empty_like(K), torch.empty((1, dim), dtype=K.dtype, device=device)
    counts = [torch.empty(1, dtype=torch.int64, device=device) for _ in range(3)]
    plain = plain_factorizer(dim)
    with cuda_ldlt.uncounted():
        cuda_ldlt.launch(K, L, d, *counts)
        fp = plain(K)
        gap = max(float((L - fp.L).abs().amax()), float((d - fp.d).abs().amax()))
        del fp
        row = {"dim": dim, "dtype": "float64", "route": plan.route,
               "kernel_launches": plan.launches, "max_abs_err": gap,
               "ms": time_ms(lambda: cuda_ldlt.launch(K, L, d, *counts)),
               "plain_ms": eager_ms(lambda: plain(K), groups=1, target_ms=1.0)}
    row["bound_ms"], row["bound_by"] = bound_ms(1, dim, 8, "float64")
    if not gap <= FACTOR_RTOL["float64"] * max(1.0, float(d.abs().amax())):
        raise AssertionError(f"initial multipliers, dim {dim}: {row}")
    return row


def lifted_options():
    """The main path's options with the lifted Cholesky in float64 (tau
    stays at 1e-8; uno_tpu's options ask for about 1e-5 with float32
    factors)."""
    return main_path_options().replace(kkt_formulation="lifted", kkt_dtype="float64")


def phase_lifted(device="cuda", batch=LIFTED_BATCH, rerun=LIFTED_RERUN,
                 unsolved=LIFTED_UNSOLVED):
    """The flagship batch through the lifted backend, held to uno_tpu's
    solved set (its CPU run of the same instances), with `rerun` instances
    again on the CPU; then hs015 under lifted against the CPU."""
    import torch
    import uno_tpu_torch
    from uno_tpu_torch.linalg import condensed, cuda_ldlt
    from uno_tpu_torch.model.library import flagship, hs015
    from uno_tpu_torch.solvers.ipm import ALMOST_OPTIMAL, OPTIMAL

    nlp, x0, params = flagship(batch)
    opts = lifted_options()
    condensed.reset_counts()
    cuda_ldlt.reset_counts()
    t0 = time.monotonic()
    res = uno_tpu_torch.solve_batch(nlp, x0, params, opts=opts, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    failed = np.nonzero((res.status != OPTIMAL) & (res.status != ALMOST_OPTIMAL))[0]
    out = {"batch": batch, "solved": res.num_solved, "unsolved": failed.tolist()[:32],
           "mean_iterations": float(np.mean(res.iterations)),
           "max_iterations": int(np.max(res.iterations)), "wall_s": wall,
           "solves_per_s": batch / wall, "lifted": dict(condensed.counts),
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls)}
    if condensed.counts["factorizations"] <= 0:
        raise AssertionError("the lifted backend did not run")
    if not np.all(np.isfinite(res.x)) or tuple(failed.tolist()) != tuple(
            i for i in unsolved if i < batch):
        raise AssertionError(f"lifted batch: {out}")
    k = min(rerun, batch)
    ref = uno_tpu_torch.solve_batch(nlp, x0[:k], params[:k], opts=opts, device="cpu")
    diff = np.abs(ref.iterations - res.iterations[:k])
    out.update(cpu_rerun=k, status_equal=int(np.sum(ref.status == res.status[:k])),
               iterations_max_diff=int(diff.max()),
               x_max_abs_diff=float(np.max(np.abs(ref.x - res.x[:k]))))
    print(json.dumps(out), flush=True)
    if not np.array_equal(ref.status, res.status[:k]) or diff.max() > 0 \
            or not out["x_max_abs_diff"] <= X_ATOL:
        raise AssertionError(f"lifted batch against the CPU: {out}")

    r, wall, counts = _solve_counted(hs015(), device, kkt_formulation="lifted")
    row = {"problem": "hs015", "status": r.status, "iterations": r.iterations,
           "objective": r.objective, "wall_s": wall, "lifted": counts["lifted"]}
    row.update(_against_cpu("hs015 lifted", r, uno_tpu_torch_solve_cpu(
        hs015(), kkt_formulation="lifted"), 1e-10))
    print(json.dumps(row), flush=True)
    if not abs(r.objective - HS015_OPTIMUM) < 1e-2 or counts["lifted"]["factorizations"] <= 0:
        raise AssertionError(f"hs015 lifted: {row}")
    out["hs015"] = row
    return out


def phase_sparse(device="cuda", n=STEERING_N, ref=STEERING_REF,
                 chwood=CHWOOD_NAME):
    """steering under kkt_formulation="sparse" against uno_tpu's CPU result
    and route report `ref`, and the card's augmented run; the auto_permute route report of the same instance; chwood_eq
    under auto_permute, whose detection finds a band for the banded
    backend, against the CPU."""
    from uno_tpu_torch.linalg import sparse_kkt
    from uno_tpu_torch.model import transforms
    from uno_tpu_torch.model.library import get_problem
    from uno_tpu_torch.model.library_cutest import cutest_problem
    from uno_tpu_torch.options import preset
    from uno_tpu_torch.solvers.ipm import build_ipm

    out = {}
    nlp = cutest_problem("steering", n)
    res, wall, counts = _solve_counted(nlp, device, kkt_formulation="sparse")
    rep = sparse_kkt.last_detection_report
    row = {"problem": nlp.name, "status": res.status, "iterations": res.iterations,
           "objective": res.objective, "wall_s": wall, "report": vars(rep),
           "flop_ratio": rep.padded_flops / rep.dense_flops, **counts}
    print(json.dumps(row), flush=True)
    if counts["sparse"]["factorizations"] <= 0 or rep.route != "sparse" \
            or (rep.N, rep.num_supernodes) != (ref["N"], ref["supernodes"]) \
            or round(row["flop_ratio"], 3) != ref["flop_ratio"]:
        raise AssertionError(f"{nlp.name}: the sparse route differs from "
                             f"uno_tpu's {ref}: {row['report']}")
    # held to uno_tpu's CPU result alone: no CPU rerun of the port here,
    # for the script's time limit (PERF.md, the cuts)
    row["uno_tpu_objective_rel_gap"] = _held_to(
        nlp.name, res, ref["iterations"], ref["objective"], 1e-9)
    aug, aug_wall, aug_counts = _solve_counted(nlp, device, kkt_formulation="augmented")
    row["augmented"] = {"status": aug.status, "iterations": aug.iterations,
                        "objective": aug.objective, "wall_s": aug_wall,
                        "launches_by_route": aug_counts["launches_by_route"]}
    if aug.status != res.status or abs(aug.iterations - res.iterations) > 1:
        raise AssertionError(f"{nlp.name}: sparse and augmented differ: {row}")
    # the auto route of the same instance (detection skips n > 1536)
    opts = preset("ipopt", auto_permute=True)
    if transforms.detect_structure(nlp)[1] is not None:
        raise AssertionError(f"{nlp.name}: detect_structure found a band")
    build_ipm(nlp, opts)
    row["auto_permute_report"] = vars(sparse_kkt.last_detection_report)
    print(json.dumps({k: row[k] for k in ("augmented", "auto_permute_report")}),
          flush=True)
    out["steering"] = row

    cw = get_problem(chwood)
    permuted, perm = transforms.detect_structure(cw)
    if perm is None:
        raise AssertionError(f"{chwood}: detect_structure found no band")
    res, wall, counts = _solve_counted(cw, device, auto_permute=True)
    row = {"problem": chwood, "hess_bandwidth": permuted.structure.hess_bandwidth,
           "jac_width": permuted.structure.jac_width, "status": res.status,
           "iterations": res.iterations, "objective": res.objective,
           "wall_s": wall, **counts}
    if counts["banded"]["factorizations"] <= 0:
        raise AssertionError(f"{chwood}: the banded backend did not run")
    row.update(_against_cpu(chwood, res, uno_tpu_torch_solve_cpu(
        cw, auto_permute=True), 1e-10, 1e-8))
    print(json.dumps(row), flush=True)
    if res.status != "optimal":
        raise AssertionError(f"{chwood}: {row}")
    out["chwood"] = row
    return out


def ipm_mix_options(mix):
    """The main path's options under one ingredient mix of IPM_MIX_BATCHES."""
    return main_path_options().replace(**IPM_MIX_BATCHES[mix])


def phase_ipm_mixes(device="cuda", full_batch=MAIN_BATCH, batch=IPM_MIX_BATCH,
                    rerun=CPU_RERUN, unsolved=IPM_MIX_UNSOLVED):
    """The IPM under each mix of IPM_MIX_BATCHES on the flagship family:
    IPM_MIX_FULL at `full_batch`, the others at `batch`, each on `device`
    (cold: the first run of its options in the process), held to uno_tpu's
    unsolved instances and, for its first `rerun` instances, to the CPU
    (equal status and iterations, x within X_ATOL); the standard filter at
    `batch` too, first, which the LS_batch_candidates=4 batch must equal
    instance for instance (x within X_ATOL).  Then IPM_MIX_SINGLES against
    the CPU (status, iterations, objective within 1e-10 relative and x
    within IPM_MIX_X_ATOL).  Prints wall seconds, iterations, line-search
    trips and the kernels' launches by route."""
    import torch
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.solvers import ipm
    from uno_tpu_torch.solvers.ipm import ALMOST_OPTIMAL, OPTIMAL

    cuda = torch.device(device).type == "cuda"
    out = {"batches": [], "singles": []}
    runs = {}
    for mix in ("standard",) + tuple(IPM_MIX_BATCHES):
        B = full_batch if mix == IPM_MIX_FULL else batch
        nlp, x0, params = flagship(B)
        opts = main_path_options() if mix == "standard" else ipm_mix_options(mix)
        cuda_ldlt.reset_counts()
        ipm.reset_counts()
        t0 = time.monotonic()
        res = uno_tpu_torch.solve_batch(nlp, x0, params, opts=opts, device=device)
        if cuda:
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {"launches_by_route": dict(cuda_ldlt.launches),
                  "calls_by_route": dict(cuda_ldlt.calls), **ipm.counts}
        runs[mix] = res
        failed = np.nonzero((res.status != OPTIMAL) & (res.status != ALMOST_OPTIMAL))[0]
        row = {"mix": mix, "batch": B, "solved": res.num_solved,
               "unsolved": failed.tolist()[:32],
               "mean_iterations": float(np.mean(res.iterations)),
               "max_iterations": int(np.max(res.iterations)), "wall_s": wall,
               "solves_per_s": B / wall, **counts,
               "launches": sum(counts["launches_by_route"].values())}
        tag = f"IPM mix {mix}"
        if cuda and counts["launches_by_route"]["ldlt_warp"] <= 0:
            raise AssertionError(f"{tag}: ldlt_warp launched 0 times")
        if res.x.shape != (B, nlp.n) or not np.all(np.isfinite(res.x)):
            raise AssertionError(f"{tag}: non-finite or misshapen solutions")
        expected = unsolved.get(mix, ())
        if mix != "standard" and tuple(failed.tolist()) != tuple(i for i in expected if i < B):
            raise AssertionError(f"{tag}: unsolved {failed.tolist()[:32]}, "
                                 f"uno_tpu: {list(expected)}")
        if mix == "LS_batch_candidates=4":
            std = runs["standard"]
            row["x_max_abs_diff_to_standard"] = float(np.max(np.abs(res.x - std.x)))
            row["standard_line_search_trips"] = out["standard"]["line_search_trips"]
            if not (np.array_equal(res.status, std.status)
                    and np.array_equal(res.iterations, std.iterations)
                    and row["x_max_abs_diff_to_standard"] <= X_ATOL):
                raise AssertionError(f"{tag}: differs from the standard batch: {row}")
        if mix != "standard":
            k = min(rerun, B)
            ref = uno_tpu_torch.solve_batch(nlp, x0[:k], params[:k], opts=opts,
                                            device="cpu")
            diff = np.abs(ref.iterations - res.iterations[:k])
            row.update(cpu_rerun=k,
                       iterations_equal=int(np.sum(diff == 0)),
                       x_max_abs_diff=float(np.max(np.abs(ref.x - res.x[:k]))))
            if not np.array_equal(ref.status, res.status[:k]) or diff.max() > 0 \
                    or not row["x_max_abs_diff"] <= X_ATOL:
                raise AssertionError(f"{tag}: differs from the CPU run: {row}")
        print(json.dumps(row), flush=True)
        if mix == "standard":
            out["standard"] = row
        else:
            out["batches"].append(row)

    with largest_factorizations() as largest:
        for name, over in IPM_MIX_SINGLES:
            out["singles"].append(_ipm_mix_single(name, over, device))
    out["singles_largest_by_route"] = largest
    return out


def _ipm_mix_single(name, over, device):
    """One run of IPM_MIX_SINGLES on `device`, held against the CPU: equal
    status and iterations, x within IPM_MIX_X_ATOL, the objective within
    1e-10 relative."""
    import torch
    from uno_tpu_torch.model.library import get_problem
    nlp = get_problem(name)
    res, wall, counts = _solve_counted(nlp, device, **over)
    ref = uno_tpu_torch_solve_cpu(nlp, **over)
    row = {"problem": name, **over, "status": res.status,
           "iterations": res.iterations, "objective": res.objective,
           "wall_s": wall, "launches_by_route": counts["launches_by_route"],
           "calls_by_route": counts["calls_by_route"], "banded": counts["banded"]}
    row.update(_against_cpu(f"{name} {over}", res, ref, 1e-10, IPM_MIX_X_ATOL))
    if nlp.structure is not None and counts["banded"]["factorizations"] <= 0:
        raise AssertionError(f"{name}: the banded backend did not run")
    if torch.device(device).type == "cuda" \
            and sum(counts["launches_by_route"].values()) <= 0:
        raise AssertionError(f"{name} {over}: no LDL^T kernel launched")
    print(json.dumps(row), flush=True)
    return row


def phase_sqp_host(device="cuda", ref=SQP_HOST_REF):
    """Each run of `ref` through solve() with the host SQP driver (the
    preset with sqp_driver="host", or the preset with the mix's mechanism,
    which only the host driver runs) on `device` and on the CPU: equal
    status, iterations and QPs, objective within SQP_F_ATOL; each held to
    uno_tpu's CPU result in `ref` the same way (objective within 1e-8
    relative).  The run of SQP_HOST_SENSITIVE is held to the status and the
    objective alone.  ldlt_warp must launch on the card."""
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import get_problem
    from uno_tpu_torch.solvers import qp

    def options(preset, how):
        return {"sqp_driver": "host"} if how == "host" \
            else {"globalization_mechanism": how}

    done = []
    cuda_ldlt.reset_counts()
    qp.reset_counts()
    t0 = time.monotonic()
    with largest_factorizations() as largest:
        for preset, name, how in ref:
            t1 = time.monotonic()
            res = uno_tpu_torch.solve(get_problem(name), preset=preset, device=device,
                                      **options(preset, how))
            done.append((preset, name, how, res, time.monotonic() - t1))
    wall = time.monotonic() - t0
    out = {"wall_s": wall, "launches": sum(cuda_ldlt.launches.values()),
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls), "qp_counts": dict(qp.counts),
           "largest_by_route": largest, "runs": []}
    for preset, name, how, res, run_s in done:
        cpu = uno_tpu_torch.solve(get_problem(name), preset=preset, device="cpu",
                                  **options(preset, how))
        status, iterations, qps, objective = ref[(preset, name, how)]
        out["runs"].append({
            "preset": preset, "problem": name, "driver": how, "wall_s": run_s,
            "status": res.status, "iterations": res.iterations,
            "qps": res.num_subproblems_solved, "objective": res.objective,
            "cpu": [cpu.status, cpu.iterations, cpu.num_subproblems_solved],
            "objective_diff": res.objective - cpu.objective,
            "uno_tpu": [status, iterations, qps],
            "uno_tpu_objective_rel_gap": abs(res.objective - objective) / abs(objective)})
    print(json.dumps(out), flush=True)
    if device != "cpu" and out["launches_by_route"]["ldlt_warp"] <= 0:
        raise AssertionError("the host SQP driver launched ldlt_warp 0 times")
    for r in out["runs"]:
        key = (r["preset"], r["problem"], r["driver"])
        got = [r["status"], r["iterations"], r["qps"]]
        if key in SQP_HOST_SENSITIVE:
            ok = r["status"] == r["cpu"][0] == r["uno_tpu"][0] \
                and r["uno_tpu_objective_rel_gap"] <= SQP_HOST_SENSITIVE_F_RTOL
        else:
            ok = got == r["cpu"] == r["uno_tpu"] \
                and abs(r["objective_diff"]) <= SQP_F_ATOL \
                and r["uno_tpu_objective_rel_gap"] <= 1e-8
        if not ok:
            raise AssertionError(f"host SQP driver: {r}")
    return out


def phase_profile_structured(top=12, n=LUKVLE1_N):
    """lukvle1 at n once more (warm: the banded phase solved it) under
    torch.profiler: the device's busy share, the top device kernels and
    host operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import uno_tpu_torch
    from uno_tpu_torch.model.library_cutest import cutest_problem

    nlp = cutest_problem("lukvle1", n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU]) as prof:
        t0 = time.monotonic()
        res = uno_tpu_torch.solve(nlp, preset="ipopt", device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    device_rows, host_rows = [], []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            device_rows.append((getattr(e, "self_device_time_total", 0.0) / 1e3,
                                e.count, e.key))
        else:
            host_rows.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    device_rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in device_rows)
    out = {"problem": nlp.name, "iterations": res.iterations,
           "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernel_launches": int(sum(r[1] for r in device_rows)),
           "device_top": [{"ms": r[0], "count": r[1], "name": r[2][:90]}
                          for r in device_rows[:top]],
           "host_top": [{"self_ms": r[0], "count": r[1], "name": r[2][:60]}
                        for r in host_rows[:top]]}
    print(json.dumps(out, indent=1), flush=True)
    if busy_ms <= 0.0:
        raise AssertionError("the profiler saw no device time")
    return out


# ---------------------------------------------------------------------------
# slice 4: multi-card on torch.distributed, on a one-process NCCL group
# ---------------------------------------------------------------------------

def _reset_device_counts(device):
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    cuda_ldlt.reset_counts()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_sharded(main_result, device="cuda", batch=MAIN_BATCH):
    """The main path's flagship batch through solve_batch_sharded on a
    one-process group (NCCL on the card); raise unless its status,
    iterations and x equal main_path's solve_batch result bit for bit and
    ldlt_warp launched."""
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.parallel import make_group, solve_batch_sharded

    group = make_group(device)
    nlp, x0, params = flagship(batch)
    _reset_device_counts(device)
    t0 = time.monotonic()
    res = solve_batch_sharded(nlp, main_path_options(), x0, params, group)
    _sync(device)
    wall = time.monotonic() - t0
    out = {"batch": batch, "world": group.size, "backend": group.backend,
           "solved": res.num_solved, "mean_iterations": float(np.mean(res.iterations)),
           "max_iterations": int(np.max(res.iterations)), "wall_s": wall,
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls), "peak_gib": _peak_gib(device)}
    out["equal_to_main_path"] = {k: bool(np.array_equal(getattr(res, k), getattr(main_result, k)))
                                 for k in ("status", "iterations", "x")}
    print(json.dumps(out), flush=True)
    if device != "cpu" and out["launches_by_route"]["ldlt_warp"] <= 0:
        raise AssertionError("the sharded batch launched ldlt_warp 0 times")
    if not all(out["equal_to_main_path"].values()):
        raise AssertionError(f"the sharded batch differs from solve_batch: "
                             f"{out['equal_to_main_path']}")
    return out


def dist_panel_cases(rows, block=DIST_BLOCK, ranks=1):
    """(row0, col0) of the panels check_dist_panel factors on a rank's
    (rows, rows / ranks) storage, as make_dist_ldlt hands them to the
    kernel: on one rank the first panel, a middle one and the last (row0 =
    rows - block, the most rows above it); on several, rank 1's first,
    middle and last (col0 > 0 from its second panel on)."""
    if ranks == 1:
        return [(r, r) for r in sorted({0, (rows - block) // 2 // block * block,
                                        rows - block})]
    mine = list(range(1, rows // block, ranks))
    return [(g * block, (g // ranks) * block)
            for g in sorted({mine[0], mine[len(mine) // 2], mine[-1]})]


def dist_panel_storage(rows, ld, seed, cases, block=DIST_BLOCK, nonfinite=None):
    """A rank's (rows, ld) storage whose panels at `cases` are KKT-like:
    small Gaussian entries, the diagonal block symmetric with pivots of
    magnitude 10^U(0, 3), 30% of them negative.  `nonfinite` "nan_pivot"
    makes each block's sixth pivot NaN, "inf_multiplier" the block's entry
    on its 41st row (its 9th at block 32) in its fourth column +Inf."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((rows, ld)) * 0.1
    at = np.arange(block)
    for row0, col0 in cases:
        D = W[row0:row0 + block, col0:col0 + block]
        D = (D + D.T) / 2
        diag = 10.0 ** rng.uniform(0, 3, block)
        D[at, at] = np.where(rng.uniform(size=block) < 0.3, -diag, diag)
        if nonfinite == "nan_pivot":
            D[5, 5] = np.nan
        elif nonfinite == "inf_multiplier":
            D[40 if block == 64 else 8, 3] = np.inf
        W[row0:row0 + block, col0:col0 + block] = D
    return W


def dist_panel_bound(rows, row0, block, itemsize, dtype_name):
    """The least time for a panel factor: the slab (rows x block) read and
    written and the pivots written, over the memory rate, against the
    operations these inputs need (per column a reciprocal, a multiplier for
    every row below the pivot and three operations for each of its entries
    right of the column), over the peak rate; the larger of the two."""
    bytes_moved = (2 * rows * block + block) * itemsize
    flops = sum((rows - row0 - jj - 1) * (1 + 3 * (block - jj - 1)) + 1
                for jj in range(block))
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def same_bits(a, b):
    """a and b NaN at the same entries and bit for bit equal elsewhere (the
    sign of a zero included; a NaN's payload is not IEEE's to fix)."""
    import torch
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(torch.where(nan, 0, a).view(ints), torch.where(nan, 0, b).view(ints))


def finite_gap(a, b):
    """max |a - b| over the entries where both are finite (0 if none)."""
    import torch
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs()[both].amax()) if bool(both.any()) else 0.0


def check_dist_panel(rows, dtype_name, seed=0, block=DIST_BLOCK, ranks=1, nonfinite=None,
                     timed=True):
    """dist_panel on a rank's (rows, rows / ranks) storage against
    panel_factor_plain on the same card tensors, bit for bit (NaN where it
    is NaN) at dist_panel_cases' panels, the other columns untouched; with
    `timed`, the slab at row 0 and column 0 (the most work) timed, with the
    plain version and the bound.  Its launches leave the counts as they
    were."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.parallel.dist_ldlt import panel_factor, panel_factor_plain

    B = block
    dtype = getattr(torch, dtype_name)
    ld = rows // ranks
    cases = dist_panel_cases(rows, B, ranks)
    W = torch.as_tensor(dist_panel_storage(rows, ld, seed, cases, B, nonfinite),
                        dtype=dtype, device="cuda")
    row = {"kernel": "dist_panel", "rows": rows, "block": B, "ld": ld,
           "dtype": dtype_name, "ranks": ranks, "nonfinite": nonfinite,
           "panels": [list(c) for c in cases],
           "grids": [cuda_ldlt.dist_panel_grid(rows, r0, B).grid for r0, _ in cases]}
    gaps = []
    with cuda_ldlt.uncounted():
        for row0, col0 in cases:
            work = W.clone()
            d = panel_factor(work, col0, row0, B)
            C, d_plain = panel_factor_plain(W[:, col0:col0 + B], row0)
            torch.cuda.synchronize()
            same = same_bits(work[:, col0:col0 + B], C) and same_bits(d, d_plain) \
                and same_bits(work[:, :col0], W[:, :col0]) \
                and same_bits(work[:, col0 + B:], W[:, col0 + B:])
            gaps.append(max(finite_gap(work[:, col0:col0 + B], C), finite_gap(d, d_plain)))
            if not same:
                raise AssertionError(f"dist_panel ({rows}, {B}) ld {ld} {dtype_name} "
                                     f"{nonfinite or ''} at row {row0}, column {col0}: "
                                     f"differs from panel_factor_plain by {gaps[-1]:.3e}")
        row["max_abs_err"] = max(gaps)
        if timed:
            work, orig = W.clone(), W[:, :B].clone()
            d = W.new_empty(B)

            def restore():
                work[:, :B].copy_(orig)

            def factor():
                restore()
                cuda_ldlt.launch_dist_panel(work, 0, 0, B, d)

            restore_ms = time_ms(restore)
            row["ms"] = time_ms(factor) - restore_ms
            row["ms_with_restore"] = row["ms"] + restore_ms
            row["plain_ms"] = time_ms(lambda: panel_factor_plain(W[:, :B], 0))
            row["eager_ms"] = eager_ms(factor)
    if timed:
        row["bound_ms"], row["bound_by"] = dist_panel_bound(rows, 0, B, W.element_size(),
                                                            dtype_name)
    print(json.dumps(row), flush=True)
    return row


def phase_dist_kkt(dense, device="cuda", n=LARGE_N):
    """single_large's instance (KKT dim 1280, float64) with its KKT
    factorization on the distributed route over a one-process group (20
    panels of 64 on dist_panel); raise unless it meets single_large's
    standard and dist_panel and ldlt_panel (the initial multipliers)
    launched; timed beside `dense`, single_large's result.  Then dist_panel
    against its plain version (check_dist_panel)."""
    import uno_tpu_torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.model.library import flagship
    from uno_tpu_torch.options import preset
    from uno_tpu_torch.parallel import make_group

    group = make_group(device)
    nlp = flagship(1, n=n)[0]
    opts = preset("ipopt", ldlt_backend="distributed")
    if opts.dist_ldlt_block != DIST_BLOCK:
        raise AssertionError(f"dist_ldlt_block {opts.dist_ldlt_block} != {DIST_BLOCK}")
    f_star, x_star = large_optimum(n)
    _reset_device_counts(device)
    t0 = time.monotonic()
    res = uno_tpu_torch.solve(nlp, options=opts, group=group)
    _sync(device)
    out = {"n": n, "kkt_dim": LARGE_KKT_DIM, "panels": LARGE_KKT_DIM // DIST_BLOCK,
           "world": group.size, "backend": group.backend, "status": res.status,
           "objective": res.objective, "objective_gap": res.objective - f_star,
           "x_max_abs_diff": float(np.max(np.abs(res.x - x_star))),
           "iterations": res.iterations, "factorizations": res.num_factorizations,
           "wall_s": time.monotonic() - t0,
           "dense_wall_s": dense["wall_s"], "dense_iterations": dense["iterations"],
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls), "peak_gib": _peak_gib(device)}
    print(json.dumps(out), flush=True)
    if device != "cpu" and (out["launches_by_route"]["dist_panel"] <= 0
                            or out["launches_by_route"]["ldlt_panel"] <= 0):
        raise AssertionError(f"the distributed route did not launch dist_panel and "
                             f"ldlt_panel: {out['launches_by_route']}")
    if res.status != "optimal" or not abs(out["objective_gap"]) <= LARGE_F_ATOL \
            or abs(res.iterations - LARGE_CPU_ITERATIONS) > LARGE_ITERATION_SLACK:
        raise AssertionError(f"distributed route: {out}")
    if device != "cpu":
        dtypes = ("float32", "float64")
        out["dist_panel"] = [check_dist_panel(rows, dtype_name, seed=k)
                             for k, (rows, dtype_name) in enumerate(
                                 (r, t) for r in DIST_PANEL_ROWS for t in dtypes)]
        # untimed: a rank's storage of four ranks and panels with a NaN
        # pivot and an infinite multiplier, bit for bit
        out["dist_panel_checks"] = [
            check_dist_panel(rows, t, seed=10 + k, ranks=DIST_PANEL_RANKS, timed=False)
            for k, (rows, t) in enumerate((r, t) for r in DIST_PANEL_ROWS for t in dtypes)] + [
            check_dist_panel(LARGE_KKT_DIM, t, seed=20 + k, nonfinite=kind, timed=False)
            for k, (kind, t) in enumerate((kind, t) for kind in DIST_PANEL_NONFINITE
                                          for t in dtypes)]
    return out


def _schur_run(Ks, Bs, K0, rhs_s, rhs0, device):
    import torch
    from uno_tpu_torch.parallel.schur import schur_factor, schur_solve
    args = [torch.as_tensor(a, device=device) for a in (Ks, Bs, K0, rhs_s, rhs0)]
    fac = schur_factor(*args[:3])
    xs, x0 = schur_solve(fac, args[1], *args[3:])
    return fac, xs, x0, args


def phase_schur(device="cuda", S=SCHUR_S, nb=SCHUR_NB, n0=SCHUR_N0):
    """The Schur-complement factor and solve of a seeded block-arrow system
    on the card (the blocks on ldlt_column, S_0 on ldlt_panel) against the
    same code on the CPU: equal inertia (all positive), x within
    SCHUR_X_ATOL; the card's blockwise residual within SCHUR_RESIDUAL;
    factor and solve timed by CUDA events around eager calls, with their
    launches."""
    import torch
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.parallel.schur import (random_block_arrow_system,
                                              schur_factor, schur_solve)

    Ks, Bs, K0 = random_block_arrow_system(S, nb, n0, seed=SCHUR_SEED)
    rng = np.random.default_rng(SCHUR_SEED + 1)
    rhs_s, rhs0 = rng.standard_normal((S, nb)), rng.standard_normal(n0)
    _reset_device_counts(device)
    t0 = time.monotonic()
    fac, xs, x0, args = _schur_run(Ks, Bs, K0, rhs_s, rhs0, device)
    _sync(device)
    inertia = (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero))
    out = {"S": S, "nb": nb, "n0": n0, "dtype": "float64",
           "mib": {"Ks": Ks.nbytes / 2 ** 20, "Bs": Bs.nbytes / 2 ** 20,
                   "Y": Bs.nbytes / 2 ** 20},
           "wall_s": time.monotonic() - t0, "inertia": inertia,
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls), "peak_gib": _peak_gib(device)}
    Kt, Bt, K0t, rst, r0t = args
    r_s = torch.einsum("sij,sj->si", Kt, xs) + torch.einsum("sij,j->si", Bt, x0)
    r_0 = torch.einsum("sij,si->j", Bt, xs) + K0t @ x0
    resid = torch.sqrt(torch.sum((r_s - rst) ** 2) + torch.sum((r_0 - r0t) ** 2))
    out["residual"] = float(resid / torch.sqrt(torch.sum(rst ** 2) + torch.sum(r0t ** 2)))
    fac_c, xs_c, x0_c, _ = _schur_run(Ks, Bs, K0, rhs_s, rhs0, "cpu")
    out["cpu_inertia"] = (int(fac_c.num_pos), int(fac_c.num_neg), int(fac_c.num_zero))
    out["x_max_abs_diff"] = max(float((xs.cpu() - xs_c).abs().amax()),
                                float((x0.cpu() - x0_c).abs().amax()))
    if device != "cpu":
        with cuda_ldlt.uncounted():
            out["factor_ms"] = eager_ms(lambda: schur_factor(Kt, Bt, K0t), groups=3,
                                        target_ms=100.0)
            out["solve_ms"] = eager_ms(lambda: schur_solve(fac, Bt, rst, r0t), groups=3,
                                       target_ms=100.0)
    print(json.dumps(out), flush=True)
    if device != "cpu" and (out["launches_by_route"]["ldlt_column"] <= 0
                            or out["launches_by_route"]["ldlt_panel"] <= 0):
        raise AssertionError(f"schur: the blocks and S_0 did not launch ldlt_column "
                             f"and ldlt_panel: {out['launches_by_route']}")
    if inertia != out["cpu_inertia"] or inertia != (S * nb + n0, 0, 0):
        raise AssertionError(f"schur: inertia {inertia}, CPU {out['cpu_inertia']}")
    if not out["x_max_abs_diff"] <= SCHUR_X_ATOL or not out["residual"] <= SCHUR_RESIDUAL:
        raise AssertionError(f"schur: x differs from the CPU by {out['x_max_abs_diff']:.3e}, "
                             f"residual {out['residual']:.3e}")
    return out


def two_stage_problem(S, seed=0):
    """The two-stage family of tests/test_structured.py:
        min ||x0 - 1||^2 + sum_s ||xs - a_s||^2
        s.t. xs_1 + xs_2 + 0.1 x0_1^2 = b_s, xs >= 0   (each scenario s)
    with a_s ~ U(-0.5, 1.5)^3 and b_s ~ U(1, 2) from `seed`."""
    import torch
    from uno_tpu_torch.model.nlp import INF
    from uno_tpu_torch.solvers.structured import ScenarioNLP

    rng = np.random.default_rng(seed)
    n0, ns, m = 2, 3, 1
    a = rng.uniform(-0.5, 1.5, (S, ns))
    b = rng.uniform(1.0, 2.0, (S, 1))

    def f0(x0):
        return torch.sum((x0 - 1.0) ** 2)

    def fs(x0, xs, p):
        return torch.sum((xs - p["a"]) ** 2)

    def cs(x0, xs, p):
        return torch.stack([xs[0] + xs[1] + 0.1 * x0[0] ** 2 - p["b"][0]])

    return ScenarioNLP(
        name="two_stage", n0=n0, ns=ns, m=m, S=S, f0=f0, fs=fs, cs=cs,
        x0_lb=np.full(n0, -INF), x0_ub=np.full(n0, INF),
        xs_lb=np.zeros(ns), xs_ub=np.full(ns, INF),
        x0_init=np.full(n0, 0.5), xs_init=np.full((S, ns), 0.5),
        params={"a": a, "b": b})


def phase_structured(device="cuda", S=STRUCTURED_S, ref=STRUCTURED_REF):
    """solve_structured_ipm on the two-stage family at S scenarios on the
    card, against the port on the CPU and uno_tpu's CPU result; raise on
    any difference beyond the limits or if ldlt_warp did not launch."""
    from uno_tpu_torch.linalg import cuda_ldlt
    from uno_tpu_torch.solvers.structured import solve_structured_ipm

    snlp = two_stage_problem(S)
    _reset_device_counts(device)
    res = solve_structured_ipm(snlp, tol=1e-8, device=device)
    _sync(device)
    out = {"S": S, "blocks": [S, snlp.ns + snlp.m, snlp.ns + snlp.m], "status": res.status,
           "iterations": res.iterations, "objective": res.objective,
           "kkt_error": res.kkt_error, "wall_s": res.cpu_time,
           "launches_by_route": dict(cuda_ldlt.launches),
           "calls_by_route": dict(cuda_ldlt.calls), "peak_gib": _peak_gib(device)}
    cpu = solve_structured_ipm(snlp, tol=1e-8, device="cpu")
    out.update(cpu_status=cpu.status, cpu_iterations=cpu.iterations,
               cpu_wall_s=cpu.cpu_time,
               x_max_abs_diff=max(float(np.max(np.abs(res.x0 - cpu.x0))),
                                  float(np.max(np.abs(res.xs - cpu.xs)))),
               uno_tpu_x0_max_abs_diff=float(np.max(np.abs(res.x0 - np.asarray(ref["x0"])))),
               uno_tpu_objective_rel_gap=abs(res.objective - ref["objective"])
               / abs(ref["objective"]),
               uno_tpu_xs_sum_diff=abs(float(np.sum(res.xs)) - ref["xs_sum"]),
               uno_tpu_xs_sumsq_diff=abs(float(np.sum(res.xs ** 2)) - ref["xs_sumsq"]))
    print(json.dumps(out), flush=True)
    if device != "cpu" and out["launches_by_route"]["ldlt_warp"] <= 0:
        raise AssertionError("the structured path launched ldlt_warp 0 times")
    if (res.status, res.iterations) != (cpu.status, cpu.iterations) \
            or not out["x_max_abs_diff"] <= STRUCTURED_X_ATOL:
        raise AssertionError(f"structured: the card and the CPU differ: {out}")
    if (res.status, res.iterations) != (ref["status"], ref["iterations"]) \
            or not out["uno_tpu_x0_max_abs_diff"] <= STRUCTURED_X_ATOL \
            or not out["uno_tpu_objective_rel_gap"] <= 1e-10 \
            or not out["uno_tpu_xs_sum_diff"] <= STRUCTURED_X_ATOL * S \
            or not out["uno_tpu_xs_sumsq_diff"] <= STRUCTURED_X_ATOL * S:
        raise AssertionError(f"structured: uno_tpu's result differs: {out}")
    return out


BATCHED = "uno_tpu/linalg/pallas_ldlt.py:206"   # ldlt_factor_pallas_batched's pallas_call
SINGLE = "uno_tpu/linalg/pallas_ldlt.py:247"    # ldlt_factor_pallas's pallas_call


DIST_PANEL_REPLACES = "uno_tpu/parallel/dist_ldlt.py:89"   # _panel_factor (XLA, no Pallas kernel)
KERNEL_SOURCES = {"ldlt_warp": "ldlt.cu", "ldlt_panel": "ldlt.cu",
                  "ldlt_column": "ldlt_column.cu", "dist_panel": "dist_ldlt.cu"}


def dist_panel_entry(path, row):
    """dist_panel's entry of the kernels line: its launches on the
    distributed-KKT path's run, its times and error at the path's slab
    (check_dist_panel's row)."""
    launches = path["launches_by_route"]["dist_panel"]
    return {"name": "dist_panel (distributed-KKT path, dim 1280, panels of 64)",
            "route": "cuda", "source": f"uno_tpu_torch/csrc/{KERNEL_SOURCES['dist_panel']}",
            "replaces": DIST_PANEL_REPLACES, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "calls": path["calls_by_route"]["dist_panel"],
            "eager_ms": row["eager_ms"], "shape": [row["rows"], row["block"]],
            "ld": row["ld"], "dtype": row["dtype"]}


def kernel_entry(name, replaces, path, route, row, **extra):
    """One entry of the kernels line: `launches` are the kernels the route
    launched on `path`'s run and `calls` its wrapper calls there, both as
    the wrapper counted them; the times and errors are `row`'s; `extra`
    adds keys."""
    launches = path["launches_by_route"][route]
    calls = path["calls_by_route"][route]
    source = KERNEL_SOURCES[route]
    return {"name": name, "route": "cuda",
            "source": f"uno_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "calls": calls,
            "kernel_launches_per_call": launches / calls if calls else None,
            "eager_ms": row["eager_ms"],
            "factor_gap": row["factor_gap"],
            "backward_error": row["backward_error"],
            "shape": [row["batch"], row["dim"], row["dim"]],
            "dtype": row["dtype"], **extra}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every measurement here as JSON")
    parser.add_argument("--profile", action="store_true",
                        help="also profile the main path with torch.profiler")
    args = parser.parse_args(argv)

    t_start = time.monotonic()
    device = run_phase("device", phase_device)
    build = run_phase("build", phase_build)
    sweep = run_phase("kernels", phase_kernels)
    large = run_phase("kernels_large", phase_kernels_large)
    main_keep = {}
    main_path = run_phase("main_path", phase_main_path, keep=main_keep)
    n32 = run_phase("n32", phase_n32)
    n512 = run_phase("n512", phase_n512)
    single = run_phase("single", phase_single)
    single_large = run_phase("single_large", phase_single_large)
    sqp_batch = run_phase("sqp_batch", phase_sqp_batch)
    sqp_single = run_phase("sqp_single", phase_sqp_single)
    byrd_batch = run_phase("byrd_batch", phase_byrd_batch)
    byrd_single = run_phase("byrd_single", phase_byrd_single)
    nl = run_phase("nl", phase_nl)
    registry = run_phase("registry", phase_registry)
    structured_kernels = run_phase("structured_kernels", phase_structured_kernels)
    banded_path = run_phase("banded", phase_banded)
    lifted = run_phase("lifted", phase_lifted)
    sparse = run_phase("sparse", phase_sparse)
    ipm_mixes = run_phase("ipm_mixes", phase_ipm_mixes)
    sqp_host = run_phase("sqp_host", phase_sqp_host)
    sharded = run_phase("sharded", phase_sharded, main_keep.pop("result"))
    dist_kkt = run_phase("dist_kkt", phase_dist_kkt, single_large)
    schur = run_phase("schur", phase_schur)
    structured = run_phase("structured", phase_structured)
    profiled = None
    if args.profile:
        profiled = run_phase("profile", phase_profile)
        profiled.update(run_phase("profile_byrd", phase_profile_byrd))
        profiled["lukvle1"] = run_phase("profile_structured", phase_profile_structured)

    # the kernels at the paths' own shapes: the flagship's KKT (dim 12,
    # float32) at the full batch, hs015's (dim 6, float64) alone, and from
    # the sweeps the n=512 path's (132, 516, 516) float32 and the large
    # instance's (1, 1280, 1280) float64
    batched = check_kernel(MAIN_BATCH, MAIN_KKT_DIM, "float32", seed=1)
    K1, expected1 = barrier_kkt_like(1, 6, seed=2)
    single_row = check_kernel(1, 6, "float64", K=K1, expected=expected1)
    # the n=32 path's KKT (dim 36, float32) at its batch; the SQP batch's
    # optimality-QP KKT (dim 10, float32) and the shape of its multiplier
    # fit (dim 18, float64; check_fit_exact holds the fit's own matrices,
    # whose float32 factors are not finite, in the kernels phase) at its
    # batch; the SQP single instances' largest KKT, hs071's (dim 6,
    # float64), has the shape of hs015's under ipopt
    n32_row = check_kernel(N32_BATCH, N32_KKT_DIM, "float32", seed=3)
    sqp_row = check_kernel(SQP_BATCH, SQP_KKT_DIM, "float32", seed=4)
    fit_row = check_kernel(SQP_BATCH, SQP_FIT_DIM, "float64", seed=5)
    # byrd: the batch's relaxed-QP KKT (dim 12, float32) and its fit's shape
    # (dim 22, float64); the single runs' largest KKT, hs071's (dim 9,
    # float64); the nl path's ipopt KKTs (dims 100 and 50, float64) and the
    # command line's byrd KKT (dim 20, float64)
    byrd_row = check_kernel(SQP_BATCH, BYRD_KKT_DIM, "float32", seed=6)
    byrd_fit_row = check_kernel(SQP_BATCH, BYRD_FIT_DIM, "float64", seed=7)
    byrd_single_row = check_kernel(1, BYRD_SINGLE_KKT_DIM, "float64", seed=8)
    nl_rows = {route: check_kernel(1, dim, "float64", seed=9)
               for route, dim in NL_KKT_DIMS.items()}
    nl_cli_row = check_kernel(1, NL_CLI_KKT_DIM, "float64", seed=10)
    chol_ms = cholesky_ms(SQP_BATCH, 8)
    # the structured paths' LDL^T calls: catena's retry (dim 448, float64),
    # the lifted batch's initial multipliers (dim 12, float64) and
    # steering's (dim 3613, float64); lukvle1's (dim 8190) is in `large`
    catena_row = check_kernel(1, CATENA_KKT_DIM, "float64", seed=13)
    lifted_row = check_kernel(LIFTED_BATCH, MAIN_KKT_DIM, "float64", seed=14)
    steering_row = check_kernel(1, STEERING_KKT_DIM, "float64", seed=15)
    # the IPM-mix batches at B=8,192 (dim 12, float32; the funnel's batch
    # has the main path's shape, `batched`); the IPM-mix singles and the
    # host SQP driver at the largest shape each route was given on their run
    mix_row = check_kernel(IPM_MIX_BATCH, MAIN_KKT_DIM, "float32", seed=16)
    mix_paths = {b["mix"]: b for b in ipm_mixes["batches"]}
    mix_single_rows = {route: check_kernel(*shape, seed=17) for route, shape
                       in ipm_mixes["singles_largest_by_route"].items()}
    host_rows = {route: check_kernel(*shape, seed=18) for route, shape
                 in sqp_host["largest_by_route"].items()}
    # the registry tier's solves at the largest shape each route was given
    registry_rows = {route: check_kernel(*shape, seed=21) for route, shape
                     in registry["largest_by_route"].items()}
    # slice 4: the Schur path's S_0 (dim 256, float64; its blocks are the
    # sweep's (2048, 64) float64 row) and the structured path's scenario
    # blocks (dim 4, float64)
    schur_s0_row = check_kernel(1, SCHUR_N0, "float64", seed=19)
    structured_row = check_kernel(STRUCTURED_S, 4, "float64", seed=20)
    dist_panel_row = next(r for r in dist_kkt["dist_panel"]
                          if (r["rows"], r["dtype"]) == (LARGE_KKT_DIM, "float64"))
    mix_singles = {"launches_by_route": {}, "calls_by_route": {}}
    for row in ipm_mixes["singles"]:
        for key in mix_singles:
            for route, k in row[key].items():
                mix_singles[key][route] = mix_singles[key].get(route, 0) + k

    def row_of(rows, batch, dim, dtype_name):
        return next(r for r in rows if (r.get("batch"), r.get("dim"), r.get("dtype"))
                    == (batch, dim, dtype_name))

    def at(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "max_abs_err", "factor_gap", "dtype")} | {
            "shape": [row["batch"], row["dim"], row["dim"]]}

    kernels = [
        kernel_entry("ldlt_warp (batched path)", BATCHED, main_path,
                     "ldlt_warp", batched),
        kernel_entry("ldlt_warp (single-instance path)", SINGLE, single,
                     "ldlt_warp", single_row),
        kernel_entry("ldlt_panel (batched path, n=512)", BATCHED, n512,
                     "ldlt_panel", row_of(sweep, N512_BATCH, N512_KKT_DIM, "float32")),
        kernel_entry("ldlt_panel (single-instance path, dim 1280)", SINGLE,
                     single_large, "ldlt_panel",
                     row_of(large, 1, LARGE_KKT_DIM, "float64")),
        kernel_entry("ldlt_column (batched path, n=32)", BATCHED, n32,
                     "ldlt_column", n32_row, panel_ms=n32_row["panel_ms"],
                     panel_factor_gap=n32_row["panel_factor_gap"]),
        kernel_entry("ldlt_warp (SQP batched path, filtersqp)", BATCHED,
                     sqp_batch, "ldlt_warp", sqp_row, multiplier_fit=at(fit_row)),
        kernel_entry("ldlt_warp (SQP single-instance path)", SINGLE,
                     sqp_single, "ldlt_warp", single_row),
        kernel_entry("ldlt_warp (byrd batched path)", BATCHED, byrd_batch,
                     "ldlt_warp", byrd_row, multiplier_fit=at(byrd_fit_row),
                     primal_regularization_cholesky_ms=chol_ms),
        kernel_entry("ldlt_warp (byrd single-instance path)", SINGLE,
                     byrd_single, "ldlt_warp", byrd_single_row),
        kernel_entry("ldlt_panel (nl path, ipopt)", SINGLE, nl, "ldlt_panel",
                     nl_rows["ldlt_panel"]),
        kernel_entry("ldlt_column (nl path, ipopt)", SINGLE, nl, "ldlt_column",
                     nl_rows["ldlt_column"]),
        kernel_entry("ldlt_warp (nl path, byrd command line)", SINGLE, nl,
                     "ldlt_warp", nl_cli_row),
        *(kernel_entry(f"{route} (registry path, n + m <= 30, ipopt)", SINGLE,
                       registry, route, row) for route, row in registry_rows.items()),
        kernel_entry("ldlt_panel (banded path, lukvle1 n=4096 initial multipliers)",
                     SINGLE, banded_path["lukvle1"], "ldlt_panel",
                     row_of(large, 1, STRUCT_INIT_DIM, "float64")),
        kernel_entry("ldlt_panel (banded path, catena_n298 augmented retry)",
                     SINGLE, banded_path["catena"], "ldlt_panel", catena_row),
        kernel_entry("ldlt_warp (lifted path, flagship initial multipliers)",
                     BATCHED, lifted, "ldlt_warp", lifted_row),
        kernel_entry("ldlt_panel (sparse path, steering initial multipliers)",
                     SINGLE, sparse["steering"], "ldlt_panel", steering_row),
        kernel_entry("ldlt_warp (IPM-mix batched path, funnel B=65,536)", BATCHED,
                     mix_paths[IPM_MIX_FULL], "ldlt_warp", batched),
        *(kernel_entry(f"ldlt_warp (IPM-mix batched path, {mix} B=8,192)",
                       BATCHED, mix_paths[mix], "ldlt_warp", mix_row)
          for mix in IPM_MIX_BATCHES if mix != IPM_MIX_FULL),
        *(kernel_entry(f"{route} (IPM-mix single-instance path)", SINGLE,
                       mix_singles, route, row)
          for route, row in mix_single_rows.items()),
        *(kernel_entry(f"{route} (host SQP single-instance path)", SINGLE,
                       sqp_host, route, row) for route, row in host_rows.items()),
        kernel_entry("ldlt_warp (sharded batched path, one-process NCCL group)",
                     BATCHED, sharded, "ldlt_warp", batched),
        dist_panel_entry(dist_kkt, dist_panel_row),
        kernel_entry("ldlt_panel (distributed-KKT path, initial multipliers)",
                     SINGLE, dist_kkt, "ldlt_panel",
                     row_of(large, 1, LARGE_KKT_DIM, "float64")),
        kernel_entry("ldlt_column (Schur path, scenario blocks)", BATCHED, schur,
                     "ldlt_column", row_of(sweep, SCHUR_S, SCHUR_NB, "float64")),
        kernel_entry("ldlt_panel (Schur path, Schur complement S_0)", SINGLE, schur,
                     "ldlt_panel", schur_s0_row),
        kernel_entry("ldlt_warp (structured scenario IPM, scenario blocks)", BATCHED,
                     structured, "ldlt_warp", structured_row),
    ]
    total = time.monotonic() - t_start
    print(f"total {total:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": device, "build": build, "kernel_sweep": sweep,
                       "kernels_large": large, "main_path": main_path,
                       "n32": n32, "n512": n512, "single": single,
                       "single_large": single_large, "sqp_batch": sqp_batch,
                       "sqp_single": sqp_single, "byrd_batch": byrd_batch,
                       "byrd_single": byrd_single, "nl": nl, "registry": registry,
                       "structured_kernels": structured_kernels,
                       "banded": banded_path, "lifted": lifted, "sparse": sparse,
                       "ipm_mixes": ipm_mixes, "sqp_host": sqp_host,
                       "sharded": sharded, "dist_kkt": dist_kkt, "schur": schur,
                       "structured": structured,
                       "path_kernels": [batched, single_row, n32_row, sqp_row,
                                        fit_row, byrd_row, byrd_fit_row,
                                        byrd_single_row, *nl_rows.values(),
                                        nl_cli_row, catena_row, lifted_row,
                                        steering_row, mix_row,
                                        *mix_single_rows.values(),
                                        *host_rows.values(),
                                        *registry_rows.values(), schur_s0_row,
                                        structured_row],
                       "profile": profiled, "kernels": kernels,
                       "phase_seconds": phase_seconds, "total_s": total}, fh, indent=1)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["kind"],
                                             "count": device["count"]}}),
          flush=True)


if __name__ == "__main__":
    main()
