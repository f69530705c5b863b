#!/usr/bin/env python3
"""Measurements of uno_tpu_torch's LDL^T kernels beyond chip_smoke.py's, on
one NVIDIA card.

    python3 tools/ldlt_kernel_study.py [--parent DIR] [--only STUDY ...]
                                       [--out results.json]

  * With --parent, the ldlt_column of an earlier tree (DIR holds its
    checkout, e.g. unpacked with `git archive <commit> uno_tpu_torch | tar
    -x -C DIR`, from a tree whose ldlt_column takes no group) is built from
    DIR/uno_tpu_torch/csrc/ldlt.cu and launched through its C entry
    `uno_ldlt_column_<f32|f64>(A, L, d, pos, neg, zero, batch, dim, rtol,
    block, smem, grid, stream, launched)` with the launch sizes of the
    earlier tree's own plan() (DIR/uno_tpu_torch/linalg/cuda_ldlt.py).  It
    is timed beside the current ldlt_column and ldlt_panel forced on the
    same inputs, in turns (earlier, current, panel, panel, current,
    earlier), at chip_smoke.py's sweep shapes of dims 33-64, the n=32
    path's shape, and single instances of dims 35, 50 and 64; the earlier
    and current factors and inertia must be equal bit for bit.
  * ldlt_column's groups: every threads-per-instance choice the dim has
    (column_groups_for) timed at batches from 1 to 8,192 and dims 36, 44,
    50 and 64, beside what plan() picks (where its switch batches come
    from).
  * ldlt_panel's launches, each one's device time in the order of a call,
    at the sweep's shapes above dim 32 and at (1, 1280), from torch.profiler.
  * The flagship shape's ldlt_warp launch (65,536 x 12 x 12) split into its
    parts: csrc/ldlt.cu built with one of its UNO_LDLT_STUDY_* switches,
    which take the factorization, the global-memory copies or the
    divisions out, timed beside the kernel.  Their results are wrong by
    construction; only their times are read.
  * ldlt_warp compiled for one fixed dim (the DIM template argument the
    library leaves at 0) against the library's kernel for the dim's bucket,
    at dims up to 16: the loops of the fixed-dim kernel stop at the dim,
    the bucket kernel's lanes update the padding too.  Both must give the
    same L, d and inertia, bit for bit.

  * dist_panel (csrc/dist_ldlt.cu) at slabs of 64 to 8,192 rows, panels of
    64, both dtypes, at the first panel, a middle one and the last: with
    --parent, the earlier tree's kernel (built from DIR/uno_tpu_torch/
    csrc/dist_ldlt.cu, its C entry `uno_dist_panel_<f32|f64>(C, d, n, ld,
    row0, block, stream, launched)`) beside the current one, in turns,
    the two bit for bit; and the current kernel built with
    UNO_DIST_STUDY_DIAG_ONLY (the diagonal block alone: the part that does
    not grow with the rows).  Each time is the slab's restore and the
    launch less the restore alone.  With cuobjdump on the PATH, each
    build's SASS instructions a dist_panel kernel.

Times are chip_smoke.time_ms's: CUDA-graph replays between CUDA events.
Prints one JSON object per measurement and the card's name and power limit
first.  Imports torch, numpy, chip_smoke and uno_tpu_torch only.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from uno_tpu_torch.linalg import cuda_ldlt  # noqa: E402

# the parts of ldlt_warp taken out: csrc/ldlt.cu's switch for each
SWITCHES = {
    "no_factorization": "UNO_LDLT_STUDY_NO_FACTORIZATION",
    "no_global_memory": "UNO_LDLT_STUDY_NO_GLOBAL_MEMORY",
    "no_division": "UNO_LDLT_STUDY_NO_DIVISION",
}
FLAGSHIP = (chip_smoke.MAIN_BATCH, chip_smoke.MAIN_KKT_DIM)
# the fixed-dim study: (batch, dim) in both dtypes, and hs015's shape in float64
FIXED_DIMS = (4, 6, 8, 9, 12, 16)
FIXED_SHAPES = [(chip_smoke.MAIN_BATCH, dim) for dim in FIXED_DIMS]
STUDIES = ("panel_launches", "warp_parts", "warp_fixed_dim", "column_groups",
           "parent", "dist_panel")
DIST_ROWS = (64, 128, 256, 512, 1280, 2048, 4096, 8192)
# ldlt_column's shapes beyond the sweep's: the n=32 path's, and single
# instances (the .nl path's srosenbr_n50 at 50, the byrd fit at 35)
COLUMN_SHAPES = [(chip_smoke.N32_BATCH, chip_smoke.N32_KKT_DIM), (1, 35), (1, 50),
                 (1, 64)]
GROUP_DIMS = (36, 44, 50, 64)
GROUP_BATCHES = (1, 8, 32, 64, 128, 256, 512, 1024, 2048, 8192)


def nvcc(source: Path, out: Path, defines=()) -> ctypes.CDLL:
    subprocess.run([cuda_ldlt._nvcc(), *cuda_ldlt.NVCC_FLAGS,
                    *(f"-D{name}" for name in defines), "-o", str(out),
                    str(source)], check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(str(out))


def sfx(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def warp_fn(lib, dtype, name=None):
    """ldlt_warp's C entry point (or one with its signature, `name`)."""
    fn = getattr(lib, name or "uno_ldlt_warp_" + sfx(dtype))
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_double] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def warp_call(fn, A, L, d, counts, name):
    """A call of `fn` (warp_fn's) at A's shape with the library's plan."""
    batch, dim = A.shape[0], A.shape[-1]
    p = cuda_ldlt.plan(batch, dim, A.dtype)
    launched = ctypes.c_int(0)

    def call():
        err = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(),
                 *(c.data_ptr() for c in counts), batch, dim, 1e-32, p.group,
                 p.block[0], p.smem[0], p.grids[0],
                 torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
        if err or launched.value != 1:
            raise RuntimeError(f"{name}: CUDA error {err}, {launched.value} launches")
    return call


def earlier_column_fn(lib, dtype):
    """ldlt_column's C entry point before the groups: block, smem, grid."""
    fn = getattr(lib, "uno_ldlt_column_" + sfx(dtype))
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_double] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module           # its dataclasses look it up
    spec.loader.exec_module(module)
    return module


def inputs(batch, dim, dtype, seed=0):
    K, _ = chip_smoke.barrier_kkt_like(batch, dim, seed)
    A = torch.as_tensor(K, dtype=dtype, device="cuda").contiguous()
    L = torch.empty_like(A)
    d = torch.empty((batch, dim), dtype=dtype, device="cuda")
    counts = [torch.empty(batch, dtype=torch.int64, device="cuda") for _ in range(3)]
    return A, L, d, counts


def emit(row, rows):
    print(json.dumps(row), flush=True)
    rows.append(row)


def column_shapes():
    return [(chip_smoke.KERNEL_BATCH[dim], dim) for dim in chip_smoke.KERNEL_DIMS
            if cuda_ldlt.plan(1, dim, torch.float32).route == "ldlt_column"] \
        + COLUMN_SHAPES


def compare_parent(parent: Path, tmp: Path, rows):
    lib = nvcc(parent / "uno_tpu_torch" / "csrc" / "ldlt.cu", tmp / "parent.so")
    earlier_plan = load_module(parent / "uno_tpu_torch" / "linalg" / "cuda_ldlt.py",
                               "earlier_cuda_ldlt").plan
    for dtype in (torch.float32, torch.float64):
        fn = earlier_column_fn(lib, dtype)
        for batch, dim in column_shapes():
            A, L, d, counts = inputs(batch, dim, dtype)
            mine = (torch.empty_like(L), torch.empty_like(d),
                    [torch.empty_like(c) for c in counts])
            p = earlier_plan(batch, dim, dtype)
            launched = ctypes.c_int(0)

            def earlier():
                # the current stream: time_ms captures the call in a CUDA graph
                err = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(),
                         *(c.data_ptr() for c in counts), batch, dim, 1e-32,
                         p.block[0], p.smem[0], p.grids[0],
                         torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
                if err or launched.value != 1:
                    raise RuntimeError(f"earlier kernel: CUDA error {err}")

            def current():
                cuda_ldlt.launch(A, mine[0], mine[1], *mine[2])

            def panel():
                cuda_ldlt.launch(A, mine[0], mine[1], *mine[2], route="ldlt_panel")

            times = {"earlier": [], "current": [], "panel": []}
            with cuda_ldlt.uncounted():
                for name in ("earlier", "current", "panel", "panel", "current", "earlier"):
                    times[name].append(chip_smoke.time_ms(
                        {"earlier": earlier, "current": current, "panel": panel}[name]))
                earlier()
                current()
            torch.cuda.synchronize()
            same = torch.equal(L, mine[0]) and torch.equal(d, mine[1]) and all(
                torch.equal(x, y) for x, y in zip(counts, mine[2]))
            if not same:
                raise RuntimeError(f"earlier and current ldlt_column differ at "
                                   f"({batch}, {dim}) {dtype}")
            bound, by = chip_smoke.bound_ms(batch, dim, A.element_size(),
                                            str(dtype).removeprefix("torch."))
            emit({"study": "ldlt_column_earlier_vs_current", "batch": batch,
                  "dim": dim, "dtype": str(dtype).removeprefix("torch."),
                  "earlier_group": p.group, "earlier_block": p.block[0],
                  "group": cuda_ldlt.plan(batch, dim, dtype).group,
                  "earlier_ms": times["earlier"], "current_ms": times["current"],
                  "panel_ms": times["panel"], "bound_ms": bound, "bound_by": by,
                  "bitwise_equal": same}, rows)


def column_groups(rows):
    """Every group of ldlt_column at GROUP_BATCHES x GROUP_DIMS, both
    dtypes, each timed twice in turns (groups in order, then reversed)."""
    for dtype in (torch.float32, torch.float64):
        for dim in GROUP_DIMS:
            for batch in GROUP_BATCHES:
                A, L, d, counts = inputs(batch, dim, dtype, seed=dim)
                times = {}
                order = list(cuda_ldlt.column_groups_for(dim))
                with cuda_ldlt.uncounted():
                    for group in order + order[::-1]:
                        times.setdefault(group, []).append(chip_smoke.time_ms(
                            lambda: cuda_ldlt.launch(A, L, d, *counts, group=group)))
                emit({"study": "ldlt_column_groups", "batch": batch, "dim": dim,
                      "dtype": str(dtype).removeprefix("torch."),
                      "planned": cuda_ldlt.plan(batch, dim, dtype).group,
                      "ms": {str(g): v for g, v in times.items()}}, rows)


def decompose(tmp: Path, rows):
    source = cuda_ldlt.CSRC / "ldlt.cu"
    text = source.read_text()
    libs = {"kernel": ctypes.CDLL(str(cuda_ldlt.build()))}
    for name, switch in SWITCHES.items():
        if switch not in text:       # an unknown switch would change nothing
            raise RuntimeError(f"{name}: {switch} is not in csrc/ldlt.cu")
        libs[name] = nvcc(source, tmp / f"{name}.so", [switch])
    batch, dim = FLAGSHIP
    for dtype in (torch.float32, torch.float64):
        A, L, d, counts = inputs(batch, dim, dtype, seed=1)
        times = {}
        for _ in range(2):
            for name, lib in libs.items():
                call = warp_call(warp_fn(lib, dtype), A, L, d, counts, name)
                times.setdefault(name, []).append(chip_smoke.time_ms(call))
        emit({"study": "ldlt_warp_parts", "batch": batch, "dim": dim,
              "dtype": str(dtype).removeprefix("torch."), "ms": times}, rows)


def fixed_dim_source(shapes) -> str:
    """A translation unit of csrc/ldlt.cu and, for each (dim, dtype), an
    entry point with uno_ldlt_warp's signature that launches ldlt_warp
    compiled for that dim."""
    out = [f'#include "{cuda_ldlt.CSRC / "ldlt.cu"}"']
    for dim, dtype in shapes:
        T = "float" if dtype == torch.float32 else "double"
        group = cuda_ldlt.plan(1, dim, dtype).group
        out.append(f"""
extern "C" int study_warp_fixed_{sfx(dtype)}_{dim}(
    const void* A, void* L, void* d, void* pos, void* neg, void* zero, int batch,
    int dim, double rtol, int group, int block, int smem, int grid, void* stream,
    int* launched) {{
  *launched = 0;
  if (dim != {dim} || group != {group}) return static_cast<int>(cudaErrorInvalidValue);
  return launch_warp_g<{T}, {group}, {dim}>(
      static_cast<const {T}*>(A), static_cast<{T}*>(L), static_cast<{T}*>(d),
      static_cast<long long*>(pos), static_cast<long long*>(neg),
      static_cast<long long*>(zero), batch, dim, static_cast<{T}>(rtol), block,
      smem, grid, static_cast<cudaStream_t>(stream), launched);
}}""")
    return "\n".join(out) + "\n"


def fixed_dim(tmp: Path, rows):
    """ldlt_warp for a fixed dim against the bucket kernel, in turns
    (bucket, fixed, fixed, bucket), on the same inputs."""
    shapes = [(b, dim, dt) for b, dim in FIXED_SHAPES
              for dt in (torch.float32, torch.float64)] + [(1, 6, torch.float64)]
    kinds = sorted({(dim, dt) for _, dim, dt in shapes}, key=str)
    (tmp / "fixed_dim.cu").write_text(fixed_dim_source(kinds))
    fixed_lib = nvcc(tmp / "fixed_dim.cu", tmp / "fixed_dim.so")
    lib = ctypes.CDLL(str(cuda_ldlt.build()))
    for batch, dim, dtype in shapes:
        A, L, d, counts = inputs(batch, dim, dtype, seed=dim)
        outs = {"bucket": (L, d, counts),
                "fixed": (torch.empty_like(L), torch.empty_like(d),
                          [torch.empty_like(c) for c in counts])}
        fns = {"bucket": warp_fn(lib, dtype),
               "fixed": warp_fn(fixed_lib, dtype, f"study_warp_fixed_{sfx(dtype)}_{dim}")}
        calls = {kind: warp_call(fns[kind], A, *outs[kind], kind) for kind in outs}
        times = {"bucket": [], "fixed": []}
        for kind in ("bucket", "fixed", "fixed", "bucket"):
            times[kind].append(chip_smoke.time_ms(calls[kind]))
        for kind in calls:
            calls[kind]()
        torch.cuda.synchronize()
        (Lb, db, cb), (Lf, df, cf) = outs["bucket"], outs["fixed"]
        same = torch.equal(Lb, Lf) and torch.equal(db, df) and all(
            torch.equal(x, y) for x, y in zip(cb, cf))
        if not same:
            raise RuntimeError(f"fixed-dim and bucket kernels differ at "
                               f"({batch}, {dim}) {dtype}")
        emit({"study": "ldlt_warp_fixed_dim", "batch": batch, "dim": dim,
              "dtype": str(dtype).removeprefix("torch."),
              "group": cuda_ldlt.plan(batch, dim, dtype).group,
              "bucket_ms": times["bucket"], "fixed_ms": times["fixed"],
              "bitwise_equal": same}, rows)


def per_kernel(rows, calls=5):
    """Each launch's device time, in the order of one call, at the sweep's
    ldlt_panel shapes and (1, 1280), from torch.profiler (mean over
    `calls` calls)."""
    from torch.profiler import ProfilerActivity, profile
    shapes = [(chip_smoke.KERNEL_BATCH[dim], dim) for dim in chip_smoke.KERNEL_DIMS
              if dim > cuda_ldlt.COLUMN_MAX_DIM] + [(1, 1280)]
    for batch, dim in shapes:
        for dtype in (torch.float32, torch.float64):
            A, L, d, counts = inputs(batch, dim, dtype)
            with cuda_ldlt.uncounted():
                cuda_ldlt.launch(A, L, d, *counts)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        cuda_ldlt.launch(A, L, d, *counts)
                    torch.cuda.synchronize()
            seq = [(re.search(r"ldlt_(panel|trail)", e.name).group(1),
                    e.device_time_total / 1e3) for e in prof.events()
                   if re.search(r"ldlt_(panel|trail)_kernel", e.name)
                   and e.device_time_total > 0]
            n = cuda_ldlt.plan(batch, dim, dtype).launches
            got = len(seq) // n          # the profiler may drop a launch
            if got < 1:
                raise RuntimeError(f"profiled {len(seq)} launches of {n * calls}")
            per_launch = [sum(seq[c * n + i][1] for c in range(got)) / got
                          for i in range(n)]
            emit({"study": "ldlt_panel_launches", "batch": batch, "dim": dim,
                  "dtype": str(dtype).removeprefix("torch."),
                  "panel_ms": [round(x, 5) for x in per_launch[0::2]],
                  "trail_ms": [round(x, 5) for x in per_launch[1::2]],
                  "sum_ms": sum(per_launch)}, rows)


def dist_fn(lib, dtype, earlier):
    """dist_panel's C entry point: the earlier tree's (one block, no
    geometry) or the current one's."""
    fn = getattr(lib, "uno_dist_panel_" + sfx(dtype))
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * (4 if earlier else 9) \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def dist_call(fn, work, col0, row0, d, earlier, name):
    """A launch of `fn` on the slab work[:, col0:col0+block] of a (n, ld)
    tensor, its pivots from row0, with the current tree's geometry unless
    `earlier`."""
    n, ld = work.shape
    block = d.shape[0]
    geo = cuda_ldlt.dist_panel_grid(n, row0, block)
    launched = ctypes.c_int(0)
    sizes = () if earlier else (geo.grid, geo.rows, geo.above, geo.threads, 0)
    ptr = work.data_ptr() + col0 * work.element_size()

    def call():
        err = fn(ptr, d.data_ptr(), n, ld, row0, block, *sizes,
                 torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
        if err or launched.value != 1:
            raise RuntimeError(f"{name}: CUDA error {err}, {launched.value} launches")
    return call


def sass_instructions(library: Path) -> dict:
    """The SASS instructions of each dist_panel kernel in `library`, by
    mangled name (cuobjdump -sass), or {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1) if "dist_panel" in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    return counts


def dist_panel_study(parent, tmp: Path, rows_out, block=64):
    """dist_panel: the earlier tree's kernel (with --parent), the current
    one and its diagonal block alone, in turns, at DIST_ROWS x both dtypes
    x the first, a middle and the last panel."""
    source = cuda_ldlt.CSRC / "dist_ldlt.cu"
    libs = {"current": (ctypes.CDLL(str(cuda_ldlt.build())), False),
            "diag_only": (nvcc(source, tmp / "dist_diag.so",
                               ["UNO_DIST_STUDY_DIAG_ONLY"]), False)}
    if parent:
        libs["earlier"] = (nvcc(parent / "uno_tpu_torch" / "csrc" / "dist_ldlt.cu",
                                tmp / "dist_parent.so"), True)
    order = [k for k in ("earlier", "current", "diag_only") if k in libs]
    paths = {"current": cuda_ldlt.build(), "diag_only": tmp / "dist_diag.so",
             "earlier": tmp / "dist_parent.so"}
    emit({"study": "dist_panel_sass", **{k: sass_instructions(paths[k]) for k in order}},
         rows_out)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for rows in DIST_ROWS:
            cases = chip_smoke.dist_panel_cases(rows, block)
            W = torch.as_tensor(chip_smoke.dist_panel_storage(rows, rows, rows, cases, block),
                                dtype=dtype, device="cuda")
            for row0, _ in cases:
                orig = W[:, row0:row0 + block].clone()
                work = W.clone()
                d = W.new_empty(block)
                outs = {}
                for kind in order:
                    lib, earlier = libs[kind]
                    call = dist_call(dist_fn(lib, dtype, earlier), work, row0, row0, d, earlier,
                                     kind)
                    work[:, row0:row0 + block].copy_(orig)
                    call()
                    torch.cuda.synchronize()
                    outs[kind] = (work[:, row0:row0 + block].clone(), d.clone())
                same = "earlier" not in outs or (
                    chip_smoke.same_bits(outs["earlier"][0], outs["current"][0])
                    and chip_smoke.same_bits(outs["earlier"][1], outs["current"][1]))
                if not same:
                    raise RuntimeError(f"earlier and current dist_panel differ at "
                                       f"({rows}, {block}) {name} row {row0}")

                def restore():
                    work[:, row0:row0 + block].copy_(orig)

                times = {kind: [] for kind in order}
                restore_ms = chip_smoke.time_ms(restore)
                for kind in order + order[::-1]:
                    lib, earlier = libs[kind]
                    call = dist_call(dist_fn(lib, dtype, earlier), work, row0, row0, d, earlier,
                                     kind)
                    times[kind].append(chip_smoke.time_ms(lambda: (restore(), call()))
                                       - restore_ms)
                geo = cuda_ldlt.dist_panel_grid(rows, row0, block)
                bound, by = chip_smoke.dist_panel_bound(rows, row0, block, W.element_size(),
                                                        name)
                emit({"study": "dist_panel", "rows": rows, "block": block, "row0": row0,
                      "dtype": name, "grid": geo.grid, "threads": geo.threads,
                      "rows_a_cta": geo.rows, "restore_ms": restore_ms,
                      **{f"{kind}_ms": v for kind, v in times.items()},
                      "bound_ms": bound, "bound_by": by, "bitwise_equal": same}, rows_out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="checkout of an earlier tree whose kernel to time beside")
    parser.add_argument("--only", nargs="+", choices=STUDIES, default=STUDIES,
                        help="the studies to run (default: all; parent runs "
                             "only with --parent)")
    parser.add_argument("--out", help="also write every measurement here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: nothing to measure")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rows = []
    cuda_ldlt.build()
    with tempfile.TemporaryDirectory(dir=cuda_ldlt.BUILD_DIR) as tmp:
        if "panel_launches" in args.only:
            per_kernel(rows)
        if "warp_parts" in args.only:
            decompose(Path(tmp), rows)
        if "warp_fixed_dim" in args.only:
            fixed_dim(Path(tmp), rows)
        if "column_groups" in args.only:
            column_groups(rows)
        if "parent" in args.only and args.parent:
            compare_parent(args.parent, Path(tmp), rows)
        if "dist_panel" in args.only:
            dist_panel_study(args.parent, Path(tmp), rows)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi.stdout.strip(), "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
