"""The batched LDL^T kernels (csrc/ldlt.cu, csrc/ldlt_column.cu) and their
wrapper.

Counterpart of uno_tpu/linalg/pallas_ldlt.py: three CUDA kernels replace
both Pallas functions there (`ldlt_factor_pallas`,
`ldlt_factor_pallas_batched`), routed by dim, the single instance being the
batch of one:
  * `ldlt_warp`   dim <= 32: a group of 8, 16 or 32 lanes per instance;
  * `ldlt_column` 32 < dim <= 64: the column form's operations in the
                  column form's order, the lower triangle in the registers of
                  a group of 16, 32 or 64 threads per instance
                  (`column_group`), spread so that every column's updates
                  are even over them; the dim's bucket of 8 sets the kernel;
  * `ldlt_panel`  dim > 64: panels of 32 columns, a panel kernel and a
                  trailing-update kernel per panel step.
All take float32 and float64 and count the inertia themselves.  Each gives
the plain version's factors bit for bit (`linalg.ldlt.plain_factorizer`:
the unrolled form up to 32, the column form up to 64, panels above).
ldlt_column is bound by its instructions where the batch fills the card
(three operations an update, and per column two barriers, a reciprocal and
a division or two a thread) and by its chain of columns where it does not;
its registers, not shared memory, set how many instances an SM runs.

The kernels are compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes.  They build on first use into
uno_tpu_torch/_build/, keyed by a hash of the csrc/ sources, one nvcc per
source, all at once.

`plan(batch, dim, dtype)` is the route and the launch sizes of a call
(`route="ldlt_panel"` forces the panels at dims 33-64, for timing, and
`group` ldlt_column's threads per instance); the C side refuses a plan it
would not launch.  `ldlt_factor_cuda(A)` launches
the kernels for a CUDA tensor; for a CPU tensor it runs the plain version
uno_tpu's batch path uses at that dim (`linalg.ldlt.plain_factorizer`),
the one place where that choice is made.  `launch(A, L, d, pos, neg, zero)`
is the launch alone, into given outputs; by route, it adds the kernels the
C side reports it launched to the module's `launches`, and one to `calls`.

The same library holds `dist_panel` (csrc/dist_ldlt.cu), the rank-local
panel factor of the distributed LDL^T (parallel/dist_ldlt.py), which
`launch_dist_panel` launches and counts under its own name, one launch a
call, on a grid of CTAs that `dist_panel_grid` sizes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

from uno_tpu_torch.linalg.ldlt import LDLT, plain_factorizer

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-Xptxas=-v"]
NVCC_FLAGS = COMPILE_FLAGS + ["-shared"]     # one source straight to a library
MAX_DIM = 46340          # dim * dim must fit the kernels' int indices
ROUTES = ("ldlt_warp", "ldlt_column", "ldlt_panel")
# what launches and calls count: the LDL^T routes and the distributed
# LDL^T's panel factor
COUNTED = (*ROUTES, "dist_panel")
DIST_PANEL_BLOCKS = (32, 64)   # the panel widths dist_panel is built for
# dist_panel's grid: a CTA takes at least this many of the rows below the
# diagonal block (while there are CTAs to spare), over at most this many
# row threads (4 a row), beside its block producers; a launch names one of
# DIST_PANEL_TICKETS counters (csrc/dist_ldlt.cu's DIST_TICKETS)
DIST_PANEL_MIN_ROWS = 8
DIST_PANEL_ROW_THREADS = 256
DIST_PANEL_TICKETS = 256
LANES_A_ROW = 4          # dist_panel's threads a row (LANES in dist_ldlt.cu)
WARP_MAX_DIM = 32        # ldlt_warp up to this dim
COLUMN_MAX_DIM = 64      # ldlt_column up to this dim, ldlt_panel above
# ldlt_column's groups: threads per instance -> the P x Q threads its rows
# and columns lie over (csrc/ldlt_column.cu's ColumnLayout); a group of 16
# shares a warp, and a block, with a second instance, and takes dims up to
# COLUMN_GROUP16_MAX_DIM
COLUMN_GROUPS = {16: (4, 4), 32: (8, 4), 64: (8, 8)}
COLUMN_GROUP16_MAX_DIM = 40
# the batches from which a smaller group beats two warps an instance
# (tools/ldlt_kernel_study.py --only column_groups; PERF.md): 16 threads
# at dims up to 40, from these batches in float32 and float64; 32 threads
# in float64 above dim 56
COLUMN_GROUP16_BATCH = {4: 4096, 8: 2048}
COLUMN_GROUP32_BATCH = 1024
COLUMN_SWITCH_BATCHES = tuple(sorted({*COLUMN_GROUP16_BATCH.values(), COLUMN_GROUP32_BATCH}))
PANEL = 32               # ldlt_panel's panel width (PB in ldlt.cu)
TILE = 64                # its trailing-update tile (32 up to dim 64)
WARP_THREADS = 256       # ldlt_warp's largest block
SMEM_DEFAULT = 48 * 1024  # dynamic shared memory a block gets without opting in
SMEM_MAX = 232448        # what an H100 block can opt in to
SMS = 132                # H100 SXM's multiprocessors: ldlt_panel's chunk size aims at two blocks each
MAX_GRID = 2**31 - 1

# since the last reset_counts(), by route: the kernels launched, as the C
# side reports them, and the wrapper calls
launches = dict.fromkeys(COUNTED, 0)
calls = dict.fromkeys(COUNTED, 0)
# nvcc's output of the build of this process (ptxas registers and spills)
build_log = ""
_lib = None
_dist_panel_slot = 0      # the ticket counter the next dist_panel launch names


def reset_counts() -> None:
    for counts in (launches, calls):
        counts.update(dict.fromkeys(COUNTED, 0))


@contextlib.contextmanager
def uncounted():
    """Launches made inside (comparisons, timing) leave `launches` and
    `calls` as they were."""
    saved = dict(launches), dict(calls)
    try:
        yield
    finally:
        launches.update(saved[0])
        calls.update(saved[1])


@dataclass(frozen=True)
class Plan:
    """The launches of one call: `block`, `smem` (dynamic shared memory
    bytes) per kernel of the route, and `grids`, the blocks of every launch
    in order.  `group` is the threads per instance of ldlt_warp and
    ldlt_column; `rows` is ldlt_panel's rows per chunk."""
    route: str
    group: int
    rows: int
    block: tuple
    smem: tuple
    grids: tuple

    @property
    def launches(self) -> int:
        return len(self.grids)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def column_group(batch: int, dim: int, item: int) -> int:
    """ldlt_column's threads per instance for a batch of (dim, dim)
    matrices of `item`-byte elements: two warps, or fewer threads where
    the batch fills the card and they take less time."""
    if dim <= COLUMN_GROUP16_MAX_DIM and batch >= COLUMN_GROUP16_BATCH[item]:
        return 16
    if dim > 56 and item == 8 and batch >= COLUMN_GROUP32_BATCH:
        return 32
    return 64


def column_groups_for(dim: int) -> tuple:
    """The groups ldlt_column has a kernel for at this dim."""
    return tuple(g for g in COLUMN_GROUPS if g != 16 or dim <= COLUMN_GROUP16_MAX_DIM)


def column_layout(dim: int, group: int, item: int) -> tuple[int, int]:
    """ldlt_column's bucket N for this dim (a multiple of 8) and an
    instance's shared memory in bytes, as ColumnLayout computes them: the
    group's P runs of the multipliers (whole 16-byte vectors, an odd number
    of them), the column and the pivots."""
    P, _ = COLUMN_GROUPS[group]
    N = _ceil(dim, 8) * 8
    vec = 16 // item
    rv = _ceil(N // P, vec)
    run = (rv if rv % 2 else rv + 1) * vec
    return N, (P * run + 2 * _ceil(N, vec) * vec) * item


def plan(batch: int, dim: int, dtype: torch.dtype, route: str | None = None,
         group: int | None = None) -> Plan:
    """The route and launch sizes of a call on (batch, dim, dim) of dtype;
    csrc/ computes the same numbers and refuses others.  `route` None is
    the dim's own; "ldlt_panel" may also be asked for at dims 33-64, where
    it sums in another order than the column form.  `group` forces
    ldlt_column's threads per instance (one of column_groups_for(dim))."""
    if batch < 1 or not 1 <= dim <= MAX_DIM:
        raise ValueError(f"batch {batch}, dim {dim}: expected batch >= 1 and "
                         f"1 <= dim <= {MAX_DIM}")
    own = ("ldlt_warp" if dim <= WARP_MAX_DIM else
           "ldlt_column" if dim <= COLUMN_MAX_DIM else "ldlt_panel")
    route = own if route is None else route
    if route != own and not (route == "ldlt_panel" and own == "ldlt_column"):
        raise ValueError(f"route {route!r} does not take dim {dim}")
    if group is not None and (route != "ldlt_column" or group not in column_groups_for(dim)):
        raise ValueError(f"group {group}: ldlt_column takes one of "
                         f"{tuple(COLUMN_GROUPS)} threads per instance, 16 up "
                         f"to dim {COLUMN_GROUP16_MAX_DIM}")
    item = torch.empty((), dtype=dtype).element_size()
    if route == "ldlt_column":
        if batch > MAX_GRID:
            raise ValueError(f"batch {batch}: above {MAX_GRID} blocks in a launch")
        group = column_group(batch, dim, item) if group is None else group
        _, smem = column_layout(dim, group, item)
        per_block = max(1, 32 // group)
        return Plan("ldlt_column", group, 0, (group * per_block,), (smem * per_block,),
                    (_ceil(batch, per_block),))
    if route == "ldlt_warp":
        group = 8 if dim <= 8 else (16 if dim <= 16 else 32)
        per_warp = 32 // group
        per_instance = dim * dim * item
        warps = WARP_THREADS // 32
        while warps > 1 and warps * (per_warp * per_instance + 32 * item) > SMEM_DEFAULT:
            warps //= 2
        warps = min(warps, _ceil(batch, per_warp))
        per_block = warps * per_warp
        vec = 16 // item     # the instances, then a column buffer of a group's lanes
        smem = (_ceil(per_block * dim * dim, vec) * vec + 32 * warps) * item
        return Plan("ldlt_warp", group, 0, (32 * warps,), (smem,),
                    (_ceil(batch, per_block),))
    tile = 32 if dim - PANEL <= 32 else TILE    # the trailing block's size
    rows = 128           # no more than the first step has rows below the panel
    while rows > 32 and (rows // 2 >= dim - PANEL
                         or batch * _ceil(dim - PANEL, rows) < 2 * SMS):
        rows //= 2
    stride = PANEL + 16 // item                      # 16-byte rows
    panel_smem = (PANEL * stride + 2 * PANEL) * item
    trail_smem = 2 * PANEL * (tile + 16 // item) * item
    grids = []
    for k0 in range(0, dim, PANEL):
        below = dim - k0 - min(PANEL, dim - k0)
        grids.append(batch * max(1, _ceil(below, rows)))
        if below:
            nt = _ceil(below, tile)
            grids.append(batch * nt * (nt + 1) // 2)
    if max(grids) > MAX_GRID:
        raise ValueError(f"batch {batch}, dim {dim}: {max(grids)} blocks in a "
                         f"launch, above {MAX_GRID}")
    return Plan("ldlt_panel", PANEL, rows, (rows, (tile // 4) ** 2),
                (panel_smem, trail_smem), tuple(grids))


@dataclass(frozen=True)
class DistPanelGrid:
    """dist_panel's launch on a slab of n rows whose pivots lie on rows
    row0 .. row0+block-1: `grid` CTAs of `threads` threads (the producers,
    LANES_A_ROW a row of the diagonal block, then the row threads),
    CTA c taking `rows` rows below the block and `above` rows above it;
    the diagonal block's rows go to the CTA that reads them last."""
    grid: int
    rows: int
    above: int
    threads: int

    def rows_of(self, cta: int, n: int, row0: int, block: int) -> tuple[range, range]:
        """The rows CTA `cta` takes, below the block and above it, as
        csrc/dist_ldlt.cu deals them."""
        first = row0 + block + cta * self.rows
        return (range(first, min(n, first + self.rows)),
                range(cta * self.above, min(row0, (cta + 1) * self.above)))


def dist_panel_grid(n: int, row0: int, block: int, sms: int = SMS) -> DistPanelGrid:
    """About one wave of the card at every height: a CTA an SM while the
    slab has DIST_PANEL_MIN_ROWS rows outside the block a CTA, the rows
    below and the rows above the block each dealt evenly over the CTAs,
    and as many row threads as a CTA's rows below need, in whole warps (at
    least one: it also takes the ticket)."""
    if block not in DIST_PANEL_BLOCKS or not 0 <= row0 <= n - block:
        raise ValueError(f"panel of {block} at row {row0}: outside {n} rows "
                         f"(widths {DIST_PANEL_BLOCKS})")
    grid = max(1, min(sms, _ceil(n - block, DIST_PANEL_MIN_ROWS)))
    rows = _ceil(n - row0 - block, grid)
    threads = min(DIST_PANEL_ROW_THREADS, max(32, _ceil(LANES_A_ROW * rows, 32) * 32))
    return DistPanelGrid(grid, rows, _ceil(row0, grid), LANES_A_ROW * block + threads)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def _run(cmds: list[list[str]], timeout: float) -> str:
    """Run the commands at once; returns their output, or raises with the
    first failure's stderr (the others are stopped)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    try:
        outs = [proc.communicate(timeout=timeout) for proc in procs]
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"nvcc timed out after {timeout} s") from exc
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{err}")
    return "".join(out + err for out, err in outs)


def build(timeout: float = 300.0) -> Path:
    """Compile csrc/ into _build/libuno_ldlt-<hash>.so unless it is there,
    one nvcc per .cu file, all at once, then link; returns its path.
    Raises with nvcc's stderr if nvcc fails or times out."""
    global build_log
    lib_path = BUILD_DIR / f"libuno_ldlt-{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{lib_path.stem}.{os.getpid()}"
    units = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in units]
    tmp = BUILD_DIR / f"{stem}.tmp.so"
    try:
        log = _run([[_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(units, objects)], timeout)
        log += _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objects)]], timeout)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    build_log = log
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptrs = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        tail = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]   # stream, launched
        for fn in (lib.uno_ldlt_warp_f32, lib.uno_ldlt_warp_f64,
                   lib.uno_ldlt_column_f32, lib.uno_ldlt_column_f64):
            fn.argtypes = ptrs + [ctypes.c_int] * 4 + tail
            fn.restype = ctypes.c_int
        for fn in (lib.uno_ldlt_panel_f32, lib.uno_ldlt_panel_f64):
            fn.argtypes = ptrs + [ctypes.c_int] * 3 + tail
            fn.restype = ctypes.c_int
        for fn in (lib.uno_dist_panel_f32, lib.uno_dist_panel_f64):
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + tail
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(A: torch.Tensor) -> None:
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"expected a tensor, got {type(A).__name__}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {A.device} is neither cpu nor cuda")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {A.dtype}: the kernel takes float32 or float64")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.shape[1] < 1:
        raise ValueError(f"shape {tuple(A.shape)}: expected (B, dim, dim)")
    if A.shape[1] > MAX_DIM:
        raise ValueError(f"dim {A.shape[1]} above {MAX_DIM}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")


def launch(A: torch.Tensor, L: torch.Tensor, d: torch.Tensor,
           pos: torch.Tensor, neg: torch.Tensor, zero: torch.Tensor,
           zero_pivot_rtol: float = 1e-32, route: str | None = None,
           group: int | None = None) -> Plan:
    """Launch the route's kernels on the current stream: the factors of A
    (B, dim, dim) on the card into L (B, dim, dim) and d (B, dim) of its
    dtype and device, the inertia into pos, neg and zero (B,) int64.
    Counts the call and the kernels it launched under its route; raises if
    a launch failed.  Returns the plan.  `route` and `group` as in plan()."""
    _check(A)
    if A.device.type != "cuda":
        raise ValueError(f"the kernels run on the card; A is on {A.device}")
    batch, dim = A.shape[0], A.shape[-1]
    outs = (("L", L, (batch, dim, dim), A.dtype), ("d", d, (batch, dim), A.dtype),
            ("pos", pos, (batch,), torch.int64), ("neg", neg, (batch,), torch.int64),
            ("zero", zero, (batch,), torch.int64))
    for name, t, shape, dtype in outs:
        if t.device != A.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} {dtype} "
                             f"tensor on {A.device}")
    if batch == 0:
        return None
    p = plan(batch, dim, A.dtype, route, group)
    lib = _load()
    suffix = "f32" if A.dtype == torch.float32 else "f64"
    ptrs = (A.data_ptr(), L.data_ptr(), d.data_ptr(), pos.data_ptr(),
            neg.data_ptr(), zero.data_ptr(), batch, dim, float(zero_pivot_rtol))
    launched = ctypes.c_int(0)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if p.route in ("ldlt_warp", "ldlt_column"):
            err = getattr(lib, f"uno_{p.route}_{suffix}")(
                *ptrs, p.group, p.block[0], p.smem[0], p.grids[0], stream,
                ctypes.byref(launched))
        else:
            err = getattr(lib, f"uno_ldlt_panel_{suffix}")(
                *ptrs, p.rows, p.smem[0], p.smem[1], stream, ctypes.byref(launched))
    launches[p.route] += launched.value
    calls[p.route] += 1
    if err != 0:
        raise RuntimeError(f"{p.route} launch failed: CUDA error {err} "
                           f"(batch {batch}, dim {dim}, {A.dtype})")
    return p


def ldlt_factor_cuda(A: torch.Tensor, zero_pivot_rtol: float = 1e-32,
                     block: int = 32) -> LDLT:
    """Unpivoted LDL^T of every (dim, dim) matrix of A (B, dim, dim), with
    inertia.  Launches the kernels for a CUDA tensor; a CPU tensor takes the
    plain version (`block` is its panel width).  Raises on any input the
    kernels do not take."""
    _check(A)
    if A.device.type == "cpu":
        return plain_factorizer(A.shape[-1], block)(A, zero_pivot_rtol)
    L = torch.empty_like(A)
    d = torch.empty(A.shape[:2], dtype=A.dtype, device=A.device)
    pos, neg, zero = (torch.empty(A.shape[:1], dtype=torch.int64, device=A.device)
                      for _ in range(3))
    launch(A, L, d, pos, neg, zero, zero_pivot_rtol)
    return LDLT(L, d, pos, neg, zero)


def launch_dist_panel(work: torch.Tensor, col0: int, row0: int, block: int,
                      d: torch.Tensor) -> None:
    """Launch dist_panel on the current stream: factor the column slab
    work[:, col0:col0+block] of a contiguous (n, ld) CUDA tensor in place,
    its pivots on rows row0 .. row0+block-1, the pivots into d (block,) of
    its dtype and device, on dist_panel_grid's grid.  Counts the call and
    the launch under "dist_panel"; raises on sizes the kernel does not take
    or if the launch failed."""
    global _dist_panel_slot
    if not isinstance(work, torch.Tensor) or work.dim() != 2 or not work.is_contiguous():
        raise ValueError("work must be a contiguous 2-D tensor")
    if work.device.type != "cuda":
        raise ValueError(f"the kernel runs on the card; work is on {work.device}")
    if work.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {work.dtype}: the kernel takes float32 or float64")
    n, ld = work.shape
    if block not in DIST_PANEL_BLOCKS:
        raise ValueError(f"panel width {block}: dist_panel takes {DIST_PANEL_BLOCKS}")
    if not (0 <= col0 <= ld - block and 0 <= row0 <= n - block) or n > MAX_GRID:
        raise ValueError(f"slab at column {col0}, rows from {row0}: outside ({n}, {ld})")
    if d.device != work.device or d.dtype != work.dtype or tuple(d.shape) != (block,) \
            or not d.is_contiguous():
        raise ValueError(f"d: expected a contiguous ({block},) {work.dtype} tensor "
                         f"on {work.device}")
    geo = dist_panel_grid(n, row0, block)
    lib = _load()
    fn = lib.uno_dist_panel_f32 if work.dtype == torch.float32 else lib.uno_dist_panel_f64
    launched = ctypes.c_int(0)
    slot, _dist_panel_slot = _dist_panel_slot, (_dist_panel_slot + 1) % DIST_PANEL_TICKETS
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream(work.device).cuda_stream
        err = fn(work.data_ptr() + col0 * work.element_size(), d.data_ptr(), n, ld,
                 row0, block, geo.grid, geo.rows, geo.above, geo.threads, slot, stream,
                 ctypes.byref(launched))
    launches["dist_panel"] += launched.value
    calls["dist_panel"] += 1
    if err != 0:
        raise RuntimeError(f"dist_panel launch failed: CUDA error {err} "
                           f"(n {n}, block {block}, {work.dtype})")
