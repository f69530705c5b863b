"""The batched LDL^T kernel (csrc/ldlt.cu) and its wrapper.

Counterpart of uno_tpu/linalg/pallas_ldlt.py: the CUDA kernel replaces both
Pallas functions there (`ldlt_factor_pallas`, `ldlt_factor_pallas_batched`);
the single instance is the batch of one.  It takes every dim and both
float32 and float64.

The kernel is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes.  It builds on first use into
uno_tpu_torch/_build/, keyed by a hash of the csrc/ sources.

`ldlt_factor_cuda(A)` launches the kernel for a CUDA tensor; for a CPU
tensor it runs the plain version uno_tpu's batch path uses at that dim
(`linalg.ldlt.plain_factorizer`), the one place where that choice is made.
`launch(A, L, d)` is the launch alone, into given outputs; it counts each
launch in the module's `launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from uno_tpu_torch.linalg.ldlt import LDLT, _inertia, plain_factorizer

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
MAX_DIM = 46340          # dim * dim must fit the kernel's int indices

# kernel launches since the last reset (set it to 0 to reset)
launches = 0
# nvcc's output of the build of this process (ptxas registers and spills)
build_log = ""
_lib = None


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


def build(timeout: float = 300.0) -> Path:
    """Compile csrc/ into _build/libuno_ldlt-<hash>.so unless it is there;
    returns its path.  Raises with nvcc's stderr if nvcc fails or times out."""
    global build_log
    lib_path = BUILD_DIR / f"libuno_ldlt-{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    try:
        out = subprocess.run(cmd, timeout=timeout, check=True,
                             capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"nvcc failed (exit {exc.returncode}):\n"
                           f"{exc.stderr}") from exc
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"nvcc timed out after {timeout} s:\n"
                           f"{exc.stderr}") from exc
    build_log = out.stdout + out.stderr
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn in (lib.uno_ldlt_factor_f32, lib.uno_ldlt_factor_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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


def launch(A: torch.Tensor, L: torch.Tensor, d: torch.Tensor) -> None:
    """Launch the kernel on the current stream: the factors of A (B, dim,
    dim) on the card into L (B, dim, dim) and d (B, dim) of its dtype and
    device.  Counts the launch; raises if the launch failed."""
    global launches
    _check(A)
    if A.device.type != "cuda":
        raise ValueError(f"the kernel runs on the card; A is on {A.device}")
    batch, dim = A.shape[0], A.shape[-1]
    for name, t, shape in (("L", L, (batch, dim, dim)), ("d", d, (batch, dim))):
        if t.device != A.device or t.dtype != A.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} {A.dtype} "
                             f"tensor on {A.device}")
    if batch == 0:
        return
    lib = _load()
    fn = lib.uno_ldlt_factor_f32 if A.dtype == torch.float32 \
        else lib.uno_ldlt_factor_f64
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), L.data_ptr(), d.data_ptr(), batch, dim, stream)
    if err != 0:
        raise RuntimeError(f"LDL^T kernel launch failed: CUDA error {err} "
                           f"(batch {batch}, dim {dim}, {A.dtype})")
    launches += 1


def ldlt_factor_cuda(A: torch.Tensor, zero_pivot_rtol: float = 1e-32,
                     block: int = 32) -> LDLT:
    """Unpivoted LDL^T of every (dim, dim) matrix of A (B, dim, dim), with
    inertia.  Launches the kernel for a CUDA tensor; a CPU tensor takes the
    plain version (`block` is its panel width).  Raises on any input the
    kernel does not take."""
    _check(A)
    if A.device.type == "cpu":
        return plain_factorizer(A.shape[-1], block)(A, zero_pivot_rtol)
    L = torch.empty_like(A)
    d = torch.empty(A.shape[:2], dtype=A.dtype, device=A.device)
    launch(A, L, d)
    pos, neg, zero = _inertia(d, zero_pivot_rtol)
    return LDLT(L, d, pos, neg, zero)
