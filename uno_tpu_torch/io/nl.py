"""AMPL .nl ingestion (text AND binary format): a native C++ parser and a
torch replay of its postfix programs.

Counterpart of uno_tpu/io/nl.py.  The C++ library (csrc/nlread.cpp, a copy
of uno_tpu's, built with g++ on first use into uno_tpu_torch/_build/) parses
the .nl file into flat postfix token streams; each expression is replayed
on a stack as torch operations on one instance's x, so the functions are
plain torch functions that the solvers map with torch.func.vmap and
differentiate with torch.func.  The replay runs on every evaluation (uno_tpu
traces it once under jit), so its cost grows with the file.

Usage:
    nlp = read_nl("problem.nl")
    result = uno_tpu_torch.solve(nlp, preset="ipopt")
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from uno_tpu_torch.model.nlp import NLP

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "nlread.cpp"
LIBRARY = _PACKAGE / "_build" / "libnlread.so"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
_LIB = None


class _NLData(ctypes.Structure):
    _fields_ = [
        ("n_vars", ctypes.c_int32), ("n_cons", ctypes.c_int32),
        ("n_objs", ctypes.c_int32), ("n_defined", ctypes.c_int32),
        ("objective_sense", ctypes.c_int32),
        ("x_lb", ctypes.POINTER(ctypes.c_double)),
        ("x_ub", ctypes.POINTER(ctypes.c_double)),
        ("c_lb", ctypes.POINTER(ctypes.c_double)),
        ("c_ub", ctypes.POINTER(ctypes.c_double)),
        ("x0", ctypes.POINTER(ctypes.c_double)),
        ("y0", ctypes.POINTER(ctypes.c_double)),
        ("jac_nnz", ctypes.c_int32),
        ("jac_row", ctypes.POINTER(ctypes.c_int32)),
        ("jac_col", ctypes.POINTER(ctypes.c_int32)),
        ("jac_val", ctypes.POINTER(ctypes.c_double)),
        ("grad_nnz", ctypes.c_int32),
        ("grad_col", ctypes.POINTER(ctypes.c_int32)),
        ("grad_val", ctypes.POINTER(ctypes.c_double)),
        ("n_tokens", ctypes.c_int32),
        ("tok_op", ctypes.POINTER(ctypes.c_int32)),
        ("tok_num", ctypes.POINTER(ctypes.c_double)),
        ("con_expr_off", ctypes.POINTER(ctypes.c_int32)),
        ("obj_expr_off", ctypes.POINTER(ctypes.c_int32)),
        ("def_expr_off", ctypes.POINTER(ctypes.c_int32)),
        ("def_index", ctypes.POINTER(ctypes.c_int32)),
        ("deflin_nnz", ctypes.c_int32),
        ("deflin_def", ctypes.POINTER(ctypes.c_int32)),
        ("deflin_col", ctypes.POINTER(ctypes.c_int32)),
        ("deflin_val", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char * 512),
    ]


def build(timeout: float = 120.0) -> Path:
    """Compile csrc/nlread.cpp into _build/libnlread.so unless it is there
    and newer than the source; returns its path.  Raises with g++'s stderr
    if g++ fails or times out."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: concurrent builds never load a half
    # written library
    tmp = LIBRARY.with_name(f"libnlread.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       timeout=timeout, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"g++ failed (exit {exc.returncode}):\n{exc.stderr}") from exc
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"g++ timed out after {timeout} s") from exc
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.nl_parse.restype = ctypes.POINTER(_NLData)
        lib.nl_parse.argtypes = [ctypes.c_char_p]
        lib.nl_free.restype = None
        lib.nl_free.argtypes = [ctypes.POINTER(_NLData)]
        lib.nl_to_binary.restype = ctypes.c_int
        lib.nl_to_binary.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_int]
        _LIB = lib
    return _LIB


def convert_nl_to_binary(src: str, dst: str) -> None:
    """Transcribe a text-format .nl file into binary format ('b' header,
    native-endian 4-byte ints / 8-byte doubles, arith kind on header line 6).
    read_nl() accepts either format."""
    buf = ctypes.create_string_buffer(512)
    rc = _lib().nl_to_binary(os.fspath(src).encode(), os.fspath(dst).encode(),
                             buf, 512)
    if rc:
        raise ValueError(f"nl_to_binary failed: {buf.value.decode()}")


def _arr(ptr, n, dtype=np.float64):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    ctype = ctypes.c_double if dtype == np.float64 else ctypes.c_int32
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)),
                                 shape=(n,)).astype(dtype).copy()


# ---------------------------------------------------------------------------
# postfix stack replay (ASL opcode subset).  Constant subexpressions stay
# Python floats, as in uno_tpu; `_t` makes a tensor of x's dtype of one
# where a torch operation needs a tensor operand.
# ---------------------------------------------------------------------------

def _t(a, like):
    if isinstance(a, torch.Tensor):
        return a
    # a fill on like's device: no host-to-device copy on the card
    return torch.full((), a, dtype=like.dtype, device=like.device)


_UNARY = {
    13: torch.floor, 14: torch.ceil, 15: torch.abs, 16: torch.neg,
    37: torch.tanh, 38: torch.tan, 39: torch.sqrt, 40: torch.sinh, 41: torch.sin,
    42: torch.log10, 43: torch.log, 44: torch.exp, 45: torch.cosh,
    46: torch.cos, 47: torch.atanh, 49: torch.atan, 50: torch.asinh,
    51: torch.asin, 52: torch.acosh, 53: torch.acos,
    77: lambda a: a * a,
}


def _pow(a, b):
    # concrete integral exponents take the integer-power path, as in
    # uno_tpu: x^4 on x < 0 must work, where a float pow would be NaN
    if isinstance(b, float) and b.is_integer() and abs(b) <= 64:
        return a ** int(b)
    return a ** b


def _maximum(a, b, like):
    # torch.maximum splits the derivative at a tie, as jnp.maximum does
    return torch.maximum(_t(a, like), _t(b, like))


def _minimum(a, b, like):
    return torch.minimum(_t(a, like), _t(b, like))


_BINARY = {
    0: lambda a, b, x: a + b,
    1: lambda a, b, x: a - b,
    2: lambda a, b, x: a * b,
    3: lambda a, b, x: a / b,
    4: lambda a, b, x: a - torch.trunc(_t(a / b, x)) * b,   # rem
    5: lambda a, b, x: _pow(a, b),
    6: lambda a, b, x: _maximum(a - b, 0.0, x),              # less
    48: lambda a, b, x: torch.atan2(_t(a, x), _t(b, x)),
    55: lambda a, b, x: torch.trunc(_t(a / b, x)),          # int div
}

_COMPARE = {20: lambda p, q: p | q, 21: lambda p, q: p & q,
            22: lambda p, q: p < q, 23: lambda p, q: p <= q,
            24: lambda p, q: p == q, 28: lambda p, q: p >= q,
            29: lambda p, q: p > q, 30: lambda p, q: p != q}


def _eval_postfix(program, x, defined):
    """Replay a postfix program, a list of (opcode, number) pairs, on a
    Python stack; returns a tensor or a Python float."""
    stack = []
    for op, v in program:
        if op == -1:
            stack.append(v)
        elif op == -2:
            idx = int(v)
            stack.append(x[idx] if idx < x.shape[0] else defined[idx])
        elif op in _UNARY:
            stack.append(_UNARY[op](_t(stack.pop(), x)))
        elif op in _BINARY:
            b = stack.pop()
            a = stack.pop()
            stack.append(_BINARY[op](a, b, x))
        elif op == 76:   # OP1POW: the text format emits it as binary pow
            raise ValueError("unexpected OP1POW in text .nl")
        elif op in (11, 12, 54):   # MINLIST / MAXLIST / OPSUMLIST
            k = int(v)
            args = [stack.pop() for _ in range(k)][::-1]
            acc = args[0]
            for a in args[1:]:
                if op == 54:
                    acc = acc + a
                elif op == 11:
                    acc = _minimum(acc, a, x)
                else:
                    acc = _maximum(acc, a, x)
            stack.append(acc)
        elif op == 35:   # if-then-else (condition is a comparison expr)
            else_v = stack.pop()
            then_v = stack.pop()
            cond = stack.pop()
            stack.append(torch.where(_t(cond, x).bool(), _t(then_v, x),
                                     _t(else_v, x)))
        elif op in _COMPARE or op == 34:
            # logical ops appear only inside OPIFnl conditions
            b = stack.pop() if op != 34 else None
            a = stack.pop()
            stack.append(~a if op == 34 else _COMPARE[op](a, b))
        else:
            raise ValueError(f"unsupported ASL opcode {op}")
    if len(stack) != 1:
        raise ValueError(f"malformed postfix program (stack depth {len(stack)})")
    return stack[0]


def _programs(ops, nums, offsets):
    """The postfix program of each segment [offsets[k], offsets[k+1])."""
    return [list(zip(ops[int(a):int(b)].tolist(), nums[int(a):int(b)].tolist()))
            for a, b in zip(offsets[:-1], offsets[1:])]


def read_nl(path, name: str | None = None) -> NLP:
    """Parse a .nl file into an NLP whose f(x, params) and c(x, params) are
    torch functions of one instance.  A file that is missing or that the
    parser rejects raises ValueError."""
    lib = _lib()
    dptr = lib.nl_parse(os.fspath(path).encode())
    d = dptr.contents
    try:
        err = bytes(d.error).split(b"\0")[0].decode()
        if err:
            raise ValueError(f"failed to parse {path}: {err}")
        nv, nc = int(d.n_vars), int(d.n_cons)
        nd = int(d.n_defined)
        x_lb = _arr(d.x_lb, nv)
        x_ub = _arr(d.x_ub, nv)
        c_lb = _arr(d.c_lb, nc)
        c_ub = _arr(d.c_ub, nc)
        x0 = _arr(d.x0, nv)
        y0 = _arr(d.y0, nc)
        sense = int(d.objective_sense)

        ntok = int(d.n_tokens)
        ops = _arr(d.tok_op, ntok, np.int32)
        nums = _arr(d.tok_num, ntok)
        con_off = _arr(d.con_expr_off, nc + 1, np.int32)
        obj_off = _arr(d.obj_expr_off, 2, np.int32)
        def_off = _arr(d.def_expr_off, nd + 1, np.int32)
        def_index = _arr(d.def_index, nd, np.int32).tolist()
        jac = (_arr(d.jac_row, d.jac_nnz, np.int32),
               _arr(d.jac_col, d.jac_nnz, np.int32),
               _arr(d.jac_val, d.jac_nnz))
        grad = (_arr(d.grad_col, d.grad_nnz, np.int32),
                _arr(d.grad_val, d.grad_nnz))
        deflin = (_arr(d.deflin_def, d.deflin_nnz, np.int32),
                  _arr(d.deflin_col, d.deflin_nnz, np.int32),
                  _arr(d.deflin_val, d.deflin_nnz))
    finally:
        lib.nl_free(dptr)

    con_progs = _programs(ops, nums, con_off)
    obj_prog = _programs(ops, nums, obj_off)[0]
    def_progs = _programs(ops, nums, def_off)
    # the linear terms of each defined variable and of the objective, in
    # file order: uno_tpu adds them one by one, and so does the replay
    def_lin = [(deflin[1][deflin[0] == k].astype(np.int64), deflin[2][deflin[0] == k])
               for k in range(nd)]
    grad_lin = (grad[0].astype(np.int64), grad[1])
    # the constraints' linear part.  uno_tpu scatter-adds the terms into
    # zeros (`.at[rows].add`), which sums each row's terms in file order; the
    # replay gathers them into a (nc, k_max) table, each row's terms in file
    # order, and adds its columns one by one: the same sums in the same
    # order, so the same rounding, and deterministic on the card, where
    # index_add would add with atomics in no fixed order
    jrows, jcols, jvals = jac
    per_row = np.bincount(jrows, minlength=nc) if len(jvals) else np.zeros(nc, int)
    k_max = int(per_row.max(initial=0))
    lin_cols = np.zeros((nc, k_max), np.int64)
    lin_vals = np.zeros((nc, k_max))
    lin_mask = np.zeros((nc, k_max), bool)
    slot = np.zeros(nc, int)
    for r, col, v in zip(jrows, jcols, jvals):
        lin_cols[r, slot[r]], lin_vals[r, slot[r]], lin_mask[r, slot[r]] = col, v, True
        slot[r] += 1
    consts = {}

    def const(name, arr, like):
        key = (name, like.device, like.dtype)
        if key not in consts:
            dtype = like.dtype if np.asarray(arr).dtype.kind == "f" else None
            consts[key] = torch.as_tensor(np.asarray(arr), dtype=dtype,
                                          device=like.device)
        return consts[key]

    def add_terms(val, cols, vals, tag, x):
        """val + vals[0] x[cols[0]] + vals[1] x[cols[1]] + ..., in order."""
        if len(cols) == 0:
            return val
        terms = const(tag + "v", vals, x) * x.index_select(0, const(tag + "c", cols, x))
        for k in range(len(cols)):
            val = val + terms[k]
        return val

    def eval_defined(x):
        """Defined (common-expression) variables, in definition order."""
        defined = {}
        for k in range(nd):
            val = _eval_postfix(def_progs[k], x, defined)
            cols, vals = def_lin[k]
            defined[def_index[k]] = add_terms(val, cols, vals, f"d{k}", x)
        return defined

    def f(x, params=None):
        defined = eval_defined(x)
        val = _eval_postfix(obj_prog, x, defined) if obj_prog else _t(0.0, x)
        val = _t(add_terms(val, *grad_lin, "g", x), x)
        return -val if sense else val

    def c(x, params=None):
        if nc == 0:
            return x.new_zeros((0,))
        defined = eval_defined(x)
        out = torch.stack([_t(_eval_postfix(p, x, defined), x) if p else _t(0.0, x)
                           for p in con_progs])
        if k_max == 0:
            return out
        terms = const("jv", lin_vals, x) * x[const("jc", lin_cols, x)]
        terms = torch.where(const("jm", lin_mask, x), terms, 0.0)
        lin = terms[:, 0]
        for k in range(1, k_max):
            lin = lin + terms[:, k]
        return out + lin

    return NLP(name=name or Path(path).stem, n=nv, m=nc, f=f, c=c,
               x_lb=x_lb, x_ub=x_ub, c_lb=c_lb, c_ub=c_ub,
               x0=x0, y0=y0, params=None)
