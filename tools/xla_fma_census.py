"""Which multiplies XLA:CPU fuses into adds in uno_tpu's LDL^T updates, its
small solve and its small matrix-vector products, and whether the port's
plain versions reproduce them bit for bit.

For each case the jitted uno_tpu function is compiled with its XLA dump
(`xla_dump_to`, one directory a case) and `objdump -d` counts the fused
multiply-add instructions (vfmadd/vfmsub/vfnmadd/vfnmsub) in the object
code of each fusion.  The IR XLA hands to LLVM has no fma: LLVM contracts
a multiply into the add or subtract it feeds when it generates code.  Which
multiply that is shows by evaluation: the port's form (the update
a - dj * (l_i * l_k) as torch.addcmul(a, -dj, l_i * l_k), one rounding of
the product l_i * l_k and one of the fused multiply-add), the same update a
rounding at a time, and the other product fused, a - (dj * l_i) * l_k, are
held bit for bit against uno_tpu's jitted result on seeded matrices.

    JAX_PLATFORMS=cpu python3 tools/xla_fma_census.py [--out FILE] [--trials 3]

Cases: ldlt_factor_unrolled (uno_tpu/linalg/ldlt.py:109), ldlt_factor (:78),
ldlt_factor_blocked's in-panel update (:150, at n <= block, where the panel
is the whole factor; above it the trailing matrix product takes another
order in each package), uno_tpu/parallel/dist_ldlt.py::_panel_factor, at
dims 5, 12, 36 and 70, float32 and float64, one instance (B=1) and vmap'd
(B=4); the unrolled solve (n <= 32) and the QP's products A @ x and A^T y.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FMA = re.compile(r"\bvf(n)?m(add|sub)\d+[ps][sd]\b")
DIMS = (5, 12, 36, 70)


def fma_counts(dump_dir):
    """Fused multiply-adds in each fusion's object file of a dump."""
    out = {}
    for path in sorted(glob.glob(os.path.join(dump_dir, "*.o"))):
        text = subprocess.run(["objdump", "-d", path], capture_output=True,
                              text=True, check=True).stdout
        count = len(FMA.findall(text))
        if count:
            name = os.path.basename(path).split("obj-file.")[-1][:-2]
            out[name] = count
    return out


def compiled(fn, *args):
    """fn jitted and compiled with its XLA dump; (callable, fma counts)."""
    import jax
    with tempfile.TemporaryDirectory() as tmp:
        exe = jax.jit(fn).lower(*args).compile(compiler_options={"xla_dump_to": tmp})
        return exe, fma_counts(tmp)


def _updates():
    """The three forms of a - dj * (l_i * l_k) as torch functions of
    (a, dj, li, lk) broadcast against each other."""
    import torch
    return {
        "fused_dj_times_product": lambda a, dj, li, lk: torch.addcmul(a, -dj, li * lk),
        "rounded_each": lambda a, dj, li, lk: a - dj * (li * lk),
        "fused_other_product": lambda a, dj, li, lk: torch.addcmul(a, -(dj * li), lk),
    }


def t_unrolled(A, upd):
    import torch
    from uno_tpu_torch.linalg.ldlt import _safe
    n = A.shape[-1]
    M, L, d = A, torch.zeros_like(A), A.new_empty(A.shape[:-1])
    for j in range(n):
        dj = M[..., 0, 0]
        l = M[..., 1:, 0] / _safe(dj)[..., None]
        d[..., j] = dj
        L[..., j + 1:, j] = l
        M = upd(M[..., 1:, 1:], dj[..., None, None], l[..., :, None], l[..., None, :])
    return L + torch.eye(n, dtype=A.dtype), d


def t_column(A, upd, block=None):
    """The column form; with `block`, blocked's single panel (n <= block)."""
    import torch
    from uno_tpu_torch.linalg.ldlt import _safe
    n = A.shape[-1]
    rows = torch.arange(n)
    M = A.clone()
    for j in range(n):
        dj = M[..., j, j]
        col = M[..., :, j]
        below = rows > j
        l = torch.where(below, col / _safe(dj)[..., None], 0.0)
        M = upd(M, dj[..., None, None], l[..., :, None], l[..., None, :])
        M[..., :, j] = torch.where(below, l, col)
        M[..., j, j] = dj
    return torch.tril(M, -1) + torch.eye(n, dtype=A.dtype), \
        torch.diagonal(M, dim1=-2, dim2=-1)


def t_panel(C, row0, upd):
    import torch
    from uno_tpu_torch.linalg.ldlt import _safe
    n, block = C.shape
    rows = torch.arange(n)
    C = C.clone()
    d = C.new_zeros(block)
    for jj in range(block):
        pr = row0 + jj
        dj = C[pr, jj]
        inv = torch.reciprocal(_safe(dj))
        l_col = torch.where(rows > pr, C[:, jj] * inv, 0.0)
        C = upd(C, dj, l_col[:, None], l_col[row0:row0 + block][None, :])
        C[:, jj] = l_col
        d[jj] = dj
    return C, d


def _sym(rng, shape, dt):
    X = rng.standard_normal(shape).astype(dt)
    return X + np.swapaxes(X, -1, -2)


def census_factors(trials):
    import jax
    import jax.numpy as jnp
    import torch

    from uno_tpu.linalg import ldlt as J
    rows = []
    rng = np.random.default_rng(0)
    forms = {
        "ldlt_factor_unrolled": (J.ldlt_factor_unrolled, t_unrolled),
        "ldlt_factor": (J.ldlt_factor, t_column),
        "ldlt_factor_blocked_panel": (
            lambda a: J.ldlt_factor_blocked(a, block=a.shape[-1] + (-a.shape[-1]) % 8),
            t_column),
    }
    for name, (jf, tf) in forms.items():
        for n in DIMS:
            for dt in (np.float64, np.float32):
                for B in (1, 4):
                    fn = jf if B == 1 else jax.vmap(jf)
                    probe = jnp.asarray(_sym(rng, (n, n) if B == 1 else (B, n, n), dt))
                    exe, counts = compiled(fn, probe)
                    equal = {k: 0 for k in _updates()}
                    for _ in range(trials):
                        A = _sym(rng, (B, n, n), dt)
                        out = exe(jnp.asarray(A[0] if B == 1 else A))
                        jL = np.asarray(out.L).reshape(B, n, n)
                        jd = np.asarray(out.d).reshape(B, n)
                        for k, upd in _updates().items():
                            L, d = tf(torch.as_tensor(A), upd)
                            equal[k] += bool(np.array_equal(L.numpy(), jL)
                                             and np.array_equal(d.numpy(), jd))
                    rows.append({"form": name, "n": n, "dtype": np.dtype(dt).name,
                                 "batch": B, "fma_by_fusion": counts,
                                 "fma_total": sum(counts.values()),
                                 "bit_equal_of": trials, "bit_equal": equal})
                    print(json.dumps(rows[-1]), flush=True)
    return rows


def census_dist_panel(trials):
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from uno_tpu.parallel import dist_ldlt as JD
    rows = []
    rng = np.random.default_rng(1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    for n, block, row0 in ((128, 64, 0), (128, 64, 64), (256, 32, 96)):
        for dt in (np.float64, np.float32):
            fn = jax.shard_map(lambda c, row0=row0, n=n, block=block:
                               JD._panel_factor(c, row0, n, block, "x"),
                               mesh=mesh, in_specs=P(), out_specs=(P(), P()),
                               check_vma=False)
            exe, counts = compiled(fn, jnp.zeros((n, block), dt))
            equal = {k: 0 for k in _updates()}
            for _ in range(trials):
                C = _sym(rng, (n, n), dt)[:, row0:row0 + block].copy()
                jC, jd = (np.asarray(v) for v in exe(jnp.asarray(C)))
                for k, upd in _updates().items():
                    tC, td = t_panel(torch.as_tensor(C), row0, upd)
                    equal[k] += bool(np.array_equal(tC.numpy(), jC)
                                     and np.array_equal(td.numpy(), jd))
            rows.append({"form": "dist_ldlt._panel_factor", "n": n, "block": block,
                         "row0": row0, "dtype": np.dtype(dt).name,
                         "fma_by_fusion": counts, "fma_total": sum(counts.values()),
                         "bit_equal_of": trials, "bit_equal": equal})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def census_products(trials):
    """The unrolled solve and the QP's products: the port's chains against
    uno_tpu's jitted forms (and, for the solve, its earlier torch.sum rows)."""
    import jax
    import jax.numpy as jnp
    import torch

    from uno_tpu.linalg import ldlt as J
    from uno_tpu_torch.linalg import ldlt as T
    from uno_tpu_torch.solvers import qp as TQ
    from uno_tpu_torch.solvers.ipm import _matvec as library_matvec

    def rows_sum_solve(fac, b):
        n = b.shape[-1]
        z = torch.zeros_like(b)
        for i in range(n):
            z[..., i] = b[..., i] - torch.sum(fac.L[..., i, :] * z, dim=-1)
        z = z / T._safe(fac.d)
        x = torch.zeros_like(b)
        for i in range(n - 1, -1, -1):
            x[..., i] = z[..., i] - torch.sum(fac.L[..., :, i] * x, dim=-1)
        return x

    out = []
    rng = np.random.default_rng(2)
    for n in (2, 5, 12, 32):
        for dt in (np.float64, np.float32):
            for B in (1, 4):
                fn = jax.jit(J.ldlt_solve) if B == 1 else jax.jit(jax.vmap(J.ldlt_solve))
                eq = {"port_chains": 0, "row_sums": 0}
                for _ in range(trials):
                    A = _sym(rng, (B, n, n), dt)
                    b = rng.standard_normal((B, n)).astype(dt)
                    jf = J.ldlt_factor_unrolled(jnp.asarray(A[0])) if B == 1 else \
                        jax.vmap(J.ldlt_factor_unrolled)(jnp.asarray(A))
                    js = np.asarray(fn(jf, jnp.asarray(b[0] if B == 1 else b))).reshape(B, n)
                    tf = T.ldlt_factor_unrolled(torch.as_tensor(A))
                    eq["port_chains"] += bool(np.array_equal(
                        T.ldlt_solve(tf, torch.as_tensor(b)).numpy(), js))
                    eq["row_sums"] += bool(np.array_equal(
                        rows_sum_solve(tf, torch.as_tensor(b)).numpy(), js))
                out.append({"form": "ldlt_solve (unrolled)", "n": n,
                            "dtype": np.dtype(dt).name, "batch": B,
                            "bit_equal_of": trials, "bit_equal": eq})
                print(json.dumps(out[-1]), flush=True)
    mv, rmv = jax.jit(lambda A, x: A @ x), jax.jit(lambda A, y: A.T @ y)
    for r, c in ((2, 2), (3, 3), (5, 5), (8, 8), (12, 12)):
        for dt in (np.float64, np.float32):
            eq = {"A@x port_chain": 0, "A@x library": 0, "A^T y port_chain": 0}
            for _ in range(trials):
                A = rng.standard_normal((r, c)).astype(dt)
                x = rng.standard_normal(c).astype(dt)
                y = rng.standard_normal(r).astype(dt)
                At, xt, yt = torch.as_tensor(A)[None], torch.as_tensor(x)[None], \
                    torch.as_tensor(y)[None]
                jmv = np.asarray(mv(A, x))
                eq["A@x port_chain"] += bool(np.array_equal(TQ._matvec(At, xt)[0].numpy(), jmv))
                eq["A@x library"] += bool(np.array_equal(library_matvec(At, xt)[0].numpy(), jmv))
                eq["A^T y port_chain"] += bool(np.array_equal(
                    TQ._rmatvec(At, yt)[0].numpy(), np.asarray(rmv(A, y))))
            out.append({"form": "QP matvec", "rows": r, "cols": c,
                        "dtype": np.dtype(dt).name, "bit_equal_of": trials,
                        "bit_equal": eq})
            print(json.dumps(out[-1]), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    result = {"jax": jax.__version__,
              "factors": census_factors(args.trials),
              "dist_panel": census_dist_panel(args.trials),
              "products": census_products(args.trials)}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
            fh.write("\n")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
