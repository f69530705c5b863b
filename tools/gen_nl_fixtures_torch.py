#!/usr/bin/env python
"""Generate the AMPL .nl fixtures of tests/fixtures/nl (text 'g' format and
its binary 'b' twin) for scalable CUTEst-family problems, with PyTorch and
uno_tpu_torch only: the counterpart of tools/gen_nl_fixtures.py, whose
expression DSL (E, V, sumlist) and writer (write_nl) this file carries as
its own copy.

The emitted format follows David Gay's public .nl spec: header, b/x/r
sections, C/O prefix expression graphs, k column pointers, J/G sparsity
with linear coefficients.  Every fixture is checked against
uno_tpu_torch.model.library before it is written (the family's constructor
library_cutest.cutest_problem where the family has one, else the library's
nl_<stem> key of the committed fixture) and read back through
uno_tpu_torch.io.read_nl, text and binary.  All of it is host work on the
CPU.

Usage: python tools/gen_nl_fixtures_torch.py [outdir]   (default tests/fixtures/nl)
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

INF = float("inf")


# ---------------------------------------------------------------------------
# tiny expression DSL -> .nl prefix text
# ---------------------------------------------------------------------------

class E:
    """Expression node; operators build trees."""

    def __init__(self, kind, *args):
        self.kind = kind      # 'v' | 'n' | opcode int
        self.args = args

    # helpers
    @staticmethod
    def _w(x):
        return x if isinstance(x, E) else E("n", float(x))

    def __add__(self, o):
        return E(0, self, E._w(o))

    def __radd__(self, o):
        return E(0, E._w(o), self)

    def __sub__(self, o):
        return E(1, self, E._w(o))

    def __rsub__(self, o):
        return E(1, E._w(o), self)

    def __mul__(self, o):
        return E(2, self, E._w(o))

    def __rmul__(self, o):
        return E(2, E._w(o), self)

    def __truediv__(self, o):
        return E(3, self, E._w(o))

    def __rtruediv__(self, o):
        return E(3, E._w(o), self)

    def __pow__(self, o):
        return E(5, self, E._w(o))

    def __rpow__(self, o):
        return E(5, E._w(o), self)

    def __neg__(self):
        return E(16, self)

    def emit(self, out):
        if self.kind == "v":
            out.append(f"v{self.args[0]}")
        elif self.kind == "n":
            out.append(f"n{self.args[0]:.17g}")
        elif self.kind in (11, 12, 54):  # min/max/sum lists carry a count
            out.append(f"o{self.kind}")
            out.append(str(len(self.args)))
            for a in self.args:
                a.emit(out)
        else:
            out.append(f"o{self.kind}")
            for a in self.args:
                a.emit(out)

    def vars(self, acc):
        if self.kind == "v":
            acc.add(self.args[0])
        for a in self.args:
            if isinstance(a, E):
                a.vars(acc)
        return acc


def V(i):
    return E("v", i)


def sin(x):
    return E(41, E._w(x))


def cos(x):
    return E(46, E._w(x))


def exp(x):
    return E(44, E._w(x))


def sumlist(terms):
    terms = [E._w(t) for t in terms]
    if len(terms) == 1:
        return terms[0]
    if len(terms) == 2:
        return terms[0] + terms[1]
    return E(54, *terms)


def write_nl(path, name, n, x0, xl, xu, cons, obj, cl, cu):
    """cons: list of E; obj: E; bounds arrays."""
    m = len(cons)
    # Jacobian sparsity: vars appearing in each constraint (linear coef 0 —
    # all terms live in the nonlinear expression)
    con_vars = [sorted(c.vars(set())) for c in cons]
    obj_vars = sorted(obj.vars(set()))
    nnz_j = sum(len(v) for v in con_vars)
    n_eqns = int(sum(1 for a, b in zip(cl, cu) if a == b and np.isfinite(a)))

    lines = []
    lines.append(f"g3 1 1 0\t# problem {name}")
    lines.append(f" {n} {m} 1 0 {n_eqns}")
    lines.append(f" {m} 1")
    lines.append(" 0 0")
    lines.append(f" {n} {n} {n}")
    lines.append(" 0 0 0 1")
    lines.append(" 0 0 0 0 0")
    lines.append(f" {nnz_j} {len(obj_vars)}")
    lines.append(" 0 0")
    lines.append(" 0 0 0 0 0")

    # constraint bodies
    for j, c in enumerate(cons):
        lines.append(f"C{j}")
        out = []
        c.emit(out)
        lines.extend(out)
    # objective (0 = minimize)
    lines.append("O0 0")
    out = []
    obj.emit(out)
    lines.extend(out)
    # initial guess
    nz0 = [(i, x0[i]) for i in range(n)]
    lines.append(f"x{len(nz0)}")
    for i, v in nz0:
        lines.append(f"{i} {v:.17g}")
    # constraint ranges
    lines.append("r")
    for a, b in zip(cl, cu):
        if np.isfinite(a) and np.isfinite(b) and a == b:
            lines.append(f"4 {a:.17g}")
        elif np.isfinite(a) and np.isfinite(b):
            lines.append(f"0 {a:.17g} {b:.17g}")
        elif np.isfinite(a):
            lines.append(f"2 {a:.17g}")
        elif np.isfinite(b):
            lines.append(f"1 {b:.17g}")
        else:
            lines.append("3")
    # variable bounds
    lines.append("b")
    for a, b in zip(xl, xu):
        if np.isfinite(a) and np.isfinite(b) and a == b:
            lines.append(f"4 {a:.17g}")
        elif np.isfinite(a) and np.isfinite(b):
            lines.append(f"0 {a:.17g} {b:.17g}")
        elif np.isfinite(a):
            lines.append(f"2 {a:.17g}")
        elif np.isfinite(b):
            lines.append(f"1 {b:.17g}")
        else:
            lines.append("3")
    # k section: cumulative Jacobian nonzero counts for columns 0..n-2
    col_counts = np.zeros(n, dtype=int)
    for vs in con_vars:
        for i in vs:
            col_counts[i] += 1
    cum = np.cumsum(col_counts)
    lines.append(f"k{n - 1}")
    for i in range(n - 1):
        lines.append(str(cum[i]))
    # J sections (linear coefficients all zero; sparsity only)
    for j, vs in enumerate(con_vars):
        lines.append(f"J{j} {len(vs)}")
        for i in vs:
            lines.append(f"{i} 0")
    # G section
    lines.append(f"G0 {len(obj_vars)}")
    for i in obj_vars:
        lines.append(f"{i} 0")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# fixture families (expression-tree mirrors of model/library_cutest.py)
# ---------------------------------------------------------------------------

def fx_srosenbr(n):
    n -= n % 2
    obj = sumlist([100.0 * (V(2 * i + 1) - V(2 * i) ** 2) ** 2
                   + (1.0 - V(2 * i)) ** 2 for i in range(n // 2)])
    x0 = np.tile([-1.2, 1.0], n // 2)
    return dict(n=n, obj=obj, cons=[], x0=x0,
                xl=np.full(n, -INF), xu=np.full(n, INF), cl=[], cu=[])


def fx_tridia(n):
    obj = sumlist([(V(0) - 1.0) ** 2]
                  + [float(i + 1) * (2.0 * V(i) - V(i - 1)) ** 2
                     for i in range(1, n)])
    return dict(n=n, obj=obj, cons=[], x0=np.ones(n),
                xl=np.full(n, -INF), xu=np.full(n, INF), cl=[], cu=[])


def fx_arwhead(n):
    obj = sumlist([(V(i) ** 2 + V(n - 1) ** 2) ** 2 - 4.0 * V(i) + 3.0
                   for i in range(n - 1)])
    return dict(n=n, obj=obj, cons=[], x0=np.ones(n),
                xl=np.full(n, -INF), xu=np.full(n, INF), cl=[], cu=[])


def fx_engval1(n):
    obj = sumlist([(V(i) ** 2 + V(i + 1) ** 2) ** 2 - 4.0 * V(i) + 3.0
                   for i in range(n - 1)])
    return dict(n=n, obj=obj, cons=[], x0=np.full(n, 2.0),
                xl=np.full(n, -INF), xu=np.full(n, INF), cl=[], cu=[])


def fx_chained_rosenbrock(n):
    obj = sumlist([100.0 * (V(i + 1) - V(i) ** 2) ** 2 + (1.0 - V(i)) ** 2
                   for i in range(n - 1)])
    cons = [sumlist([V(i) * V(i) for i in range(n)]) - float(n)]
    return dict(n=n, obj=obj, cons=cons, x0=np.full(n, 0.5),
                xl=np.full(n, -5.0), xu=np.full(n, 5.0),
                cl=[0.0], cu=[INF])


def fx_sphere_proj(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n)
    obj = 0.5 * sumlist([(V(i) - a[i]) ** 2 for i in range(n)])
    cons = [sumlist([V(i) * V(i) for i in range(n)]) - 1.0]
    return dict(n=n, obj=obj, cons=cons,
                x0=np.full(n, 1.0 / np.sqrt(n)),
                xl=np.full(n, -INF), xu=np.full(n, INF), cl=[0.0], cu=[0.0])


def fx_lukvle1(n):
    obj = sumlist([100.0 * (V(i) ** 2 - V(i + 1)) ** 2 + (V(i) - 1.0) ** 2
                   for i in range(n - 1)])
    cons = []
    for k in range(n - 2):
        a, b, d = V(k), V(k + 1), V(k + 2)
        cons.append(3.0 * b ** 3 + 2.0 * d - 5.0
                    + sin(b - d) * sin(b + d) + 4.0 * b
                    - a * exp(a - b) - 3.0)
    x0 = np.full(n, -1.2)
    x0[1::2] = 1.0
    m = n - 2
    return dict(n=n, obj=obj, cons=cons, x0=x0,
                xl=np.full(n, -INF), xu=np.full(n, INF),
                cl=[0.0] * m, cu=[0.0] * m)


def fx_catena(n):
    K = max(3, n // 2)
    L = 2.0 / K
    nv = 2 * (K - 1)

    def X(i):  # joint i in 1..K-1 -> vars (2(i-1), 2(i-1)+1)
        return V(2 * (i - 1)), V(2 * (i - 1) + 1)

    # potential energy sum of (y_i + y_{i+1})/2 with pinned endpoints (0,0)/(1,0)
    terms = []
    ys = [E._w(0.0)] + [X(i)[1] for i in range(1, K)] + [E._w(0.0)]
    for i in range(K):
        terms.append(0.5 * (ys[i] + ys[i + 1]))
    obj = sumlist(terms)
    xs = [E._w(0.0)] + [X(i)[0] for i in range(1, K)] + [E._w(1.0)]
    cons = [(xs[i + 1] - xs[i]) ** 2 + (ys[i + 1] - ys[i]) ** 2 - L ** 2
            for i in range(K)]
    x0 = np.zeros(nv)
    x0[0::2] = np.linspace(0, 1, K + 1)[1:-1]
    x0[1::2] = -0.1
    return dict(n=nv, obj=obj, cons=cons, x0=x0,
                xl=np.full(nv, -INF), xu=np.full(nv, INF),
                cl=[0.0] * K, cu=[0.0] * K)


def fx_biggsb1(n):
    obj = sumlist([(V(0) - 1.0) ** 2]
                  + [(V(i) - V(i - 1)) ** 2 for i in range(1, n)]
                  + [(1.0 - V(n - 1)) ** 2])
    return dict(n=n, obj=obj, cons=[], x0=np.zeros(n),
                xl=np.zeros(n), xu=np.full(n, 0.9), cl=[], cu=[])


def fx_cosine(n):
    obj = sumlist([cos(V(i) ** 2 - 0.5 * V(i + 1)) for i in range(n - 1)])
    return dict(n=n, obj=obj, cons=[], x0=np.ones(n),
                xl=np.full(n, -INF), xu=np.full(n, INF), cl=[], cu=[])


def fx_hs015like(n):  # inequality-constrained nonconvex family
    obj = sumlist([100.0 * (V(2 * i + 1) - V(2 * i) ** 2) ** 2
                   + (1.0 - V(2 * i)) ** 2 for i in range(n // 2)])
    cons = [V(2 * i) * V(2 * i + 1) - 1.0 for i in range(n // 2)]
    xu = np.full(n, INF)
    xu[0::2] = 0.5
    m = n // 2
    return dict(n=n - n % 2, obj=obj, cons=cons,
                x0=np.tile([-2.0, 1.0], n // 2),
                xl=np.full(n, -INF), xu=xu, cl=[0.0] * m, cu=[INF] * m)


FAMILIES = {
    "srosenbr": fx_srosenbr,
    "tridia": fx_tridia,
    "arwhead": fx_arwhead,
    "engval1": fx_engval1,
    "chained_rosenbrock": fx_chained_rosenbrock,
    "sphere_proj": fx_sphere_proj,
    "lukvle1": fx_lukvle1,
    "catena": fx_catena,
    "biggsb1": fx_biggsb1,
    "cosine": fx_cosine,
    "hs015like": fx_hs015like,
}

SIZES = (10, 50)


def _values(nlp, xs):
    """f and c of an NLP at the rows of xs, as float64 numpy arrays."""
    import torch
    x = torch.as_tensor(np.asarray(xs, dtype=np.float64))
    f = nlp.objective(x).numpy()
    c = nlp.constraints(x).numpy()
    return f, c


def _library_twin(name, n, m, fname):
    """The library's problem this fixture is checked against: the family's
    constructor where it makes this size, else the committed fixture's key."""
    from uno_tpu_torch.model import library_cutest
    from uno_tpu_torch.model.library import get_problem, problem_names
    if name in library_cutest.family_names():
        twin = library_cutest.cutest_problem(name, n)
        if (twin.n, twin.m) == (n, m):
            return twin
    if f"nl_{fname}" in problem_names():
        return get_problem(f"nl_{fname}")
    return None


def check_fixture(d, fname, path, twin, rtol=1e-12):
    """Raise AssertionError unless the file read back by the port agrees
    with the library's twin (when there is one and it has the fixture's
    size) in bounds, x0 and f and c at x0 and two seeded points."""
    from uno_tpu_torch.io import read_nl
    back = read_nl(path)
    assert back.n == d["n"] and back.m == len(d["cons"]), fname
    rng = np.random.default_rng(0)
    x0 = np.asarray(d["x0"], dtype=np.float64)
    xs = np.stack([x0] + [x0 + 0.1 * rng.standard_normal(d["n"]) for _ in range(2)])
    fb, cb = _values(back, xs)
    assert np.all(np.isfinite(fb)), fname
    if twin is None or (twin.n, twin.m) != (back.n, back.m):
        return fb
    np.testing.assert_array_equal(back.x_lb, np.asarray(twin.x_lb), err_msg=fname)
    np.testing.assert_array_equal(back.x_ub, np.asarray(twin.x_ub), err_msg=fname)
    np.testing.assert_array_equal(back.x0, np.asarray(twin.x0), err_msg=fname)
    ft, ct = _values(twin, xs)
    np.testing.assert_allclose(fb, ft, rtol=rtol, atol=rtol, err_msg=fname)
    np.testing.assert_allclose(cb, ct, rtol=rtol, atol=rtol, err_msg=fname)
    return fb


def write_fixture(outdir, name, size):
    """Build family `name` at `size`, write <stem>.nl and <stem>.bin.nl into
    outdir after the checks; returns the stem."""
    from uno_tpu_torch.io import convert_nl_to_binary, read_nl
    d = FAMILIES[name](size)
    fname = f"{name}_n{d['n']}"
    twin = _library_twin(name, d["n"], len(d["cons"]), fname)
    path = os.path.join(outdir, fname + ".nl")
    tmp = path + ".tmp"
    write_nl(tmp, fname, d["n"], d["x0"], d["xl"], d["xu"], d["cons"],
             d["obj"], d["cl"], d["cu"])
    try:
        fval = check_fixture(d, fname, tmp, twin)
        bpath = os.path.join(outdir, fname + ".bin.nl")
        convert_nl_to_binary(tmp, bpath)
        x0 = np.asarray(d["x0"], dtype=np.float64)[None]
        fb, _ = _values(read_nl(bpath), x0)
        assert np.isclose(fb[0], fval[0], rtol=1e-14), fname
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return fname


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures", "nl")
    os.makedirs(outdir, exist_ok=True)
    count = 0
    for name in FAMILIES:
        for size in SIZES:
            fname = write_fixture(outdir, name, size)
            count += 2
            print(f"wrote {fname}.nl + .bin.nl")
    print(f"{count} fixtures in {outdir}")


if __name__ == "__main__":
    main()
