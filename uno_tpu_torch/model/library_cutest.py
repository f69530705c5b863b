"""Scalable CUTEst-style problem families in torch: a copy of
uno_tpu/model/library_cutest.py under the same families, sizes, optima and
structure declarations, and of the control and chained families of
uno_tpu/model/library_r4.py (steering, vanderpol_ctrl, chwood_eq,
chpowellsg_eq, broydn_eq; registered by model/library_r4.py, as uno_tpu
registers them).

Each family is a classic scalable test problem from the public literature
(More-Garbow-Hillstrom 1981; Conn-Gould-Toint CUTE(st); Luksan-Vlcek 1999
sparse equality-constrained set; COPS 3.0), written with shifted-slice sums
and no per-element Python loops.  Most declare an NLPStructure (a banded
Hessian, windowed Jacobian rows) and take the banded KKT backend under
kkt_formulation="auto"; hager1, dtoc1, gridpde, dblintegrator and clnlbeam
are interleaved by stage at build time; the r4 families declare none
(auto_permute's detection or the sparse backend finds theirs).

Instances register into model/library.py's registry as "<family>_n<N>",
N the BUILT dimension (builders snap n to their structure: grids use
g = isqrt(n), control families N stages), for N in the family's sizes;
`f_star` is registered only where it is analytically exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.nn.functional import pad

from uno_tpu_torch.model import transforms
from uno_tpu_torch.model.library import register
from uno_tpu_torch.model.nlp import INF, NLP, NLPStructure, const, nlp_from_functions

SIZES = (10, 100, 1000)

_FAMILIES: dict = {}
# the control and chained families of uno_tpu's library_r4.py (its
# _R4_FAMILIES), registered by model/library_r4.py
_R4_FAMILIES: dict = {}


def family(name, f_star=None, sizes=SIZES, min_n=2, local_optima=()):
    """Register a family builder n -> NLP.  f_star / local_optima entries:
    None, a constant, or a callable n -> value (documented secondary
    first-order points, e.g. MGH's BROWNAL local minimum f = 1)."""
    def deco(builder):
        _FAMILIES[name] = (builder, f_star, sizes, min_n, local_optima)
        return builder
    return deco


def r4_family(name, f_star=None, sizes=SIZES, min_n=2):
    """Register a family of uno_tpu's library_r4.py (its _family)."""
    def deco(builder):
        _R4_FAMILIES[name] = (builder, f_star, sizes, min_n)
        return builder
    return deco


def family_names():
    return sorted(_FAMILIES)


def cutest_problem(name: str, n: int) -> NLP:
    """The family `name` (of either table) built at size n."""
    table = _FAMILIES if name in _FAMILIES else _R4_FAMILIES
    return table[name][0](n)


def _reg_all():
    """Register every (family, size) instance into the main registry under
    the key of its BUILT dimension (uno_tpu/model/library_cutest.py:52-75)."""
    seen = set()
    for name, (builder, f_star, sizes, min_n, locs) in _FAMILIES.items():
        for n in sizes:
            if n < min_n:
                continue
            key = f"{name}_n{builder(n).n}"
            if key in seen:
                continue
            seen.add(key)
            fs = f_star(n) if callable(f_star) else f_star
            lo = tuple(v(n) if callable(v) else v for v in locs)
            register(key, f_star=fs, local_optima=lo)(
                lambda name=name, n=n: cutest_problem(name, n))


# ===========================================================================
# unconstrained / bound-constrained (classic sparse sums)
# ===========================================================================

@family("srosenbr", f_star=0.0)
def srosenbr(n):
    """Extended Rosenbrock (separable pairs), MGH #21 / CUTEst SROSENBR."""
    n -= n % 2

    def f(x):
        xo, xe = x[0::2], x[1::2]
        return torch.sum(100.0 * (xe - xo ** 2) ** 2 + (1.0 - xo) ** 2)

    x0 = np.tile([-1.2, 1.0], n // 2)
    return nlp_from_functions(f"srosenbr_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


@family("arwhead", f_star=0.0)
def arwhead(n):
    """CUTEst ARWHEAD: sum_{i<n} ((x_i^2+x_n^2)^2 - 4x_i + 3)."""
    def f(x):
        head = x[:-1]
        return torch.sum((head ** 2 + x[-1] ** 2) ** 2 - 4.0 * head + 3.0)

    return nlp_from_functions(f"arwhead_n{n}", f, None, x0=np.ones(n))


@family("liarwhd", f_star=0.0)
def liarwhd(n):
    """CUTEst LIARWHD: sum 4(x_i^2 - x_1)^2 + (x_i - 1)^2; min at x=1."""
    def f(x):
        return torch.sum(4.0 * (x ** 2 - x[0]) ** 2 + (x - 1.0) ** 2)

    return nlp_from_functions(f"liarwhd_n{n}", f, None, x0=np.full(n, 4.0))


@family("nondquar", f_star=0.0, min_n=3)
def nondquar(n):
    """CUTEst NONDQUAR: (x1-x2)^2 + (x_{n-1}+x_n)^2
    + sum_{i<=n-2} (x_i + x_{i+1} + x_n)^4."""
    def f(x):
        mid = (x[:-2] + x[1:-1] + x[-1]) ** 4
        return (x[0] - x[1]) ** 2 + (x[-2] + x[-1]) ** 2 + torch.sum(mid)

    x0 = np.ones(n)
    x0[1::2] = -1.0
    return nlp_from_functions(f"nondquar_n{n}", f, None, x0=x0)


@family("engval1")
def engval1(n):
    """CUTEst ENGVAL1: sum (x_i^2 + x_{i+1}^2)^2 - 4 x_i + 3."""
    def f(x):
        return torch.sum((x[:-1] ** 2 + x[1:] ** 2) ** 2 - 4.0 * x[:-1] + 3.0)

    return nlp_from_functions(f"engval1_n{n}", f, None, x0=np.full(n, 2.0),
                              structure=NLPStructure(hess_bandwidth=1))


@family("edensch")
def edensch(n):
    """CUTEst EDENSCH: 16 + sum (x_i-2)^4 + (x_i x_{i+1} - 2 x_{i+1})^2
    + (x_{i+1}+1)^2."""
    def f(x):
        a, b = x[:-1], x[1:]
        return 16.0 + torch.sum((a - 2.0) ** 4 + (a * b - 2.0 * b) ** 2
                                + (b + 1.0) ** 2)

    return nlp_from_functions(f"edensch_n{n}", f, None, x0=np.zeros(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("cragglvy", min_n=4)
def cragglvy(n):
    """CUTEst CRAGGLVY (chained Cragg-Levy):
    sum over odd i of (exp(x_i)-x_{i+1})^4 + 100(x_{i+1}-x_{i+2})^6
    + tan^4(x_{i+2}-x_{i+3}) + x_i^8 + (x_{i+3}-1)^2."""
    n -= n % 2

    def f(x):
        a, b, c, d = x[0:-3:2], x[1:-2:2], x[2:-1:2], x[3::2]
        return torch.sum((torch.exp(a) - b) ** 4 + 100.0 * (b - c) ** 6
                         + torch.tan(c - d) ** 4 + a ** 8 + (d - 1.0) ** 2)

    x0 = np.full(n, 2.0)
    x0[0] = 1.0
    return nlp_from_functions(f"cragglvy_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=3))


@family("freuroth", min_n=2)
def freuroth(n):
    """Extended Freudenstein & Roth (CUTEst FREUROTH)."""
    def f(x):
        a, b = x[:-1], x[1:]
        r1 = -13.0 + a + ((5.0 - b) * b - 2.0) * b
        r2 = -29.0 + a + ((b + 1.0) * b - 14.0) * b
        return torch.sum(r1 ** 2 + r2 ** 2)

    x0 = np.zeros(n)
    x0[0], x0[1] = 0.5, -2.0
    return nlp_from_functions(f"freuroth_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


@family("tridia", f_star=0.0)
def tridia(n):
    """CUTEst TRIDIA (alpha=2, beta=1, gamma=1, delta=1):
    (x_1-1)^2 + sum_{i=2}^n i (2x_i - x_{i-1})^2."""
    i_np = np.arange(2, n + 1)
    cache: dict = {}

    def f(x):
        i = const(cache, i_np, x)
        return (x[0] - 1.0) ** 2 + torch.sum(i * (2.0 * x[1:] - x[:-1]) ** 2)

    return nlp_from_functions(f"tridia_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("dqrtic", f_star=0.0)
def dqrtic(n):
    """CUTEst DQRTIC: sum (x_i - i)^4."""
    i_np = np.arange(1, n + 1)
    cache: dict = {}

    def f(x):
        return torch.sum((x - const(cache, i_np, x)) ** 4)

    return nlp_from_functions(f"dqrtic_n{n}", f, None, x0=np.full(n, 2.0),
                              structure=NLPStructure(hess_bandwidth=0))


@family("woods", f_star=0.0, min_n=4)
def woods(n):
    """Extended Wood function (MGH #14 chained in 4-blocks, CUTEst WOODS)."""
    n -= n % 4

    def f(x):
        x1, x2, x3, x4 = x[0::4], x[1::4], x[2::4], x[3::4]
        return torch.sum(100.0 * (x2 - x1 ** 2) ** 2 + (1.0 - x1) ** 2
                         + 90.0 * (x4 - x3 ** 2) ** 2 + (1.0 - x3) ** 2
                         + 10.0 * (x2 + x4 - 2.0) ** 2
                         + 0.1 * (x2 - x4) ** 2)

    x0 = np.tile([-3.0, -1.0, -3.0, -1.0], n // 4)
    return nlp_from_functions(f"woods_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=3))


@family("powellsg", f_star=0.0, min_n=4)
def powellsg(n):
    """Extended Powell singular (MGH #13, CUTEst POWELLSG); singular Hessian
    at the solution."""
    n -= n % 4

    def f(x):
        x1, x2, x3, x4 = x[0::4], x[1::4], x[2::4], x[3::4]
        return torch.sum((x1 + 10.0 * x2) ** 2 + 5.0 * (x3 - x4) ** 2
                         + (x2 - 2.0 * x3) ** 4 + 10.0 * (x1 - x4) ** 4)

    x0 = np.tile([3.0, -1.0, 0.0, 1.0], n // 4)
    return nlp_from_functions(f"powellsg_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=3))


@family("vardim", f_star=0.0)
def vardim(n):
    """MGH #25 VARDIM: sum(x_i-1)^2 + (sum i x_i - K)^2 + (...)^4,
    K = n(n+1)/2; min at x=1."""
    K = n * (n + 1) / 2.0

    i_np = np.arange(1, n + 1)
    cache: dict = {}

    def f(x):
        t = torch.dot(const(cache, i_np, x), x) - K
        return torch.sum((x - 1.0) ** 2) + t ** 2 + t ** 4

    x0 = 1.0 - np.arange(1, n + 1) / n
    return nlp_from_functions(f"vardim_n{n}", f, None, x0=x0)


@family("brownal", f_star=0.0, local_optima=(1.0,))
def brownal(n):
    """MGH #27 Brown almost-linear: sum_{i<n} (x_i + sum x - (n+1))^2
    + (prod x - 1)^2; min 0 at x=1; documented local minimum f = 1 at
    x = (0, ..., 0, n+1) (MGH 1981)."""
    def f(x):
        s = torch.sum(x)
        r = x[:-1] + s - (x.shape[0] + 1.0)
        # product via exp-sum-log is invalid for negative x; direct prod
        return torch.sum(r ** 2) + (torch.prod(x) - 1.0) ** 2

    return nlp_from_functions(f"brownal_n{n}", f, None, x0=np.full(n, 0.5))


@family("penalty1")
def penalty1(n):
    """MGH #23 PENALTY1: 1e-5 sum (x_i-1)^2 + (sum x_i^2 - 0.25)^2."""
    def f(x):
        return 1e-5 * torch.sum((x - 1.0) ** 2) + (torch.sum(x ** 2) - 0.25) ** 2

    return nlp_from_functions(f"penalty1_n{n}", f, None,
                              x0=np.arange(1.0, n + 1.0))


@family("bdqrtic", min_n=5)
def bdqrtic(n):
    """CUTEst BDQRTIC: sum_{i<=n-4} (-4x_i+3)^2
    + (x_i^2 + 2x_{i+1}^2 + 3x_{i+2}^2 + 4x_{i+3}^2 + 5x_n^2)^2."""
    def f(x):
        a = x[:-4]
        q = (a ** 2 + 2.0 * x[1:-3] ** 2 + 3.0 * x[2:-2] ** 2
             + 4.0 * x[3:-1] ** 2 + 5.0 * x[-1] ** 2)
        return torch.sum((-4.0 * a + 3.0) ** 2 + q ** 2)

    return nlp_from_functions(f"bdqrtic_n{n}", f, None, x0=np.ones(n))


@family("cosine", f_star=lambda n: -(n - 1.0))
def cosine(n):
    """CUTEst COSINE: sum cos(x_i^2 - 0.5 x_{i+1}); min -(n-1)."""
    def f(x):
        return torch.sum(torch.cos(x[:-1] ** 2 - 0.5 * x[1:]))

    return nlp_from_functions(f"cosine_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("sinquad", f_star=0.0, min_n=3)
def sinquad(n):
    """CUTEst SINQUAD: (x1-1)^4 + (x_n^2 - x_1^2)^2
    + sum_mid (sin(x_i - x_n) - x_1^2 + x_i^2)^2."""
    def f(x):
        mid = x[1:-1]
        return ((x[0] - 1.0) ** 4 + (x[-1] ** 2 - x[0] ** 2) ** 2
                + torch.sum((torch.sin(mid - x[-1]) - x[0] ** 2 + mid ** 2) ** 2))

    return nlp_from_functions(f"sinquad_n{n}", f, None, x0=np.full(n, 0.1))


@family("broydn3d_ls", f_star=0.0)
def broydn3d_ls(n):
    """Broyden tridiagonal equations (MGH #30) as least squares."""
    def F(x):
        xm = pad(x, (1, 1))  # x_0 = x_{n+1} = 0
        return (3.0 - 2.0 * xm[1:-1]) * xm[1:-1] - xm[:-2] - 2.0 * xm[2:] + 1.0

    def f(x):
        return torch.sum(F(x) ** 2)

    return nlp_from_functions(f"broydn3d_ls_n{n}", f, None, x0=np.full(n, -1.0),
                              structure=NLPStructure(hess_bandwidth=2))


@family("broydnbd_ls", f_star=0.0, min_n=7)
def broydnbd_ls(n):
    """Broyden banded equations (MGH #31, lower bandwidth 5, upper 1) as
    least squares; banded sums via stacked shifted slices (static shapes)."""
    def F(x):
        xp = pad(x, (5, 1))
        # neighbors j != i with max(0, i-5) <= j <= min(n-1, i+1): the
        # offsets -5..+1 with offset 0, x_i itself, held at zero
        nb = torch.stack([xp[k:k + n] if k != 5 else torch.zeros_like(x)
                          for k in range(7)], dim=0)
        s = torch.sum(nb * (1.0 + nb), dim=0)
        return x * (2.0 + 5.0 * x ** 2) + 1.0 - s

    def f(x):
        return torch.sum(F(x) ** 2)

    return nlp_from_functions(f"broydnbd_ls_n{n}", f, None, x0=np.full(n, -1.0),
                              structure=NLPStructure(hess_bandwidth=6))


@family("genhumps", f_star=0.0)
def genhumps(n):
    """CUTEst GENHUMPS: sum sin(2x_i)^2 sin(2x_{i+1})^2
    + 0.05(x_i^2 + x_{i+1}^2); min 0 at x=0."""
    def f(x):
        a, b = x[:-1], x[1:]
        return torch.sum(torch.sin(2.0 * a) ** 2 * torch.sin(2.0 * b) ** 2
                         + 0.05 * (a ** 2 + b ** 2))

    x0 = np.full(n, 2.0)
    x0[0] = -2.0
    return nlp_from_functions(f"genhumps_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


# ---------------------------------------------------------------------------
# bound-constrained
# ---------------------------------------------------------------------------

@family("biggsb1")
def biggsb1(n):
    """CUTEst BIGGSB1: (x1-1)^2 + sum (x_{i+1}-x_i)^2 + (1-x_n)^2,
    0 <= x_i <= 0.9."""
    def f(x):
        return ((x[0] - 1.0) ** 2 + torch.sum((x[1:] - x[:-1]) ** 2)
                + (1.0 - x[-1]) ** 2)

    return nlp_from_functions(
        f"biggsb1_n{n}", f, None, x0=np.zeros(n),
        x_lb=np.zeros(n), x_ub=np.full(n, 0.9),
        structure=NLPStructure(hess_bandwidth=1))


@family("obstacle", min_n=16)
def obstacle(n):
    """Obstacle problem (CUTEst OBSTCLAE-style): min 1/2 u^T K u - f^T u on a
    sqrt(n) x sqrt(n) interior grid (5-point Laplacian), u >= obstacle (a
    centered plateau), u = 0 on the boundary."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)

    def f(u):
        U = u.reshape(g, g)
        Up = pad(U, (1, 1, 1, 1))
        lap = 4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1] - Up[1:-1, :-2] - Up[1:-1, 2:]
        return 0.5 * torch.sum(U * lap) - h * h * torch.sum(U)

    lb = np.zeros((g, g))
    q = max(1, g // 4)
    lb[q:g - q, q:g - q] = 0.3  # plateau obstacle
    return nlp_from_functions(
        f"obstacle_n{g * g}", f, None, x0=np.zeros(g * g),
        x_lb=lb.ravel(), x_ub=np.full(g * g, INF),
        structure=NLPStructure(hess_bandwidth=g))


# ===========================================================================
# constrained scalable families (the KKT-relevant tier)
# ===========================================================================

@family("lukvle1", min_n=3)
def lukvle1(n):
    """Luksan-Vlcek problem 5.1 (CUTEst LUKVLE1): chained Rosenbrock
    objective, n-2 trigonometric-exponential equality constraints."""
    def f(x):
        return torch.sum(100.0 * (x[:-1] ** 2 - x[1:]) ** 2 + (x[:-1] - 1.0) ** 2)

    def c(x):
        a, b, d = x[:-2], x[1:-1], x[2:]
        return (3.0 * b ** 3 + 2.0 * d - 5.0
                + torch.sin(b - d) * torch.sin(b + d)
                + 4.0 * b - a * torch.exp(a - b) - 3.0)

    m = n - 2
    x0 = np.full(n, -1.2)
    x0[1::2] = 1.0
    return nlp_from_functions(
        f"lukvle1_n{n}", f, c, x0=x0,
        c_lb=np.zeros(m), c_ub=np.zeros(m),
        structure=NLPStructure(hess_bandwidth=2,
                               jac_starts=np.arange(m, dtype=np.int64),
                               jac_width=3))


@family("lukvli1", min_n=3)
def lukvli1(n):
    """LUKVLI1: LUKVLE1 with the constraints relaxed to <= 0."""
    base = lukvle1(n)
    m = n - 2
    return nlp_from_functions(
        f"lukvli1_n{n}", base.f, base.c, x0=np.asarray(base.x0),
        c_lb=np.full(m, -INF), c_ub=np.zeros(m),
        structure=base.structure)


@family("hager1", min_n=4)
def hager1(n):
    """Hager optimal control (CUTEst HAGER1-style): min 1/2 int_0^1 (x^2 +
    u^2) dt, x' = 0.5 x + u, x(0) = 1, trapezoidal; states x_0..x_N and
    controls u_1..u_N, interleaved by stage so the KKT is banded."""
    N = max(2, (n - 1) // 2)
    h = 1.0 / N

    def f(z):
        x, u = z[: N + 1], z[N + 1:]
        xm = 0.5 * (x[1:] ** 2 + x[:-1] ** 2)
        return 0.5 * h * torch.sum(xm + u ** 2)

    def c(z):
        x, u = z[: N + 1], z[N + 1:]
        return (x[1:] - x[:-1]
                - 0.25 * h * (x[1:] + x[:-1]) - h * u)

    nv = 2 * N + 1
    x0 = np.zeros(nv)
    x0[0] = 1.0
    xl = np.full(nv, -INF)
    xu = np.full(nv, INF)
    xl[0] = xu[0] = 1.0
    nlp = nlp_from_functions(
        f"hager1_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(N), c_ub=np.zeros(N))
    # [x_0, (x_1, u_1), (x_2, u_2), ...]: row k touches x_{k-1}, x_k, u_k
    perm = np.concatenate([[0], np.stack([np.arange(1, N + 1),
                                          N + np.arange(1, N + 1)], 1).ravel()])
    starts = np.concatenate([[0], 2 * np.arange(1, N, dtype=np.int64) - 1])
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 4),
        jac_width=4))


@family("dtoc1", min_n=6)
def dtoc1(n):
    """Discrete-time optimal control (CUTEst DTOC1L-style, 2 states /
    1 control): min sum (y_t + 0.25)^4 + (u_t + 0.25)^4-like smooth costs
    with coupled linear dynamics."""
    T = max(2, n // 3)

    def split(z):
        u = z[:T]
        y = z[T:].reshape(T + 1, 2)
        return u, y

    def f(z):
        u, y = split(z)
        return torch.sum((u + 0.25) ** 4) + torch.sum((y + 0.25) ** 4)

    def c(z):
        u, y = split(z)
        y1, y2 = y[:, 0], y[:, 1]
        r1 = y1[1:] - (0.5 * y1[:-1] + 0.25 * y2[:-1] + 0.5 * u)
        r2 = y2[1:] - (0.25 * y1[:-1] + 0.5 * y2[:-1] - 0.25 * u ** 2)
        return torch.cat([r1, r2])

    nv = T + 2 * (T + 1)
    x0 = np.zeros(nv)
    xl = np.full(nv, -INF)
    xu = np.full(nv, INF)
    # initial state fixed at (1, -1)
    xl[T] = xu[T] = 1.0
    x0[T] = 1.0
    xl[T + 1] = xu[T + 1] = -1.0
    x0[T + 1] = -1.0
    nlp = nlp_from_functions(
        f"dtoc1_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(2 * T), c_ub=np.zeros(2 * T))
    # stage interleave (y_t1, y_t2, u_t): dynamics rows become width-5
    # windows (banded KKT)
    perm = np.empty(nv, dtype=np.int64)
    t_idx = np.arange(T + 1)
    perm[3 * t_idx] = T + 2 * t_idx          # y_t1
    perm[3 * t_idx + 1] = T + 1 + 2 * t_idx  # y_t2
    perm[3 * np.arange(T) + 2] = np.arange(T)  # u_t
    starts = np.concatenate([3 * np.arange(T, dtype=np.int64)] * 2)
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 5),
        jac_width=5))


@family("catena", min_n=9)
def catena(n):
    """Hanging chain (COPS 3 'chain' / CUTEst CATENA): the potential energy
    of K links of fixed length, endpoints pinned."""
    K = max(3, n // 2)
    L = 2.0 / K

    def split(z):
        pts = z.reshape(K - 1, 2)
        zero, one = z.new_zeros(1), z.new_ones(1)
        x = torch.cat([zero, pts[:, 0], one])
        y = torch.cat([zero, pts[:, 1], zero])
        return x, y

    def f(z):
        _, y = split(z)
        return torch.sum(0.5 * (y[1:] + y[:-1]))

    def c(z):
        x, y = split(z)
        return (x[1:] - x[:-1]) ** 2 + (y[1:] - y[:-1]) ** 2 - L ** 2

    nv = 2 * (K - 1)
    x0 = np.zeros(nv)
    x0[0::2] = np.linspace(0, 1, K + 1)[1:-1]
    x0[1::2] = -0.1
    starts = np.clip(2 * np.arange(K, dtype=np.int64) - 2, 0, max(nv - 4, 0))
    return nlp_from_functions(
        f"catena_n{nv}", f, c, x0=x0,
        c_lb=np.zeros(K), c_ub=np.zeros(K),
        structure=NLPStructure(hess_bandwidth=3, jac_starts=starts,
                               jac_width=min(4, nv)))


@family("sphere_proj", f_star=None)
def sphere_proj(n):
    """Projection onto the unit sphere: min 1/2||x - a||^2 s.t. ||x||^2 = 1.
    Analytic optimum f* = (||a|| - 1)^2 / 2."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n)
    cache: dict = {}

    def f(x):
        return 0.5 * torch.sum((x - const(cache, a, x)) ** 2)

    def c(x):
        return torch.stack([torch.sum(x ** 2) - 1.0])

    nlp = nlp_from_functions(
        f"sphere_proj_n{n}", f, c, x0=np.full(n, 1.0 / np.sqrt(n)),
        c_lb=[0.0], c_ub=[0.0])
    return nlp


# analytic optimum for sphere_proj: register with the exact f*
_FAMILIES["sphere_proj"] = (
    _FAMILIES["sphere_proj"][0],
    lambda n: 0.5 * (float(np.linalg.norm(
        np.random.default_rng(n).standard_normal(n))) - 1.0) ** 2,
    _FAMILIES["sphere_proj"][2], _FAMILIES["sphere_proj"][3],
    _FAMILIES["sphere_proj"][4])


@family("structqp", min_n=8)
def structqp(n):
    """Block-structured convex QP with linear equality constraints
    (CVXQP-class): banded SPD Hessian, sparse equality rows, box bounds."""
    rng = np.random.default_rng(7 + n)
    m = n // 4
    d = 1.0 + rng.uniform(0, 9, n)
    off = rng.uniform(-0.5, 0.5, n - 1)
    rows = rng.integers(0, n, (m, 3))
    coef = rng.uniform(0.5, 2.0, (m, 3))
    b = rng.uniform(0.5, 1.5, m)
    cache: dict = {}

    def f(x):
        dj = const(cache, d, x, name="d")
        offj = const(cache, off, x, name="off")
        return 0.5 * (torch.sum(dj * x ** 2)
                      + 2.0 * torch.sum(offj * x[:-1] * x[1:])) + torch.sum(x)

    def c(x):
        rj = const(cache, rows, x, torch.int64, "rows")
        return (torch.sum(x[rj] * const(cache, coef, x, name="coef"), dim=1)
                - const(cache, b, x, name="b"))

    return nlp_from_functions(
        f"structqp_n{n}", f, c, x0=np.full(n, 0.5),
        x_lb=np.full(n, -2.0), x_ub=np.full(n, 2.0),
        c_lb=np.zeros(m), c_ub=np.zeros(m))


@family("orthreg", min_n=6)
def orthreg(n):
    """Orthogonal regression onto an ellipse (CUTEst ORTHREGA-style):
    min sum ((xi-ai)^2 + (yi-bi)^2) s.t. each (xi, yi) on x^2 + 4 y^2 = 4."""
    K = max(2, (n + 1) // 2)
    rng = np.random.default_rng(n)
    t = rng.uniform(0, 2 * np.pi, K)
    a = 2.2 * np.cos(t) + 0.1 * rng.standard_normal(K)
    b = 1.1 * np.sin(t) + 0.1 * rng.standard_normal(K)
    cache: dict = {}

    def f(z):
        p = z.reshape(K, 2)
        aj = const(cache, a, z, name="a")
        bj = const(cache, b, z, name="b")
        return torch.sum((p[:, 0] - aj) ** 2 + (p[:, 1] - bj) ** 2)

    def c(z):
        p = z.reshape(K, 2)
        return p[:, 0] ** 2 + 4.0 * p[:, 1] ** 2 - 4.0

    x0 = np.stack([2.0 * np.cos(t), np.sin(t)], axis=1).ravel()
    return nlp_from_functions(
        f"orthreg_n{2 * K}", f, c, x0=x0,
        c_lb=np.zeros(K), c_ub=np.zeros(K),
        structure=NLPStructure(hess_bandwidth=1,
                               jac_starts=2 * np.arange(K, dtype=np.int64),
                               jac_width=2))


@family("elec", min_n=9)
def elec(n):
    """COPS 3 'elec': K point charges on the unit sphere minimizing the
    Coulomb energy (all pairs), K = n//3."""
    K = max(3, n // 3)
    triu_mask = np.triu(np.ones((K, K), dtype=bool), 1)
    cache: dict = {}

    def f(z):
        p = z.reshape(K, 3)
        mask = const(cache, triu_mask, z, torch.bool)
        d2 = torch.sum((p[:, None, :] - p[None, :, :]) ** 2, dim=-1)
        inv = 1.0 / torch.sqrt(torch.where(mask, d2, 1.0) + 1e-12)
        return torch.sum(torch.where(mask, inv, 0.0))

    def c(z):
        p = z.reshape(K, 3)
        return torch.sum(p ** 2, dim=1) - 1.0

    rng = np.random.default_rng(K)
    p0 = rng.standard_normal((K, 3))
    p0 /= np.linalg.norm(p0, axis=1, keepdims=True)
    return nlp_from_functions(
        f"elec_n{3 * K}", f, c, x0=p0.ravel(),
        c_lb=np.zeros(K), c_ub=np.zeros(K))


@family("gridpde", min_n=16)
def gridpde(n):
    """PDE-constrained-style grid QP (AUG2D-class): min 1/2||u - t||^2 +
    alpha/2||w||^2 s.t. 5-point Laplacian(u) = w + source on a g x g grid."""
    g = int(np.sqrt(n / 2))
    g = max(3, g)
    N = g * g
    h = 1.0 / (g + 1)
    ii, jj = np.meshgrid(np.arange(1, g + 1), np.arange(1, g + 1), indexing="ij")
    target = np.sin(np.pi * ii * h) * np.sin(np.pi * jj * h)
    cache: dict = {}

    def f(z):
        u, w = z[:N], z[N:]
        tj = const(cache, target.ravel(), z)
        return 0.5 * torch.sum((u - tj) ** 2) + 0.005 * torch.sum(w ** 2)

    def c(z):
        u, w = z[:N], z[N:]
        U = u.reshape(g, g)
        Up = pad(U, (1, 1, 1, 1))
        lap = (4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1]
               - Up[1:-1, :-2] - Up[1:-1, 2:]) / (h * h)
        return lap.ravel() - w

    nlp = nlp_from_functions(
        f"gridpde_n{2 * N}", f, c, x0=np.zeros(2 * N),
        c_lb=np.zeros(N), c_ub=np.zeros(N))
    # interleave (u_i, w_i); Laplacian rows span u_{i-g}..u_{i+g} plus w_i
    # -> width 4g+2 windows
    nv = 2 * N
    perm = np.empty(nv, dtype=np.int64)
    i_idx = np.arange(N)
    perm[2 * i_idx] = i_idx          # u_i
    perm[2 * i_idx + 1] = N + i_idx  # w_i
    w_win = min(4 * g + 2, nv)
    starts = np.clip(2 * (i_idx - g), 0, nv - w_win).astype(np.int64)
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=starts, jac_width=w_win))


@family("chainrosen_ineq", min_n=3)
def chainrosen_ineq(n):
    """Chained Rosenbrock with coupled inequality constraints and bounds."""
    def f(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    def c(x):
        a, b = x[:-1:2], x[1::2]
        return a ** 2 + b ** 2

    m = len(np.zeros(n)[:-1:2])
    return nlp_from_functions(
        f"chainrosen_ineq_n{n}", f, c, x0=np.full(n, 0.0),
        x_lb=np.full(n, -5.0), x_ub=np.full(n, 5.0),
        c_lb=np.full(m, -INF), c_ub=np.full(m, 4.0),
        structure=NLPStructure(hess_bandwidth=1,
                               jac_starts=2 * np.arange(m, dtype=np.int64),
                               jac_width=2))


@family("dblintegrator", min_n=9)
def dblintegrator(n):
    """Bounded-control double integrator to the origin (OPTCNTRL-class):
    min sum u^2 + 10 (p_T^2 + v_T^2), dynamics p' = v, v' = u, |u| <= 1,
    p(0)=1, v(0)=0."""
    T = max(3, n // 3)
    h = 1.0 / T

    def split(z):
        u = z[:T]
        p = z[T: 2 * T + 1]
        v = z[2 * T + 1:]
        return u, p, v

    def f(z):
        u, p, v = split(z)
        return h * torch.sum(u ** 2) + 10.0 * (p[-1] ** 2 + v[-1] ** 2)

    def c(z):
        u, p, v = split(z)
        r1 = p[1:] - p[:-1] - h * v[:-1]
        r2 = v[1:] - v[:-1] - h * u
        return torch.cat([r1, r2])

    nv = 3 * T + 2
    x0 = np.zeros(nv)
    xl = np.full(nv, -INF)
    xu = np.full(nv, INF)
    xl[:T] = -1.0
    xu[:T] = 1.0
    xl[T] = xu[T] = 1.0  # p(0) = 1
    x0[T] = 1.0
    xl[2 * T + 1] = xu[2 * T + 1] = 0.0  # v(0) = 0
    nlp = nlp_from_functions(
        f"dblintegrator_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(2 * T), c_ub=np.zeros(2 * T))
    # stage interleave (p_t, v_t, u_t) -> width-4 dynamics windows
    perm = np.empty(nv, dtype=np.int64)
    t_idx = np.arange(T + 1)
    perm[3 * t_idx] = T + t_idx              # p_t
    perm[3 * t_idx + 1] = 2 * T + 1 + t_idx  # v_t
    perm[3 * np.arange(T) + 2] = np.arange(T)  # u_t
    starts = np.concatenate([3 * np.arange(T, dtype=np.int64),
                             3 * np.arange(T, dtype=np.int64) + 1])
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 4),
        jac_width=4))


# ===========================================================================
# 16 further classic families from MGH-1981 / CUTE(st) / COPS 3.0,
# encoded from the published formulations
# ===========================================================================

@family("fletchcr", f_star=0.0)
def fletchcr(n):
    """CUTEst FLETCHCR (Fletcher's chained Rosenbrock variant):
    sum 100 (x_{i+1} - x_i + 1 - x_i^2)^2; f* = 0 at x = 1."""
    def f(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] + 1.0 - x[:-1] ** 2) ** 2)

    return nlp_from_functions(f"fletchcr_n{n}", f, None, x0=np.zeros(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("genrose", f_star=1.0)
def genrose(n):
    """CUTEst GENROSE (generalized Rosenbrock): 1 + sum 100(x_i - x_{i-1}^2)^2
    + (x_i - 1)^2; f* = 1 at x = 1; x0_i = i/(n+1)."""
    def f(x):
        return (1.0 + torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                + (x[1:] - 1.0) ** 2))

    x0 = np.arange(1, n + 1) / (n + 1.0)
    return nlp_from_functions(f"genrose_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


@family("dqdrtic", f_star=0.0, min_n=3)
def dqdrtic(n):
    """CUTEst DQDRTIC: sum_{i<=n-2} (x_i^2 + 100 x_{i+1}^2 + 100 x_{i+2}^2);
    separable convex quadratic, f* = 0; x0 = 3."""
    def f(x):
        return torch.sum(x[:-2] ** 2 + 100.0 * x[1:-1] ** 2 + 100.0 * x[2:] ** 2)

    return nlp_from_functions(f"dqdrtic_n{n}", f, None, x0=np.full(n, 3.0),
                              structure=NLPStructure(hess_bandwidth=2))


@family("nondia")
def nondia(n):
    """CUTEst NONDIA (Shanno's nondiagonal Rosenbrock variant):
    (x_1-1)^2 + sum_{i>=2} 100 (x_1 - x_i^2)^2; global f* = 0 at x = 1, but
    from the published start x0 = -1 a local method may stop at another
    first-order point (x ~ 0), so no f* is asserted."""
    def f(x):
        return (x[0] - 1.0) ** 2 + torch.sum(100.0 * (x[0] - x[1:] ** 2) ** 2)

    return nlp_from_functions(f"nondia_n{n}", f, None, x0=np.full(n, -1.0))


@family("denschnb", f_star=0.0, min_n=2)
def denschnb(n):
    """CUTEst DENSCHNB (extended Dennis-Schnabel B): pairwise separable
    sum (a-2)^2 + ((a-2) b)^2 + (b+1)^2 over pairs (a,b); f* = 0 at
    (2, -1)."""
    n -= n % 2

    def f(x):
        a, b = x[0::2], x[1::2]
        return torch.sum((a - 2.0) ** 2 + ((a - 2.0) * b) ** 2 + (b + 1.0) ** 2)

    return nlp_from_functions(f"denschnb_n{n}", f, None, x0=np.ones(n))


@family("powergq", f_star=0.0)
def powergq(n):
    """POWER-style graded convex quadratic: sum (i * x_i)^2; f* = 0.
    Condition number n^2 — stresses termination scaling."""
    w = np.arange(1, n + 1, dtype=float)
    cache: dict = {}

    def f(x):
        return torch.sum((const(cache, w, x) * x) ** 2)

    return nlp_from_functions(f"powergq_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=0))


@family("dixmaana", f_star=1.0, min_n=6)
def dixmaana(n):
    """CUTEst DIXMAANA (Dixon-Maany, variant A: alpha=1, beta=0, gamma=1/8,
    delta=1/8, all exponents 0): f* = 1 at x = 0; x0 = 2."""
    m = n // 3

    def f(x):
        t1 = torch.sum(x ** 2)
        t3 = torch.sum(x[: 2 * m] ** 2 * x[m: 3 * m] ** 4)
        t4 = torch.sum(x[:m] * x[2 * m: 3 * m])
        return 1.0 + t1 + 0.125 * t3 + 0.125 * t4

    return nlp_from_functions(f"dixmaana_n{n}", f, None, x0=np.full(n, 2.0))


@family("morebv", f_star=0.0)
def morebv(n):
    """MGH #28 / CUTEst MOREBV: discretized two-point boundary value problem
    (least squares), f* = 0; x0_i = t_i (t_i - 1)."""
    h = 1.0 / (n + 1)
    t_np = np.arange(1, n + 1) * h
    cache: dict = {}

    def f(x):
        t = const(cache, t_np, x)
        xp = pad(x, (1, 1))
        r = (2.0 * x - xp[:-2] - xp[2:]
             + 0.5 * h * h * (x + t + 1.0) ** 3)
        return torch.sum(r ** 2)

    x0 = np.arange(1, n + 1) * h
    x0 = x0 * (x0 - 1.0)
    return nlp_from_functions(f"morebv_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=2))


@family("trigmgh", f_star=0.0)
def trigmgh(n):
    """MGH #26 trigonometric function (least squares): f_i = n - sum_j cos x_j
    + i (1 - cos x_i) - sin x_i; f* = 0; x0 = 1/n."""
    idx_np = np.arange(1, n + 1, dtype=float)
    cache: dict = {}

    def f(x):
        idx = const(cache, idx_np, x)
        s = torch.sum(torch.cos(x))
        r = n - s + idx * (1.0 - torch.cos(x)) - torch.sin(x)
        return torch.sum(r ** 2)

    return nlp_from_functions(f"trigmgh_n{n}", f, None, x0=np.full(n, 1.0 / n))


@family("eg2")
def eg2(n):
    """CUTEst EG2: sum_{i<n} sin(x_1 + x_i^2 - 1) + 0.5 sin(x_n^2);
    highly nonconvex, no exact f* (≈ -(n-1))."""
    def f(x):
        return (torch.sum(torch.sin(x[0] + x[:-1] ** 2 - 1.0))
                + 0.5 * torch.sin(x[-1] ** 2))

    return nlp_from_functions(f"eg2_n{n}", f, None, x0=np.zeros(n))


@family("curly10", min_n=11)
def curly10(n):
    """CUTEst CURLY10: q_i = sum_{j=i}^{min(i+10,n)} x_j,
    f = sum q_i (q_i^2 (q_i^2 - 20) - 0.1); banded nonconvex."""
    K = 10
    hi = np.minimum(np.arange(n) + K + 1, n)
    cache: dict = {}

    def f(x):
        S0 = pad(torch.cumsum(x, 0), (1, 0))
        q = S0[const(cache, hi, x, torch.int64)] - S0[:n]
        return torch.sum(q * (q ** 2 * (q ** 2 - 20.0) - 0.1))

    x0 = 1e-4 * np.arange(1, n + 1) / (n + 1)
    return nlp_from_functions(f"curly10_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=10))


@family("penalty2", min_n=2)
def penalty2(n):
    """MGH #24 / CUTEst PENALTY2: a = 1e-5, exponential residuals plus the
    weighted-norm penalty ((sum (n-j+1) x_j^2) - 1)^2; x0 = 0.5."""
    a = 1e-5
    i2 = np.arange(2, n + 1)
    y = np.exp(i2 / 10.0) + np.exp((i2 - 1) / 10.0)
    w = np.arange(n, 0, -1, dtype=float)
    em = float(np.exp(-0.1))
    cache: dict = {}

    def f(x):
        yj = const(cache, y, x, name="y")
        wj = const(cache, w, x, name="w")
        e = torch.exp(x / 10.0)
        r1 = a * torch.sum((e[1:] + e[:-1] - yj) ** 2)
        r2 = a * torch.sum((e[1:] - em) ** 2)
        r3 = (torch.sum(wj * x ** 2) - 1.0) ** 2
        return (x[0] - 0.2) ** 2 + r1 + r2 + r3

    return nlp_from_functions(f"penalty2_n{n}", f, None, x0=np.full(n, 0.5))


@family("noncvxun", min_n=4)
def noncvxun(n):
    """CUTEst NONCVXUN: f = sum g(x_i + x_{p_i} + x_{q_i}) with
    g(t) = t^2 + 4 cos(t), p_i = 2i mod n, q_i = 3i mod n; nonconvex
    with many local minima."""
    p = (2 * (np.arange(n) + 1)) % n
    q = (3 * (np.arange(n) + 1)) % n
    cache: dict = {}

    def f(x):
        t = (x + x[const(cache, p, x, torch.int64, "p")]
             + x[const(cache, q, x, torch.int64, "q")])
        return torch.sum(t ** 2 + 4.0 * torch.cos(t))

    x0 = np.arange(1, n + 1, dtype=float)
    return nlp_from_functions(f"noncvxun_n{n}", f, None, x0=x0)


@family("chandheq_ls", f_star=0.0)
def chandheq_ls(n):
    """Chandrasekhar H-equation (CUTEst CHANDHEQ), c = 0.9, as least
    squares: r_i = x_i - 1 - (c/2) x_i sum_j w mu_i/(mu_i+mu_j) x_j."""
    mu = (np.arange(1, n + 1) - 0.5) / n
    A = (mu[:, None] / (mu[:, None] + mu[None, :])) / n
    cache: dict = {}

    def f(x):
        r = x - 1.0 - 0.45 * x * (const(cache, A, x) @ x)
        return torch.sum(r ** 2)

    return nlp_from_functions(f"chandheq_ls_n{n}", f, None, x0=np.ones(n))


@family("torsion", min_n=16, sizes=(100, 1000))
def torsion(n):
    """Elastic-plastic torsion (CUTEst TORSION1-style): min 1/2 u^T K u
    - c h^2 sum u on a g x g interior grid, |u_ij| <= dist(ij, boundary);
    c = 5."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)

    def f(u):
        U = u.reshape(g, g)
        Up = pad(U, (1, 1, 1, 1))
        lap = 4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1] - Up[1:-1, :-2] - Up[1:-1, 2:]
        return 0.5 * torch.sum(U * lap) - 5.0 * h * h * torch.sum(U)

    ii, jj = np.meshgrid(np.arange(1, g + 1), np.arange(1, g + 1), indexing="ij")
    dist = h * np.minimum(np.minimum(ii, jj), np.minimum(g + 1 - ii, g + 1 - jj))
    return nlp_from_functions(
        f"torsion_n{g * g}", f, None, x0=np.zeros(g * g),
        x_lb=-dist.ravel(), x_ub=dist.ravel(),
        structure=NLPStructure(hess_bandwidth=g))


@family("minsurf", min_n=16, sizes=(100, 1000))
def minsurf(n):
    """Minimal surface (COPS 3.0 / CUTEst MINSURF-class): min sum h^2
    sqrt(1 + |forward-difference gradient|^2) over a g x g grid of free
    heights; boundary fixed to sin(pi s) on two opposite edges."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)
    s = np.arange(0, g + 2) * h
    bnd = np.sin(np.pi * s)
    cache: dict = {}

    def f(u):
        U = u.reshape(g, g)
        edge = const(cache, bnd, u)[None, :]
        # the first and last rows of the padded grid are the fixed boundary
        Up = torch.cat([edge, pad(U, (1, 1)), edge], 0)
        dx = (Up[1:, :] - Up[:-1, :]) / h
        dy = (Up[:, 1:] - Up[:, :-1]) / h
        area = torch.sqrt(1.0 + dx[:, :-1] ** 2 + dy[:-1, :] ** 2)
        return h * h * torch.sum(area)

    return nlp_from_functions(
        f"minsurf_n{g * g}", f, None, x0=np.full(g * g, 0.5),
        structure=NLPStructure(hess_bandwidth=g))


@family("bratu2d_ls", f_star=0.0, min_n=16, sizes=(100, 1000))
def bratu2d_ls(n):
    """2-D Bratu problem -lap(u) = lam e^u (lam = 4 < critical 6.81), as a
    least-squares nonlinear system on a g x g interior grid; f* = 0."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)
    lam = 4.0

    def f(u):
        U = u.reshape(g, g)
        Up = pad(U, (1, 1, 1, 1))
        lap = 4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1] - Up[1:-1, :-2] - Up[1:-1, 2:]
        r = lap - h * h * lam * torch.exp(U)
        return torch.sum(r ** 2)

    return nlp_from_functions(f"bratu2d_ls_n{g * g}", f, None,
                              x0=np.zeros(g * g),
                              structure=NLPStructure(hess_bandwidth=2 * g))


@family("clnlbeam", min_n=9)
def clnlbeam(n):
    """COPS 3.0 / CUTEst CLNLBEAM: nonlinear beam optimal control,
    min sum h/2 (u_i^2 + u_{i+1}^2) + alpha h/2 (cos t_i + cos t_{i+1}),
    s.t. trapezoidal dynamics x' = sin t, t' = u; |t| <= 1,
    |x| <= 0.05, endpoints pinned at 0; alpha = 350."""
    N = max(2, n // 3)
    h = 1.0 / N
    alpha = 350.0

    def split(z):
        t = z[: N + 1]
        x = z[N + 1: 2 * (N + 1)]
        u = z[2 * (N + 1):]
        return t, x, u

    def f(z):
        t, x, u = split(z)
        return torch.sum(0.5 * h * (u[1:] ** 2 + u[:-1] ** 2)
                         + 0.5 * alpha * h * (torch.cos(t[1:]) + torch.cos(t[:-1])))

    def c(z):
        t, x, u = split(z)
        r1 = x[1:] - x[:-1] - 0.5 * h * (torch.sin(t[1:]) + torch.sin(t[:-1]))
        r2 = t[1:] - t[:-1] - 0.5 * h * (u[1:] + u[:-1])
        return torch.cat([r1, r2])

    nv = 3 * (N + 1)
    ih = np.arange(N + 1) * h
    x0 = np.concatenate([0.05 * np.cos(np.pi * ih),        # t init
                         0.025 * np.sin(np.pi * ih),       # x init
                         np.zeros(N + 1)])                 # u init
    xl = np.concatenate([np.full(N + 1, -1.0), np.full(N + 1, -0.05),
                         np.full(N + 1, -INF)])
    xu = np.concatenate([np.full(N + 1, 1.0), np.full(N + 1, 0.05),
                         np.full(N + 1, INF)])
    for k in (0, N, N + 1, 2 * N + 1):  # t and x endpoints pinned
        xl[k] = xu[k] = 0.0
        x0[k] = 0.0
    nlp = nlp_from_functions(
        f"clnlbeam_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(2 * N), c_ub=np.zeros(2 * N))
    # stage interleave (t_k, x_k, u_k) -> width-6 dynamics windows
    perm = np.empty(nv, dtype=np.int64)
    k_idx = np.arange(N + 1)
    perm[3 * k_idx] = k_idx                  # t_k
    perm[3 * k_idx + 1] = (N + 1) + k_idx    # x_k
    perm[3 * k_idx + 2] = 2 * (N + 1) + k_idx  # u_k
    starts = np.concatenate([3 * np.arange(N, dtype=np.int64)] * 2)
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 6),
        jac_width=6))


# ===========================================================================
# control / collocation and chained equality families (uno_tpu's
# library_r4.py: registered there, after the mgh and .nl problems)
# ===========================================================================

_STEERING_FSTAR = {26: 0.570442085, 106: 0.555179894, 306: 0.554638900}


@r4_family("steering", f_star=_STEERING_FSTAR.get, sizes=(26, 106, 306), min_n=26)
def steering(n):
    """COPS 3.0 'Particle Steering': min t_f, x1'=x3, x2'=x4, x3' = a cos u,
    x4' = a sin u (a=100), |u| <= pi/2, x(0)=0, x2(tf)=5, x3(tf)=45,
    x4(tf)=0; trapezoidal with free final time.  Variables [u_0..u_N,
    x1_0.., x2_0.., x3_0.., x4_0.., tf], n = 5(N+1)+1."""
    N = max(4, (n - 6) // 5)
    a = 100.0
    nv = 5 * (N + 1) + 1

    def c(z):
        u = z[: N + 1]
        xs = z[N + 1: -1].reshape(4, N + 1)
        h = z[-1] / N
        x1, x2, x3, x4 = xs[0], xs[1], xs[2], xs[3]
        d1 = x1[1:] - x1[:-1] - 0.5 * h * (x3[1:] + x3[:-1])
        d2 = x2[1:] - x2[:-1] - 0.5 * h * (x4[1:] + x4[:-1])
        d3 = x3[1:] - x3[:-1] - 0.5 * h * a * (torch.cos(u[1:]) + torch.cos(u[:-1]))
        d4 = x4[1:] - x4[:-1] - 0.5 * h * a * (torch.sin(u[1:]) + torch.sin(u[:-1]))
        return torch.cat([d1, d2, d3, d4])

    lb = np.full(nv, -INF)
    ub = np.full(nv, INF)
    lb[: N + 1] = -np.pi / 2
    ub[: N + 1] = np.pi / 2
    lb[-1] = 0.1
    for si in range(4):                       # x(0) = 0
        i = N + 1 + si * (N + 1)
        lb[i] = ub[i] = 0.0
    for si, val in ((1, 5.0), (2, 45.0), (3, 0.0)):   # final conditions
        i = N + 1 + si * (N + 1) + N
        lb[i] = ub[i] = val
    t = np.arange(N + 1) / N
    z0 = np.zeros(nv)
    z0[2 * (N + 1): 3 * (N + 1)] = 5.0 * t
    z0[3 * (N + 1): 4 * (N + 1)] = 45.0 * t
    z0[-1] = 1.0
    return nlp_from_functions(f"steering_n{nv}", lambda z: z[-1], c, x0=z0,
                              x_lb=lb, x_ub=ub, c_lb=np.zeros(4 * N),
                              c_ub=np.zeros(4 * N))


_VDP_FSTAR = {15: 3.568248177, 63: 2.916942286, 183: 2.873293874}


@r4_family("vanderpol_ctrl", f_star=_VDP_FSTAR.get, sizes=(15, 63, 183), min_n=15)
def vanderpol_ctrl(n):
    """Van der Pol tracking control: min int_0^5 (x1^2 + x2^2 + u^2) dt,
    x1' = x2, x2' = (1-x1^2) x2 - x1 + u, x(0) = (1, 0), u in [-0.75, 1];
    trapezoidal, n = 3(N+1)."""
    N = max(4, n // 3 - 1)
    h = 5.0 / N
    nv = 3 * (N + 1)

    def unpack(z):
        return z[: N + 1], z[N + 1: 2 * (N + 1)], z[2 * (N + 1):]

    def f(z):
        x1, x2, u = unpack(z)
        g = x1 ** 2 + x2 ** 2 + u ** 2
        return 0.5 * h * torch.sum(g[1:] + g[:-1])

    def c(z):
        x1, x2, u = unpack(z)
        f1 = x2
        f2 = (1.0 - x1 ** 2) * x2 - x1 + u
        d1 = x1[1:] - x1[:-1] - 0.5 * h * (f1[1:] + f1[:-1])
        d2 = x2[1:] - x2[:-1] - 0.5 * h * (f2[1:] + f2[:-1])
        return torch.cat([d1, d2])

    lb = np.full(nv, -INF)
    ub = np.full(nv, INF)
    lb[2 * (N + 1):] = -0.75
    ub[2 * (N + 1):] = 1.0
    lb[0] = ub[0] = 1.0
    lb[N + 1] = ub[N + 1] = 0.0
    z0 = np.zeros(nv)
    z0[0] = 1.0
    return nlp_from_functions(f"vanderpol_ctrl_n{nv}", f, c, x0=z0,
                              x_lb=lb, x_ub=ub, c_lb=np.zeros(2 * N),
                              c_ub=np.zeros(2 * N))


@r4_family("chwood_eq", f_star=0.0, sizes=(12, 100, 1000), min_n=8)
def chwood_eq(n):
    """Chained Wood objective with one equality per 4-block through the
    minimizer x* = 1 (x_j x_{j+1} + x_{j+2} - x_{j+3} - 1 = 0); f* = 0."""
    n = 4 * max(2, n // 4)

    def f(x):
        b = x.reshape(-1, 4)
        x1, x2, x3, x4 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        return torch.sum(100.0 * (x2 - x1 ** 2) ** 2 + (1.0 - x1) ** 2
                         + 90.0 * (x4 - x3 ** 2) ** 2 + (1.0 - x3) ** 2
                         + 10.0 * (x2 + x4 - 2.0) ** 2
                         + 0.1 * (x2 - x4) ** 2)

    def c(x):
        b = x.reshape(-1, 4)
        return b[:, 0] * b[:, 1] + b[:, 2] - b[:, 3] - 1.0

    m = n // 4
    x0 = np.tile([-3.0, -1.0, -3.0, -1.0], m)
    return nlp_from_functions(f"chwood_eq_n{n}", f, c, x0=x0,
                              c_lb=np.zeros(m), c_ub=np.zeros(m))


@r4_family("chpowellsg_eq", f_star=0.0, sizes=(12, 100, 1000), min_n=8)
def chpowellsg_eq(n):
    """Chained Powell singular objective with one equality per 4-block
    through the minimizer x*=0 (c: x_j + x_{j+1}^2 - x_{j+2}^3 = 0);
    f* = 0 analytic; the singular Hessian at the solution is preserved."""
    n = 4 * max(2, n // 4)

    def f(x):
        b = x.reshape(-1, 4)
        x1, x2, x3, x4 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        return torch.sum((x1 + 10.0 * x2) ** 2 + 5.0 * (x3 - x4) ** 2
                         + (x2 - 2.0 * x3) ** 4 + 10.0 * (x1 - x4) ** 4)

    def c(x):
        b = x.reshape(-1, 4)
        return b[:, 0] + b[:, 1] ** 2 - b[:, 2] ** 3

    m = n // 4
    x0 = np.tile([3.0, -1.0, 0.0, 1.0], m)
    return nlp_from_functions(f"chpowellsg_eq_n{n}", f, c, x0=x0,
                              c_lb=np.zeros(m), c_ub=np.zeros(m))


_BROYDN_EQ_FSTAR = {10: 0.537660259, 30: 1.792200862, 100: 5.914262845}


@r4_family("broydn_eq", f_star=_BROYDN_EQ_FSTAR.get, sizes=(10, 30, 100), min_n=5)
def broydn_eq(n):
    """sum (x_i - 1)^2 subject to Broyden-tridiagonal equality rows on every
    third index ((3-2x_k) x_k - x_{k-1} - 2 x_{k+1} + 1 = 0)."""
    ks = np.arange(1, n - 1, 3)
    cache: dict = {}

    def f(x):
        return torch.sum((x - 1.0) ** 2)

    def c(x):
        k = const(cache, ks, x, torch.int64)
        xk = x[k]
        return (3.0 - 2.0 * xk) * xk - x[k - 1] - 2.0 * x[k + 1] + 1.0

    x0 = np.full(n, -1.0)
    return nlp_from_functions(f"broydn_eq_n{n}", f, c, x0=x0,
                              c_lb=np.zeros(ks.size), c_ub=np.zeros(ks.size))


_reg_all()
