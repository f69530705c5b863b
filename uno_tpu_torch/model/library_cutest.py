"""Scalable structured problem families in torch: copies of uno_tpu's
(uno_tpu/model/library_cutest.py and the control and chained families of
uno_tpu/model/library_r4.py), under their names, sizes and optima.

Most declare an NLPStructure (a banded Hessian, windowed Jacobian rows) and
take the banded KKT backend under kkt_formulation="auto"; hager1 is
interleaved by stage at build time; steering, vanderpol_ctrl, chwood_eq
and broydn_eq declare none (auto_permute's detection or the sparse backend
finds theirs); elec and chandheq_ls are all-pairs coupled and stay dense.

Instances register as "<family>_n<N>" with N the built dimension, for the
sizes uno_tpu registers (10, 100 and 1000; the control families their own;
30 and 300 for the families uno_tpu adds at mid size), so `get_problem`
finds them by uno_tpu's keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uno_tpu_torch.model import transforms
from uno_tpu_torch.model.nlp import INF, NLP, NLPStructure, const, nlp_from_functions

SIZES = (10, 100, 1000)
# uno_tpu's mid-size instances of these families (library_r4._EXTRA_SIZES)
EXTRA_SIZES = (30, 300)
EXTRA_SIZE_FAMILIES = ("srosenbr", "biggsb1", "lukvle1", "lukvli1",
                       "chainrosen_ineq", "catena")

_FAMILIES: dict = {}
# key -> (builder of no arguments, f_star)
REGISTRY: dict = {}


def family(name, f_star=None, sizes=SIZES, min_n=2):
    """Register a family builder n -> NLP.  f_star: None, a constant, or a
    callable n -> value."""
    def deco(builder):
        _FAMILIES[name] = (builder, f_star, sizes, min_n)
        return builder
    return deco


def cutest_problem(name: str, n: int) -> NLP:
    return _FAMILIES[name][0](n)


def _reg_all():
    """Every (family, size) instance under the key of its BUILT dimension
    (builders snap n to their structure), then the mid sizes of
    EXTRA_SIZE_FAMILIES, skipping keys already there, as uno_tpu does."""
    def reg(name, n, f_star):
        key = f"{name}_n{cutest_problem(name, n).n}"
        if key not in REGISTRY:
            fs = f_star(n) if callable(f_star) else f_star
            REGISTRY[key] = (lambda name=name, n=n: cutest_problem(name, n), fs)

    for name, (_, f_star, sizes, min_n) in _FAMILIES.items():
        for n in sizes:
            if n >= min_n:
                reg(name, n, f_star)
    for name in EXTRA_SIZE_FAMILIES:
        _, f_star, _, min_n = _FAMILIES[name]
        for n in EXTRA_SIZES:
            if n >= min_n:
                reg(name, n, f_star)


# ===========================================================================
# unconstrained and bound-constrained
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


# ===========================================================================
# constrained
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


# ===========================================================================
# control / collocation and chained equality families (library_r4.py)
# ===========================================================================

_STEERING_FSTAR = {26: 0.570442085, 106: 0.555179894, 306: 0.554638900}


@family("steering", f_star=_STEERING_FSTAR.get, sizes=(26, 106, 306), min_n=26)
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


@family("vanderpol_ctrl", f_star=_VDP_FSTAR.get, sizes=(15, 63, 183), min_n=15)
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


@family("chwood_eq", f_star=0.0, sizes=(12, 100, 1000), min_n=8)
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


_BROYDN_EQ_FSTAR = {10: 0.537660259, 30: 1.792200862, 100: 5.914262845}


@family("broydn_eq", f_star=_BROYDN_EQ_FSTAR.get, sizes=(10, 30, 100), min_n=5)
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
