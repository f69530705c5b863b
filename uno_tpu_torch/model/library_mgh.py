"""The widening of uno_tpu's corpus toward the CUTEst-429 surface, in
torch: a copy of uno_tpu/model/library_mgh.py under the same keys and
optima.

* the More-Garbow-Hillstrom (1981) nonlinear least-squares collection, with
  the paper's certified optimal values;
* classic smooth 2-variable test functions (Dixon-Szego / CUTE set);
* classic equality/inequality-constrained problems (Maratos, Boggs-Tolle,
  spring and pressure-vessel design);
* COPS 3.0 largest small polygon;
* further scalable chained families (Dixon-Price, Levy, DIXON3DQ, extended
  Himmelblau/Beale) with banded structure declarations.

The data tables are numpy arrays (uno_tpu computes some of them with XLA at
import; numpy's exp, log and pow agree with it to the last ulp or so).
"""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.model.library import register
from uno_tpu_torch.model.nlp import INF, NLPStructure, const, nlp_from_functions

# the module's numpy tables on each device and dtype they are used at
_CONSTS: dict = {}


def _on(x, arr):
    """The module-level numpy table `arr` as a tensor on x's device and of
    its dtype, made once (the table lives as long as the module, so its id
    names it)."""
    return const(_CONSTS, arr, x, name=str(id(arr)))


def _ls(name, resid, x0, f_star, local_optima=(), x_lb=None, x_ub=None):
    """Register a least-squares problem  min sum r(x)^2."""
    @register(name, f_star=f_star, local_optima=local_optima)
    def _build(resid=resid, x0=x0):
        def f(x):
            r = resid(x)
            return torch.sum(r * r)
        return nlp_from_functions(name, f, None, x0=np.asarray(x0, float),
                                  x_lb=x_lb, x_ub=x_ub)
    return _build


# ---------------------------------------------------------------------------
# MGH 1981 fixed-size least squares (problem numbers from the paper)
# ---------------------------------------------------------------------------

_ls("rosenbrock", lambda x: torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]]),
    [-1.2, 1.0], 0.0)                                             # MGH 1

_ls("powell_bs",
    lambda x: torch.stack([1e4 * x[0] * x[1] - 1.0,
                           torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001]),
    [0.0, 1.0], 0.0)                                              # MGH 3

_ls("brown_bs",
    lambda x: torch.stack([x[0] - 1e6, x[1] - 2e-6, x[0] * x[1] - 2.0]),
    [1.0, 1.0], 0.0)                                              # MGH 4

_ls("beale",
    lambda x: torch.stack([1.5 - x[0] * (1.0 - x[1]),
                           2.25 - x[0] * (1.0 - x[1] ** 2),
                           2.625 - x[0] * (1.0 - x[1] ** 3)]),
    [1.0, 1.0], 0.0)                                              # MGH 5

_I10 = np.arange(1.0, 11.0)


def _jensam(x):
    i = _on(x, _I10)
    return 2.0 + 2.0 * i - (torch.exp(i * x[0]) + torch.exp(i * x[1]))


_ls("jensam", _jensam, [0.3, 0.4], 124.362)                       # MGH 6


@register("helical", f_star=0.0)
def helical():                                                    # MGH 7
    def f(x):
        theta = torch.atan2(x[1], x[0]) / (2.0 * np.pi)
        r = torch.stack([10.0 * (x[2] - 10.0 * theta),
                         10.0 * (torch.sqrt(x[0] ** 2 + x[1] ** 2) - 1.0),
                         x[2]])
        return torch.sum(r * r)
    return nlp_from_functions("helical", f, None, x0=np.array([-1.0, 0.0, 0.0]))


_BARD_Y = np.array([0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39,
                    0.37, 0.58, 0.73, 0.96, 1.34, 2.10, 4.39])
_BARD_U = np.arange(1.0, 16.0)
_BARD_V = 16.0 - _BARD_U
_BARD_W = np.minimum(_BARD_U, _BARD_V)


def _bard(x):
    u, v, w = _on(x, _BARD_U), _on(x, _BARD_V), _on(x, _BARD_W)
    return _on(x, _BARD_Y) - (x[0] + u / (v * x[1] + w * x[2]))


_ls("bard", _bard, [1.0, 1.0, 1.0], 8.21487e-3,
    local_optima=(17.4286,))                                      # MGH 8

_GAUSS_Y = np.array([0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420,
                     0.3521, 0.3989, 0.3521, 0.2420, 0.1295, 0.0540,
                     0.0175, 0.0044, 0.0009])
_GAUSS_T = (8.0 - np.arange(1.0, 16.0)) / 2.0


def _gaussian(x):
    t = _on(x, _GAUSS_T)
    return x[0] * torch.exp(-x[1] * (t - x[2]) ** 2 / 2.0) - _on(x, _GAUSS_Y)


_ls("gaussian", _gaussian, [0.4, 1.0, 0.0], 1.12793e-8)           # MGH 9

_MEYER_Y = np.array([34780.0, 28610.0, 23650.0, 19630.0, 16370.0, 13720.0,
                     11540.0, 9744.0, 8261.0, 7030.0, 6005.0, 5147.0,
                     4427.0, 3820.0, 3307.0, 2872.0])
_MEYER_T = 45.0 + 5.0 * np.arange(1.0, 17.0)
_ls("meyer",
    lambda x: (x[0] * torch.exp(x[1] / (_on(x, _MEYER_T) + x[2]))
               - _on(x, _MEYER_Y)),
    [0.02, 4000.0, 250.0], 87.9458)                               # MGH 10

_GULF_T = np.arange(1.0, 100.0) / 100.0
_GULF_Y = 25.0 + (-50.0 * np.log(_GULF_T)) ** (2.0 / 3.0)


def _gulf(x):
    # |d| as a select, whose derivative at 0 is +1 as jnp.abs's is (torch.abs
    # gives 0); maximum, not clamp: at the tie it passes half the derivative,
    # as jnp.maximum does
    d = _on(x, _GULF_Y) - x[1]
    return (torch.exp(-torch.where(d >= 0, d, -d) ** x[2]
                      / torch.maximum(x[0], torch.full_like(x[0], 1e-12)))
            - _on(x, _GULF_T))


_ls("gulf", _gulf, [5.0, 2.5, 0.15], 0.0)                         # MGH 11

_BOX_T = 0.1 * np.arange(1.0, 11.0)


def _box3d(x):
    t = _on(x, _BOX_T)
    return (torch.exp(-t * x[0]) - torch.exp(-t * x[1])
            - x[2] * (torch.exp(-t) - torch.exp(-10.0 * t)))


_ls("box3d", _box3d, [0.0, 10.0, 20.0], 0.0)                      # MGH 12

_KOW_Y = np.array([0.1957, 0.1947, 0.1735, 0.1600, 0.0844, 0.0627,
                   0.0456, 0.0342, 0.0323, 0.0235, 0.0246])
_KOW_U = np.array([4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1,
                   0.0833, 0.0714, 0.0625])


def _kowosb(x):
    u = _on(x, _KOW_U)
    return _on(x, _KOW_Y) - x[0] * u * (u + x[1]) / (u ** 2 + u * x[2] + x[3])


_ls("kowosb", _kowosb, [0.25, 0.39, 0.415, 0.39], 3.07505e-4,
    local_optima=(1.02734e-3,))                                   # MGH 15

_BD_T = np.arange(1.0, 21.0) / 5.0


def _brown_den(x):
    t = _on(x, _BD_T)
    return ((x[0] + t * x[1] - torch.exp(t)) ** 2
            + (x[2] + x[3] * torch.sin(t) - torch.cos(t)) ** 2)


_ls("brown_den", _brown_den, [25.0, 5.0, -5.0, -1.0], 85822.2)   # MGH 16

_OSB1_Y = np.array([0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881,
                    0.850, 0.818, 0.784, 0.751, 0.718, 0.685, 0.658,
                    0.628, 0.603, 0.580, 0.558, 0.538, 0.522, 0.506,
                    0.490, 0.478, 0.467, 0.457, 0.448, 0.438, 0.431,
                    0.424, 0.420, 0.414, 0.411, 0.406])
_OSB1_T = 10.0 * np.arange(0.0, 33.0)


def _osborne1(x):
    t = _on(x, _OSB1_T)
    return _on(x, _OSB1_Y) - (x[0] + x[1] * torch.exp(-t * x[3])
                              + x[2] * torch.exp(-t * x[4]))


_ls("osborne1", _osborne1, [0.5, 1.5, -1.0, 0.01, 0.02],
    5.46489e-5)                                                   # MGH 17

_BIGGS_T = 0.1 * np.arange(1.0, 14.0)
_BIGGS_Y = np.exp(-_BIGGS_T) - 5.0 * np.exp(-10.0 * _BIGGS_T) \
    + 3.0 * np.exp(-4.0 * _BIGGS_T)


def _biggs6(x):
    t = _on(x, _BIGGS_T)
    return (x[2] * torch.exp(-t * x[0]) - x[3] * torch.exp(-t * x[1])
            + x[5] * torch.exp(-t * x[4]) - _on(x, _BIGGS_Y))


_ls("biggs6", _biggs6, [1.0, 2.0, 1.0, 1.0, 1.0, 1.0], 0.0,
    local_optima=(5.65565e-3,))                                   # MGH 18

_OSB2_Y = np.array([
    1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847, 0.786, 0.725,
    0.746, 0.679, 0.608, 0.655, 0.616, 0.606, 0.602, 0.626, 0.651, 0.724,
    0.649, 0.649, 0.694, 0.644, 0.624, 0.661, 0.612, 0.558, 0.533, 0.495,
    0.500, 0.423, 0.395, 0.375, 0.372, 0.391, 0.396, 0.405, 0.428, 0.429,
    0.523, 0.562, 0.607, 0.653, 0.672, 0.708, 0.633, 0.668, 0.645, 0.632,
    0.591, 0.559, 0.597, 0.625, 0.739, 0.710, 0.729, 0.720, 0.636, 0.581,
    0.428, 0.292, 0.162, 0.098, 0.054])
_OSB2_T = np.arange(0.0, 65.0) / 10.0


def _osborne2(x):
    t = _on(x, _OSB2_T)
    return _on(x, _OSB2_Y) - (x[0] * torch.exp(-t * x[4])
                              + x[1] * torch.exp(-(t - x[8]) ** 2 * x[5])
                              + x[2] * torch.exp(-(t - x[9]) ** 2 * x[6])
                              + x[3] * torch.exp(-(t - x[10]) ** 2 * x[7]))


_ls("osborne2", _osborne2,
    [1.3, 0.65, 0.65, 0.7, 0.6, 3.0, 5.0, 7.0, 2.0, 4.5, 5.5],
    4.01377e-2)                                                   # MGH 19


def _watson(n, f_star):
    name = f"watson{n}"

    @register(name, f_star=f_star)
    def _build(n=n):
        t = np.arange(1.0, 30.0) / 29.0
        j = np.arange(n, dtype=np.float64)
        tp = t[:, None] ** j[None, :]                  # t^(j-1) grid
        dp = tp[:, :-1] * (j[1:])[None, :]              # d/dt powers
        cache: dict = {}

        def f(x):
            s2 = const(cache, tp, x, name="tp") @ x    # sum x_j t^{j-1}
            s1 = const(cache, dp, x, name="dp") @ x[1:]
            r = torch.cat([s1 - s2 ** 2 - 1.0,
                           torch.stack([x[0], x[1] - x[0] ** 2 - 1.0])])
            return torch.sum(r * r)
        return nlp_from_functions(name, f, None, x0=np.zeros(n))
    return _build


_watson(6, 2.28767e-3)                                            # MGH 20
_watson(9, 1.39976e-6)
_watson(12, 4.72238e-10)


def _clip_as_jnp(v, lo, hi):
    """jnp.clip(v, lo, hi) with the derivative JAX gives it: the incoming
    derivative times 1 inside the bounds, 1/2 on one, 0 beyond, as a
    product, so that an infinite one (acos' at +-1) makes NaN beyond the
    bounds, where torch.clamp's masked backward makes 0."""
    inside = ((v > lo) & (v < hi)).to(v.dtype)
    on_bound = ((v == lo) | (v == hi)).to(v.dtype)
    weight = (inside + 0.5 * on_bound).detach()
    return torch.clamp(v, lo, hi).detach() + weight * (v - v.detach())


def _chebyquad(n, f_star):
    name = f"chebyquad{n}"

    @register(name, f_star=f_star)
    def _build(n=n):
        i = np.arange(1.0, n + 1.0)
        with np.errstate(divide="ignore"):          # the odd i, unused
            integral = np.where(i % 2 == 1, 0.0, -1.0 / (i ** 2 - 1.0))
        cache: dict = {}

        def f(x):
            # shifted Chebyshev via the trig identity on [0, 1]
            ang = torch.acos(_clip_as_jnp(2.0 * x - 1.0, -1.0, 1.0))
            T = torch.cos(const(cache, i[:, None], x, name="i")
                          * ang[None, :])                # (m, n)
            r = torch.mean(T, dim=1) - const(cache, integral, x, name="int")
            return torch.sum(r * r)
        x0 = np.arange(1.0, n + 1.0) / (n + 1.0)
        return nlp_from_functions(name, f, None, x0=x0)
    return _build


_chebyquad(6, 0.0)                                                # MGH 35
_chebyquad(8, 3.51687e-3)


def _dintegral(n):
    name = f"dintegral_n{n}"

    @register(name, f_star=0.0)
    def _build(n=n):
        h = 1.0 / (n + 1.0)
        t_np = np.arange(1.0, n + 1.0) * h
        cache: dict = {}

        def f(x):
            t = const(cache, t_np, x)
            cube = (x + t + 1.0) ** 3
            lower = torch.cumsum(t * cube, 0)                 # sum_{j<=i}
            upper_full = torch.sum((1.0 - t) * cube)
            upper = upper_full - torch.cumsum((1.0 - t) * cube, 0)  # sum_{j>i}
            r = x + h * ((1.0 - t) * lower + t * upper) / 2.0
            return torch.sum(r * r)
        x0 = np.arange(1.0, n + 1.0) / (n + 1.0)
        x0 = x0 * (x0 - 1.0)
        return nlp_from_functions(name, f, None, x0=x0)
    return _build


_dintegral(10)                                                    # MGH 29
_dintegral(100)


# ---------------------------------------------------------------------------
# classic 2-variable smooth test functions (CUTE / Dixon-Szegő)
# ---------------------------------------------------------------------------

def _classic(name, f_fn, x0, f_star, x_lb=None, x_ub=None, local_optima=()):
    @register(name, f_star=f_star, local_optima=local_optima)
    def _build():
        return nlp_from_functions(name, f_fn, None, x0=np.asarray(x0, float),
                                  x_lb=x_lb, x_ub=x_ub)
    return _build


_classic("booth", lambda x: (x[0] + 2 * x[1] - 7) ** 2
         + (2 * x[0] + x[1] - 5) ** 2, [0.0, 0.0], 0.0)
_classic("matyas", lambda x: 0.26 * (x[0] ** 2 + x[1] ** 2)
         - 0.48 * x[0] * x[1], [1.0, 1.0], 0.0)
_classic("himmelblau2", lambda x: (x[0] ** 2 + x[1] - 11.0) ** 2
         + (x[0] + x[1] ** 2 - 7.0) ** 2, [1.0, 1.0], 0.0)
_classic("mccormick", lambda x: torch.sin(x[0] + x[1]) + (x[0] - x[1]) ** 2
         - 1.5 * x[0] + 2.5 * x[1] + 1.0, [0.0, 0.0], -1.91322,
         x_lb=[-1.5, -3.0], x_ub=[4.0, 4.0])
_classic("camel6", lambda x: (4.0 - 2.1 * x[0] ** 2 + x[0] ** 4 / 3.0)
         * x[0] ** 2 + x[0] * x[1] + (-4.0 + 4.0 * x[1] ** 2) * x[1] ** 2,
         [0.1, -0.5], -1.031628)
_classic("branin", lambda x: (x[1] - 5.1 / (4 * np.pi ** 2) * x[0] ** 2
         + 5.0 / np.pi * x[0] - 6.0) ** 2
         + 10.0 * (1.0 - 1.0 / (8 * np.pi)) * torch.cos(x[0]) + 10.0,
         [3.0, 3.0], 0.397887)
_classic("cliff", lambda x: ((x[0] - 3.0) / 100.0) ** 2 - (x[0] - x[1])
         + torch.exp(20.0 * (x[0] - x[1])), [0.0, -1.0], 0.199787)
_classic("sisser", lambda x: 3.0 * x[0] ** 4 - 2.0 * (x[0] * x[1]) ** 2
         + 3.0 * x[1] ** 4, [1.0, 0.1], 0.0)


# ---------------------------------------------------------------------------
# classic constrained problems
# ---------------------------------------------------------------------------

@register("maratos", f_star=-1.0)
def maratos():
    """Maratos-effect test: min -x1 + 2(x1^2+x2^2-1) s.t. x1^2+x2^2 = 1;
    f* = -1 at (1, 0) (Maratos 1978 / standard SQP-test form)."""
    def f(x):
        return -x[0] + 2.0 * (x[0] ** 2 + x[1] ** 2 - 1.0)

    def c(x):
        return torch.stack([x[0] ** 2 + x[1] ** 2 - 1.0])

    return nlp_from_functions("maratos", f, c, x0=[np.cos(0.1), np.sin(0.1)],
                              c_lb=[0.0], c_ub=[0.0])


@register("bt1", f_star=-1.0)
def bt1():
    """Boggs-Tolle 1: min 100 x1^2 + 100 x2^2 - x1 - 100
    s.t. x1^2 + x2^2 = 1; f* = -1 at (1, 0)."""
    def f(x):
        return 100.0 * x[0] ** 2 + 100.0 * x[1] ** 2 - x[0] - 100.0

    def c(x):
        return torch.stack([x[0] ** 2 + x[1] ** 2 - 1.0])

    return nlp_from_functions("bt1", f, c, x0=[0.08, 0.06],
                              c_lb=[0.0], c_ub=[0.0])


@register("bt2", f_star=0.032568)
def bt2():
    """Boggs-Tolle 2: min (x1-1)^2 + (x1-x2)^2 + (x2-x3)^4
    s.t. x1(1+x2^2) + x3^4 = 4 + 3 sqrt(2)."""
    def f(x):
        return (x[0] - 1.0) ** 2 + (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 4

    def c(x):
        return torch.stack([x[0] * (1.0 + x[1] ** 2) + x[2] ** 4
                            - 4.0 - 3.0 * np.sqrt(2.0)])

    return nlp_from_functions("bt2", f, c, x0=[1.0, 1.0, 1.0],
                              c_lb=[0.0], c_ub=[0.0])


@register("spring_design", f_star=0.012665)
def spring_design():
    """Tension/compression spring design (classic engineering benchmark):
    min (N+2) D d^2 over wire diameter d, coil diameter D, turns N with the
    four standard inequality constraints; continuous optimum ~0.012665."""
    def f(x):
        d, D, N = x[0], x[1], x[2]
        return (N + 2.0) * D * d ** 2

    def c(x):
        d, D, N = x[0], x[1], x[2]
        g1 = 1.0 - D ** 3 * N / (71785.0 * d ** 4)
        g2 = (4.0 * D ** 2 - d * D) / (12566.0 * (D * d ** 3 - d ** 4)) \
            + 1.0 / (5108.0 * d ** 2) - 1.0
        g3 = 1.0 - 140.45 * d / (D ** 2 * N)
        g4 = (D + d) / 1.5 - 1.0
        return torch.stack([g1, g2, g3, g4])

    return nlp_from_functions(
        "spring_design", f, c, x0=[0.05, 0.4, 10.0],
        x_lb=[0.05, 0.25, 2.0], x_ub=[2.0, 1.3, 15.0],
        c_lb=[-INF] * 4, c_ub=[0.0] * 4)


@register("pressure_vessel", f_star=None)
def pressure_vessel():
    """Pressure vessel design, continuous relaxation (classic benchmark):
    min 0.6224 x1 x3 x4 + 1.7781 x2 x3^2 + 3.1661 x1^2 x4 + 19.84 x1^2 x3.
    No f* asserted: published optima vary with the bound conventions
    (5885.33 is common but scipy cross-validation finds lower feasible
    points under these bounds), so the sweep counts solver-internal KKT
    success only."""
    def f(x):
        return (0.6224 * x[0] * x[2] * x[3] + 1.7781 * x[1] * x[2] ** 2
                + 3.1661 * x[0] ** 2 * x[3] + 19.84 * x[0] ** 2 * x[2])

    def c(x):
        g1 = -x[0] + 0.0193 * x[2]
        g2 = -x[1] + 0.00954 * x[2]
        g3 = -np.pi * x[2] ** 2 * x[3] - 4.0 / 3.0 * np.pi * x[2] ** 3 \
            + 1296000.0
        g4 = x[3] - 240.0
        return torch.stack([g1, g2, g3, g4])

    return nlp_from_functions(
        "pressure_vessel", f, c, x0=[1.0, 0.5, 50.0, 100.0],
        x_lb=[0.0625, 0.0625, 10.0, 10.0], x_ub=[6.1875, 6.1875, 200.0, 240.0],
        c_lb=[-INF] * 4, c_ub=[0.0] * 4)


def _polygon(K, f_star):
    """COPS 3.0 largest small polygon: maximize the area of a K-gon of unit
    diameter.  Variables (r_i, theta_i) polar with one vertex pinned at the
    origin; f = -area; pairwise diameter constraints."""
    name = f"polygon_k{K}"

    @register(name, f_star=f_star)
    def _build(K=K):
        pairs = np.array([(i, j) for i in range(K - 1)
                          for j in range(i + 1, K - 1)], dtype=np.int64)
        cache: dict = {}

        def split(z):
            return z[: K - 1], z[K - 1:]

        def f(z):
            r, th = split(z)
            area = 0.5 * torch.sum(r[1:] * r[:-1] * torch.sin(th[1:] - th[:-1]))
            return -area

        def c(z):
            r, th = split(z)
            pi_ = const(cache, pairs[:, 0], z, torch.int64, "i")
            pj_ = const(cache, pairs[:, 1], z, torch.int64, "j")
            return (r[pi_] ** 2 + r[pj_] ** 2
                    - 2.0 * r[pi_] * r[pj_] * torch.cos(th[pi_] - th[pj_]))

        m = pairs.shape[0]
        th0 = np.pi * (np.arange(1, K) / K)
        x0 = np.concatenate([np.full(K - 1, 0.5), th0])
        xl = np.concatenate([np.zeros(K - 1), np.zeros(K - 1)])
        xu = np.concatenate([np.ones(K - 1) * 1.0, np.full(K - 1, np.pi)])
        return nlp_from_functions(
            name, f, c, x0=x0, x_lb=xl, x_ub=xu,
            c_lb=np.full(m, -INF), c_ub=np.ones(m))
    return _build


_polygon(6, -0.674981)
_polygon(8, -0.726868)
_polygon(25, None)


# ---------------------------------------------------------------------------
# further scalable chained families (banded structure declared)
# ---------------------------------------------------------------------------

def _scalable(name, builder, sizes=(10, 100, 1000), f_star=None):
    for n in sizes:
        fs = f_star(n) if callable(f_star) else f_star
        register(f"{name}_n{n}", f_star=fs)(
            lambda builder=builder, n=n: builder(n))


def _styblinski(n):
    def f(x):
        return 0.5 * torch.sum(x ** 4 - 16.0 * x ** 2 + 5.0 * x)
    return nlp_from_functions(f"styblinski_n{n}", f, None,
                              x0=np.full(n, -1.0),
                              structure=NLPStructure(hess_bandwidth=0))


_scalable("styblinski", _styblinski, f_star=lambda n: -39.1661657 * n)


def _dixon_price(n):
    i_np = np.arange(2.0, n + 1.0)
    cache: dict = {}

    def f(x):
        i = const(cache, i_np, x)
        return (x[0] - 1.0) ** 2 \
            + torch.sum(i * (2.0 * x[1:] ** 2 - x[:-1]) ** 2)
    return nlp_from_functions(f"dixon_price_n{n}", f, None,
                              x0=np.full(n, 0.8),
                              structure=NLPStructure(hess_bandwidth=1))


_scalable("dixon_price", _dixon_price, f_star=0.0)


def _levy(n):
    def f(x):
        w = 1.0 + (x - 1.0) / 4.0
        head = torch.sin(np.pi * w[0]) ** 2
        mid = torch.sum((w[:-1] - 1.0) ** 2
                        * (1.0 + 10.0 * torch.sin(np.pi * w[:-1] + 1.0) ** 2))
        tail = (w[-1] - 1.0) ** 2 * (1.0 + torch.sin(2.0 * np.pi * w[-1]) ** 2)
        return head + mid + tail
    return nlp_from_functions(f"levy_n{n}", f, None, x0=np.full(n, 2.0),
                              structure=NLPStructure(hess_bandwidth=1))


_scalable("levy", _levy, f_star=0.0)


def _dixon3dq(n):
    def f(x):
        return (x[0] - 1.0) ** 2 + torch.sum((x[:-1] - x[1:]) ** 2) \
            + (x[-1] - 1.0) ** 2
    return nlp_from_functions(f"dixon3dq_n{n}", f, None, x0=np.full(n, -1.0),
                              structure=NLPStructure(hess_bandwidth=1))


_scalable("dixon3dq", _dixon3dq, f_star=0.0)


def _exthimmelblau(n):
    n -= n % 2

    def f(x):
        a, b = x[0::2], x[1::2]
        return torch.sum((a ** 2 + b - 11.0) ** 2 + (a + b ** 2 - 7.0) ** 2)
    return nlp_from_functions(f"exthimmelblau_n{n}", f, None,
                              x0=np.tile([1.0, 1.0], n // 2),
                              structure=NLPStructure(hess_bandwidth=1))


_scalable("exthimmelblau", _exthimmelblau, f_star=0.0)


def _extbeale(n):
    n -= n % 2

    def f(x):
        a, b = x[0::2], x[1::2]
        return torch.sum((1.5 - a * (1.0 - b)) ** 2
                         + (2.25 - a * (1.0 - b ** 2)) ** 2
                         + (2.625 - a * (1.0 - b ** 3)) ** 2)
    return nlp_from_functions(f"extbeale_n{n}", f, None,
                              x0=np.tile([1.0, 1.0], n // 2),
                              structure=NLPStructure(hess_bandwidth=1))


_scalable("extbeale", _extbeale, f_star=0.0)


def _trid(n):
    def f(x):
        return torch.sum((x - 1.0) ** 2) - torch.sum(x[1:] * x[:-1])
    return nlp_from_functions(f"trid_n{n}", f, None, x0=np.zeros(n),
                              structure=NLPStructure(hess_bandwidth=1))


# f* = -n(n+4)(n-1)/6 at x_i = i(n+1-i)  (classic TRID quadratic)
_scalable("trid", _trid, f_star=lambda n: -n * (n + 4.0) * (n - 1.0) / 6.0)


def _zakharov(n):
    w = 0.5 * np.arange(1.0, n + 1.0)
    cache: dict = {}

    def f(x):
        s = torch.dot(const(cache, w, x), x)
        return torch.sum(x ** 2) + s ** 2 + s ** 4
    return nlp_from_functions(f"zakharov_n{n}", f, None, x0=np.full(n, 0.5))


_scalable("zakharov", _zakharov, f_star=0.0)


def _qing(n):
    i = np.arange(1.0, n + 1.0)
    cache: dict = {}

    def f(x):
        return torch.sum((x ** 2 - const(cache, i, x)) ** 2)
    return nlp_from_functions(f"qing_n{n}", f, None, x0=np.full(n, 1.0),
                              structure=NLPStructure(hess_bandwidth=0))


_scalable("qing", _qing, f_star=0.0)


def _raydan1(n):
    w = np.arange(1.0, n + 1.0) / 10.0
    cache: dict = {}

    def f(x):
        return torch.sum(const(cache, w, x) * (torch.exp(x) - x))
    return nlp_from_functions(f"raydan1_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=0))


# min at x = 0 with value sum(i/10) = n(n+1)/20  (CUTEst RAYDAN1)
_scalable("raydan1", _raydan1, f_star=lambda n: n * (n + 1.0) / 20.0)


def _raydan2(n):
    def f(x):
        return torch.sum(torch.exp(x) - x)
    return nlp_from_functions(f"raydan2_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=0))


# min at x = 0 with value n  (CUTEst RAYDAN2)
_scalable("raydan2", _raydan2, f_star=lambda n: float(n))


def _hilberta(n):
    i = np.arange(n)
    Hm = 1.0 / (1.0 + i[:, None] + i[None, :])
    cache: dict = {}

    def f(x):
        return 0.5 * x @ (const(cache, Hm, x) @ x)
    return nlp_from_functions(f"hilberta_n{n}", f, None, x0=np.full(n, -3.0))


_scalable("hilberta", _hilberta, sizes=(10, 100), f_star=0.0)


_classic("colville", lambda x: 100.0 * (x[0] ** 2 - x[1]) ** 2
         + (x[0] - 1.0) ** 2 + (x[2] - 1.0) ** 2
         + 90.0 * (x[2] ** 2 - x[3]) ** 2
         + 10.1 * ((x[1] - 1.0) ** 2 + (x[3] - 1.0) ** 2)
         + 19.8 * (x[1] - 1.0) * (x[3] - 1.0),
         [-0.5, 1.0, -0.5, 1.0], 0.0)

_classic("leon", lambda x: 100.0 * (x[1] - x[0] ** 3) ** 2
         + (1.0 - x[0]) ** 2, [-1.2, 1.0], 0.0)
