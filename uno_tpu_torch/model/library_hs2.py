"""Hock-Schittkowski extension set II in torch: the harder
engineering-design problems (alkylation, heat exchanger, launch-vehicle
weight allocation, membrane separation), a copy of
uno_tpu/model/library_hs2.py under the same keys and optima.

Formulations and optimal values follow Hock & Schittkowski, "Test Examples
for Nonlinear Programming Codes" (1981).
"""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.model.library import register
from uno_tpu_torch.model.nlp import INF, const, nlp_from_functions


def _p(name, f, c, x0, x_lb=None, x_ub=None, c_lb=None, c_ub=None):
    return nlp_from_functions(name, f, c, x0=x0, x_lb=x_lb, x_ub=x_ub,
                              c_lb=c_lb, c_ub=c_ub)


@register("hs017", f_star=1.0)
def hs017():
    return _p("hs017",
              lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
              lambda x: torch.stack([x[1] ** 2 - x[0], x[0] ** 2 - x[1]]),
              x0=[-2.0, 1.0], x_lb=[-0.5, -INF], x_ub=[0.5, 1.0],
              c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs057", f_star=0.02845966972, local_optima=(0.03064761905,))
def hs057():
    # exponential-fit least squares (44 observations)
    a = np.array([8, 8, 10, 10, 10, 10, 12, 12, 12, 12, 14, 14, 14, 16, 16,
                  16, 18, 18, 20, 20, 20, 22, 22, 22, 24, 24, 24, 26, 26, 26,
                  28, 28, 30, 30, 30, 32, 32, 34, 36, 36, 38, 38, 40, 42],
                 dtype=float)
    b = np.array([.49, .49, .48, .47, .48, .47, .46, .46, .45, .43, .45, .43,
                  .43, .44, .43, .43, .46, .45, .42, .42, .43, .41, .41, .40,
                  .42, .40, .40, .41, .40, .41, .41, .40, .40, .40, .38, .41,
                  .40, .40, .41, .38, .40, .40, .39, .39])
    cache: dict = {}

    def f(x):
        aj = const(cache, a, x, name="a")
        bj = const(cache, b, x, name="b")
        r = bj - x[0] - (0.49 - x[0]) * torch.exp(-x[1] * (aj - 8.0))
        return torch.sum(r ** 2)

    def c(x):
        return torch.stack([0.49 * x[1] - x[0] * x[1] - 0.09])

    return _p("hs057", f, c, x0=[0.42, 5.0],
              x_lb=[0.4, -4.0], x_ub=[INF, INF],
              c_lb=[0.0], c_ub=[INF])


@register("hs084", f_star=-5280335.133)
def hs084():
    # Colville No. 6 (quadratic program with range constraints)
    a = np.array([
        -24345.0, -8720288.849, 150512.5253, -156.6950325, 476470.3222,
        729482.8271, -145421.402, 2931.1506, -40.427932, 5106.192,
        15711.36, -155011.1084, 4360.53352, 12.9492344, 10236.884,
        13176.786, -326669.5104, 7390.68412, -27.8986976, 16643.076,
        30988.146,
    ])

    def f(x):
        return -(a[0] + a[1] * x[0] + a[2] * x[0] * x[1] + a[3] * x[0] * x[2]
                 + a[4] * x[0] * x[3] + a[5] * x[0] * x[4])

    def c(x):
        return torch.stack([
            a[6] * x[0] + a[7] * x[0] * x[1] + a[8] * x[0] * x[2]
            + a[9] * x[0] * x[3] + a[10] * x[0] * x[4],
            a[11] * x[0] + a[12] * x[0] * x[1] + a[13] * x[0] * x[2]
            + a[14] * x[0] * x[3] + a[15] * x[0] * x[4],
            a[16] * x[0] + a[17] * x[0] * x[1] + a[18] * x[0] * x[2]
            + a[19] * x[0] * x[3] + a[20] * x[0] * x[4],
        ])

    return _p("hs084", f, c, x0=[2.52, 2.0, 37.5, 9.25, 6.8],
              x_lb=[0.0, 1.2, 20.0, 9.0, 6.5],
              x_ub=[1000.0, 2.4, 60.0, 9.3, 7.0],
              c_lb=[0.0, 0.0, 0.0],
              c_ub=[294000.0, 294000.0, 277200.0])


def _hs095_family(name, blo, f_star_unused=None):
    # quadratically-constrained linear programs hs095-hs098 differ only in
    # the constraint right-hand sides
    def f(x):
        return (4.3 * x[0] + 31.8 * x[1] + 63.3 * x[2] + 15.8 * x[3]
                + 68.5 * x[4] + 4.7 * x[5])

    def c(x):
        return torch.stack([
            17.1 * x[0] + 38.2 * x[1] + 204.2 * x[2] + 212.3 * x[3]
            + 623.4 * x[4] + 1495.5 * x[5]
            - 169.0 * x[0] * x[2] - 3580.0 * x[2] * x[4]
            - 3810.0 * x[3] * x[4] - 18500.0 * x[3] * x[5]
            - 24300.0 * x[4] * x[5],
            17.9 * x[0] + 36.8 * x[1] + 113.9 * x[2] + 169.7 * x[3]
            + 337.8 * x[4] + 1385.2 * x[5]
            - 139.0 * x[0] * x[2] - 2450.0 * x[3] * x[4]
            - 16600.0 * x[3] * x[5] - 17200.0 * x[4] * x[5],
            -273.0 * x[1] - 70.0 * x[3] - 819.0 * x[4]
            + 26000.0 * x[3] * x[4],
            159.9 * x[0] - 311.0 * x[1] + 587.0 * x[3] + 391.0 * x[4]
            + 2198.0 * x[5] - 14000.0 * x[0] * x[5],
        ])

    return _p(name, f, c, x0=[0.0] * 6,
              x_lb=[0.0] * 6,
              x_ub=[0.31, 0.046, 0.068, 0.042, 0.028, 0.0134],
              c_lb=list(blo), c_ub=[INF] * 4)


@register("hs095", f_star=0.015619514)
def hs095():
    return _hs095_family("hs095", (4.97, -1.88, -29.08, -78.02))


@register("hs096", f_star=0.015619514)
def hs096():
    return _hs095_family("hs096", (4.97, -1.88, -69.08, -118.02))


@register("hs097", f_star=3.1358091,
          local_optima=(4.0712463565,))
def hs097():
    return _hs095_family("hs097", (32.97, 25.12, -29.08, -78.02))


@register("hs098", f_star=3.1358091,
          local_optima=(4.0712463565,))
def hs098():
    return _hs095_family("hs098", (32.97, 25.12, -124.08, -173.03))


@register("hs104", f_star=3.9511634396)
def hs104():
    # two-stage membrane separation process design
    def _f(x):
        return (0.4 * x[0] ** 0.67 * x[6] ** (-0.67)
                + 0.4 * x[1] ** 0.67 * x[7] ** (-0.67)
                + 10.0 - x[0] - x[1])

    def c(x):
        return torch.stack([
            1.0 - 0.0588 * x[4] * x[6] - 0.1 * x[0],
            1.0 - 0.0588 * x[5] * x[7] - 0.1 * x[0] - 0.1 * x[1],
            1.0 - 4.0 * x[2] / x[4] - 2.0 / (x[2] ** 0.71 * x[4])
            - 0.0588 * x[6] / x[2] ** 1.3,
            1.0 - 4.0 * x[3] / x[5] - 2.0 / (x[3] ** 0.71 * x[5])
            - 0.0588 * x[7] / x[3] ** 1.3,
            _f(x),                         # 0.1 <= f(x) <= 4.2
        ])

    return _p("hs104", _f, c,
              x0=[6.0, 3.0, 0.4, 0.2, 6.0, 6.0, 1.0, 0.5],
              x_lb=[0.1] * 8, x_ub=[10.0] * 8,
              c_lb=[0.0, 0.0, 0.0, 0.0, 0.1],
              c_ub=[INF, INF, INF, INF, 4.2])


@register("hs114", f_star=-1768.80696)
def hs114():
    # alkylation process optimization (Bracken-McCormick)
    A, B = 0.99, 0.9

    def f(x):
        return (5.04 * x[0] + 0.035 * x[1] + 10.0 * x[2] + 3.36 * x[4]
                - 0.063 * x[3] * x[6])

    def c(x):
        g1 = 35.82 - 0.222 * x[9] - B * x[8]
        g2 = -133.0 + 3.0 * x[6] - A * x[9]
        g5 = (1.12 * x[0] + 0.13167 * x[0] * x[7]
              - 0.00667 * x[0] * x[7] ** 2 - A * x[3])
        g6 = (57.425 + 1.098 * x[7] - 0.038 * x[7] ** 2
              + 0.325 * x[5] - A * x[6])
        return torch.stack([
            g1,
            g2,
            -g1 + x[8] * (1.0 / B - B),
            -g2 + (1.0 / A - A) * x[9],
            g5,
            g6,
            -g5 + (1.0 / A - A) * x[3],
            -g6 + (1.0 / A - A) * x[6],
            1.22 * x[3] - x[0] - x[4],                               # = 0
            98000.0 * x[2] / (x[3] * x[8] + 1000.0 * x[2]) - x[5],   # = 0
            (x[1] + x[4]) / x[0] - x[7],                             # = 0
        ])

    lo = [1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 85.0, 90.0, 3.0, 1.2, 145.0]
    hi = [2000.0, 16000.0, 120.0, 5000.0, 2000.0, 93.0, 95.0, 12.0, 4.0, 162.0]
    return _p("hs114", f, c,
              x0=[1745.0, 12000.0, 110.0, 3048.0, 1974.0,
                  89.2, 92.8, 8.0, 3.6, 145.0],
              x_lb=lo, x_ub=hi,
              c_lb=[0.0] * 8 + [0.0] * 3,
              c_ub=[INF] * 8 + [0.0] * 3)


@register("hs117", f_star=32.348679)
def hs117():
    # Colville No. 2 / Shell dual (shares the hs086 data tables)
    e = np.array([-15.0, -27.0, -36.0, -18.0, -12.0])
    C = np.array([
        [30.0, -20.0, -10.0, 32.0, -10.0],
        [-20.0, 39.0, -6.0, -31.0, 32.0],
        [-10.0, -6.0, 10.0, -6.0, -10.0],
        [32.0, -31.0, -6.0, 39.0, -20.0],
        [-10.0, 32.0, -10.0, -20.0, 30.0],
    ])
    d = np.array([4.0, 8.0, 10.0, 6.0, 2.0])
    A = np.array([
        [-16.0, 2.0, 0.0, 1.0, 0.0],
        [0.0, -2.0, 0.0, 0.4, 2.0],
        [-3.5, 0.0, 2.0, 0.0, 0.0],
        [0.0, -2.0, 0.0, -4.0, -1.0],
        [0.0, -9.0, -2.0, 1.0, -2.8],
        [2.0, 0.0, -4.0, 0.0, 0.0],
        [-1.0, -1.0, -1.0, -1.0, -1.0],
        [-1.0, -2.0, -3.0, -2.0, -1.0],
        [1.0, 2.0, 3.0, 4.0, 5.0],
        [1.0, 1.0, 1.0, 1.0, 1.0],
    ])
    b = np.array([-40.0, -2.0, -0.25, -4.0, -4.0, -1.0, -40.0, -60.0, 5.0, 1.0])
    cache: dict = {}

    def on(arr, name, x):
        return const(cache, arr, x, name=name)

    def f(x):
        y = x[10:]
        return (-on(b, "b", x) @ x[:10] + y @ (on(C, "C", x) @ y)
                + 2.0 * on(d, "d", x) @ (y ** 3))

    def c(x):
        y = x[10:]
        return (2.0 * (on(C, "C", x) @ y) + 3.0 * on(d, "d", x) * y ** 2
                + on(e, "e", x) - on(A.T, "AT", x) @ x[:10])

    x0 = [0.001] * 15
    x0[6] = 60.0
    return _p("hs117", f, c, x0=x0,
              x_lb=[0.0] * 15, x_ub=[INF] * 15,
              c_lb=[0.0] * 5, c_ub=[INF] * 5)


@register("hs099", f_star=-0.831079892e9)
def hs099():
    # multi-stage launch vehicle ascent (recursive trajectory integration)
    a = np.array([0.0, 50.0, 50.0, 75.0, 75.0, 75.0, 100.0, 100.0])
    t = np.array([0.0, 25.0, 50.0, 100.0, 150.0, 200.0, 290.0, 380.0])
    b = 32.0
    cache: dict = {}

    def consts(x):
        return (const(cache, t[1:] - t[:-1], x, name="dt"),    # (7,)
                const(cache, a[1:], x, name="a"))               # (7,)

    def _rsq(x):
        # r_i = sum a_i dt_i cos(x_{i-1})
        dt, aj = consts(x)
        return torch.cumsum(aj * dt * torch.cos(x), 0)

    def _s(x):
        dt, aj = consts(x)
        return torch.cumsum((aj * torch.sin(x) - b) * dt, 0)

    def _q(x):
        dt, aj = consts(x)
        acc = (aj * torch.sin(x) - b)
        s = _s(x)
        s_prev = torch.cat([x.new_zeros(1), s[:-1]])
        return torch.cumsum(0.5 * dt ** 2 * acc + dt * s_prev, 0)

    def f(x):
        return -_rsq(x)[-1] ** 2

    def c(x):
        return torch.stack([_q(x)[-1] - 1.0e5, _s(x)[-1] - 1.0e3])

    return _p("hs099", f, c, x0=[0.5] * 7,
              x_lb=[0.0] * 7, x_ub=[1.58] * 7,
              c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs116", f_star=97.588409)
def hs116():
    # 3-stage membrane separation
    def f(x):
        return x[10] + x[11] + x[12]

    def c(x):
        return torch.stack([
            x[2] - x[1],
            x[1] - x[0],
            1.0 - 0.002 * x[6] + 0.002 * x[7],
            x[10] + x[11] + x[12],                                    # >= 50
            x[12] - 1.262626 * x[9] + 1.231059 * x[2] * x[9],
            x[4] - 0.03475 * x[1] - 0.975 * x[1] * x[4]
            + 0.00975 * x[1] ** 2,
            x[5] - 0.03475 * x[2] - 0.975 * x[2] * x[5]
            + 0.00975 * x[2] ** 2,
            x[4] * x[6] - x[0] * x[7] - x[3] * x[6] + x[3] * x[7],
            1.0 - 0.002 * (x[1] * x[8] + x[4] * x[7] - x[0] * x[7]
                           - x[5] * x[8]) - x[4] - x[5],
            x[1] * x[8] - x[2] * x[9] - x[5] * x[8] - 500.0 * x[1]
            + 500.0 * x[5] + x[1] * x[9],
            x[1] - 0.9 - 0.002 * (x[1] * x[9] - x[2] * x[9]),
            x[3] - 0.03475 * x[0] - 0.975 * x[0] * x[3]
            + 0.00975 * x[0] ** 2,
            x[10] - 1.262626 * x[7] + 1.231059 * x[0] * x[7],
            x[11] - 1.262626 * x[8] + 1.231059 * x[1] * x[8],
            x[10] + x[11] + x[12],                                    # <= 250
        ])

    lo = [0.1, 0.1, 0.1, 0.0001, 0.1, 0.1, 0.1, 0.1, 500.0, 0.1,
          1.0, 0.0001, 0.0001]
    hi = [1.0, 1.0, 1.0, 0.1, 0.9, 0.9, 1000.0, 1000.0, 1000.0, 500.0,
          150.0, 150.0, 150.0]
    x0 = [0.5, 0.8, 0.9, 0.1, 0.14, 0.5, 489.0, 80.0, 650.0, 450.0,
          150.0, 150.0, 150.0]
    return _p("hs116", f, c, x0=x0, x_lb=lo, x_ub=hi,
              c_lb=[0.0, 0.0, 0.0, 50.0] + [0.0] * 10 + [-INF],
              c_ub=[INF] * 14 + [250.0])


def _hs101_family(name, a):
    # posynomial process design; hs101/102/103 differ in the exponent a
    def f(x):
        return (10.0 * x[0] * x[3] ** 2 * x[6] ** a / (x[1] * x[5] ** 3)
                + 15.0 * x[2] * x[3] / (x[0] * x[1] ** 2 * x[4]
                                        * x[6] ** 0.5)
                + 20.0 * x[1] * x[5] / (x[0] ** 2 * x[3] * x[4] ** 2)
                + 25.0 * x[0] ** 2 * x[1] ** 2 * x[4] ** 0.5 * x[6]
                / (x[2] * x[5] ** 2))

    def c(x):
        c1 = (1.0
              - 0.5 * x[0] ** 0.5 * x[6] / (x[2] * x[5] ** 2)
              - 0.7 * x[0] ** 3 * x[1] * x[5] * x[6] ** 0.5 / x[2] ** 2
              - 0.2 * x[2] * x[5] ** (2.0 / 3.0) * x[6] ** 0.25
              / (x[1] * x[3] ** 0.5))
        c2 = (1.0
              - 1.3 * x[1] * x[5] / (x[0] ** 0.5 * x[2] * x[4])
              - 0.8 * x[2] * x[5] ** 2 / (x[3] * x[4])
              - 3.1 * x[1] ** 0.5 * x[5] ** (1.0 / 3.0)
              / (x[0] * x[3] ** 2 * x[4]))
        c3 = (1.0
              - 2.0 * x[0] * x[4] * x[6] ** (1.0 / 3.0)
              / (x[2] ** 1.5 * x[5])
              - 0.1 * x[1] * x[4] / (x[2] ** 0.5 * x[5] * x[6] ** 0.5)
              - x[1] * x[2] ** 0.5 * x[4] / x[0]
              - 0.65 * x[2] * x[4] * x[6] / (x[1] ** 2 * x[5]))
        c4 = (1.0
              - 0.2 * x[1] * x[4] ** 0.5 * x[6] ** (1.0 / 3.0)
              / (x[0] ** 2 * x[3])
              - 0.3 * x[0] ** 0.5 * x[1] ** 2 * x[2] * x[3] ** (1.0 / 3.0)
              * x[6] ** 0.25 / x[4] ** (2.0 / 3.0)
              - 0.4 * x[2] * x[4] * x[6] ** 0.75
              / (x[0] ** 3 * x[1] ** 2)
              - 0.5 * x[3] * x[6] ** 0.5 / x[2] ** 2)
        return torch.stack([c1, c2, c3, c4, f(x)])

    return _p(name, f, c, x0=[6.0] * 7,
              x_lb=[0.1] * 6 + [0.01], x_ub=[10.0] * 7,
              c_lb=[0.0, 0.0, 0.0, 0.0, 100.0],
              c_ub=[INF, INF, INF, INF, 3000.0])


@register("hs101", f_star=1809.76476)
def hs101():
    return _hs101_family("hs101", -0.25)


@register("hs102", f_star=911.880571)
def hs102():
    return _hs101_family("hs102", 0.125)


@register("hs103", f_star=543.667958)
def hs103():
    return _hs101_family("hs103", 0.5)
