"""Extended Hock-Schittkowski problem set in torch: a copy of
uno_tpu/model/library_hs.py under the same keys and optima, registered into
model/library.py's registry.

Formulations and optimal values follow Hock & Schittkowski, "Test Examples
for Nonlinear Programming Codes" (1981).  Constant tables live in numpy and
reach x's device through nlp.const, once per device.
"""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.model.library import register
from uno_tpu_torch.model.nlp import INF, const, nlp_from_functions


def _p(name, f, c, x0, x_lb=None, x_ub=None, c_lb=None, c_ub=None):
    return nlp_from_functions(name, f, c, x0=x0, x_lb=x_lb, x_ub=x_ub,
                              c_lb=c_lb, c_ub=c_ub)


@register("hs002", f_star=0.0504261879, local_optima=(4.9412293,))
def hs002():
    return _p("hs002",
              lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
              None, x0=[-2.0, 1.0], x_lb=[-INF, 1.5], x_ub=[INF, INF])


@register("hs003", f_star=0.0)
def hs003():
    return _p("hs003", lambda x: x[1] + 1e-5 * (x[1] - x[0]) ** 2,
              None, x0=[10.0, 1.0], x_lb=[-INF, 0.0], x_ub=[INF, INF])


@register("hs004", f_star=8.0 / 3.0)
def hs004():
    return _p("hs004", lambda x: (x[0] + 1.0) ** 3 / 3.0 + x[1],
              None, x0=[1.125, 0.125], x_lb=[1.0, 0.0], x_ub=[INF, INF])


@register("hs005", f_star=-(np.sqrt(3.0) / 2.0 + np.pi / 3.0))
def hs005():
    return _p("hs005",
              lambda x: (torch.sin(x[0] + x[1]) + (x[0] - x[1]) ** 2
                         - 1.5 * x[0] + 2.5 * x[1] + 1.0),
              None, x0=[0.0, 0.0], x_lb=[-1.5, -3.0], x_ub=[4.0, 3.0])


@register("hs008", f_star=-1.0)
def hs008():
    return _p("hs008", lambda x: torch.full_like(x[0], -1.0),
              lambda x: torch.stack([x[0] ** 2 + x[1] ** 2, x[0] * x[1]]),
              x0=[2.0, 1.0], c_lb=[25.0, 9.0], c_ub=[25.0, 9.0])


@register("hs009", f_star=-0.5)
def hs009():
    return _p("hs009",
              lambda x: torch.sin(np.pi * x[0] / 12.0) * torch.cos(np.pi * x[1] / 16.0),
              lambda x: torch.stack([4.0 * x[0] - 3.0 * x[1]]),
              x0=[0.0, 0.0], c_lb=[0.0], c_ub=[0.0])


@register("hs013", f_star=1.0)
def hs013():
    # constraint qualification fails at the solution (2,0)
    return _p("hs013", lambda x: (x[0] - 2.0) ** 2 + x[1] ** 2,
              lambda x: torch.stack([(1.0 - x[0]) ** 3 - x[1]]),
              x0=[-2.0, -2.0], x_lb=[0.0, 0.0], x_ub=[INF, INF],
              c_lb=[0.0], c_ub=[INF])


@register("hs018", f_star=5.0)
def hs018():
    return _p("hs018", lambda x: 0.01 * x[0] ** 2 + x[1] ** 2,
              lambda x: torch.stack([x[0] * x[1] - 25.0,
                                     x[0] ** 2 + x[1] ** 2 - 25.0]),
              x0=[2.0, 2.0], x_lb=[2.0, 0.0], x_ub=[50.0, 50.0],
              c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs019", f_star=-6961.81388)
def hs019():
    return _p("hs019", lambda x: (x[0] - 10.0) ** 3 + (x[1] - 20.0) ** 3,
              lambda x: torch.stack([
                  (x[0] - 5.0) ** 2 + (x[1] - 5.0) ** 2 - 100.0,
                  82.81 - (x[1] - 5.0) ** 2 - (x[0] - 6.0) ** 2,
              ]),
              x0=[20.1, 5.84], x_lb=[13.0, 0.0], x_ub=[100.0, 100.0],
              c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs020", f_star=81.5 - 25.0 * np.sqrt(3.0),
          local_optima=(83.5 - 25.0 * np.sqrt(3.0),))  # x1 = -0.5 branch
def hs020():
    return _p("hs020",
              lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
              lambda x: torch.stack([x[0] + x[1] ** 2, x[0] ** 2 + x[1],
                                     x[0] ** 2 + x[1] ** 2 - 1.0]),
              x0=[-2.0, 1.0], x_lb=[-0.5, -INF], x_ub=[0.5, INF],
              c_lb=[0.0] * 3, c_ub=[INF] * 3)


@register("hs023", f_star=2.0)
def hs023():
    return _p("hs023", lambda x: x[0] ** 2 + x[1] ** 2,
              lambda x: torch.stack([
                  x[0] + x[1] - 1.0,
                  x[0] ** 2 + x[1] ** 2 - 1.0,
                  9.0 * x[0] ** 2 + x[1] ** 2 - 9.0,
                  x[0] ** 2 - x[1],
                  x[1] ** 2 - x[0],
              ]),
              x0=[3.0, 1.0], x_lb=[-50.0, -50.0], x_ub=[50.0, 50.0],
              c_lb=[0.0] * 5, c_ub=[INF] * 5)


@register("hs025", f_star=0.0)
def hs025():
    i = np.arange(1, 100, dtype=np.float64)
    u = 25.0 + (-50.0 * np.log(0.01 * i)) ** (2.0 / 3.0)
    cache: dict = {}

    def f(x):
        uj = const(cache, u, x, name="u")
        ij = const(cache, 0.01 * i, x, name="i")
        r = -ij + torch.exp(-((uj - x[1]) ** x[2]) / x[0])
        return torch.sum(r ** 2)

    return _p("hs025", f, None, x0=[100.0, 12.5, 3.0],
              x_lb=[0.1, 0.0, 0.0], x_ub=[100.0, 25.6, 5.0])


@register("hs026", f_star=0.0)
def hs026():
    return _p("hs026",
              lambda x: (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 4,
              lambda x: torch.stack([(1.0 + x[1] ** 2) * x[0] + x[2] ** 4 - 3.0]),
              x0=[-2.6, 2.0, 2.0], c_lb=[0.0], c_ub=[0.0])


@register("hs027", f_star=0.04)
def hs027():
    return _p("hs027",
              lambda x: 0.01 * (x[0] - 1.0) ** 2 + (x[1] - x[0] ** 2) ** 2,
              lambda x: torch.stack([x[0] + x[2] ** 2 + 1.0]),
              x0=[2.0, 2.0, 2.0], c_lb=[0.0], c_ub=[0.0])


@register("hs031", f_star=6.0)
def hs031():
    return _p("hs031",
              lambda x: 9.0 * x[0] ** 2 + x[1] ** 2 + 9.0 * x[2] ** 2,
              lambda x: torch.stack([x[0] * x[1] - 1.0]),
              x0=[1.0, 1.0, 0.0], x_lb=[-10.0, 1.0, -10.0],
              x_ub=[10.0, 10.0, 1.0], c_lb=[0.0], c_ub=[INF])


@register("hs032", f_star=1.0)
def hs032():
    return _p("hs032",
              lambda x: (x[0] + 3.0 * x[1] + x[2]) ** 2 + 4.0 * (x[0] - x[1]) ** 2,
              lambda x: torch.stack([
                  6.0 * x[1] + 4.0 * x[2] - x[0] ** 3 - 3.0,
                  1.0 - x[0] - x[1] - x[2],
              ]),
              x0=[0.1, 0.7, 0.2], x_lb=[0.0] * 3, x_ub=[INF] * 3,
              c_lb=[0.0, 0.0], c_ub=[INF, 0.0])


@register("hs034", f_star=-np.log(np.log(10.0)))
def hs034():
    return _p("hs034", lambda x: -x[0],
              lambda x: torch.stack([x[1] - torch.exp(x[0]),
                                     x[2] - torch.exp(x[1])]),
              x0=[0.0, 1.05, 2.9], x_lb=[0.0] * 3, x_ub=[100.0, 100.0, 10.0],
              c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs039", f_star=-1.0)
def hs039():
    return _p("hs039", lambda x: -x[0],
              lambda x: torch.stack([x[1] - x[0] ** 3 - x[2] ** 2,
                                     x[0] ** 2 - x[1] - x[3] ** 2]),
              x0=[2.0, 2.0, 2.0, 2.0], c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs040", f_star=-0.25)
def hs040():
    return _p("hs040", lambda x: -x[0] * x[1] * x[2] * x[3],
              lambda x: torch.stack([x[0] ** 3 + x[1] ** 2 - 1.0,
                                     x[0] ** 2 * x[3] - x[2],
                                     x[3] ** 2 - x[1]]),
              x0=[0.8] * 4, c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs041", f_star=52.0 / 27.0)
def hs041():
    return _p("hs041", lambda x: 2.0 - x[0] * x[1] * x[2],
              lambda x: torch.stack([x[0] + 2.0 * x[1] + 2.0 * x[2] - x[3]]),
              x0=[2.0, 2.0, 2.0, 2.0],
              x_lb=[0.0] * 4, x_ub=[1.0, 1.0, 1.0, 2.0],
              c_lb=[0.0], c_ub=[0.0])


@register("hs042", f_star=28.0 - 10.0 * np.sqrt(2.0))
def hs042():
    return _p("hs042",
              lambda x: ((x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2
                         + (x[2] - 3.0) ** 2 + (x[3] - 4.0) ** 2),
              lambda x: torch.stack([x[0] - 2.0,
                                     x[2] ** 2 + x[3] ** 2 - 2.0]),
              x0=[1.0] * 4, c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs044", f_star=-15.0, local_optima=(-13.0,))
def hs044():
    def f(x):
        return (x[0] - x[1] - x[2] - x[0] * x[2] + x[0] * x[3]
                + x[1] * x[2] - x[1] * x[3])

    def c(x):
        return torch.stack([
            8.0 - x[0] - 2.0 * x[1],
            12.0 - 4.0 * x[0] - x[1],
            12.0 - 3.0 * x[0] - 4.0 * x[1],
            8.0 - 2.0 * x[2] - x[3],
            8.0 - x[2] - 2.0 * x[3],
            5.0 - x[2] - x[3],
        ])

    return _p("hs044", f, c, x0=[0.0] * 4, x_lb=[0.0] * 4, x_ub=[INF] * 4,
              c_lb=[0.0] * 6, c_ub=[INF] * 6)


@register("hs046", f_star=0.0)
def hs046():
    def f(x):
        return ((x[0] - x[1]) ** 2 + (x[2] - 1.0) ** 2
                + (x[3] - 1.0) ** 4 + (x[4] - 1.0) ** 6)

    def c(x):
        return torch.stack([
            x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 1.0,
            x[1] + x[2] ** 4 * x[3] ** 2 - 2.0,
        ])

    return _p("hs046", f, c,
              x0=[np.sqrt(2.0) / 2.0, 1.75, 0.5, 2.0, 2.0],
              c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs047", f_star=0.0)
def hs047():
    def f(x):
        return ((x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 3
                + (x[2] - x[3]) ** 4 + (x[3] - x[4]) ** 4)

    def c(x):
        return torch.stack([
            x[0] + x[1] ** 2 + x[2] ** 3 - 3.0,
            x[1] - x[2] ** 2 + x[3] - 1.0,
            x[0] * x[4] - 1.0,
        ])

    return _p("hs047", f, c,
              x0=[2.0, np.sqrt(2.0), -1.0, 2.0 - np.sqrt(2.0), 0.5],
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs049", f_star=0.0)
def hs049():
    def f(x):
        return ((x[0] - x[1]) ** 2 + (x[2] - 1.0) ** 2
                + (x[3] - 1.0) ** 4 + (x[4] - 1.0) ** 6)

    def c(x):
        return torch.stack([x[0] + x[1] + x[2] + 4.0 * x[3] - 7.0,
                            x[2] + 5.0 * x[4] - 6.0])

    return _p("hs049", f, c, x0=[10.0, 7.0, 2.0, -3.0, 0.8],
              c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs050", f_star=0.0)
def hs050():
    def f(x):
        return ((x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 2
                + (x[2] - x[3]) ** 4 + (x[3] - x[4]) ** 2)

    def c(x):
        return torch.stack([
            x[0] + 2.0 * x[1] + 3.0 * x[2] - 6.0,
            x[1] + 2.0 * x[2] + 3.0 * x[3] - 6.0,
            x[2] + 2.0 * x[3] + 3.0 * x[4] - 6.0,
        ])

    return _p("hs050", f, c, x0=[35.0, -31.0, 11.0, 5.0, -5.0],
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs051", f_star=0.0)
def hs051():
    def f(x):
        return ((x[0] - x[1]) ** 2 + (x[1] + x[2] - 2.0) ** 2
                + (x[3] - 1.0) ** 2 + (x[4] - 1.0) ** 2)

    def c(x):
        return torch.stack([x[0] + 3.0 * x[1] - 4.0,
                            x[2] + x[3] - 2.0 * x[4],
                            x[1] - x[4]])

    return _p("hs051", f, c, x0=[2.5, 0.5, 2.0, -1.0, 0.5],
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs052", f_star=1859.0 / 349.0)
def hs052():
    def f(x):
        return ((4.0 * x[0] - x[1]) ** 2 + (x[1] + x[2] - 2.0) ** 2
                + (x[3] - 1.0) ** 2 + (x[4] - 1.0) ** 2)

    def c(x):
        return torch.stack([x[0] + 3.0 * x[1],
                            x[2] + x[3] - 2.0 * x[4],
                            x[1] - x[4]])

    return _p("hs052", f, c, x0=[2.0] * 5, c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs053", f_star=176.0 / 43.0)
def hs053():
    def f(x):
        return ((x[0] - x[1]) ** 2 + (x[1] + x[2] - 2.0) ** 2
                + (x[3] - 1.0) ** 2 + (x[4] - 1.0) ** 2)

    def c(x):
        return torch.stack([x[0] + 3.0 * x[1],
                            x[2] + x[3] - 2.0 * x[4],
                            x[1] - x[4]])

    return _p("hs053", f, c, x0=[2.0] * 5,
              x_lb=[-10.0] * 5, x_ub=[10.0] * 5,
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs055", f_star=19.0 / 3.0, local_optima=(20.0 / 3.0,))
def hs055():
    # rank-deficient equality Jacobian (6 constraints, rank 5)
    def f(x):
        return x[0] + 2.0 * x[1] + 4.0 * x[4] + torch.exp(x[0] * x[3])

    def c(x):
        return torch.stack([
            x[0] + 2.0 * x[1] + 5.0 * x[4] - 6.0,
            x[0] + x[1] + x[2] - 3.0,
            x[3] + x[4] + x[5] - 2.0,
            x[0] + x[3] - 1.0,
            x[1] + x[4] - 2.0,
            x[2] + x[5] - 2.0,
        ])

    return _p("hs055", f, c, x0=[1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
              x_lb=[0.0] * 6, x_ub=[1.0, INF, INF, 1.0, INF, INF],
              c_lb=[0.0] * 6, c_ub=[0.0] * 6)


@register("hs056", f_star=-3.456)
def hs056():
    a = float(np.arcsin(np.sqrt(1.0 / 4.2)))
    b = float(np.arcsin(np.sqrt(5.0 / 7.2)))

    def f(x):
        return -x[0] * x[1] * x[2]

    def c(x):
        return torch.stack([
            x[0] - 4.2 * torch.sin(x[3]) ** 2,
            x[1] - 4.2 * torch.sin(x[4]) ** 2,
            x[2] - 4.2 * torch.sin(x[5]) ** 2,
            x[0] + 2.0 * x[1] + 2.0 * x[2] - 7.2 * torch.sin(x[6]) ** 2,
        ])

    return _p("hs056", f, c, x0=[1.0, 1.0, 1.0, a, a, a, b],
              c_lb=[0.0] * 4, c_ub=[0.0] * 4)


@register("hs060", f_star=0.03256820025)
def hs060():
    return _p("hs060",
              lambda x: ((x[0] - 1.0) ** 2 + (x[0] - x[1]) ** 2
                         + (x[1] - x[2]) ** 4),
              lambda x: torch.stack([x[0] * (1.0 + x[1] ** 2) + x[2] ** 4
                                     - 4.0 - 3.0 * np.sqrt(2.0)]),
              x0=[2.0] * 3, x_lb=[-10.0] * 3, x_ub=[10.0] * 3,
              c_lb=[0.0], c_ub=[0.0])


@register("hs061", f_star=-143.6461422)
def hs061():
    return _p("hs061",
              lambda x: (4.0 * x[0] ** 2 + 2.0 * x[1] ** 2 + 2.0 * x[2] ** 2
                         - 33.0 * x[0] + 16.0 * x[1] - 24.0 * x[2]),
              lambda x: torch.stack([3.0 * x[0] - 2.0 * x[1] ** 2 - 7.0,
                                     4.0 * x[0] - x[2] ** 2 - 11.0]),
              x0=[0.0] * 3, c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs062", f_star=-26272.51448)
def hs062():
    def f(x):
        return -32.174 * (
            255.0 * torch.log((x[0] + x[1] + x[2] + 0.03)
                              / (0.09 * x[0] + x[1] + x[2] + 0.03))
            + 280.0 * torch.log((x[1] + x[2] + 0.03)
                                / (0.07 * x[1] + x[2] + 0.03))
            + 290.0 * torch.log((x[2] + 0.03) / (0.13 * x[2] + 0.03)))

    return _p("hs062", f,
              lambda x: torch.stack([x[0] + x[1] + x[2] - 1.0]),
              x0=[0.7, 0.2, 0.1], x_lb=[0.0] * 3, x_ub=[1.0] * 3,
              c_lb=[0.0], c_ub=[0.0])


@register("hs063", f_star=961.7151721)
def hs063():
    return _p("hs063",
              lambda x: (1000.0 - x[0] ** 2 - 2.0 * x[1] ** 2 - x[2] ** 2
                         - x[0] * x[1] - x[0] * x[2]),
              lambda x: torch.stack([
                  8.0 * x[0] + 14.0 * x[1] + 7.0 * x[2] - 56.0,
                  x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 25.0,
              ]),
              x0=[2.0] * 3, x_lb=[0.0] * 3, x_ub=[INF] * 3,
              c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs064", f_star=6299.842428)
def hs064():
    def f(x):
        return (5.0 * x[0] + 50000.0 / x[0] + 20.0 * x[1] + 72000.0 / x[1]
                + 10.0 * x[2] + 144000.0 / x[2])

    def c(x):
        return torch.stack([1.0 - 4.0 / x[0] - 32.0 / x[1] - 120.0 / x[2]])

    return _p("hs064", f, c, x0=[1.0] * 3,
              x_lb=[1e-5] * 3, x_ub=[INF] * 3, c_lb=[0.0], c_ub=[INF])


@register("hs065", f_star=0.9535288567)
def hs065():
    return _p("hs065",
              lambda x: ((x[0] - x[1]) ** 2 + (x[0] + x[1] - 10.0) ** 2 / 9.0
                         + (x[2] - 5.0) ** 2),
              lambda x: torch.stack([48.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2]),
              x0=[-5.0, 5.0, 0.0], x_lb=[-4.5, -4.5, -5.0],
              x_ub=[4.5, 4.5, 5.0], c_lb=[0.0], c_ub=[INF])


@register("hs066", f_star=0.5181632741)
def hs066():
    return _p("hs066", lambda x: 0.2 * x[2] - 0.8 * x[0],
              lambda x: torch.stack([x[1] - torch.exp(x[0]),
                                     x[2] - torch.exp(x[1])]),
              x0=[0.0, 1.05, 2.9], x_lb=[0.0] * 3, x_ub=[100.0, 100.0, 10.0],
              c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs072", f_star=727.67937)
def hs072():
    def c(x):
        return torch.stack([
            0.0401 - 4.0 / x[0] - 2.25 / x[1] - 1.0 / x[2] - 0.25 / x[3],
            0.010085 - 0.16 / x[0] - 0.36 / x[1] - 0.64 / x[2] - 0.64 / x[3],
        ])

    return _p("hs072", lambda x: 1.0 + x[0] + x[1] + x[2] + x[3], c,
              x0=[1.0] * 4, x_lb=[0.001] * 4,
              x_ub=[4e5, 3e5, 2e5, 1e5], c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs073", f_star=29.894378)
def hs073():
    def c(x):
        return torch.stack([
            2.3 * x[0] + 5.6 * x[1] + 11.1 * x[2] + 1.3 * x[3] - 5.0,
            12.0 * x[0] + 11.9 * x[1] + 41.8 * x[2] + 52.1 * x[3] - 21.0
            - 1.645 * torch.sqrt(0.28 * x[0] ** 2 + 0.19 * x[1] ** 2
                                 + 20.5 * x[2] ** 2 + 0.62 * x[3] ** 2),
            x[0] + x[1] + x[2] + x[3] - 1.0,
        ])

    return _p("hs073",
              lambda x: 24.55 * x[0] + 26.75 * x[1] + 39.0 * x[2] + 40.5 * x[3],
              c, x0=[1.0] * 4, x_lb=[0.0] * 4, x_ub=[INF] * 4,
              c_lb=[0.0, 0.0, 0.0], c_ub=[INF, INF, 0.0])


def _hs074_75(name, a):
    def f(x):
        return (3.0 * x[0] + 1e-6 * x[0] ** 3 + 2.0 * x[1]
                + (2e-6 / 3.0) * x[1] ** 3)

    def c(x):
        return torch.stack([
            x[3] - x[2] + a,
            x[2] - x[3] + a,
            1000.0 * torch.sin(-x[2] - 0.25) + 1000.0 * torch.sin(-x[3] - 0.25)
            + 894.8 - x[0],
            1000.0 * torch.sin(x[2] - 0.25) + 1000.0 * torch.sin(x[2] - x[3] - 0.25)
            + 894.8 - x[1],
            1000.0 * torch.sin(x[3] - 0.25) + 1000.0 * torch.sin(x[3] - x[2] - 0.25)
            + 1294.8,
        ])

    return _p(name, f, c, x0=[0.0] * 4,
              x_lb=[0.0, 0.0, -a, -a], x_ub=[1200.0, 1200.0, a, a],
              c_lb=[0.0, 0.0, 0.0, 0.0, 0.0], c_ub=[INF, INF, 0.0, 0.0, 0.0])


@register("hs074", f_star=5126.4981)
def hs074():
    return _hs074_75("hs074", 0.55)


@register("hs075", f_star=5174.4127)
def hs075():
    return _hs074_75("hs075", 0.48)


@register("hs076", f_star=-4.681818181)
def hs076():
    def f(x):
        return (x[0] ** 2 + 0.5 * x[1] ** 2 + x[2] ** 2 + 0.5 * x[3] ** 2
                - x[0] * x[2] + x[2] * x[3] - x[0] - 3.0 * x[1] + x[2] - x[3])

    def c(x):
        return torch.stack([
            5.0 - x[0] - 2.0 * x[1] - x[2] - x[3],
            4.0 - 3.0 * x[0] - x[1] - 2.0 * x[2] + x[3],
            x[1] + 4.0 * x[2] - 1.5,
        ])

    return _p("hs076", f, c, x0=[0.5] * 4, x_lb=[0.0] * 4, x_ub=[INF] * 4,
              c_lb=[0.0] * 3, c_ub=[INF] * 3)


@register("hs077", f_star=0.24150513)
def hs077():
    def f(x):
        return ((x[0] - 1.0) ** 2 + (x[0] - x[1]) ** 2 + (x[2] - 1.0) ** 2
                + (x[3] - 1.0) ** 4 + (x[4] - 1.0) ** 6)

    def c(x):
        return torch.stack([
            x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 2.0 * np.sqrt(2.0),
            x[1] + x[2] ** 4 * x[3] ** 2 - 8.0 - np.sqrt(2.0),
        ])

    return _p("hs077", f, c, x0=[2.0] * 5, c_lb=[0.0, 0.0], c_ub=[0.0, 0.0])


@register("hs078", f_star=-2.91970041)
def hs078():
    def c(x):
        return torch.stack([
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ])

    return _p("hs078", lambda x: x[0] * x[1] * x[2] * x[3] * x[4], c,
              x0=[-2.0, 1.5, 2.0, -1.0, -1.0],
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs079", f_star=0.0787768209)
def hs079():
    def f(x):
        return ((x[0] - 1.0) ** 2 + (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 2
                + (x[2] - x[3]) ** 4 + (x[3] - x[4]) ** 4)

    def c(x):
        return torch.stack([
            x[0] + x[1] ** 2 + x[2] ** 3 - 2.0 - 3.0 * np.sqrt(2.0),
            x[1] - x[2] ** 2 + x[3] + 2.0 - 2.0 * np.sqrt(2.0),
            x[0] * x[4] - 2.0,
        ])

    return _p("hs079", f, c, x0=[2.0] * 5, c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs080", f_star=0.0539498478)
def hs080():
    def c(x):
        return torch.stack([
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ])

    return _p("hs080", lambda x: torch.exp(x[0] * x[1] * x[2] * x[3] * x[4]), c,
              x0=[-2.0, 2.0, 2.0, -1.0, -1.0],
              x_lb=[-2.3, -2.3, -3.2, -3.2, -3.2],
              x_ub=[2.3, 2.3, 3.2, 3.2, 3.2],
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs081", f_star=0.0539498478)
def hs081():
    def f(x):
        return (torch.exp(x[0] * x[1] * x[2] * x[3] * x[4])
                - 0.5 * (x[0] ** 3 + x[1] ** 3 + 1.0) ** 2)

    def c(x):
        return torch.stack([
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ])

    return _p("hs081", f, c, x0=[-2.0, 2.0, 2.0, -1.0, -1.0],
              x_lb=[-2.3, -2.3, -3.2, -3.2, -3.2],
              x_ub=[2.3, 2.3, 3.2, 3.2, 3.2],
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs083", f_star=-30665.53867)
def hs083():
    a = np.array([85.334407, 0.0056858, 0.0006262, 0.0022053,
                  80.51249, 0.0071317, 0.0029955, 0.0021813,
                  9.300961, 0.0047026, 0.0012547, 0.0019085])

    def f(x):
        return (5.3578547 * x[2] ** 2 + 0.8356891 * x[0] * x[4]
                + 37.293239 * x[0] - 40792.141)

    def c(x):
        return torch.stack([
            a[0] + a[1] * x[1] * x[4] + a[2] * x[0] * x[3] - a[3] * x[2] * x[4],
            a[4] + a[5] * x[1] * x[4] + a[6] * x[0] * x[1] + a[7] * x[2] ** 2,
            a[8] + a[9] * x[2] * x[4] + a[10] * x[0] * x[2] + a[11] * x[2] * x[3],
        ])

    return _p("hs083", f, c, x0=[78.0, 33.0, 27.0, 27.0, 27.0],
              x_lb=[78.0, 33.0, 27.0, 27.0, 27.0],
              x_ub=[102.0, 45.0, 45.0, 45.0, 45.0],
              c_lb=[0.0, 90.0, 20.0], c_ub=[92.0, 110.0, 25.0])


@register("hs086", f_star=-32.34867897)
def hs086():
    # Colville No. 1
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

    def f(x):
        ej, Cj, dj = (const(cache, a, x, name=k)
                      for k, a in (("e", e), ("C", C), ("d", d)))
        return ej @ x + x @ (Cj @ x) + dj @ (x ** 3)

    def c(x):
        return const(cache, A, x, name="A") @ x - const(cache, b, x, name="b")

    return _p("hs086", f, c, x0=[0.0, 0.0, 0.0, 0.0, 1.0],
              x_lb=[0.0] * 5, x_ub=[INF] * 5,
              c_lb=[0.0] * 10, c_ub=[INF] * 10)


@register("hs093", f_star=135.075961)
def hs093():
    def f(x):
        return (0.0204 * x[0] * x[3] * (x[0] + x[1] + x[2])
                + 0.0187 * x[1] * x[2] * (x[0] + 1.57 * x[1] + x[3])
                + 0.0607 * x[0] * x[3] * x[4] ** 2 * (x[0] + x[1] + x[2])
                + 0.0437 * x[1] * x[2] * x[5] ** 2 * (x[0] + 1.57 * x[1] + x[3]))

    def c(x):
        return torch.stack([
            0.001 * x[0] * x[1] * x[2] * x[3] * x[4] * x[5] - 2.07,
            1.0 - 0.00062 * x[0] * x[3] * x[4] ** 2 * (x[0] + x[1] + x[2])
            - 0.00058 * x[1] * x[2] * x[5] ** 2 * (x[0] + 1.57 * x[1] + x[3]),
        ])

    return _p("hs093", f, c, x0=[5.54, 4.4, 12.02, 11.82, 0.702, 0.852],
              x_lb=[0.0] * 6, x_ub=[INF] * 6,
              c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs106", f_star=7049.330923)
def hs106():
    # heat exchanger design
    def f(x):
        return x[0] + x[1] + x[2]

    def c(x):
        return torch.stack([
            1.0 - 0.0025 * (x[3] + x[5]),
            1.0 - 0.0025 * (x[4] + x[6] - x[3]),
            1.0 - 0.01 * (x[7] - x[4]),
            x[0] * x[5] - 833.33252 * x[3] - 100.0 * x[0] + 83333.333,
            x[1] * x[6] - 1250.0 * x[4] - x[1] * x[3] + 1250.0 * x[3],
            x[2] * x[7] - 1250000.0 - x[2] * x[4] + 2500.0 * x[4],
        ])

    return _p("hs106", f, c,
              x0=[5000.0, 5000.0, 5000.0, 200.0, 350.0, 150.0, 225.0, 425.0],
              x_lb=[100.0, 1000.0, 1000.0] + [10.0] * 5,
              x_ub=[10000.0] * 3 + [1000.0] * 5,
              c_lb=[0.0] * 6, c_ub=[INF] * 6)


@register("hs108", f_star=-0.8660254038, local_optima=(-0.67498143,))
def hs108():
    def f(x):
        return -0.5 * (x[0] * x[3] - x[1] * x[2] + x[2] * x[8]
                       - x[4] * x[8] + x[4] * x[7] - x[5] * x[6])

    def c(x):
        return torch.stack([
            1.0 - x[2] ** 2 - x[3] ** 2,
            1.0 - x[4] ** 2 - x[5] ** 2,
            1.0 - x[8] ** 2,
            1.0 - x[0] ** 2 - (x[1] - x[8]) ** 2,
            1.0 - (x[0] - x[4]) ** 2 - (x[1] - x[5]) ** 2,
            1.0 - (x[0] - x[6]) ** 2 - (x[1] - x[7]) ** 2,
            1.0 - (x[2] - x[6]) ** 2 - (x[3] - x[7]) ** 2,
            1.0 - (x[2] - x[4]) ** 2 - (x[3] - x[5]) ** 2,
            1.0 - x[6] ** 2 - (x[7] - x[8]) ** 2,
            x[0] * x[3] - x[1] * x[2],
            x[2] * x[8],
            -x[4] * x[8],
            x[4] * x[7] - x[5] * x[6],
        ])

    return _p("hs108", f, c, x0=[1.0] * 9,
              x_lb=[-INF] * 8 + [0.0], x_ub=[INF] * 9,
              c_lb=[0.0] * 13, c_ub=[INF] * 13)


@register("hs110", f_star=-45.77846971)
def hs110():
    def f(x):
        return (torch.sum(torch.log(x - 2.0) ** 2 + torch.log(10.0 - x) ** 2)
                - torch.prod(x) ** 0.2)

    return _p("hs110", f, None, x0=[9.0] * 10,
              x_lb=[2.001] * 10, x_ub=[9.999] * 10)


_HS111_C = np.array([-6.089, -17.164, -34.054, -5.914, -24.721,
                     -14.986, -24.100, -10.708, -26.662, -22.179])


@register("hs111", f_star=-47.76109026)
def hs111():
    cache: dict = {}

    def f(x):
        cj = const(cache, _HS111_C, x)
        ex = torch.exp(x)
        return torch.sum(ex * (cj + x - torch.log(torch.sum(ex))))

    def c(x):
        ex = torch.exp(x)
        return torch.stack([
            ex[0] + 2.0 * ex[1] + 2.0 * ex[2] + ex[5] + ex[9] - 2.0,
            ex[3] + 2.0 * ex[4] + ex[5] + ex[6] - 1.0,
            ex[2] + ex[6] + ex[7] + 2.0 * ex[8] + ex[9] - 1.0,
        ])

    return _p("hs111", f, c, x0=[-2.3] * 10,
              x_lb=[-100.0] * 10, x_ub=[100.0] * 10,
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs112", f_star=-47.7610908594)  # book value -47.707579 is at a
# slightly infeasible point; modern solvers (and scipy) reach -47.76109
def hs112():
    cache: dict = {}

    def f(x):
        cj = const(cache, _HS111_C, x)
        return torch.sum(x * (cj + torch.log(x / torch.sum(x))))

    def c(x):
        return torch.stack([
            x[0] + 2.0 * x[1] + 2.0 * x[2] + x[5] + x[9] - 2.0,
            x[3] + 2.0 * x[4] + x[5] + x[6] - 1.0,
            x[2] + x[6] + x[7] + 2.0 * x[8] + x[9] - 1.0,
        ])

    return _p("hs112", f, c, x0=[0.1] * 10,
              x_lb=[1e-6] * 10, x_ub=[INF] * 10,
              c_lb=[0.0] * 3, c_ub=[0.0] * 3)


@register("hs113", f_star=24.3062091)
def hs113():
    # Wong No. 2
    def f(x):
        return (x[0] ** 2 + x[1] ** 2 + x[0] * x[1] - 14.0 * x[0]
                - 16.0 * x[1] + (x[2] - 10.0) ** 2 + 4.0 * (x[3] - 5.0) ** 2
                + (x[4] - 3.0) ** 2 + 2.0 * (x[5] - 1.0) ** 2 + 5.0 * x[6] ** 2
                + 7.0 * (x[7] - 11.0) ** 2 + 2.0 * (x[8] - 10.0) ** 2
                + (x[9] - 7.0) ** 2 + 45.0)

    def c(x):
        return torch.stack([
            105.0 - 4.0 * x[0] - 5.0 * x[1] + 3.0 * x[6] - 9.0 * x[7],
            -10.0 * x[0] + 8.0 * x[1] + 17.0 * x[6] - 2.0 * x[7],
            8.0 * x[0] - 2.0 * x[1] - 5.0 * x[8] + 2.0 * x[9] + 12.0,
            -3.0 * (x[0] - 2.0) ** 2 - 4.0 * (x[1] - 3.0) ** 2
            - 2.0 * x[2] ** 2 + 7.0 * x[3] + 120.0,
            -5.0 * x[0] ** 2 - 8.0 * x[1] - (x[2] - 6.0) ** 2
            + 2.0 * x[3] + 40.0,
            -x[0] ** 2 - 2.0 * (x[1] - 2.0) ** 2 + 2.0 * x[0] * x[1]
            - 14.0 * x[4] + 6.0 * x[5],
            -0.5 * (x[0] - 8.0) ** 2 - 2.0 * (x[1] - 4.0) ** 2
            - 3.0 * x[4] ** 2 + x[5] + 30.0,
            3.0 * x[0] - 6.0 * x[1] - 12.0 * (x[8] - 8.0) ** 2 + 7.0 * x[9],
        ])

    return _p("hs113", f, c, x0=[2.0, 3.0, 5.0, 5.0, 1.0, 2.0, 7.0, 3.0, 6.0, 10.0],
              c_lb=[0.0] * 8, c_ub=[INF] * 8)


@register("hs118", f_star=664.82045)
def hs118():
    def f(x):
        x1, x2, x3 = x[0::3], x[1::3], x[2::3]
        return torch.sum(2.3 * x1 + 0.0001 * x1 ** 2 + 1.7 * x2
                         + 0.0001 * x2 ** 2 + 2.2 * x3 + 0.00015 * x3 ** 2)

    def c(x):
        rows = []
        for k in range(1, 5):
            rows.append(x[3 * k] - x[3 * k - 3] + 7.0)       # in [0, 13]
            rows.append(x[3 * k + 1] - x[3 * k - 2] + 7.0)   # in [0, 14]
            rows.append(x[3 * k + 2] - x[3 * k - 1] + 7.0)   # in [0, 13]
        rows.extend([
            x[0] + x[1] + x[2] - 60.0,
            x[3] + x[4] + x[5] - 50.0,
            x[6] + x[7] + x[8] - 70.0,
            x[9] + x[10] + x[11] - 85.0,
            x[12] + x[13] + x[14] - 100.0,
        ])
        return torch.stack(rows)

    c_lb = []
    c_ub = []
    for _ in range(1, 5):
        c_lb.extend([0.0, 0.0, 0.0])
        c_ub.extend([13.0, 14.0, 13.0])
    c_lb.extend([0.0] * 5)
    c_ub.extend([INF] * 5)

    x_lb = [8.0, 43.0, 3.0] + [0.0] * 12
    x_ub = [21.0, 57.0, 16.0] + [90.0, 120.0, 60.0] * 4
    x0 = [20.0, 55.0, 15.0, 20.0, 60.0, 20.0, 20.0, 60.0, 20.0,
          20.0, 60.0, 20.0, 20.0, 60.0, 20.0]
    return _p("hs118", f, c, x0=x0, x_lb=x_lb, x_ub=x_ub,
              c_lb=c_lb, c_ub=c_ub)
