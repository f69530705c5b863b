"""Built-in problems in torch: copies of Hock-Schittkowski problems of
uno_tpu/model/library.py (hs014, hs015, hs016, hs021, hs035, hs038, hs071,
hs100)
with their known optima, uno_tpu's random convex `scalable_quadratic`, and
the flagship batch family of uno_tpu's bench (n variables, m=2).  `get_problem` also gives the scalable structured
families under uno_tpu's keys (model/library_cutest.py, e.g.
"lukvle1_n100") and the `.nl` fixtures (model/library_nl.py)."""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.model.nlp import INF, NLP, const, nlp_from_functions

HS015_OPTIMUM = 306.5
# the Hock-Schittkowski optima (uno_tpu/model/library.py); hs016 has a
# second local optimum, 3.9820604541
OPTIMA = {"hs014": 9.0 - 2.875 * np.sqrt(7.0), "hs015": HS015_OPTIMUM,
          "hs016": 0.25, "hs021": -99.96, "hs035": 1.0 / 9.0, "hs038": 0.0,
          "hs071": 17.0140173, "hs100": 680.6300573}


def hs015() -> NLP:
    # min 100(x2-x1^2)^2 + (1-x1)^2
    # s.t. x1*x2 >= 1; x1 + x2^2 >= 0; x1 <= 1/2  (examples/hs015.mod)
    def f(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def c(x):
        return torch.stack([x[0] * x[1], x[0] + x[1] ** 2])

    return nlp_from_functions(
        "hs015", f, c,
        x0=[-2.0, 1.0],
        x_lb=[-INF, -INF], x_ub=[0.5, INF],
        c_lb=[1.0, 0.0], c_ub=[INF, INF],
    )


def hs014() -> NLP:
    def f(x):
        return (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2

    def c(x):
        return torch.stack([
            x[0] - 2.0 * x[1],                       # == -1
            -0.25 * x[0] ** 2 - x[1] ** 2 + 1.0,     # >= 0
        ])

    return nlp_from_functions("hs014", f, c, x0=[2.0, 2.0],
                              c_lb=[-1.0, 0.0], c_ub=[-1.0, INF])


def hs016() -> NLP:
    def f(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def c(x):
        return torch.stack([x[0] + x[1] ** 2, x[0] ** 2 + x[1]])

    return nlp_from_functions(
        "hs016", f, c, x0=[-2.0, 1.0],
        x_lb=[-2.0, -INF], x_ub=[0.5, 1.0],
        c_lb=[0.0, 0.0], c_ub=[INF, INF],
    )


def hs021() -> NLP:
    # min 0.01 x1^2 + x2^2 - 100  s.t. 10 x1 - x2 >= 10, 2 <= x1 <= 50,
    # -50 <= x2 <= 50: a convex QP, uno_tpu's test of the Hessian models
    def f(x):
        return 0.01 * x[0] ** 2 + x[1] ** 2 - 100.0

    def c(x):
        return torch.stack([10.0 * x[0] - x[1]])

    return nlp_from_functions(
        "hs021", f, c, x0=[-1.0, -1.0],
        x_lb=[2.0, -50.0], x_ub=[50.0, 50.0],
        c_lb=[10.0], c_ub=[INF],
    )


def hs035() -> NLP:
    def f(x):
        return (9.0 - 8.0 * x[0] - 6.0 * x[1] - 4.0 * x[2]
                + 2.0 * x[0] ** 2 + 2.0 * x[1] ** 2 + x[2] ** 2
                + 2.0 * x[0] * x[1] + 2.0 * x[0] * x[2])

    def c(x):
        return torch.stack([3.0 - x[0] - x[1] - 2.0 * x[2]])

    return nlp_from_functions(
        "hs035", f, c, x0=[0.5, 0.5, 0.5],
        x_lb=[0.0, 0.0, 0.0], x_ub=[INF, INF, INF],
        c_lb=[0.0], c_ub=[INF],
    )


def hs038() -> NLP:
    def f(x):
        return (100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
                + 90.0 * (x[3] - x[2] ** 2) ** 2 + (1.0 - x[2]) ** 2
                + 10.1 * ((x[1] - 1.0) ** 2 + (x[3] - 1.0) ** 2)
                + 19.8 * (x[1] - 1.0) * (x[3] - 1.0))

    return nlp_from_functions(
        "hs038", f, None, x0=[-3.0, -1.0, -3.0, -1.0],
        x_lb=[-10.0] * 4, x_ub=[10.0] * 4,
    )


def hs071() -> NLP:
    def f(x):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def c(x):
        return torch.stack([
            x[0] * x[1] * x[2] * x[3],
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2,
        ])

    return nlp_from_functions(
        "hs071", f, c, x0=[1.0, 5.0, 5.0, 1.0],
        x_lb=[1.0] * 4, x_ub=[5.0] * 4,
        c_lb=[25.0, 40.0], c_ub=[INF, 40.0],
    )


def hs100() -> NLP:
    def f(x):
        return ((x[0] - 10.0) ** 2 + 5.0 * (x[1] - 12.0) ** 2 + x[2] ** 4
                + 3.0 * (x[3] - 11.0) ** 2 + 10.0 * x[4] ** 6 + 7.0 * x[5] ** 2
                + x[6] ** 4 - 4.0 * x[5] * x[6] - 10.0 * x[5] - 8.0 * x[6])

    def c(x):
        return torch.stack([
            127.0 - 2.0 * x[0] ** 2 - 3.0 * x[1] ** 4 - x[2] - 4.0 * x[3] ** 2 - 5.0 * x[4],
            282.0 - 7.0 * x[0] - 3.0 * x[1] - 10.0 * x[2] ** 2 - x[3] + x[4],
            196.0 - 23.0 * x[0] - x[1] ** 2 - 6.0 * x[5] ** 2 + 8.0 * x[6],
            -4.0 * x[0] ** 2 - x[1] ** 2 + 3.0 * x[0] * x[1] - 2.0 * x[2] ** 2
            - 5.0 * x[5] + 11.0 * x[6],
        ])

    return nlp_from_functions(
        "hs100", f, c, x0=[1.0, 2.0, 0.0, 4.0, 0.0, 1.0, 1.0],
        c_lb=[0.0] * 4, c_ub=[INF] * 4,
    )


def get_problem(name: str) -> NLP:
    """One of the built-in Hock-Schittkowski problems, a structured family
    instance under uno_tpu's key (model/library_cutest.py), or an `.nl`
    fixture of tests/fixtures/nl as `nl_<stem>` (model/library_nl.py), by
    name."""
    from uno_tpu_torch.model.library_cutest import REGISTRY
    from uno_tpu_torch.model.library_nl import NL_FIXTURES
    builders = {"hs014": hs014, "hs015": hs015, "hs016": hs016,
                "hs021": hs021, "hs035": hs035, "hs038": hs038, "hs071": hs071,
                "hs100": hs100}
    if name in NL_FIXTURES:
        return NL_FIXTURES[name]()
    if name in REGISTRY:
        return REGISTRY[name][0]()
    if name not in builders:
        raise KeyError(f"{name!r}: the port's library has {sorted(builders)}, "
                       f"the structured families {sorted(REGISTRY)} "
                       f"and the .nl fixtures {sorted(NL_FIXTURES)}")
    return builders[name]()


def known_optimum(name: str):
    """The optimum uno_tpu registers for `name`, or None."""
    from uno_tpu_torch.model.library_cutest import REGISTRY
    if name in REGISTRY:
        return REGISTRY[name][1]
    return OPTIMA.get(name)


def flagship(batch: int, n: int = 8, seed: int = 0):
    """The flagship family: min ||x - p||^2 + 0.1 sum x_i x_{i+1}
    s.t. sum(x) >= 1, ||x||^2 <= 2, x >= 0, with p ~ U(-0.5, 1)^n per
    instance.  Returns (nlp, x0 (batch, n), params (batch, n)), as numpy,
    from the same seed as uno_tpu's bench."""

    def f(x, p):
        return torch.sum((x - p) ** 2) + 0.1 * torch.sum(x[:-1] * x[1:])

    def c(x, p):
        return torch.stack([torch.sum(x) - 1.0, torch.sum(x * x) - 2.0])

    nlp = nlp_from_functions(
        f"flagship_n{n}", f, c,
        x0=np.full(n, 0.5),
        x_lb=np.zeros(n), x_ub=np.full(n, INF),
        c_lb=[0.0, -INF], c_ub=[INF, 0.0],
        params=np.zeros(n),
    )
    rng = np.random.default_rng(seed)
    params = rng.uniform(-0.5, 1.0, (batch, n))
    x0 = np.tile(np.full(n, 0.5), (batch, 1))
    return nlp, x0, params


def scalable_quadratic(n: int, m: int, seed: int = 0) -> NLP:
    """Random strictly convex QP-like NLP with m linear inequalities and
    bounds (uno_tpu/model/library.py:421-443, the same numpy draws)."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    b = rng.uniform(-0.5, 0.5, m)
    cache = {}

    def f(x):
        return 0.5 * x @ (const(cache, Q, x, name="Q") @ x) + const(cache, q, x, name="q") @ x

    def c(x):
        return const(cache, A, x, name="A") @ x - const(cache, b, x, name="b")

    return nlp_from_functions(
        f"scalable_quadratic_{n}x{m}", f, c,
        x0=np.zeros(n), x_lb=np.full(n, -2.0), x_ub=np.full(n, 2.0),
        c_lb=np.full(m, -INF), c_ub=np.zeros(m),
    )
