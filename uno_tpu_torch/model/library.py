"""The problem registry of the port: uno_tpu's whole library of test
problems (uno_tpu/model/library.py and its side modules), under the same
keys, with the same known optima, documented local optima and
self-certification flags, sizes, bounds and structure declarations.

`problem_names()` lists the keys; `get_problem(name)` builds one.  This
module holds the registry and the Hock-Schittkowski core (hs015 and polak5
mirror the reference's example fixtures); importing it imports the side
modules, which register the rest:

* model/library_hs.py, library_hs2.py: the extended Hock-Schittkowski sets;
* model/library_cutest.py: the scalable CUTEst-style families as
  "<family>_n<N>", N the built dimension (`family_names()`), with the
  control and chained families uno_tpu keeps in library_r4.py;
* model/library_mgh.py: the More-Garbow-Hillstrom least squares, classic
  2-variable functions, constrained classics, COPS polygons and further
  scalable families;
* model/library_r4.py: recovered HS problems, engineering designs,
  chpowellsg_eq and the mid-size (n = 30, 300) family instances;
* model/library_nl.py: the AMPL `.nl` fixtures of tests/fixtures/nl as
  "nl_<stem>".

Besides the registry: uno_tpu's random convex `scalable_quadratic`, the
scalable `chained_rosenbrock` and the flagship batch family of uno_tpu's
bench (n variables, m=2)."""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.model.nlp import INF, NLP, const, nlp_from_functions

_REGISTRY: dict = {}


def register(name, f_star=None, local_optima=(), self_certified=False):
    """Register the builder of no arguments under `name`.  f_star: the
    known optimal objective or None; local_optima: further first-order
    values a local solver may legitimately stop at; self_certified: f_star
    is the certified optimum of this encoding rather than the published
    book value (uno_tpu/model/library.py:21-32)."""
    def deco(builder):
        _REGISTRY[name] = (builder, f_star, tuple(local_optima),
                           bool(self_certified))
        return builder
    return deco


def get_problem(name: str) -> NLP:
    """The registered problem `name`, built."""
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not in the registry of {len(_REGISTRY)} "
                       "problems: the Hock-Schittkowski sets, the MGH and "
                       "classic problems, the CUTEst-style families as "
                       "<family>_n<N> and the .nl fixtures as nl_<stem>, "
                       f"{problem_names()}")
    return _REGISTRY[name][0]()


def known_optimum(name: str):
    """The registered optimal objective of `name`, or None."""
    return _REGISTRY[name][1]


def acceptable_optima(name: str):
    """The global optimum followed by the documented local optima (a local
    solver may stop at any of them)."""
    _, f_star, locals_ = _REGISTRY[name][:3]
    return ([] if f_star is None else [f_star]) + list(locals_)


def is_self_certified(name: str) -> bool:
    """True when f_star is certified against this encoding rather than the
    published value (see register())."""
    return _REGISTRY[name][3]


def problem_names():
    return sorted(_REGISTRY)


@register("hs015", f_star=306.5)
def hs015():
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


@register("polak5", f_star=50.0)
def polak5():
    # min u  s.t. -u+3x1^2+50(x1-x2^4-1)^2 <= 0 ; -u+3x1^2+50(x1-x2^4+1)^2 <= 0
    # variables (x1, x2, u), start (0.1, 0.1, 0)  (examples/polak5.mod)
    def f(x):
        return x[2]

    def c(x):
        t = 3.0 * x[0] ** 2
        return torch.stack([
            -x[2] + t + 50.0 * (x[0] - x[1] ** 4 - 1.0) ** 2,
            -x[2] + t + 50.0 * (x[0] - x[1] ** 4 + 1.0) ** 2,
        ])

    return nlp_from_functions(
        "polak5", f, c,
        x0=[0.1, 0.1, 0.0],
        c_lb=[-INF, -INF], c_ub=[0.0, 0.0],
    )


@register("hs001", f_star=0.0)
def hs001():
    def f(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    return nlp_from_functions("hs001", f, None, x0=[-2.0, 1.0],
                              x_lb=[-INF, -1.5], x_ub=[INF, INF])


@register("hs006", f_star=0.0)
def hs006():
    def f(x):
        return (1.0 - x[0]) ** 2

    def c(x):
        return torch.stack([10.0 * (x[1] - x[0] ** 2)])

    return nlp_from_functions("hs006", f, c, x0=[-1.2, 1.0],
                              c_lb=[0.0], c_ub=[0.0])


@register("hs007", f_star=-np.sqrt(3.0))
def hs007():
    def f(x):
        return torch.log(1.0 + x[0] ** 2) - x[1]

    def c(x):
        return torch.stack([(1.0 + x[0] ** 2) ** 2 + x[1] ** 2])

    return nlp_from_functions("hs007", f, c, x0=[2.0, 2.0],
                              c_lb=[4.0], c_ub=[4.0])


@register("hs010", f_star=-1.0)
def hs010():
    def f(x):
        return x[0] - x[1]

    def c(x):
        return torch.stack([-3.0 * x[0] ** 2 + 2.0 * x[0] * x[1] - x[1] ** 2 + 1.0])

    return nlp_from_functions("hs010", f, c, x0=[-10.0, 10.0],
                              c_lb=[0.0], c_ub=[INF])


@register("hs014", f_star=9.0 - 2.875 * np.sqrt(7.0))
def hs014():
    def f(x):
        return (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2

    def c(x):
        return torch.stack([
            x[0] - 2.0 * x[1],                       # == -1
            -0.25 * x[0] ** 2 - x[1] ** 2 + 1.0,     # >= 0
        ])

    return nlp_from_functions("hs014", f, c, x0=[2.0, 2.0],
                              c_lb=[-1.0, 0.0], c_ub=[-1.0, INF])


@register("hs016", f_star=0.25, local_optima=(3.9820604541,))
def hs016():
    def f(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def c(x):
        return torch.stack([x[0] + x[1] ** 2, x[0] ** 2 + x[1]])

    return nlp_from_functions(
        "hs016", f, c, x0=[-2.0, 1.0],
        x_lb=[-2.0, -INF], x_ub=[0.5, 1.0],
        c_lb=[0.0, 0.0], c_ub=[INF, INF],
    )


@register("hs021", f_star=-99.96)
def hs021():
    def f(x):
        return 0.01 * x[0] ** 2 + x[1] ** 2 - 100.0

    def c(x):
        return torch.stack([10.0 * x[0] - x[1]])

    return nlp_from_functions(
        "hs021", f, c, x0=[-1.0, -1.0],
        x_lb=[2.0, -50.0], x_ub=[50.0, 50.0],
        c_lb=[10.0], c_ub=[INF],
    )


@register("hs035", f_star=1.0 / 9.0)
def hs035():
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


@register("hs038", f_star=0.0)
def hs038():
    def f(x):
        return (100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
                + 90.0 * (x[3] - x[2] ** 2) ** 2 + (1.0 - x[2]) ** 2
                + 10.1 * ((x[1] - 1.0) ** 2 + (x[3] - 1.0) ** 2)
                + 19.8 * (x[1] - 1.0) * (x[3] - 1.0))

    return nlp_from_functions(
        "hs038", f, None, x0=[-3.0, -1.0, -3.0, -1.0],
        x_lb=[-10.0] * 4, x_ub=[10.0] * 4,
    )


@register("hs048", f_star=0.0)
def hs048():
    def f(x):
        return (x[0] - 1.0) ** 2 + (x[1] - x[2]) ** 2 + (x[3] - x[4]) ** 2

    def c(x):
        return torch.stack([
            x[0] + x[1] + x[2] + x[3] + x[4],
            x[2] - 2.0 * (x[3] + x[4]),
        ])

    return nlp_from_functions(
        "hs048", f, c, x0=[3.0, 5.0, -3.0, 2.0, -2.0],
        c_lb=[5.0, -3.0], c_ub=[5.0, -3.0],
    )


@register("hs071", f_star=17.0140173)
def hs071():
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


@register("hs100", f_star=680.6300573)
def hs100():
    def f(x):
        return ((x[0] - 10.0) ** 2 + 5.0 * (x[1] - 12.0) ** 2 + x[2] ** 4
                + 3.0 * (x[3] - 11.0) ** 2 + 10.0 * x[4] ** 6 + 7.0 * x[5] ** 2
                + x[6] ** 4 - 4.0 * x[5] * x[6] - 10.0 * x[5] - 8.0 * x[6])

    def c(x):
        return torch.stack([
            127.0 - 2.0 * x[0] ** 2 - 3.0 * x[1] ** 4 - x[2] - 4.0 * x[3] ** 2 - 5.0 * x[4],
            282.0 - 7.0 * x[0] - 3.0 * x[1] - 10.0 * x[2] ** 2 - x[3] + x[4],
            196.0 - 23.0 * x[0] - x[1] ** 2 - 6.0 * x[5] ** 2 + 8.0 * x[6],
            -4.0 * x[0] ** 2 - x[1] ** 2 + 3.0 * x[0] * x[1] - 2.0 * x[2] ** 2 - 5.0 * x[5] + 11.0 * x[6],
        ])

    return nlp_from_functions(
        "hs100", f, c, x0=[1.0, 2.0, 0.0, 4.0, 0.0, 1.0, 1.0],
        c_lb=[0.0] * 4, c_ub=[INF] * 4,
    )


@register("rosenbrock_eq", f_star=0.0)
def rosenbrock_eq():
    # an infeasible-start equality-constrained Rosenbrock variant
    def f(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def c(x):
        return torch.stack([x[0] ** 2 + x[1] ** 2])

    return nlp_from_functions("rosenbrock_eq", f, c, x0=[2.0, 2.0],
                              c_lb=[2.0], c_ub=[2.0])


@register("hs011", f_star=-8.498464223)
def hs011():
    return nlp_from_functions(
        "hs011", lambda x: (x[0] - 5.0) ** 2 + x[1] ** 2 - 25.0,
        lambda x: torch.stack([-x[0] ** 2 + x[1]]),
        x0=[4.9, 0.1], c_lb=[0.0], c_ub=[INF])


@register("hs012", f_star=-30.0)
def hs012():
    return nlp_from_functions(
        "hs012", lambda x: 0.5 * x[0] ** 2 + x[1] ** 2 - x[0] * x[1] - 7.0 * x[0] - 7.0 * x[1],
        lambda x: torch.stack([25.0 - 4.0 * x[0] ** 2 - x[1] ** 2]),
        x0=[0.0, 0.0], c_lb=[0.0], c_ub=[INF])


@register("hs022", f_star=1.0)
def hs022():
    return nlp_from_functions(
        "hs022", lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2,
        lambda x: torch.stack([-x[0] - x[1] + 2.0, -x[0] ** 2 + x[1]]),
        x0=[2.0, 2.0], c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs024", f_star=-1.0)
def hs024():
    s3 = np.sqrt(3.0)
    return nlp_from_functions(
        "hs024", lambda x: ((x[0] - 3.0) ** 2 - 9.0) * x[1] ** 3 / (27.0 * s3),
        lambda x: torch.stack([x[0] / s3 - x[1], x[0] + s3 * x[1],
                               -x[0] - s3 * x[1] + 6.0]),
        x0=[1.0, 0.5], x_lb=[0.0, 0.0], x_ub=[INF, INF],
        c_lb=[0.0] * 3, c_ub=[INF] * 3)


@register("hs028", f_star=0.0)
def hs028():
    return nlp_from_functions(
        "hs028", lambda x: (x[0] + x[1]) ** 2 + (x[1] + x[2]) ** 2,
        lambda x: torch.stack([x[0] + 2.0 * x[1] + 3.0 * x[2]]),
        x0=[-4.0, 1.0, 1.0], c_lb=[1.0], c_ub=[1.0])


@register("hs029", f_star=-16.0 * np.sqrt(2.0))
def hs029():
    return nlp_from_functions(
        "hs029", lambda x: -x[0] * x[1] * x[2],
        lambda x: torch.stack([-x[0] ** 2 - 2.0 * x[1] ** 2 - 4.0 * x[2] ** 2 + 48.0]),
        x0=[1.0, 1.0, 1.0], c_lb=[0.0], c_ub=[INF])


@register("hs030", f_star=1.0)
def hs030():
    return nlp_from_functions(
        "hs030", lambda x: x[0] ** 2 + x[1] ** 2 + x[2] ** 2,
        lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - 1.0]),
        x0=[1.0, 1.0, 1.0], x_lb=[1.0, -10.0, -10.0], x_ub=[10.0] * 3,
        c_lb=[0.0], c_ub=[INF])


@register("hs033", f_star=np.sqrt(2.0) - 6.0, local_optima=(-4.0,))
def hs033():
    return nlp_from_functions(
        "hs033", lambda x: (x[0] - 1.0) * (x[0] - 2.0) * (x[0] - 3.0) + x[2],
        lambda x: torch.stack([x[2] ** 2 - x[1] ** 2 - x[0] ** 2,
                               x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 4.0]),
        x0=[0.0, 0.0, 3.0], x_lb=[0.0] * 3, x_ub=[INF, INF, 5.0],
        c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs036", f_star=-3300.0)
def hs036():
    return nlp_from_functions(
        "hs036", lambda x: -x[0] * x[1] * x[2],
        lambda x: torch.stack([72.0 - x[0] - 2.0 * x[1] - 2.0 * x[2]]),
        x0=[10.0, 10.0, 10.0], x_lb=[0.0] * 3, x_ub=[20.0, 11.0, 42.0],
        c_lb=[0.0], c_ub=[INF])


@register("hs037", f_star=-3456.0)
def hs037():
    return nlp_from_functions(
        "hs037", lambda x: -x[0] * x[1] * x[2],
        lambda x: torch.stack([72.0 - x[0] - 2.0 * x[1] - 2.0 * x[2],
                               x[0] + 2.0 * x[1] + 2.0 * x[2]]),
        x0=[10.0, 10.0, 10.0], x_lb=[0.0] * 3, x_ub=[42.0] * 3,
        c_lb=[0.0, 0.0], c_ub=[INF, INF])


@register("hs043", f_star=-44.0)
def hs043():
    # Rosen-Suzuki
    def f(x):
        return (x[0] ** 2 + x[1] ** 2 + 2.0 * x[2] ** 2 + x[3] ** 2
                - 5.0 * x[0] - 5.0 * x[1] - 21.0 * x[2] + 7.0 * x[3])

    def c(x):
        return torch.stack([
            8.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2 - x[3] ** 2 - x[0] + x[1] - x[2] + x[3],
            10.0 - x[0] ** 2 - 2.0 * x[1] ** 2 - x[2] ** 2 - 2.0 * x[3] ** 2 + x[0] + x[3],
            5.0 - 2.0 * x[0] ** 2 - x[1] ** 2 - x[2] ** 2 - 2.0 * x[0] + x[1] + x[3],
        ])

    return nlp_from_functions("hs043", f, c, x0=[0.0] * 4,
                              c_lb=[0.0] * 3, c_ub=[INF] * 3)


@register("hs045", f_star=1.0)
def hs045():
    return nlp_from_functions(
        "hs045", lambda x: 2.0 - x[0] * x[1] * x[2] * x[3] * x[4] / 120.0,
        None, x0=[2.0] * 5, x_lb=[0.0] * 5, x_ub=[1.0, 2.0, 3.0, 4.0, 5.0])


def chained_rosenbrock(n: int) -> NLP:
    """Scalable chained-Rosenbrock with spherical equality + bound
    constraints (CUTEst-style scalable family)."""
    def f(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    def c(x):
        return torch.stack([torch.dot(x, x) - float(n)])

    return nlp_from_functions(
        f"chained_rosenbrock_{n}", f, c,
        x0=np.full(n, 0.5),
        x_lb=np.full(n, -5.0), x_ub=np.full(n, 5.0),
        c_lb=[0.0], c_ub=[INF],
    )


def chained_rosenbrock(n: int) -> NLP:
    """Scalable chained Rosenbrock with a spherical inequality and bounds
    (uno_tpu/model/library.py:404-418)."""
    def f(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    def c(x):
        return torch.stack([torch.dot(x, x) - float(n)])

    return nlp_from_functions(
        f"chained_rosenbrock_{n}", f, c,
        x0=np.full(n, 0.5),
        x_lb=np.full(n, -5.0), x_ub=np.full(n, 5.0),
        c_lb=[0.0], c_ub=[INF],
    )


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


# the side modules register the rest of the library into _REGISTRY
from uno_tpu_torch.model import library_hs  # noqa: E402,F401  (isort: skip)
from uno_tpu_torch.model import library_hs2  # noqa: E402,F401  (isort: skip)
from uno_tpu_torch.model import library_cutest  # noqa: E402,F401  (isort: skip)
from uno_tpu_torch.model import library_mgh  # noqa: E402,F401  (isort: skip)
from uno_tpu_torch.model import library_nl  # noqa: E402,F401  (isort: skip)
from uno_tpu_torch.model import library_r4  # noqa: E402,F401  (isort: skip)
