"""Built-in problems in torch: hs015 (uno_tpu/model/library.py:61-75) and
the flagship batch family of uno_tpu's bench (n variables, m=2)."""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.model.nlp import INF, NLP, nlp_from_functions

HS015_OPTIMUM = 306.5


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
