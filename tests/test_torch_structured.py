"""uno_tpu_torch.solvers.structured against uno_tpu.solvers.structured on
the CPU.

The cases of uno_tpu's tests/test_structured.py (the two-stage family at
S=4 against the monolithic IPM, the same family with bounds active, the
infeasible family that must end in restoration) go through both packages'
solve_structured_ipm from the same numpy data: status and iterations
equal, x0 and xs within 1e-8 (the scenario blocks are factored by other
plain versions in the two packages, so they agree to rounding).  S=8 on a
Gloo world of 2 processes, the scenarios split over the ranks, against one
process within 1e-10 (the sums over scenarios add the ranks' parts in
another order).  JAX is imported inside the tests only: the spawned ranks
import this module.
"""

import numpy as np
import pytest
import torch

from torch_world import run_world
import uno_tpu_torch
from uno_tpu_torch.model.nlp import INF, nlp_from_functions
from uno_tpu_torch.parallel import make_group
from uno_tpu_torch.solvers.structured import ScenarioNLP, solve_structured_ipm

X_ATOL = 1e-8
WORLD_ATOL = 1e-10


def two_stage_data(S, seed=0, a_col2=None):
    """uno_tpu's make_two_stage draws: a ~ U(-0.5, 1.5)^(S, 3), b ~ U(1, 2)^(S, 1);
    a_col2 overrides a[:, 2] (the bounds-active case)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 1.5, (S, 3))
    b = rng.uniform(1.0, 2.0, (S, 1))
    if a_col2 is not None:
        a[:, 2] = a_col2
    return a, b


def two_stage(S=4, seed=0, a_col2=None):
    """min ||x0 - 1||^2 + sum_s ||xs - a_s||^2
       s.t. per scenario: xs_1 + xs_2 + 0.1 x0_1^2 = b_s; xs >= 0."""
    a, b = two_stage_data(S, seed, a_col2)
    n0, ns, m = 2, 3, 1

    def f0(x0):
        return torch.sum((x0 - 1.0) ** 2)

    def fs(x0, xs, p):
        return torch.sum((xs - p["a"]) ** 2)

    def cs(x0, xs, p):
        return torch.stack([xs[0] + xs[1] + 0.1 * x0[0] ** 2 - p["b"][0]])

    return ScenarioNLP(
        name="two_stage", n0=n0, ns=ns, m=m, S=S, f0=f0, fs=fs, cs=cs,
        x0_lb=np.full(n0, -INF), x0_ub=np.full(n0, INF),
        xs_lb=np.zeros(ns), xs_ub=np.full(ns, INF),
        x0_init=np.full(n0, 0.5), xs_init=np.full((S, ns), 0.5),
        params={"a": a, "b": b})


def infeasible():
    """cs = xs_0^2 + 1 = 0 has no solution: restoration must certify it."""
    S, n0, ns, m = 2, 1, 1, 1

    def f0(x0):
        return torch.sum(x0 ** 2)

    def fs(x0, xs, p):
        return torch.sum((xs - 1.0) ** 2)

    def cs(x0, xs, p):
        return torch.stack([xs[0] ** 2 + 1.0])

    return ScenarioNLP(
        name="infeas", n0=n0, ns=ns, m=m, S=S, f0=f0, fs=fs, cs=cs,
        x0_lb=np.full(n0, -INF), x0_ub=np.full(n0, INF),
        xs_lb=np.full(ns, -INF), xs_ub=np.full(ns, INF),
        x0_init=np.zeros(n0), xs_init=np.zeros((S, ns)),
        params={"dummy": np.zeros((S, 1))})


CASES = {"monolithic_S4": (dict(S=4), 200), "bounds_active": (dict(S=4, seed=3, a_col2=-2.0), 200),
         "infeasible": (None, 100)}


def uno_tpu_problem(name):
    import jax.numpy as jnp
    from uno_tpu.solvers.structured import ScenarioNLP as JScenarioNLP
    if name == "infeasible":
        def f0(x0):
            return jnp.sum(x0 ** 2)

        def fs(x0, xs, p):
            return jnp.sum((xs - 1.0) ** 2)

        def cs(x0, xs, p):
            return jnp.array([xs[0] ** 2 + 1.0])

        return JScenarioNLP(
            name="infeas", n0=1, ns=1, m=1, S=2, f0=f0, fs=fs, cs=cs,
            x0_lb=np.full(1, -INF), x0_ub=np.full(1, INF),
            xs_lb=np.full(1, -INF), xs_ub=np.full(1, INF),
            x0_init=np.zeros(1), xs_init=np.zeros((2, 1)),
            params={"dummy": jnp.zeros((2, 1))})
    kw = CASES[name][0]
    a, b = two_stage_data(**kw)
    S = kw["S"]

    def f0(x0):
        return jnp.sum((x0 - 1.0) ** 2)

    def fs(x0, xs, p):
        return jnp.sum((xs - p["a"]) ** 2)

    def cs(x0, xs, p):
        return jnp.array([xs[0] + xs[1] + 0.1 * x0[0] ** 2 - p["b"][0]])

    return JScenarioNLP(
        name="two_stage", n0=2, ns=3, m=1, S=S, f0=f0, fs=fs, cs=cs,
        x0_lb=np.full(2, -INF), x0_ub=np.full(2, INF),
        xs_lb=np.zeros(3), xs_ub=np.full(3, INF),
        x0_init=np.full(2, 0.5), xs_init=np.full((S, 3), 0.5),
        params={"a": jnp.asarray(a), "b": jnp.asarray(b)})


def port_problem(name):
    return infeasible() if name == "infeasible" else two_stage(**CASES[name][0])


@pytest.fixture(scope="module")
def uno_tpu_results():
    from uno_tpu.solvers.structured import solve_structured_ipm as j_solve
    return {name: j_solve(uno_tpu_problem(name), tol=1e-8, max_iterations=its)
            for name, (_, its) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_uno_tpu(name, uno_tpu_results):
    ref = uno_tpu_results[name]
    res = solve_structured_ipm(port_problem(name), tol=1e-8,
                               max_iterations=CASES[name][1], device="cpu")
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert np.max(np.abs(res.x0 - ref.x0)) <= X_ATOL
    assert np.max(np.abs(res.xs - ref.xs)) <= X_ATOL
    assert abs(res.objective - ref.objective) <= X_ATOL * max(1.0, abs(ref.objective))
    expected = {"monolithic_S4": "optimal", "bounds_active": "optimal",
                "infeasible": "infeasible"}[name]
    assert res.status == expected
    if name == "bounds_active":
        assert np.all(res.xs[:, 2] >= -1e-10) and np.all(res.xs[:, 2] <= 1e-6)
    if name == "infeasible":
        assert np.all(np.abs(res.xs) < 1e-4)


def test_matches_the_monolithic_ipm():
    """The flattened problem through the port's own IPM reaches the same x0."""
    snlp = two_stage(S=4)
    res = solve_structured_ipm(snlp, tol=1e-8, device="cpu")
    S, n0, ns = snlp.S, snlp.n0, snlp.ns
    a = torch.as_tensor(snlp.params["a"])
    b = torch.as_tensor(snlp.params["b"])

    def f(z):
        return snlp.f0(z[:n0]) + torch.sum((z[n0:].reshape(S, ns) - a) ** 2)

    def c(z):
        xs = z[n0:].reshape(S, ns)
        return xs[:, 0] + xs[:, 1] + 0.1 * z[0] ** 2 - b[:, 0]

    mono = uno_tpu_torch.solve(nlp_from_functions(
        "mono", f, c, x0=np.full(n0 + S * ns, 0.5),
        x_lb=np.concatenate([np.full(n0, -INF), np.zeros(S * ns)]),
        x_ub=np.full(n0 + S * ns, INF), c_lb=np.zeros(S), c_ub=np.zeros(S)),
        preset="ipopt", scale_functions=False, device="cpu")
    assert mono.success and res.status == "optimal"
    assert abs(res.objective - mono.objective) < 1e-6
    assert np.allclose(res.x0, mono.x[:n0], atol=1e-6)


def test_scenario_nlp_evaluates_the_whole_problem():
    """ScenarioNLP.objective and .constraints (uno_tpu's methods) at the
    solution: the solver's objective, and feasible constraints."""
    snlp = two_stage(S=4)
    res = solve_structured_ipm(snlp, tol=1e-8, device="cpu")
    x0, xs = torch.as_tensor(res.x0), torch.as_tensor(res.xs)
    assert abs(float(snlp.objective(x0, xs)) - res.objective) <= 1e-12 * abs(res.objective)
    c = snlp.constraints(x0, xs)
    assert c.shape == (4, 1) and float(c.abs().max()) <= 1e-8


def world_worker(group):
    res = solve_structured_ipm(two_stage(S=8, seed=1), tol=1e-8, group=group)
    return res.status, res.iterations, res.x0, res.xs, res.y, res.objective


def test_scenarios_split_over_two_ranks():
    one = world_worker(make_group("cpu"))
    alone = solve_structured_ipm(two_stage(S=8, seed=1), tol=1e-8, device="cpu")
    assert one[:2] == (alone.status, alone.iterations) == ("optimal", one[1])
    assert np.array_equal(one[3], alone.xs)     # a world of one is the single program
    for rank in run_world(world_worker, 2):
        assert rank[:2] == one[:2]
        for a, b in zip(rank[2:5], one[2:5]):
            assert a.shape == b.shape and np.max(np.abs(a - b)) <= WORLD_ATOL
        assert abs(rank[5] - one[5]) <= WORLD_ATOL * max(1.0, abs(one[5]))
