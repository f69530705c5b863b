"""The port's lifted (condensed Cholesky) KKT backend held against uno_tpu
on the CPU: the backend on seeded saddle systems, hs015 and
tests/test_condensed.py's 8-instance batch under kkt_formulation="lifted",
catena_n298's banded attempt and augmented retry under "auto", the
bucketed IPM driver, and chip_smoke.py's banded and lifted phases at small
sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu
import uno_tpu_torch
from uno_tpu.linalg.condensed import make_lifted_kkt_backend as j_lifted
from uno_tpu.model.library import get_problem as j_get
from uno_tpu.model.nlp import INF
from uno_tpu.model.nlp import nlp_from_functions as j_nlp
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers.batch import solve_batch as j_solve_batch
from uno_tpu_torch.linalg.condensed import make_lifted_kkt_backend as t_lifted
from uno_tpu_torch.model.library import flagship, get_problem as t_get
from uno_tpu_torch.model.nlp import nlp_from_functions as t_nlp
from uno_tpu_torch.options import preset as t_preset
from uno_tpu_torch.solvers.batch import build_batch_ipm, build_bucketed_batch_ipm

LA_TOL = 1e-12


def _saddle(n, m, seed, definite=True):
    """A seeded saddle system whose condensed matrix is well conditioned
    (C in [0.1, 1]): two Cholesky codes then agree to rounding; with a
    dual block near 0 their gap grows with the condensed matrix's
    condition number, 1/C."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    Hd = Q @ Q.T / n + 2 * np.eye(n) if definite else -np.eye(n)
    J = rng.standard_normal((m, n))
    C = 10.0 ** rng.uniform(-1, 0, m)
    A = np.block([[Hd, J.T], [J, -np.diag(C)]])
    return A, rng.standard_normal(n + m)


@pytest.mark.parametrize("n,m,seed", [(12, 4, 0), (30, 10, 1), (8, 0, 2)])
def test_lifted_backend_matches(n, m, seed):
    A, rhs = _saddle(n, m, seed)
    jf, js = map(jax.jit, j_lifted(n, m, tau=1e-8))
    tf, ts = t_lifted(n, m, tau=1e-8)
    fj, ft = jf(jnp.asarray(A)), tf(torch.as_tensor(A)[None])
    assert (int(ft.num_pos[0]), int(ft.num_neg[0]), int(ft.num_zero[0])) \
        == (int(fj.num_pos), int(fj.num_neg), int(fj.num_zero)) == (n, m, 0)
    np.testing.assert_allclose(ft.L[0].numpy(), np.asarray(fj.L), rtol=0,
                               atol=LA_TOL * np.abs(np.asarray(fj.L)).max())
    xj = np.asarray(js(fj, jnp.asarray(rhs)))
    xt = ts(ft, torch.as_tensor(rhs)[None])[0].numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=LA_TOL * max(1.0, np.abs(xj).max()))


def test_lifted_failure_reports_the_failure_inertia():
    A, _ = _saddle(12, 4, 3, definite=False)
    fj = j_lifted(12, 4)[0](jnp.asarray(A))
    ft = t_lifted(12, 4)[0](torch.as_tensor(np.stack([A, _saddle(12, 4, 4)[0]])))
    assert int(fj.num_zero) == 16
    assert ft.num_zero.tolist() == [16, 0] and ft.num_pos.tolist() == [0, 12]
    assert float(ft.L[0].abs().max()) == 0.0


def test_hs015_lifted_matches():
    ref = uno_tpu.solve(j_get("hs015"), preset="ipopt", kkt_formulation="lifted")
    res = uno_tpu_torch.solve(t_get("hs015"), preset="ipopt", kkt_formulation="lifted",
                              device="cpu")
    assert (res.status, res.iterations) == (ref.status, ref.iterations) == ("optimal", 17)
    assert abs(res.objective - ref.objective) <= 1e-10 * abs(ref.objective)
    assert abs(res.objective - 306.5) < 1e-2
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-8)


def _batch_pair():
    """tests/test_condensed.py's batch: min |x - p|^2 s.t. x0 + x1 >= 1."""
    kw = dict(x0=[0.5, 0.5], x_lb=[-5.0, -5.0], x_ub=[5.0, 5.0], c_lb=[0.0],
              c_ub=[INF], params=np.zeros(2))
    jn = j_nlp("b", lambda x, p: jnp.sum((x - p) ** 2),
               lambda x, p: jnp.array([x[0] + x[1] - 1.0]), **kw)
    tn = t_nlp("b", lambda x, p: torch.sum((x - p) ** 2),
               lambda x, p: torch.stack([x[0] + x[1] - 1.0]), **kw)
    rng = np.random.default_rng(1)
    return jn, tn, np.tile([0.5, 0.5], (8, 1)), rng.uniform(-1, 2, (8, 2))


def test_lifted_batch_matches_uno_tpu_batch():
    jn, tn, x0, params = _batch_pair()
    ref = j_solve_batch(jn, j_preset("ipopt", scale_functions=False,
                                     kkt_formulation="lifted"),
                        jnp.asarray(x0), jnp.asarray(params))
    res = uno_tpu_torch.solve_batch(tn, x0, params, preset="ipopt",
                                    scale_functions=False,
                                    kkt_formulation="lifted", device="cpu")
    assert res.num_solved == 8
    assert res.status.tolist() == np.asarray(ref.status).tolist()
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=0, atol=1e-8)


def test_bucketed_batch_ipm_equals_the_plain_batch():
    """build_bucketed_batch_ipm takes uno_tpu's signature and steps the
    batch as build_batch_ipm does."""
    nlp, x0, params = flagship(12)
    opts = t_preset("ipopt", scale_functions=False)
    _, plain = build_batch_ipm(nlp, opts, device="cpu")
    _, bucketed = build_bucketed_batch_ipm(nlp, opts, params_example=params[0],
                                           segment=4, min_bucket=1024,
                                           device="cpu")
    a, b = plain(x0, params), bucketed(x0, params)
    assert torch.equal(a.status, b.status) and torch.equal(a.iteration, b.iteration)
    assert torch.equal(a.x, b.x)


def test_catena_retry_matches_uno_tpu():
    """catena_n298 under "auto": the banded attempt ends in an algorithmic
    error, as uno_tpu's explicit banded solve does after the same
    iterations, and the augmented retry gives uno_tpu's result."""
    first = uno_tpu.solve(j_get("catena_n298"), preset="ipopt",
                          kkt_formulation="banded")
    ref = uno_tpu.solve(j_get("catena_n298"), preset="ipopt")
    res = uno_tpu_torch.solve(t_get("catena_n298"), preset="ipopt", device="cpu")
    assert res.retried_after == {"status": first.status, "iterations": first.iterations}
    assert first.status == "algorithmic_error"
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert abs(res.objective - ref.objective) <= 1e-10 * abs(ref.objective)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-8)


def test_chip_smoke_lifted_phase_on_cpu():
    import chip_smoke
    out = chip_smoke.phase_lifted(device="cpu", batch=16, rerun=4)
    assert out["solved"] == 16 and out["lifted"]["factorizations"] > 0
    assert out["hs015"]["iterations"] == 17


def test_chip_smoke_banded_phase_on_cpu():
    """lukvle1 at n=100 (the same 6 iterations and optimum as at n=4,096)
    and catena_n298's banded attempt and augmented retry."""
    import chip_smoke
    out = chip_smoke.phase_banded(device="cpu", n=100, large_n=None)
    assert out["lukvle1"]["iterations"] == chip_smoke.LUKVLE1_ITERATIONS
    assert out["catena"]["retried_after"]["status"] == "algorithmic_error"
