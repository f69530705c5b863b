"""The port's supernodal sparse LDL^T and the sparse route held against
uno_tpu on the CPU: the symbolic plan array for array, the numeric
factorization and solve on tests/test_sparse_ldlt.py's patterns, the probed
KKT pattern, steering_n26 under kkt_formulation="sparse", the auto routes
of models that stay dense, and chip_smoke.py's sparse phase at a small
size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu
import uno_tpu_torch
from uno_tpu.linalg import sparse_kkt as j_kkt
from uno_tpu.linalg import sparse_ldlt as j_sp
from uno_tpu.model import transforms as j_tf
from uno_tpu.model.library import get_problem as j_get
from uno_tpu.options import preset as j_preset
from uno_tpu_torch.linalg import sparse_kkt as t_kkt
from uno_tpu_torch.linalg import sparse_ldlt as t_sp
from uno_tpu_torch.model import transforms as t_tf
from uno_tpu_torch.model.library import get_problem as t_get

# the same elimination by two implementations: sums in another order
LA_TOL = 1e-12


def _banded_spd():
    N = 40
    A = np.zeros((N, N))
    for i in range(N):
        A[i, i] = 4.0
        if i + 1 < N:
            A[i, i + 1] = A[i + 1, i] = -1.0
        if i + 3 < N:
            A[i, i + 3] = A[i + 3, i] = -0.5
    return A, None


def _arrow():
    rng = np.random.default_rng(1)
    N = 40
    A = np.diag(rng.standard_normal(N) + 3.0)
    A[-1, :] = rng.standard_normal(N) * 0.5
    A[:, -1] = A[-1, :]
    A[-1, -1] = -2.0
    return A, None


def _random_sparse():
    rng = np.random.default_rng(2)
    N = 60
    M = np.zeros((N, N))
    for i, j in rng.integers(0, N, size=(150, 2)):
        v = rng.standard_normal()
        M[i, j] += v
        M[j, i] += v
    return M + np.diag(rng.standard_normal(N) * 3), None


def _kkt_zero_dual():
    rng = np.random.default_rng(3)
    n, m = 30, 12
    H = np.zeros((n, n))
    for i in range(n):
        H[i, i] = 2.0 + rng.random()
        if i + 1 < n:
            H[i, i + 1] = H[i + 1, i] = 0.3
    J = np.zeros((m, n))
    for r in range(m):
        J[r, rng.choice(n, size=3, replace=False)] = rng.standard_normal(3)
    K = np.block([[H, J.T], [J, np.zeros((m, m))]])
    is_dual = np.zeros(n + m, bool)
    is_dual[n:] = True
    return K, is_dual


def _singular():
    A = np.zeros((6, 6))
    A[0, 0], A[1, 1] = 2.0, 3.0
    A[2, 3] = A[3, 2] = 1.0
    A[2, 2] = A[4, 4] = 1.0
    return A, None


PATTERNS = {"banded_spd": _banded_spd, "arrow": _arrow,
            "random_sparse": _random_sparse, "kkt_zero_dual": _kkt_zero_dual,
            "singular": _singular}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_build_plan_equals_uno_tpu_array_for_array(name):
    A, is_dual = PATTERNS[name]()
    pj, pt = j_sp.build_plan(A != 0, is_dual), t_sp.build_plan(A != 0, is_dual)
    for field in ("N", "w_max", "r_max", "u_max", "nnz_factor", "padded_cells"):
        assert getattr(pt, field) == getattr(pj, field), field
    for field in ("perm", "iperm", "col_start", "width", "col_ids", "row_ids",
                  "upd_t", "upd_selI", "upd_selJ"):
        a, b = getattr(pt, field), getattr(pj, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert pt.padded_flops() == pj.padded_flops()


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_sparse_factor_and_solve_match(name):
    A, is_dual = PATTERNS[name]()
    plan = j_sp.build_plan(A != 0, is_dual)
    jf, js = j_sp.make_sparse_ldlt(plan)
    tf, ts = t_sp.make_sparse_ldlt(t_sp.build_plan(A != 0, is_dual))
    fj = jf(jnp.asarray(A))
    # a batch of two: the matrix and a shifted copy
    A2 = np.stack([A, A + np.diag(np.full(A.shape[0], 0.5))])
    ft = tf(torch.as_tensor(A2))
    for k in ("num_pos", "num_neg", "num_zero"):
        assert int(getattr(ft, k)[0]) == int(getattr(fj, k)), k
    dj = np.asarray(fj.dvec)
    np.testing.assert_allclose(ft.dvec[0].numpy(), dj, rtol=0,
                               atol=LA_TOL * max(1.0, np.abs(dj).max()))
    if int(fj.num_zero):
        return
    rhs = np.random.default_rng(7).standard_normal(A.shape[0])
    xj = np.asarray(js(fj, jnp.asarray(rhs)))
    xt = ts(ft, torch.as_tensor(np.stack([rhs, rhs])))
    np.testing.assert_allclose(xt[0].numpy(), xj, rtol=0,
                               atol=LA_TOL * max(1.0, np.abs(xj).max()))
    x2 = np.linalg.solve(A2[1], rhs)
    np.testing.assert_allclose(xt[1].numpy(), x2, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(x2).max()))


def test_minimum_degree_matches():
    rng = np.random.default_rng(4)
    A = rng.random((25, 25)) < 0.15
    np.testing.assert_array_equal(t_sp.minimum_degree(A), j_sp.minimum_degree(A))


def test_f32_factor_matches_in_dtype_and_inertia():
    A, _ = _banded_spd()
    plan = t_sp.build_plan(A != 0)
    tf, ts = t_sp.make_sparse_ldlt(plan)
    fac = tf(torch.as_tensor(A, dtype=torch.float32)[None])
    assert fac.dvec.dtype == torch.float32 and int(fac.num_pos[0]) == A.shape[0]
    rhs = np.random.default_rng(5).standard_normal(A.shape[0])
    x = ts(fac, torch.as_tensor(rhs, dtype=torch.float32)[None])[0].double().numpy()
    assert np.linalg.norm(A @ x - rhs) < 1e-4


@pytest.mark.parametrize("name", ["steering_n26", "vanderpol_ctrl_n15"])
def test_probe_kkt_pattern_matches(name):
    opts = j_preset("ipopt")
    jp = j_tf.reformulate_for_interior_point(j_tf.scale_model(j_get(name)),
                                             opts.tolerance)
    tp = t_tf.reformulate_for_interior_point(t_tf.scale_model(t_get(name)),
                                             opts.tolerance)
    pj, dj = j_kkt.probe_kkt_pattern(jp, jp.m)
    pt, dt = t_kkt.probe_kkt_pattern(tp, tp.m)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(dt, dj)


def _report(mod):
    r = mod.last_detection_report
    return (r.route, r.N, r.num_supernodes, r.nnz_factor, r.padded_flops,
            r.dense_flops)


def test_steering_sparse_solve_matches():
    ref = uno_tpu.solve(j_get("steering_n26"), preset="ipopt", kkt_formulation="sparse")
    rep_j = _report(j_kkt)
    t_sp.reset_counts()
    res = uno_tpu_torch.solve(t_get("steering_n26"), preset="ipopt",
                              kkt_formulation="sparse", device="cpu")
    assert _report(t_kkt) == rep_j and rep_j[0] == "sparse"
    assert t_sp.counts["factorizations"] > 0
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert abs(res.objective - ref.objective) <= 1e-10 * max(abs(ref.objective), 1.0)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", ["elec_n9", "chandheq_ls_n10"])
def test_dense_models_stay_dense_as_in_uno_tpu(name):
    """All-pairs coupling: auto_permute's detection declines, the sparse
    route declines, and the dense solve equals uno_tpu's."""
    ref = uno_tpu.solve(j_get(name), preset="ipopt", auto_permute=True)
    route_j = j_kkt.last_detection_report.route
    t_kkt.last_detection_report = None
    res = uno_tpu_torch.solve(t_get(name), preset="ipopt", auto_permute=True,
                              device="cpu")
    assert t_kkt.last_detection_report.route == route_j == "dense"
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert abs(res.objective - ref.objective) <= 1e-10 * max(abs(ref.objective), 1.0)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-8)


def test_forced_sparse_above_the_probe_range_raises():
    from uno_tpu_torch.options import preset
    from uno_tpu_torch.solvers.ipm import build_ipm
    with pytest.raises(ValueError, match="probe range"):
        build_ipm(_wide(), preset("ipopt", kkt_formulation="sparse"))


def _wide():
    """A model whose KKT dimension is above the sparse probe range (8192)."""
    from uno_tpu_torch.model.nlp import nlp_from_functions
    return nlp_from_functions("wide", lambda x: torch.sum(x * x), None,
                              x0=np.ones(8200))


def test_chip_smoke_sparse_phase_on_cpu():
    """steering_n26 held to uno_tpu's result and route report, as the chip
    phase holds N=400; chwood_eq_n100 through detection to the banded
    backend."""
    import chip_smoke
    ref = uno_tpu.solve(j_get("steering_n26"), preset="ipopt", kkt_formulation="sparse")
    r = j_kkt.last_detection_report
    out = chip_smoke.phase_sparse(device="cpu", n=26, chwood="chwood_eq_n100", ref={
        "iterations": ref.iterations, "objective": ref.objective, "N": r.N,
        "supernodes": r.num_supernodes,
        "flop_ratio": round(r.padded_flops / r.dense_flops, 3)})
    assert out["chwood"]["jac_width"] == 4
    assert out["steering"]["augmented"]["iterations"] == ref.iterations
