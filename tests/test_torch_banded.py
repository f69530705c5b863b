"""The port's banded linear algebra and banded KKT backend held against
uno_tpu on the CPU (block-tridiagonal Cholesky, sweep and cyclic
reduction, their solves and inertia; the condensed banded KKT's factorize,
solve and matvec), the banded solves of the structured families, the
backend dispatch of build_ipm, and chip_smoke.py's structured phases at
small sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu
import uno_tpu_torch
from uno_tpu.linalg import banded as jb
from uno_tpu.linalg import banded_kkt as jbk
from uno_tpu.model.library import get_problem as j_get
from uno_tpu_torch.linalg import banded as tb
from uno_tpu_torch.linalg import banded_kkt as tbk
from uno_tpu_torch.model.library import get_problem as t_get
from uno_tpu_torch.model.nlp import NLPStructure, nlp_from_functions
from uno_tpu_torch.options import preset as t_preset
from uno_tpu_torch.solvers import ipm as tipm

# the same factorization by two LAPACK-backed implementations: sums in
# another order
LA_TOL = 1e-12
# uno_tpu's functions jitted, as its solver calls them (eager dispatch of
# the cyclic reduction's levels costs seconds)
J_BLOCKS = jax.jit(jb.band_to_blocks, static_argnums=1)
J_CHOL, J_SOLVE = jax.jit(jb.btd_cholesky), jax.jit(jb.btd_solve)
J_CR, J_SOLVE_CR = jax.jit(jb.btd_cholesky_cr), jax.jit(jb.btd_solve_cr)


def _random_band(n, b, rng, spd=True):
    """(dense A, lower band (b+1, n)) of a seeded symmetric band matrix,
    diagonally dominant when spd (tests/test_banded.py's matrices)."""
    A = np.zeros((n, n))
    for d in range(b + 1):
        v = rng.standard_normal(n - d) * 0.3
        A[np.arange(n - d) + d, np.arange(n - d)] = v
        A[np.arange(n - d), np.arange(n - d) + d] = v
    if spd:
        A[np.arange(n), np.arange(n)] = np.abs(A).sum(1) + 1.0
    band = np.zeros((b + 1, n))
    for d in range(b + 1):
        band[d, : n - d] = A[np.arange(n - d) + d, np.arange(n - d)]
    return A, band


def _t(a):
    return torch.as_tensor(np.asarray(a))[None]


def _gap(t, j):
    """max |t - j| relative to max(max |j|, 1)."""
    j = np.asarray(j)
    return float(np.max(np.abs(t[0].numpy() - j))) / max(1.0, float(np.max(np.abs(j))))


@pytest.mark.parametrize("n,b", [(64, 1), (100, 7), (257, 5), (512, 31),
                                 (520, 3)])
def test_btd_sweep_and_cyclic_reduction_match(n, b):
    rng = np.random.default_rng(n + b)
    A, band = _random_band(n, b, rng)
    rhs = rng.standard_normal(n)
    nb = tb.pick_block_size(b)
    assert nb == jb.pick_block_size(b)
    Dj, Ej = J_BLOCKS(jnp.asarray(band), nb)
    Dt, Et = tb.band_to_blocks(_t(band), nb)
    np.testing.assert_array_equal(Dt[0].numpy(), np.asarray(Dj))
    np.testing.assert_array_equal(Et[0].numpy(), np.asarray(Ej))
    np.testing.assert_allclose(tb.band_matvec(_t(band), _t(rhs))[0].numpy(),
                               np.asarray(jb.band_matvec(jnp.asarray(band), jnp.asarray(rhs))),
                               rtol=0, atol=LA_TOL * np.abs(A).max() * np.abs(rhs).max())
    fj, ft = J_CHOL(Dj, Ej), tb.btd_cholesky(Dt, Et)
    assert int(ft.num_zero[0]) == int(fj.num_zero) == 0
    assert _gap(ft.L, fj.L) <= LA_TOL and _gap(ft.Ct, fj.Ct) <= LA_TOL
    xj = np.asarray(J_SOLVE(fj, jnp.asarray(rhs)))
    assert _gap(tb.btd_solve(ft, _t(rhs)), xj) <= LA_TOL
    cj, ct = J_CR(Dj, Ej), tb.btd_cholesky_cr(Dt, Et)
    assert int(ct.num_pos[0]) == int(cj.num_pos) == Dj.shape[0] * nb
    for lj, lt in zip(cj.levels, ct.levels):
        for a, c in zip(lj, lt):
            assert _gap(c, a) <= LA_TOL
    xcr = np.asarray(J_SOLVE_CR(cj, jnp.asarray(rhs)))
    assert _gap(tb.btd_solve_cr(ct, _t(rhs)), xcr) <= LA_TOL
    assert np.max(np.abs(A @ xcr - rhs)) < 1e-10


@pytest.mark.parametrize("n,b,seed", [(64, 1, 0), (200, 7, 1), (600, 3, 2)])
def test_indefinite_band_fails_as_uno_tpu_does(n, b, seed):
    """A non-positive-definite band fails the whole factorization, in the
    sweep and in cyclic reduction, with uno_tpu's num_zero."""
    rng = np.random.default_rng(seed)
    A, band = _random_band(n, b, rng)
    band[0, rng.integers(0, n)] = -5.0 * np.abs(band).max()
    nb = tb.pick_block_size(b)
    Dj, Ej = J_BLOCKS(jnp.asarray(band), nb)
    Dt, Et = tb.band_to_blocks(_t(band), nb)
    for jf, tf in ((J_CHOL, tb.btd_cholesky), (J_CR, tb.btd_cholesky_cr)):
        fj, ft = jf(Dj, Ej), tf(Dt, Et)
        assert int(fj.num_zero) > 0
        assert (int(ft.num_pos[0]), int(ft.num_neg[0]), int(ft.num_zero[0])) \
            == (int(fj.num_pos), int(fj.num_neg), int(fj.num_zero))


def _kkt_case(n0, w, bh, m, ns, seed):
    rng = np.random.default_rng(seed)
    _, H_band = _random_band(n0, bh, rng)
    starts = np.sort(rng.integers(0, n0 - w, m))
    starts[1] = starts[0]                   # repeated starts, as catena's
    J_local = rng.standard_normal((m, w))
    slack_rows = np.sort(rng.choice(m, ns, replace=False))
    soc = np.full(m, -1)
    soc[slack_rows] = n0 + np.arange(ns)
    diag0 = np.abs(rng.standard_normal(n0)) + 0.5
    sig_s = np.abs(rng.standard_normal(ns)) + 0.5
    C = np.abs(rng.standard_normal(m)) * 0.1
    rhs = rng.standard_normal(n0 + ns + m)
    return H_band, starts, J_local, soc, diag0, sig_s, C, rhs


@pytest.mark.parametrize("n0,w,bh,m,ns", [(30, 3, 2, 20, 8),     # sweep
                                          (600, 4, 3, 300, 120)])  # cyclic reduction
def test_banded_kkt_backend_matches(n0, w, bh, m, ns):
    H_band, starts, J_local, soc, diag0, sig_s, C, rhs = _kkt_case(n0, w, bh, m, ns, 3)
    n_full = n0 + ns
    jf, js, jm = map(jax.jit, jbk.make_banded_kkt_backend(
        n_full, n0, m, starts, soc, bh, w, tau=1e-8))
    tf, ts, tm = tbk.make_banded_kkt_backend(n_full, n0, m, starts, soc, bh, w, tau=1e-8)
    kj = jbk.BandedKKT(*(jnp.asarray(a) for a in (H_band, diag0, sig_s, J_local, C)))
    kt = tbk.BandedKKT(*(_t(a) for a in (H_band, diag0, sig_s, J_local, C)))
    fj, ft = jf(kj), tf(kt)
    assert (int(ft.num_pos[0]), int(ft.num_neg[0]), int(ft.num_zero[0])) \
        == (int(fj.num_pos), int(fj.num_neg), int(fj.num_zero)) == (n_full, m, 0)
    assert _gap(ft.denom, fj.denom) <= LA_TOL
    assert _gap(ts(ft, _t(rhs)), js(fj, jnp.asarray(rhs))) <= LA_TOL
    assert _gap(tm(kt, _t(rhs)), jm(kj, jnp.asarray(rhs))) <= LA_TOL
    # the structured pieces on their own
    win = tbk.Windows(starts, w, n0, max(bh, w - 1))
    dinv = 1.0 / (C + 1.0)
    assert _gap(tbk.jtdj_band(_t(J_local), win, _t(dinv), max(bh, w - 1), n0),
                jbk.jtdj_band(jnp.asarray(J_local), starts, jnp.asarray(dinv),
                              max(bh, w - 1), n0)) <= LA_TOL
    u = rhs[:m]
    assert _gap(tbk.win_mtv(_t(J_local), win, _t(u), n0),
                jbk.win_mtv(jnp.asarray(J_local), starts, jnp.asarray(u), n0)) <= LA_TOL
    assert _gap(tbk.win_mv(_t(J_local), win, _t(rhs[:n0])),
                jbk.win_mv(jnp.asarray(J_local), starts, jnp.asarray(rhs[:n0]))) <= LA_TOL
    np.testing.assert_array_equal(
        tbk.dense_from_windows(_t(J_local), starts, n_full, soc)[0].numpy(),
        np.asarray(jbk.dense_from_windows(jnp.asarray(J_local), starts, n_full, soc)))


def test_segment_sum_adds_in_scatter_order():
    """Repeated targets are summed in index order, as one scatter-add after
    another: the same bits as index_add on the CPU."""
    rng = np.random.default_rng(5)
    targets = rng.integers(-2, 12, 200)
    src = torch.as_tensor(rng.standard_normal((3, 200)))
    got = tbk.SegmentSum(targets, 10)(src)
    keep = torch.as_tensor((targets >= 0) & (targets < 10))
    want = torch.zeros(3, 10, dtype=torch.float64)
    for k in range(200):
        if keep[k]:
            want[:, targets[k]] += src[:, k]
    assert torch.equal(got, want)


BANDED_SOLVES = ["srosenbr_n100", "lukvle1_n100", "lukvli1_n100",
                 "biggsb1_n100", "catena_n98", "hager1_n99"]


@pytest.mark.parametrize("name", BANDED_SOLVES)
def test_banded_solve_matches(name):
    """kkt_formulation="auto" on a declared structure: the banded backend,
    with uno_tpu's status and iterations, objective within 1e-10 relative
    and x within 1e-8."""
    from uno_tpu_torch.linalg import banded_kkt
    ref = uno_tpu.solve(j_get(name), preset="ipopt")
    banded_kkt.reset_counts()
    res = uno_tpu_torch.solve(t_get(name), preset="ipopt", device="cpu")
    assert banded_kkt.counts["factorizations"] > 0
    assert res.retried_after is None
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert abs(res.objective - ref.objective) <= 1e-10 * max(abs(ref.objective), 1.0)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-8)


def _structured_toy(structure):
    def f(x):
        return torch.sum((x - 1.0) ** 2)

    def c(x):
        return torch.stack([x[0] + x[1], x[2] * x[3]])

    return nlp_from_functions("toy", f, c, x0=np.zeros(4), c_lb=[1.0, 0.5],
                              c_ub=[1.0, 0.5], structure=structure)


def test_build_ipm_routes_and_refuses_as_uno_tpu():
    """banded on an undeclared model, or on a constrained one without
    jac_starts, raises uno_tpu's ValueError; auto on an incomplete
    declaration takes the dense path; the distributed backend without a
    process group raises uno_tpu's ValueError; lifted, sparse and banded
    build their backends."""
    opts = t_preset("ipopt")
    with pytest.raises(ValueError, match="requires the model"):
        tipm.build_ipm(_structured_toy(None), opts.replace(kkt_formulation="banded"))
    with pytest.raises(ValueError, match="jac_starts"):
        tipm.build_ipm(_structured_toy(NLPStructure(hess_bandwidth=0)),
                       opts.replace(kkt_formulation="banded"))
    with pytest.raises(ValueError, match="requires a process group"):
        tipm.build_ipm(_structured_toy(None), opts.replace(ldlt_backend="distributed"))
    prob, ws, _ = tipm.build_ipm(_structured_toy(NLPStructure(hess_bandwidth=0)), opts)
    assert tipm.pick_kkt_backend(prob, ws.m, opts) is None
    full = NLPStructure(hess_bandwidth=0, jac_starts=np.array([0, 2]), jac_width=2)
    prob, ws, _ = tipm.build_ipm(_structured_toy(full), opts)
    assert len(tipm.pick_kkt_backend(prob, ws.m, opts)) == 3
    for form, size in (("lifted", 2), ("sparse", 2), ("augmented", None)):
        be = tipm.pick_kkt_backend(prob, ws.m, opts.replace(kkt_formulation=form))
        assert (None if be is None else len(be)) == size
    res = uno_tpu_torch.solve(_structured_toy(NLPStructure(hess_bandwidth=0)),
                              preset="ipopt", device="cpu")
    assert res.status == "optimal"


def test_chip_smoke_structured_kernels_phase_on_cpu():
    """The structured factorize+solve phase at small sizes, both routes of
    the banded factorization (sweep below 64 blocks, cyclic reduction
    above)."""
    import chip_smoke
    out = chip_smoke.phase_structured_kernels(device="cpu", band_n=600, band_bw=7,
                                              sparse_n=300, sparse_bw=4)
    assert [r["route"] for r in out["banded"]] == ["cyclic reduction"] * 2
    out = chip_smoke.phase_structured_kernels(device="cpu", band_n=256, band_bw=31,
                                              sparse_n=100, sparse_bw=2)
    assert [r["route"] for r in out["banded"]] == ["sweep"] * 2
    assert out["sparse"][0]["supernodes"] > 1
