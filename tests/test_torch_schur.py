"""uno_tpu_torch.parallel.schur against uno_tpu.parallel.schur on the CPU.

The same block-arrow systems (the generators' numpy draws, equal bit for
bit) go through both packages' schur_factor and schur_solve: inertia equal,
x within 1e-10 (uno_tpu factors every block with ldlt_factor_blocked, the
port with the plain version of the kernel its dim takes, so the two agree
to rounding).  The sharded solver runs on Gloo worlds of 2 and 4 processes,
2 scenarios a rank among them, against a world of one (1e-12: the
all-reduced sums add the ranks' parts in another order) and against
uno_tpu's make_sharded_schur_solver on 8 virtual devices.  JAX is imported
inside the tests only: the spawned ranks import this module.
"""

import numpy as np
import pytest
import torch

from torch_world import run_world
from uno_tpu_torch.parallel import make_group
from uno_tpu_torch.parallel import schur as tschur

X_ATOL = 1e-10
WORLD_ATOL = 1e-12
# (S, nb, n0, seed): uno_tpu's test_schur.py systems
CASES = [(4, 12, 5, 1), (3, 8, 4, 3)]
SHARDED = [(8, 16, 6, 5), (16, 8, 4, 7)]


def saddle_system():
    """tests/test_schur.py:41's saddle blocks [H J^T; J 0] per scenario."""
    rng = np.random.default_rng(4)
    S, n, m, n0 = 2, 6, 3, 4
    Ks = []
    for _ in range(S):
        Hb = rng.standard_normal((n, n))
        H = Hb @ Hb.T + n * np.eye(n)
        J = rng.standard_normal((m, n))
        Ks.append(np.block([[H, J.T], [J, np.zeros((m, m))]]))
    Bs = np.zeros((S, n + m, n0))
    Bs[:, :n, :] = rng.standard_normal((S, n, n0)) * 0.1
    return np.stack(Ks), Bs, np.eye(n0) * n0


def rhs_for(S, nb, n0, seed):
    rng = np.random.default_rng(seed + 100)
    return rng.standard_normal((S, nb)), rng.standard_normal(n0)


def systems():
    out = {f"random_{S}_{nb}_{n0}": tschur.random_block_arrow_system(S, nb, n0, seed=seed)
           for S, nb, n0, seed in CASES}
    out["saddle"] = saddle_system()
    return out


def t(a):
    return torch.as_tensor(np.asarray(a))


def port_solve(Ks, Bs, K0, rhs_s, rhs0, group=None):
    fac = tschur.schur_factor(t(Ks), t(Bs), t(K0), group=group)
    xs, x0 = tschur.schur_solve(fac, t(Bs), t(rhs_s), t(rhs0), group=group)
    return (xs.numpy(), x0.numpy(),
            (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)))


@pytest.fixture(scope="module")
def uno_tpu_results():
    """uno_tpu's factor + solve of every system, once."""
    import jax.numpy as jnp
    from uno_tpu.parallel import schur as jschur
    out = {}
    for name, (Ks, Bs, K0) in systems().items():
        rhs_s, rhs0 = rhs_for(*Ks.shape[:2], K0.shape[0], 0)
        fac = jschur.schur_factor(jnp.asarray(Ks), jnp.asarray(Bs), jnp.asarray(K0))
        xs, x0 = jschur.schur_solve(fac, jnp.asarray(Bs), jnp.asarray(rhs_s),
                                    jnp.asarray(rhs0))
        out[name] = (np.asarray(xs), np.asarray(x0),
                     (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)))
    return out


@pytest.mark.parametrize("S,nb,n0,seed", CASES + SHARDED)
@pytest.mark.parametrize("definite", [True, False])
def test_generators_equal_uno_tpu(S, nb, n0, seed, definite):
    from uno_tpu.parallel import schur as jschur
    ours = tschur.random_block_arrow_system(S, nb, n0, seed=seed, definite=definite)
    theirs = jschur.random_block_arrow_system(S, nb, n0, seed=seed, definite=definite)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    assert np.array_equal(tschur.dense_from_blocks(*ours), jschur.dense_from_blocks(*theirs))


@pytest.mark.parametrize("name", ["random_4_12_5", "random_3_8_4", "saddle"])
def test_factor_and_solve_match_uno_tpu(name, uno_tpu_results):
    Ks, Bs, K0 = systems()[name]
    rhs_s, rhs0 = rhs_for(*Ks.shape[:2], K0.shape[0], 0)
    xs, x0, inertia = port_solve(Ks, Bs, K0, rhs_s, rhs0)
    jxs, jx0, jinertia = uno_tpu_results[name]
    assert inertia == jinertia
    assert np.max(np.abs(xs - jxs)) <= X_ATOL and np.max(np.abs(x0 - jx0)) <= X_ATOL
    K = tschur.dense_from_blocks(Ks, Bs, K0)
    x = np.linalg.solve(K, np.concatenate([rhs_s.ravel(), rhs0]))
    assert np.allclose(np.concatenate([xs.ravel(), x0]), x, atol=1e-8)
    w = np.linalg.eigvalsh(K)
    assert inertia == (int(np.sum(w > 0)), int(np.sum(w < 0)), 0)


def test_saddle_inertia_is_haynsworth():
    Ks, Bs, K0 = saddle_system()
    fac = tschur.schur_factor(t(Ks), t(Bs), t(K0))
    assert (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)) == (2 * 6 + 4, 2 * 3, 0)


def sharded_worker(group):
    """Every SHARDED system through make_sharded_schur_solver on this rank's
    scenarios; xs gathered in rank order."""
    out = []
    for S, nb, n0, seed in SHARDED:
        Ks, Bs, K0 = tschur.random_block_arrow_system(S, nb, n0, seed=seed)
        rhs_s, rhs0 = rhs_for(S, nb, n0, seed)
        lo, hi = group.local_range(S)
        solve = tschur.make_sharded_schur_solver(group, nb, n0)
        xs, x0, pos, neg, zero = solve(t(Ks[lo:hi]), t(Bs[lo:hi]), t(K0),
                                       t(rhs_s[lo:hi]), t(rhs0))
        out.append((group.all_gather(xs).numpy(), x0.numpy(),
                    (int(pos), int(neg), int(zero))))
    return out


@pytest.fixture(scope="module")
def uno_tpu_sharded():
    import jax
    import jax.numpy as jnp
    from uno_tpu.parallel import make_mesh
    from uno_tpu.parallel import schur as jschur
    mesh = make_mesh(axis_name="scenario")
    out = []
    for S, nb, n0, seed in SHARDED:
        Ks, Bs, K0 = jschur.random_block_arrow_system(S, nb, n0, seed=seed)
        rhs_s, rhs0 = rhs_for(S, nb, n0, seed)
        solver = jschur.make_sharded_schur_solver(mesh, nb, n0)
        xs, x0, pos, neg, zero = jax.block_until_ready(solver(
            *(jnp.asarray(a) for a in (Ks, Bs, K0, rhs_s, rhs0))))
        out.append((np.asarray(xs), np.asarray(x0), (int(pos), int(neg), int(zero))))
    return out


def test_sharded_solver_worlds(uno_tpu_sharded):
    one = sharded_worker(make_group("cpu"))
    for world in (2, 4):
        ranks = run_world(sharded_worker, world)
        for rank in ranks:
            for (xs, x0, inertia), (xs1, x01, inertia1), (jxs, jx0, jinertia), (S, nb, n0, seed) \
                    in zip(rank, one, uno_tpu_sharded, SHARDED):
                assert inertia == inertia1 == jinertia == (S * nb + n0, 0, 0)
                assert np.max(np.abs(xs - xs1)) <= WORLD_ATOL
                assert np.max(np.abs(x0 - x01)) <= WORLD_ATOL
                assert np.max(np.abs(xs - jxs)) <= X_ATOL
                assert np.max(np.abs(x0 - jx0)) <= X_ATOL


def test_sharded_solver_checks_shapes():
    solve = tschur.make_sharded_schur_solver(make_group("cpu"), 4, 3)
    Ks, Bs, K0 = (t(a) for a in tschur.random_block_arrow_system(2, 4, 2, seed=0))
    with pytest.raises(ValueError, match="do not fit"):
        solve(Ks, Bs, K0, torch.zeros(2, 4, dtype=torch.float64),
              torch.zeros(2, dtype=torch.float64))
