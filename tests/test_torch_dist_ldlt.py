"""uno_tpu_torch.parallel.dist_ldlt against uno_tpu.parallel.dist_ldlt on
the CPU.

The block-cyclic distributed LDL^T on Gloo worlds of 1, 2 and 4 processes
against uno_tpu's on meshes of as many virtual devices, at n=256 with
panels of 32: inertia equal, L and d within 1e-12 of uno_tpu's relative
to their largest entry (the trailing products are matrix products of
other shapes), solves within 1e-7 of numpy.  The permutation equals
uno_tpu's; the plain panel factor (the CPU's side of the dist_panel
kernel) matches uno_tpu's _panel_factor.  The IPM with
ldlt_backend="distributed" on scalable_quadratic(40, 12, seed=2) equals
uno_tpu's distributed run in status and iterations, x within 1e-8.  The
dist_panel kernel's grid (cuda_ldlt.dist_panel_grid, computed on the host)
deals every row of every slab to exactly one CTA.  JAX is imported inside
the tests only: the spawned ranks import this module.
"""

import numpy as np
import pytest
import torch

from torch_world import run_world
import uno_tpu_torch
from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.model.library import scalable_quadratic
from uno_tpu_torch.parallel import make_group
from uno_tpu_torch.parallel import dist_ldlt as tdl

N, BLOCK = 256, 32
REL = 1e-12
SOLVE_REL = 1e-7
IPM_X_ATOL = 1e-8
WORLDS = (1, 2, 4)


def kkt_matrix(n, m, seed=0, reg=-1e-6):
    """uno_tpu's tests/test_dist_ldlt.py saddle matrix."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n - m, n - m))
    H = np.eye(n - m) * 2 + 0.1 * (B + B.T) / 2
    J = rng.standard_normal((m, n - m))
    return np.block([[H, J.T], [J, reg * np.eye(m)]])


def indefinite_matrix():
    """uno_tpu's test_indefinite_inertia matrix: inertia (96, 32, 0)."""
    n, m = 128, 32
    J = np.random.default_rng(6).standard_normal((m, n - m))
    return np.block([[np.eye(n - m) * 3, J.T], [J, -0.5 * np.eye(m)]])


def rhs_list():
    rng = np.random.default_rng(5)
    return [rng.standard_normal(N) for _ in range(3)]


def ipm_options():
    return uno_tpu_torch.preset("ipopt", scale_functions=False,
                                ldlt_backend="distributed")


def dist_worker(group):
    """On this rank: the factor of kkt_matrix(256) (L gathered into global
    column order), its solves, the indefinite matrix's inertia at panels of
    16, and the distributed IPM on scalable_quadratic(40, 12, seed=2)."""
    def factor(K, block):
        n = K.shape[0]
        fac_fn, solve_fn, perm = tdl.make_dist_ldlt(group, n, block)
        lo, hi = group.local_range(n)
        fac = fac_fn(torch.as_tensor(K[:, perm][:, lo:hi]))
        L = np.zeros((n, n))
        L[:, perm] = group.all_gather(fac.L_cyc.T.contiguous()).T.numpy()
        return fac, solve_fn, L

    fac, solve, L = factor(kkt_matrix(N, N // 4, seed=3), BLOCK)
    xs = [solve(fac, torch.as_tensor(r)).numpy() for r in rhs_list()]
    ind, _, _ = factor(indefinite_matrix(), 16)
    res = uno_tpu_torch.solve(scalable_quadratic(40, 12, seed=2), options=ipm_options(),
                              group=group)
    return {"L": L, "d": fac.d.numpy(),
            "inertia": (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)),
            "x": xs, "indefinite": (int(ind.num_pos), int(ind.num_neg), int(ind.num_zero)),
            "ipm": (res.status, res.iterations, res.x)}


@pytest.fixture(scope="module")
def uno_tpu_results():
    """uno_tpu's factor and solves on meshes of 1, 2 and 4 devices, and its
    distributed IPM on 8, once."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from uno_tpu.model.library import scalable_quadratic as j_quadratic
    from uno_tpu.options import preset as j_preset
    from uno_tpu.parallel.dist_ldlt import make_dist_ldlt
    from uno_tpu.solvers.ipm import (STATUS_NAMES, build_ipm, canonicalize_state,
                                     make_initial_state)
    K = kkt_matrix(N, N // 4, seed=3)
    out = {}
    for world in WORLDS:
        mesh = Mesh(np.array(jax.devices()[:world]), ("kkt",))
        factor, solve, perm = make_dist_ldlt(mesh, N, "kkt", BLOCK)
        fac = factor(jnp.asarray(K[:, perm]))
        L = np.zeros((N, N))
        L[:, perm] = np.asarray(fac.L_cyc)
        out[world] = {"L": L, "d": np.asarray(fac.d),
                      "inertia": (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)),
                      "x": [np.asarray(solve(fac, jnp.asarray(r))) for r in rhs_list()]}
    mesh = Mesh(np.array(jax.devices()), ("kkt",))
    nlp = j_quadratic(40, 12, seed=2)
    opts = j_preset("ipopt", scale_functions=False, ldlt_backend="distributed")
    prob, ws, _, run = build_ipm(nlp, opts, mesh=mesh)
    final = jax.block_until_ready(run(canonicalize_state(make_initial_state(prob, ws, opts))))
    out["ipm"] = (STATUS_NAMES[int(final.status)], int(final.iteration),
                  np.asarray(final.x)[:nlp.n])
    return out


@pytest.fixture(scope="module")
def port_worlds():
    """The port's dist_worker on worlds of 1 (in this process), 2 and 4."""
    out = {1: [dist_worker(make_group("cpu"))]}
    for world in WORLDS[1:]:
        out[world] = run_world(dist_worker, world)
    return out


@pytest.mark.parametrize("n,nproc,block", [(64, 4, 8), (256, 2, 32), (256, 4, 32),
                                           (512, 8, 64)])
def test_cyclic_permutation_equals_uno_tpu(n, nproc, block):
    from uno_tpu.parallel.dist_ldlt import cyclic_permutation
    assert np.array_equal(tdl.cyclic_permutation(n, nproc, block),
                          cyclic_permutation(n, nproc, block))


@pytest.mark.parametrize("row0", [0, 96, 224])
def test_panel_factor_plain_matches_uno_tpu(row0):
    import jax.numpy as jnp
    from uno_tpu.parallel.dist_ldlt import _panel_factor
    C = kkt_matrix(N, N // 4, seed=8)[:, row0:row0 + BLOCK]
    jC, jd = _panel_factor(jnp.asarray(C), row0, N, BLOCK, "kkt")
    tC, td = tdl.panel_factor_plain(torch.as_tensor(C), row0)
    assert np.max(np.abs(tC.numpy() - np.asarray(jC))) <= REL * np.max(np.abs(jC))
    assert np.max(np.abs(td.numpy() - np.asarray(jd))) <= REL * np.max(np.abs(jd))
    assert not tC.numpy()[:row0 + 1].any()          # zeros down to the first pivot


def test_panel_factor_works_in_place_on_a_slab():
    """panel_factor on a rank's (n, nloc) storage factors only its slab, as
    panel_factor_plain does on a copy."""
    work = torch.as_tensor(kkt_matrix(N, N // 4, seed=9)[:, :4 * BLOCK]).contiguous()
    before = work.clone()
    d = tdl.panel_factor(work, 2 * BLOCK, 64, BLOCK)
    C, d_plain = tdl.panel_factor_plain(before[:, 2 * BLOCK:3 * BLOCK], 64)
    assert torch.equal(work[:, 2 * BLOCK:3 * BLOCK], C) and torch.equal(d, d_plain)
    assert torch.equal(work[:, :2 * BLOCK], before[:, :2 * BLOCK])
    assert torch.equal(work[:, 3 * BLOCK:], before[:, 3 * BLOCK:])


@pytest.mark.parametrize("block", cuda_ldlt.DIST_PANEL_BLOCKS)
@pytest.mark.parametrize("n", range(64, 8193, 64))
def test_dist_panel_grid_deals_every_row_once(n, block):
    """At every panel of an n-row slab: every row below the diagonal block
    and above it in exactly one CTA's runs (the block's own rows go to one
    CTA, the last to have read them), at most one CTA an SM, one pass of
    the row threads over a CTA's rows, and a launch the kernel takes."""
    for row0 in range(0, n - block + 1, block):
        geo = cuda_ldlt.dist_panel_grid(n, row0, block)
        assert 1 <= geo.grid <= min(cuda_ldlt.SMS, cuda_ldlt.MAX_GRID)
        row_threads = geo.threads - cuda_ldlt.LANES_A_ROW * block
        assert row_threads % 32 == 0 and 32 <= row_threads <= cuda_ldlt.DIST_PANEL_ROW_THREADS
        assert cuda_ldlt.LANES_A_ROW * geo.rows <= row_threads
        cover = np.zeros(n, dtype=np.int64)
        cover[row0:row0 + block] += 1
        for cta in range(geo.grid):
            below, above = geo.rows_of(cta, n, row0, block)
            cover[below.start:below.stop] += 1
            cover[above.start:above.stop] += 1
        assert (cover == 1).all(), (n, block, row0, geo)


def test_dist_panel_grid_refuses_panels_outside_the_slab():
    with pytest.raises(ValueError, match="outside"):
        cuda_ldlt.dist_panel_grid(128, 96, 64)
    with pytest.raises(ValueError, match="widths"):
        cuda_ldlt.dist_panel_grid(128, 0, 48)


@pytest.mark.parametrize("world", WORLDS)
def test_factor_and_solve_match_uno_tpu(world, port_worlds, uno_tpu_results):
    ref = uno_tpu_results[world]
    K = kkt_matrix(N, N // 4, seed=3)
    for rank in port_worlds[world]:
        assert rank["inertia"] == ref["inertia"] == (N - N // 4, N // 4, 0)
        assert np.max(np.abs(rank["L"] - ref["L"])) <= REL * np.max(np.abs(ref["L"]))
        assert np.max(np.abs(rank["d"] - ref["d"])) <= REL * np.max(np.abs(ref["d"]))
        for x, r in zip(rank["x"], rhs_list()):
            x_np = np.linalg.solve(K, r)
            assert np.max(np.abs(x - x_np)) <= SOLVE_REL * np.max(np.abs(x_np))
        assert rank["indefinite"] == (96, 32, 0)
    # every rank holds the same pivots and solutions
    first = port_worlds[world][0]
    for rank in port_worlds[world][1:]:
        assert np.array_equal(rank["d"], first["d"])
        assert all(np.array_equal(a, b) for a, b in zip(rank["x"], first["x"]))


@pytest.mark.parametrize("world", WORLDS)
def test_ipm_with_distributed_kkt_matches_uno_tpu(world, port_worlds, uno_tpu_results):
    status, iterations, x = uno_tpu_results["ipm"]
    assert status == "optimal"
    for rank in port_worlds[world]:
        assert rank["ipm"][:2] == (status, iterations)
        assert np.max(np.abs(rank["ipm"][2] - x)) <= IPM_X_ATOL


def test_kkt_backend_pads_and_refuses_batches():
    """make_dist_kkt_backend pads to a multiple of P * block with a +1
    identity tail whose pivots leave the inertia, and takes a batch of one."""
    group = make_group("cpu")
    K = torch.as_tensor(kkt_matrix(50, 10, seed=1))
    factorize, solve = tdl.make_dist_kkt_backend(group, 50, block=16)
    fac = factorize(K[None].contiguous())
    assert (int(fac.num_pos[0]), int(fac.num_neg[0]), int(fac.num_zero[0])) == (40, 10, 0)
    assert fac.L_cyc.shape == (1, 64, 64)
    r = torch.as_tensor(np.random.default_rng(2).standard_normal((1, 50)))
    x = solve(fac, r)
    assert x.shape == (1, 50)
    assert np.allclose(x[0].numpy(), np.linalg.solve(K.numpy(), r[0].numpy()), atol=1e-9)
    with pytest.raises(ValueError, match="batch of one"):
        factorize(torch.stack([K, K]))


def test_distributed_route_requires_a_process_group():
    with pytest.raises(ValueError, match="requires a process group"):
        uno_tpu_torch.solve(scalable_quadratic(6, 2), options=ipm_options(), device="cpu")
    # a group serves the interior-point method only
    with pytest.raises(ValueError, match="interior-point"):
        uno_tpu_torch.solve(scalable_quadratic(6, 2), preset="filtersqp",
                            group=make_group("cpu"))
