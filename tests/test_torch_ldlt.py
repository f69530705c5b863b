"""uno_tpu_torch's plain LDL^T versions and the CPU side of the CUDA wrapper,
held against uno_tpu's factorizations (the Pallas kernel in interpret mode,
as tests/test_ldlt.py runs it) on seeded barrier-KKT-like matrices."""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uno_tpu.linalg import ldlt as jl
from uno_tpu.linalg.pallas_ldlt import ldlt_factor_pallas
from uno_tpu_torch.ingredients.regularization import pick_factorizer
from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.linalg import ldlt as tl

# float64 L and d of the same unpivoted algorithm: only the order of the
# sums in the panel updates differs between the forms
LDLT_TOL = 1e-12


def kkt(dim, seed):
    """Barrier-KKT-like symmetric indefinite matrix with well-separated
    pivots: H diagonal 1..1e2 plus small coupling, Gaussian J, -eps block."""
    rng = np.random.default_rng(seed)
    m = max(1, dim // 5)
    n = dim - m
    H = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    H = (H + H.T) / 2
    H[np.diag_indices(n)] = 10.0 ** rng.uniform(0, 2, n)
    J = rng.standard_normal((m, n))
    K = np.zeros((dim, dim))
    K[:n, :n] = H
    K[n:, :n] = J
    K[:n, n:] = J.T
    K[np.arange(n, dim), np.arange(n, dim)] = -(10.0 ** rng.uniform(-8, -2, m))
    return K, (n, m)


JAX_FACTORS = {
    "unrolled": jl.ldlt_factor_unrolled,
    "column": jl.ldlt_factor,
    "blocked": lambda A: jl.ldlt_factor_blocked(A, block=32),
    "pallas": lambda A: ldlt_factor_pallas(A, interpret=True),
}
# the port's counterpart of each: the Pallas kernel's is the solver's
# factorizer, which on a CPU tensor runs the kernel's plain version
TORCH_FACTORS = {
    "unrolled": tl.ldlt_factor_unrolled,
    "column": tl.ldlt_factor,
    "blocked": lambda A: tl.ldlt_factor_blocked(A, block=32),
    "pallas": lambda A: pick_factorizer(A.shape[-1])(A),
}


# 32/33 and 64/65 are the edges of the kernels' routes and of the plain
# versions' forms; 100 leaves a ragged last panel
@pytest.mark.parametrize("dim", [12, 32, 33, 40, 64, 65, 100, 200])
@pytest.mark.parametrize("form", list(JAX_FACTORS))
def test_plain_ldlt_matches_uno_tpu(form, dim):
    K, (n, m) = kkt(dim, seed=dim)
    ref = JAX_FACTORS[form](jnp.asarray(K))
    got = TORCH_FACTORS[form](torch.as_tensor(K)[None])
    np.testing.assert_allclose(got.L[0].numpy(), np.asarray(ref.L),
                               rtol=LDLT_TOL, atol=LDLT_TOL)
    np.testing.assert_allclose(got.d[0].numpy(), np.asarray(ref.d),
                               rtol=LDLT_TOL, atol=LDLT_TOL)
    inertia = [int(got.num_pos[0]), int(got.num_neg[0]), int(got.num_zero[0])]
    assert inertia == [int(ref.num_pos), int(ref.num_neg), int(ref.num_zero)]
    assert inertia == [n, m, 0]


@pytest.mark.parametrize("dim", [5, 40])
def test_solve_and_refine_match_uno_tpu(dim):
    K, _ = kkt(dim, seed=3)
    rhs = np.random.default_rng(4).standard_normal(dim)
    jf = jl.ldlt_factor(jnp.asarray(K))
    tf = tl.ldlt_factor(torch.as_tensor(K)[None])
    x_ref = np.asarray(jl.ldlt_solve(jf, jnp.asarray(rhs)))
    x = tl.ldlt_solve(tf, torch.as_tensor(rhs)[None])
    np.testing.assert_allclose(x[0].numpy(), x_ref, rtol=1e-10, atol=1e-12)
    # f32 factors + one f64-residual refinement step
    K32 = K.astype(np.float32)
    tf32 = tl.ldlt_factor(torch.as_tensor(K32)[None])
    x32 = tl.ldlt_solve(tf32, torch.as_tensor(rhs, dtype=torch.float32)[None])
    x1 = tl.ldlt_refine(torch.as_tensor(K32)[None], tf32,
                        torch.as_tensor(rhs, dtype=torch.float32)[None], x32)
    r0 = np.abs(K @ x32[0].double().numpy() - rhs).max()
    r1 = np.abs(K @ x1[0].double().numpy() - rhs).max()
    assert r1 <= r0 + 1e-6


def test_singular_and_batched():
    A = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [1.0, 1.0, 2.0]])
    for form, fn in TORCH_FACTORS.items():
        fac = fn(torch.as_tensor(A)[None])
        assert int(fac.num_zero[0]) >= 1, form
    # each instance of a batch factors on its own
    Ks = np.stack([kkt(12, s)[0] for s in range(5)])
    fb = tl.ldlt_factor_unrolled(torch.as_tensor(Ks))
    for i in range(5):
        fi = tl.ldlt_factor_unrolled(torch.as_tensor(Ks[i])[None])
        np.testing.assert_array_equal(fb.L[i].numpy(), fi.L[0].numpy())


@pytest.mark.parametrize("bad", ["float16", "int", "2d", "nonsquare",
                                 "noncontiguous", "empty_dim", "not_tensor"])
def test_cuda_wrapper_rejects_bad_inputs(bad):
    A = torch.eye(4, dtype=torch.float64).expand(2, 4, 4).contiguous()
    arg = {
        "float16": A.half(),
        "int": A.long(),
        "2d": A[0],
        "nonsquare": A[:, :3, :],
        "noncontiguous": A.transpose(1, 2),
        "empty_dim": A[:, :0, :0],
        "not_tensor": A.numpy(),
    }[bad]
    with pytest.raises((ValueError, TypeError)):
        cuda_ldlt.ldlt_factor_cuda(arg)


def test_cuda_wrapper_counts_only_kernel_launches():
    before = dict(cuda_ldlt.launches), dict(cuda_ldlt.calls)
    assert set(before[0]) == set(before[1]) == {"ldlt_warp", "ldlt_column", "ldlt_panel",
                                                "dist_panel"}
    A = torch.as_tensor(kkt(40, 1)[0])[None]
    fac = cuda_ldlt.ldlt_factor_cuda(A)
    # the CPU path launches nothing, nor does the distributed panel factor's
    from uno_tpu_torch.parallel.dist_ldlt import panel_factor
    panel_factor(A[0].clone(), 0, 0, 32)
    assert (cuda_ldlt.launches, cuda_ldlt.calls) == before
    # ... and runs the plain version the solver uses at that dim
    np.testing.assert_array_equal(fac.L.numpy(), tl.plain_factorizer(40)(A).L.numpy())
    assert len(cuda_ldlt.source_hash()) == 16
    counts = [torch.empty(1, dtype=torch.int64) for _ in range(3)]
    with pytest.raises(ValueError):
        cuda_ldlt.launch(A, torch.empty_like(A), torch.empty(A.shape[:2]), *counts)
    assert (cuda_ldlt.launches, cuda_ldlt.calls) == before
    # uncounted() restores the counts; reset_counts() zeroes them
    with cuda_ldlt.uncounted():
        cuda_ldlt.launches["ldlt_panel"] += 3
        cuda_ldlt.calls["ldlt_panel"] += 1
    assert (cuda_ldlt.launches, cuda_ldlt.calls) == before
    cuda_ldlt.reset_counts()
    assert set(cuda_ldlt.launches.values()) == set(cuda_ldlt.calls.values()) == {0}


def _rn32(x):
    """The float32 nearest to the exact rational x, ties to even."""
    from fractions import Fraction
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))


def test_markstein_division_is_correctly_rounded():
    """csrc/ldlt.cu's row solves divide a by b as q0 = a y, r = fma(-q0,
    b, a), q = fma(r, y, q0) with y = 1/b correctly rounded; that is a
    correctly rounded a / b (in range), so the kernel keeps the plain
    version's quotients.  Checked in exact arithmetic on float32."""
    from fractions import Fraction as F
    rng = np.random.default_rng(0)
    n = 3000
    sign = np.where(rng.uniform(size=n) < 0.5, -1, 1)
    a = (sign * rng.uniform(1, 2, n) * 2.0 ** rng.integers(-40, 40, n)).astype(np.float32)
    b = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-40, 40, n)).astype(np.float32)
    b[:500] = (2 - 2.0 ** -23) * 2.0 ** rng.integers(-20, 20, 500)   # all-ones significands
    b[500:1000] = 1 + rng.integers(0, 64, 500) * 2.0 ** -23          # just above powers of 2
    a[1000:1500] = 2 - rng.integers(0, 64, 500) * 2.0 ** -23
    for x, y_ in zip(a, b):
        y = np.float32(1) / y_
        q0 = np.float32(x * y)
        r = _rn32(F(float(x)) - F(float(q0)) * F(float(y_)))
        q = _rn32(F(float(r)) * F(float(y)) + F(float(q0)))
        assert q == x / y_, (x, y_)


PLAN_DIMS = [1, 2, 6, 8, 9, 12, 16, 17, 31, 32, *range(33, 65), 65, 66, 100,
             516, 640, 1280, 4097, 46340]
# ldlt_column's batches: 1, 2, the sweep's, and each batch where plan()
# changes the threads per instance with its two neighbours
COLUMN_BATCHES = sorted({1, 2, 8192} | {least + k for least in cuda_ldlt.COLUMN_SWITCH_BATCHES
                                        for k in (-1, 0, 1)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", PLAN_DIMS)
def test_plan_routes_and_sizes(dim, dtype):
    """The launch plan the C side checks: ldlt_warp up to dim 32,
    ldlt_column up to 64 (one instance a block, or two of 16 threads, its
    threads per instance set by the batch, dim and dtype), ldlt_panel above it with 2 ceil(dim/32) - 1 launches
    (the ragged last panel has no trailing update; it may be forced at
    33-64), shared memory an H100 block can have, grids the card takes, and
    every instance covered."""
    item = torch.empty((), dtype=dtype).element_size()
    for batch in sorted({1, 3, 132, 65536} | set(COLUMN_BATCHES)):
        if batch * dim * dim > 2**33:
            continue
        plans = [cuda_ldlt.plan(batch, dim, dtype)]
        assert plans[0].route == ("ldlt_warp" if dim <= 32 else
                                  "ldlt_column" if dim <= 64 else "ldlt_panel")
        if plans[0].route == "ldlt_column":
            plans.append(cuda_ldlt.plan(batch, dim, dtype, route="ldlt_panel"))
            plans += [cuda_ldlt.plan(batch, dim, dtype, group=g)
                      for g in cuda_ldlt.column_groups_for(dim)]
            if dim > cuda_ldlt.COLUMN_GROUP16_MAX_DIM:
                with pytest.raises(ValueError):
                    cuda_ldlt.plan(batch, dim, dtype, group=16)
        else:
            with pytest.raises(ValueError):
                cuda_ldlt.plan(batch, dim, dtype, route="ldlt_column")
            with pytest.raises(ValueError):
                cuda_ldlt.plan(batch, dim, dtype, group=32)
        for p in plans:
            _check_plan(p, batch, dim, item)
    with pytest.raises(ValueError):
        cuda_ldlt.plan(0, dim, dtype)


def test_column_group_switches_at_its_batches():
    """Two warps an instance until the batch fills the card; from the
    switch batches, 16 threads at dims up to 40 and 32 in float64 above
    56; never a group without a kernel for the dim."""
    for item in (4, 8):
        for dim in range(33, 65):
            groups = [cuda_ldlt.column_group(b, dim, item) for b in range(1, 8193)]
            assert groups[0] == 64 and groups == sorted(groups, reverse=True)
            assert set(groups) <= set(cuda_ldlt.column_groups_for(dim))
    switches = {(36, 4): (4096, 16), (40, 8): (2048, 16), (64, 8): (1024, 32),
                (57, 8): (1024, 32)}
    for (dim, item), (least, group) in switches.items():
        assert cuda_ldlt.column_group(least, dim, item) == group
        assert cuda_ldlt.column_group(least - 1, dim, item) == 64
    assert {cuda_ldlt.column_group(8192, dim, 4) for dim in (41, 50, 64)} == {64}
    assert cuda_ldlt.column_groups_for(41) == (32, 64)


def _check_plan(p, batch, dim, item):
    assert all(0 < s <= cuda_ldlt.SMEM_MAX for s in p.smem)
    assert all(b % 32 == 0 and 32 <= b <= 1024 for b in p.block)
    assert all(1 <= g <= 2**31 - 1 for g in p.grids)
    if p.route == "ldlt_warp":
        assert p.group == min(g for g in (8, 16, 32) if g >= dim)
        per_block = p.block[0] // p.group
        assert p.smem[0] >= (per_block * dim * dim + p.block[0]) * item
        assert p.grids == (-(-batch // per_block),)
        assert p.launches == 1
    elif p.route == "ldlt_column":
        # one instance a block, over P x Q threads of a bucket N that holds
        # the dim and is a multiple of 8 and of P; shared memory holds the
        # P runs of multipliers, the column and the pivots, not the matrix
        P, Q = cuda_ldlt.COLUMN_GROUPS[p.group]
        per_block = 2 if p.group == 16 else 1     # a warp's two instances
        assert p.group == P * Q and p.block == (per_block * p.group,)
        assert p.grids == (-(-batch // per_block),)
        N, smem = cuda_ldlt.column_layout(dim, p.group, item)
        assert N % 8 == 0 and N % P == 0 and dim <= N < dim + 8
        assert (P * (N // P) + 2 * N) * item <= smem <= 2048
        assert p.smem == (per_block * smem,)
        assert p.launches == 1
    else:
        assert p.launches == 2 * -(-dim // 32) - 1
        tile = 32 if dim <= 64 else 64
        assert p.rows in (32, 64, 128) and p.block == (p.rows, (tile // 4) ** 2)
        # the first panel step covers every row below the panel, and its
        # trailing update every tile of their lower triangle
        nt = -(-(dim - 32) // tile)
        assert p.grids[0] == batch * -(-(dim - 32) // p.rows)
        assert p.grids[1] == batch * nt * (nt + 1) // 2
        assert p.grids[-1] == batch          # the last panel, one block each


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chip_smoke_kernel_checks_reject_wrong_factors(dtype):
    """chip_smoke's limits pass the plain factors and fail factors that are
    off by ten times the entry limit; the float64 limits fail float32
    factors."""
    K, _ = chip_smoke.barrier_kkt_like(64, 12, seed=5)
    A = torch.as_tensor(K, dtype=dtype)
    fac = tl.plain_factorizer(12)(A)
    name = str(dtype).removeprefix("torch.")
    assert chip_smoke.backward_error(fac, A) <= chip_smoke.BACKWARD_LIMIT
    assert chip_smoke.factor_gap(fac, fac) == 0.0
    tol = chip_smoke.FACTOR_RTOL[name]
    L = fac.L.clone()
    L[7, 9, 2] += 10 * tol * max(abs(float(L[7, 9, 2])), 1.0)
    wrong = fac._replace(L=L)
    assert chip_smoke.factor_gap(wrong, fac) > tol
    assert chip_smoke.backward_error(wrong, A) > chip_smoke.BACKWARD_LIMIT
    if dtype == torch.float64:
        f32 = tl.plain_factorizer(12)(A.float())
        f32 = f32._replace(L=f32.L.double(), d=f32.d.double())
        assert chip_smoke.factor_gap(f32, fac) > tol
        assert chip_smoke.backward_error(f32, A) > chip_smoke.BACKWARD_LIMIT


def test_pick_factorizer_routes_by_device():
    A = torch.as_tensor(kkt(12, 0)[0])[None]
    # a CPU tensor takes the plain version uno_tpu uses at that dim
    np.testing.assert_array_equal(pick_factorizer(12)(A).L.numpy(),
                                  tl.ldlt_factor_unrolled(A).L.numpy())
    with pytest.raises(ValueError):
        pick_factorizer(12)(A.to("meta"))
