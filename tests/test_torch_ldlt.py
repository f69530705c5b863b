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


@pytest.mark.parametrize("dim", [12, 40, 200])
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
    before = cuda_ldlt.launches
    A = torch.as_tensor(kkt(40, 1)[0])[None]
    fac = cuda_ldlt.ldlt_factor_cuda(A)
    assert cuda_ldlt.launches == before       # the CPU path launches nothing
    # ... and runs the plain version the solver uses at that dim
    np.testing.assert_array_equal(fac.L.numpy(), tl.plain_factorizer(40)(A).L.numpy())
    assert len(cuda_ldlt.source_hash()) == 16
    with pytest.raises(ValueError):
        cuda_ldlt.launch(A, torch.empty_like(A), torch.empty(A.shape[:2]))
    assert cuda_ldlt.launches == before


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
