"""The port's plain LDL^T updates, its small solve and its QP products
against uno_tpu's jitted ones, bit for bit: XLA:CPU contracts each update
a - dj * (l_i * l_k) into one fused multiply-add of the rounded product
l_i * l_k, and each small dot into a chain of fused multiply-adds
(tools/xla_fma_census.py reads both off the object code), and the port
writes the same operations with torch.addcmul."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from uno_tpu.linalg import ldlt as J
from uno_tpu.parallel import dist_ldlt as JD
from uno_tpu_torch.linalg import ldlt as T
from uno_tpu_torch.parallel import dist_ldlt as TD
from uno_tpu_torch.solvers import qp as TQ

DTYPES = (np.float64, np.float32)
HS061_PIVOT = -8.881784197001252e-16


def _sym(seed, shape, dt):
    X = np.random.default_rng(seed).standard_normal(shape).astype(dt)
    return X + np.swapaxes(X, -1, -2)


def _blocked_one_panel(a):
    """ldlt_factor_blocked with one panel of the whole (padded) matrix: its
    in-panel update alone, before any trailing matrix product."""
    n = a.shape[-1]
    return J.ldlt_factor_blocked(a, block=n + (-n) % 8)


FORMS = {
    "unrolled": (J.ldlt_factor_unrolled, T.ldlt_factor_unrolled, (5, 12, 36)),
    "column": (J.ldlt_factor, T.ldlt_factor, (5, 12, 36, 70)),
    "blocked_panel": (_blocked_one_panel,
                      lambda A: T.ldlt_factor_blocked(A, block=A.shape[-1] + (-A.shape[-1]) % 8),
                      (12, 36)),
}
CASES = [(form, n, dt, batch) for form, (_, _, dims) in FORMS.items() for n in dims
         for dt in DTYPES for batch in (1, 4)]


@pytest.mark.parametrize("form,n,dt,batch", CASES)
def test_plain_factor_equals_uno_tpu_bit_for_bit(form, n, dt, batch):
    jf, tf, _ = FORMS[form]
    A = _sym(n * 7 + batch, (batch, n, n), dt)
    if batch == 1:
        out = jax.jit(jf)(jnp.asarray(A[0]))
    else:
        out = jax.jit(jax.vmap(jf))(jnp.asarray(A))
    got = tf(torch.as_tensor(A))
    np.testing.assert_array_equal(got.L.numpy(), np.asarray(out.L).reshape(batch, n, n))
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(out.d).reshape(batch, n))


@pytest.mark.parametrize("dt", DTYPES)
def test_dist_panel_plain_equals_uno_tpu_bit_for_bit(dt):
    n, block, row0 = 128, 64, 64
    C = _sym(3, (n, n), dt)[:, row0:row0 + block].copy()
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    fn = jax.shard_map(lambda c: JD._panel_factor(c, row0, n, block, "x"), mesh=mesh,
                       in_specs=P(), out_specs=(P(), P()), check_vma=False)
    jC, jd = jax.jit(fn)(jnp.asarray(C))
    tC, td = TD.panel_factor_plain(torch.as_tensor(C), row0)
    np.testing.assert_array_equal(tC.numpy(), np.asarray(jC))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n,dt", [(n, dt) for n in (5, 12, 32) for dt in DTYPES])
def test_small_solve_equals_uno_tpu_bit_for_bit(n, dt):
    """One instance, as uno_tpu's single solves run it (its vmap'd solve
    takes other orders, which neither package's batch reproduces)."""
    A = _sym(n, (n, n), dt)
    b = np.random.default_rng(n + 1).standard_normal(n).astype(dt)
    b[0] = -0.0
    jf = jax.jit(J.ldlt_factor_unrolled)(jnp.asarray(A))
    js = np.asarray(jax.jit(J.ldlt_solve)(jf, jnp.asarray(b)))
    tf = T.ldlt_factor_unrolled(torch.as_tensor(A)[None])
    ts = T.ldlt_solve(tf, torch.as_tensor(b)[None])[0].numpy()
    np.testing.assert_array_equal(ts.view(np.uint8), js.view(np.uint8))


@pytest.mark.parametrize("rows,cols", [(2, 2), (3, 3), (5, 2)])
def test_qp_products_equal_uno_tpu_bit_for_bit(rows, cols):
    """The QP's A @ x (XLA's chain below one vector of columns) and A^T y."""
    rng = np.random.default_rng(rows * 10 + cols)
    A = rng.standard_normal((rows, cols)) * 1e10
    x, y = rng.standard_normal(cols), rng.standard_normal(rows)
    At = torch.as_tensor(A)[None]
    np.testing.assert_array_equal(TQ._matvec(At, torch.as_tensor(x)[None])[0].numpy(),
                                  np.asarray(jax.jit(lambda A, x: A @ x)(A, x)))
    np.testing.assert_array_equal(TQ._rmatvec(At, torch.as_tensor(y)[None])[0].numpy(),
                                  np.asarray(jax.jit(lambda A, y: A.T @ y)(A, y)))


def test_addcmul_fuses_the_update():
    """hs061's exactly singular least-squares system at x0: the last update
    -16 - (-9) (4/3)^2 is 0 with the product rounded and -8.9e-16 fused;
    torch.addcmul(a, -dj, p) gives the fused value at every length, and so
    do the three plain factors and uno_tpu's."""
    p = torch.tensor((4.0 / 3.0) ** 2, dtype=torch.float64)
    for length in range(1, 18):
        a = torch.full((length,), -16.0, dtype=torch.float64)
        dj = torch.full((length,), -9.0, dtype=torch.float64)
        assert torch.all(torch.addcmul(a, -dj, p.expand(length)) == HS061_PIVOT)
        assert torch.all(a - dj * p == 0.0)
    Jm = np.array([[3.0, 0.0, 0.0], [4.0, 0.0, 0.0]])
    K = np.block([[np.eye(3), Jm.T], [Jm, np.zeros((2, 2))]])
    for tf in (T.ldlt_factor_unrolled, T.ldlt_factor, T.ldlt_factor_blocked):
        fac = tf(torch.as_tensor(K)[None])
        assert (float(fac.d[0, -1]), int(fac.num_zero[0])) == (HS061_PIVOT, 0)
    assert float(jax.jit(J.ldlt_factor_unrolled)(jnp.asarray(K)).d[-1]) == HS061_PIVOT
