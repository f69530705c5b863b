"""The QP multiplier fit above dim 64 held against uno_tpu on the CPU.

uno_tpu factors the fit's normal equations (solvers/qp.py's dual
purification) with the column form at every dim; the port's wrapper takes
the panels above dim 64, which sum in another order.  A model whose fits
pass dim 64 is solved by both packages under byrd (the fused driver) and
filtersqp (the host driver)."""

import numpy as np
import pytest

import uno_tpu
import uno_tpu_torch
from uno_tpu.io import read_nl as j_read_nl
from uno_tpu_torch.io import read_nl as t_read_nl
from uno_tpu_torch.linalg import cuda_ldlt

MODEL = "tests/fixtures/nl/hs015like_n50.nl"


@pytest.mark.parametrize("preset,kw,fit_dim", [
    ("byrd", {}, 175),                     # fused: relaxed QPs, width 75, m 25
    ("filtersqp", dict(sqp_driver="host"), 125)])   # host: optimality QPs, 50 and 25
def test_multiplier_fit_above_dim_64_matches(monkeypatch, preset, kw, fit_dim):
    """hs015like_n50.nl, whose QP multiplier fits (m + 2n of each QP) reach
    dim 175 under byrd and 125 under filtersqp: uno_tpu factors the fit's
    normal equations with the column form at every dim, the port with the
    kernels' plain version at that dim (panels above 64).  Status,
    iterations, QPs and x equal uno_tpu's."""
    dims = set()
    factor = cuda_ldlt.ldlt_factor_cuda

    def recording(A, *args, **kwargs):
        dims.add(A.shape[-1])
        return factor(A, *args, **kwargs)

    monkeypatch.setattr(cuda_ldlt, "ldlt_factor_cuda", recording)
    ref = uno_tpu.solve(j_read_nl(MODEL), preset=preset, **kw)
    got = uno_tpu_torch.solve(t_read_nl(MODEL), preset=preset, device="cpu", **kw)
    assert ref.status == "optimal"
    assert (got.status, got.iterations, got.num_subproblems_solved) \
        == (ref.status, ref.iterations, ref.num_subproblems_solved)
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=0, atol=1e-8)
    assert got.objective == pytest.approx(ref.objective, rel=1e-10)
    assert max(dims) >= fit_dim > 64
