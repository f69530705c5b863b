"""uno_tpu_torch on the card: the LDL^T kernel against its plain version,
and the batch solve through the kernel.  Marked `cuda`; each test skips
where torch sees no card.  On the card: pytest -m cuda tests/test_torch_cuda.py"""

import numpy as np
import pytest
import torch

import chip_smoke
import uno_tpu_torch
from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.model.library import flagship

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim", [1, 6, 12, 40, 132, 260])
def test_kernel_matches_plain_version(card, dim, dtype):
    # backward-error, entry and inertia limits of chip_smoke.check_kernel
    chip_smoke.check_kernel(8, dim, dtype, seed=dim)


def test_kernel_counts_launches_and_rejects_bad_inputs(card):
    A = torch.eye(5, dtype=torch.float32, device=card)[None].repeat(3, 1, 1)
    before = cuda_ldlt.launches
    fac = cuda_ldlt.ldlt_factor_cuda(A)
    torch.cuda.synchronize()
    assert cuda_ldlt.launches == before + 1
    assert fac.num_pos.tolist() == [5, 5, 5]
    with pytest.raises(ValueError):
        cuda_ldlt.ldlt_factor_cuda(A.transpose(1, 2))
    with pytest.raises(ValueError):
        cuda_ldlt.ldlt_factor_cuda(A.half())


def test_batch_solve_on_the_card_matches_cpu(card):
    nlp, x0, p = flagship(64)
    opts = chip_smoke.main_path_options()
    before = cuda_ldlt.launches
    gpu = uno_tpu_torch.solve_batch(nlp, x0, p, opts=opts, device="cuda")
    assert cuda_ldlt.launches > before
    cpu = uno_tpu_torch.solve_batch(nlp, x0, p, opts=opts, device="cpu")
    assert gpu.status.tolist() == cpu.status.tolist()
    assert np.abs(gpu.iterations - cpu.iterations).max() <= chip_smoke.ITERATION_SLACK
    np.testing.assert_allclose(gpu.x, cpu.x, atol=chip_smoke.X_ATOL)
