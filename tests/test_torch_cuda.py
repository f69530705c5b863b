"""uno_tpu_torch on the card: the LDL^T kernels (ldlt_warp up to dim 32,
ldlt_column up to 64, ldlt_panel above) and the distributed LDL^T's panel
factor (dist_panel) against their plain versions, and the batch solves
(ipopt and filtersqp), the IPM's ingredient mixes, the host SQP driver,
the distributed KKT route on a one-process NCCL group, the sharded batch
and the Schur-complement solver through them.  Marked `cuda`; each
test skips where torch sees no card.  On the card:
pytest -m cuda tests/test_torch_cuda.py"""

import numpy as np
import pytest
import torch

import chip_smoke
import uno_tpu_torch
from uno_tpu_torch.linalg import cuda_ldlt
from uno_tpu_torch.linalg.ldlt import _inertia
from uno_tpu_torch.model.library import flagship

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim", [1, 6, 12, 31, 32, 33, 34, 40, 64, 65, 66, 132,
                                 260, 516])
def test_kernel_matches_plain_version(card, dim, dtype):
    # backward-error, entry and inertia limits of chip_smoke.check_kernel;
    # barrier_kkt_like's matrices are indefinite, with a known inertia.
    # Float64 rows of dims 34 and 66 end two elements into a 16-byte vector
    chip_smoke.check_kernel(8, dim, dtype, seed=dim)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_single_large_instance(card, dtype):
    chip_smoke.check_kernel(1, 1280, dtype, seed=7)


@pytest.mark.parametrize("batch", [1, 65536])
def test_warp_kernel_batch_sizes(card, batch):
    chip_smoke.check_kernel(batch, 12, "float32", seed=batch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", [3, 33, 40, 50, 64])
def test_zero_pivot(card, dim, dtype):
    """An exactly singular matrix: the third pivot is 0, the _safe clamp
    keeps L finite, and the inertia counts the pivot as zero.  Then NaN
    pivots: the inertia follows _inertia's NaN rule (a NaN in d makes the
    threshold NaN: no pivot counts as zero, NaN pivots count nowhere).  At a
    NaN first pivot the factors equal the plain version's, NaN for NaN; at
    a later one the plain version's full-matrix update spreads the NaN over
    every entry, the kernel's over the trailing entries only."""
    A = torch.eye(dim, dtype=torch.float64)
    A[:3, :3] = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [1.0, 1.0, 2.0]])
    A = A.to(dtype=dtype, device=card)[None].repeat(5, 1, 1).contiguous()
    fac = cuda_ldlt.ldlt_factor_cuda(A)
    plain = cuda_ldlt.plain_factorizer(dim)(A)
    assert torch.isfinite(fac.L).all()
    assert fac.d[:, 2].abs().max() == 0
    assert torch.equal(fac.L, plain.L) and torch.equal(fac.d, plain.d)
    assert fac.num_zero.tolist() == [1] * 5
    assert fac.num_pos.tolist() == [dim - 1] * 5 and fac.num_neg.tolist() == [0] * 5
    for got, want in zip(fac[2:], _inertia(fac.d, 1e-32)):
        assert torch.equal(got, want)
    if dim <= 32:
        return
    A[0, 0, 0] = float("nan")         # the first pivot
    A[1:, 4, 4] = float("nan")        # a later one, after the zero pivot
    fac = cuda_ldlt.ldlt_factor_cuda(A)
    plain = cuda_ldlt.plain_factorizer(dim)(A)
    for got, want in zip(fac[:2], plain[:2]):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)
    assert fac.d[0].isnan().all() and fac.d[1:, 4:].isnan().all()
    assert torch.equal(fac.d[1:, :4], A.new_tensor([1.0, 1.0, 0.0, 1.0]).expand(4, 4))
    assert torch.isfinite(fac.L[1:, :, :4]).all()
    for got, want in zip(fac[2:], _inertia(fac.d, 1e-32)):
        assert torch.equal(got, want)
    assert fac.num_pos.tolist() == [0] + [3] * 4
    assert fac.num_neg.tolist() == [0] * 5 and fac.num_zero.tolist() == [0] * 5


def test_kernel_counts_launches_and_rejects_bad_inputs(card):
    for dim, route in ((5, "ldlt_warp"), (40, "ldlt_column"), (70, "ldlt_panel")):
        A = torch.eye(dim, dtype=torch.float32, device=card)[None].repeat(3, 1, 1)
        before = dict(cuda_ldlt.launches), dict(cuda_ldlt.calls)
        fac = cuda_ldlt.ldlt_factor_cuda(A)
        torch.cuda.synchronize()
        # the kernels the C side launched: 1, or 5 for three panel steps
        launched = cuda_ldlt.plan(3, dim, A.dtype).launches
        assert cuda_ldlt.plan(3, dim, A.dtype).route == route
        assert launched == (5 if route == "ldlt_panel" else 1)
        assert cuda_ldlt.launches[route] == before[0][route] + launched
        assert sum(cuda_ldlt.launches.values()) == sum(before[0].values()) + launched
        assert cuda_ldlt.calls[route] == before[1][route] + 1
        assert sum(cuda_ldlt.calls.values()) == sum(before[1].values()) + 1
        assert fac.num_pos.tolist() == [dim] * 3
        with pytest.raises(ValueError):
            cuda_ldlt.ldlt_factor_cuda(A.transpose(1, 2))
        with pytest.raises(ValueError):
            cuda_ldlt.ldlt_factor_cuda(A.half())


def test_batch_solve_on_the_card_matches_cpu(card):
    nlp, x0, p = flagship(64)
    opts = chip_smoke.main_path_options()
    before = cuda_ldlt.launches["ldlt_warp"]
    gpu = uno_tpu_torch.solve_batch(nlp, x0, p, opts=opts, device="cuda")
    assert cuda_ldlt.launches["ldlt_warp"] > before
    cpu = uno_tpu_torch.solve_batch(nlp, x0, p, opts=opts, device="cpu")
    assert gpu.status.tolist() == cpu.status.tolist()
    assert np.abs(gpu.iterations - cpu.iterations).max() <= chip_smoke.ITERATION_SLACK
    np.testing.assert_allclose(gpu.x, cpu.x, atol=chip_smoke.X_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", range(33, 65))
def test_column_kernel_equals_the_column_form(card, dim, dtype):
    """ldlt_column repeats ldlt_factor's operations in its order: L, d and
    the inertia equal bit for bit, at B=1, 2, a ragged batch, each batch
    where plan() changes the threads per instance and its neighbours, and
    the sweep's batch; every group of threads at a small batch."""
    from uno_tpu_torch.linalg.ldlt import ldlt_factor
    for batch in chip_smoke.column_batches() + [chip_smoke.N32_BATCH]:
        K, _ = chip_smoke.barrier_kkt_like(batch, dim, seed=dim + batch)
        A = torch.as_tensor(K, dtype=dtype, device=card).contiguous()
        fk, fc = cuda_ldlt.ldlt_factor_cuda(A), ldlt_factor(A)
        assert cuda_ldlt.plan(batch, dim, dtype).route == "ldlt_column"
        for name in LDLT_FIELDS:
            assert torch.equal(getattr(fk, name), getattr(fc, name)), (batch, name)
    for group in cuda_ldlt.column_groups_for(dim):
        outs = (torch.empty_like(A[:3]), torch.empty_like(fc.d[:3]),
                *(torch.empty_like(c[:3]) for c in fc[2:]))
        cuda_ldlt.launch(A[:3].contiguous(), *outs, group=group)
        for got, name in zip(outs, LDLT_FIELDS):
            assert torch.equal(got, getattr(fc, name)[:3]), (group, name)


LDLT_FIELDS = ("L", "d", "num_pos", "num_neg", "num_zero")


@pytest.mark.parametrize("dim", chip_smoke.FIT_DIMS + (40, 64))
def test_kernels_equal_the_column_form_at_the_multiplier_fit_dims(card, dim):
    """The QP's multiplier fit factors its normal equations with uno_tpu's
    column form: the kernels give the same factors at the fit dims."""
    row = chip_smoke.check_fit_exact(64, dim, seed=dim)
    assert row["max_abs_err"] == 0.0 and row["inertia_equal"]


def test_sqp_batch_on_the_card_matches_cpu(card):
    nlp, x0, p = flagship(64)
    opts = chip_smoke.sqp_options()
    before = cuda_ldlt.launches["ldlt_warp"]
    gpu = uno_tpu_torch.solve_batch(nlp, x0, p, opts=opts, device="cuda")
    assert cuda_ldlt.launches["ldlt_warp"] > before
    cpu = uno_tpu_torch.solve_batch(nlp, x0, p, opts=opts, device="cpu")
    assert gpu.status.tolist() == cpu.status.tolist()
    assert gpu.iterations.tolist() == cpu.iterations.tolist()
    np.testing.assert_allclose(gpu.x, cpu.x, atol=chip_smoke.X_ATOL)


def test_sqp_single_instances_on_the_card_match_cpu(card):
    chip_smoke.phase_sqp_single("cuda")


def test_ipm_mix_batches_on_the_card_match_cpu(card):
    """chip_smoke.py's ipm_mixes phase at B=256: every mix solves every
    instance, equal to the CPU on 16 reruns, LS_batch_candidates=4 equal to
    the standard filter, and the Hessian-model singles against the CPU."""
    out = chip_smoke.phase_ipm_mixes("cuda", full_batch=256, batch=256, rerun=16)
    for row in out["batches"]:
        assert row["solved"] == 256 and row["launches_by_route"]["ldlt_warp"] > 0


def test_host_sqp_driver_on_the_card_matches_cpu(card):
    """chip_smoke.py's sqp_host phase: the host driver on hs015 and hs071,
    card against CPU and uno_tpu's recorded results."""
    out = chip_smoke.phase_sqp_host("cuda")
    assert out["launches_by_route"]["ldlt_warp"] > 0


# dist_panel's heights: with panels of 64, cuda_ldlt.dist_panel_grid's grid
# grows with the rows to 132 CTAs at 1,120 rows (131 at 1,112), its row
# threads go from one warp to two past 8 rows a CTA (1,120 to 1,128 rows)
# and a CTA's rows take two passes past 64 (8,512 to 8,520 rows); 72 and
# 80 rows make one CTA and two
DIST_PANEL_HEIGHTS = [64, 72, 80, 202, 1112, 1120, 1128, 1280, 8512, 8520]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rows", DIST_PANEL_HEIGHTS)
def test_dist_panel_equals_its_plain_version(card, rows, dtype):
    """dist_panel on a rank's storage against panel_factor_plain, bit for
    bit, at the first panel, a middle one and the last (row0 = rows - 64),
    the other columns untouched (chip_smoke.check_dist_panel); 202 rows of
    float32 take the path without 16-byte accesses."""
    row = chip_smoke.check_dist_panel(rows, dtype, seed=rows, timed=False)
    assert row["max_abs_err"] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rows", [32, 202, 1280])
def test_dist_panel_of_32_columns(card, rows, dtype):
    row = chip_smoke.check_dist_panel(rows, dtype, seed=rows, block=32, timed=False)
    assert row["max_abs_err"] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rows,block", [(1280, 64), (8192, 64), (1280, 32)])
def test_dist_panel_on_a_four_rank_storage(card, rows, block, dtype):
    """Rank 1's (rows, rows / 4) storage of four ranks, as make_dist_ldlt
    hands it to the kernel: ld = rows / 4 and col0 > 0 past its first
    panel."""
    row = chip_smoke.check_dist_panel(rows, dtype, seed=rows + 1, block=block, ranks=4,
                                      timed=False)
    assert row["ld"] == rows // 4 and row["panels"][-1][1] > 0
    assert row["max_abs_err"] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("kind", ["nan_pivot", "inf_multiplier"])
def test_dist_panel_on_nonfinite_panels(card, kind, block, dtype):
    """A NaN pivot and an infinite multiplier: NaN and Inf spread over the
    slab, the rows above the block included, as in panel_factor_plain (NaN
    where it is NaN, the other entries bit for bit)."""
    row = chip_smoke.check_dist_panel(1280, dtype, seed=5, block=block, nonfinite=kind,
                                      timed=False)
    assert row["max_abs_err"] == 0.0


def test_dist_panel_refuses_what_it_does_not_take(card):
    from uno_tpu_torch.parallel.dist_ldlt import panel_factor
    work = torch.zeros((64, 96), dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="panel width"):
        panel_factor(work, 0, 0, 48)
    with pytest.raises(ValueError, match="outside"):
        panel_factor(work, 64, 0, 64)
    with pytest.raises(ValueError, match="contiguous"):
        panel_factor(work[:, :64].t(), 0, 0, 32)


@pytest.fixture
def nccl(card):
    """The one-process NCCL group, destroyed after the test."""
    from uno_tpu_torch.parallel import make_group
    group = make_group("cuda")
    yield group
    torch.distributed.destroy_process_group()


def test_distributed_kkt_on_a_one_process_nccl_group(nccl):
    """ldlt_backend="distributed" on a one-process NCCL group equals the
    dense route on the CPU (status and iterations, x within 1e-8) and
    launches dist_panel."""
    from uno_tpu_torch.model.library import scalable_quadratic
    nlp = scalable_quadratic(100, 30, seed=2)
    opts = uno_tpu_torch.preset("ipopt", scale_functions=False, ldlt_backend="distributed")
    group = nccl
    assert group.backend == "nccl" and group.device.type == "cuda"
    before = cuda_ldlt.launches["dist_panel"]
    gpu = uno_tpu_torch.solve(nlp, options=opts, group=group)
    assert cuda_ldlt.launches["dist_panel"] > before
    cpu = uno_tpu_torch.solve(nlp, options=opts.replace(ldlt_backend="auto"), device="cpu")
    assert (gpu.status, gpu.iterations) == (cpu.status, cpu.iterations) == ("optimal", cpu.iterations)
    np.testing.assert_allclose(gpu.x, cpu.x, atol=1e-8)


def test_sharded_batch_and_schur_on_the_card(nccl):
    """chip_smoke.py's sharded phase at B=256 against solve_batch on the
    card, and its schur phase at a small size against the CPU."""
    keep = {}
    chip_smoke.phase_main_path("cuda", batch=256, rerun=8, keep=keep)
    chip_smoke.phase_sharded(keep["result"], "cuda", batch=256)
    chip_smoke.phase_schur("cuda", S=64, nb=40, n0=72)
