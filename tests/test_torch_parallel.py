"""uno_tpu_torch.parallel's sharded batch and dry run on the CPU.

solve_batch_sharded on a Gloo world of 2 processes, 4 flagship instances
a rank, equals the port's solve_batch on the 8 instances bit for bit
(every instance's iterates are its own, whatever batch it runs in) and
matches uno_tpu's solve_batch_sharded on 8 virtual devices (status and
iterations equal, x within 1e-8).  The dry run (the counterpart of
dryrun_multichip) runs in this process on a one-process Gloo group.  JAX
is imported inside the tests only: the spawned ranks import this module.
"""

import numpy as np
import pytest

from torch_world import run_world
import uno_tpu_torch
from uno_tpu_torch.model.library import flagship
from uno_tpu_torch.parallel import Group, make_group, solve_batch_sharded
from uno_tpu_torch.parallel.dryrun import dryrun

BATCH = 8
X_ATOL = 1e-8
FIELDS = ("status", "x", "objective", "iterations", "primal_feasibility", "stationarity")


def options():
    return uno_tpu_torch.preset("ipopt", scale_functions=False)


def sharded_worker(group):
    nlp, x0, params = flagship(BATCH)
    res = solve_batch_sharded(nlp, options(), x0, params, group)
    return {k: getattr(res, k) for k in FIELDS}


@pytest.fixture(scope="module")
def plain_batch():
    nlp, x0, params = flagship(BATCH)
    return uno_tpu_torch.solve_batch(nlp, x0, params, opts=options(), device="cpu")


def test_sharded_batch_equals_solve_batch(plain_batch):
    ranks = run_world(sharded_worker, 2)
    for rank in ranks:
        for k in FIELDS:
            assert np.array_equal(rank[k], getattr(plain_batch, k)), k
    assert plain_batch.num_solved == BATCH


def test_sharded_batch_matches_uno_tpu(plain_batch):
    import jax.numpy as jnp
    from __graft_entry__ import _flagship
    from uno_tpu.options import preset as j_preset
    from uno_tpu.parallel import make_mesh
    from uno_tpu.parallel import solve_batch_sharded as j_sharded
    nlp, x0, params = _flagship(BATCH)
    ref = j_sharded(nlp, j_preset("ipopt", scale_functions=False), x0,
                    jnp.asarray(params), mesh=make_mesh())
    assert np.array_equal(plain_batch.status, ref.status)
    assert np.array_equal(plain_batch.iterations, ref.iterations)
    assert np.max(np.abs(plain_batch.x - ref.x)) <= X_ATOL


def test_sharded_batch_on_a_world_of_one(plain_batch):
    nlp, x0, params = flagship(BATCH)
    res = solve_batch_sharded(nlp, options(), x0, params, make_group("cpu"))
    for k in FIELDS:
        assert np.array_equal(getattr(res, k), getattr(plain_batch, k)), k


def test_ranks_take_contiguous_runs():
    """Group.local_range splits as a mesh axis's PartitionSpec does, and
    refuses a batch that is not a multiple of the world size."""
    import torch
    runs = [Group(rank, 4, torch.device("cpu"), "gloo").local_range(8) for rank in range(4)]
    assert runs == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        Group(1, 2, torch.device("cpu"), "gloo").local_range(3)


def test_dryrun_in_process():
    out = dryrun(make_group("cpu"))
    assert out["world"] == 1 and out["backend"] == "gloo"
    assert out["solved"] == out["batch"] == 2
    assert out["dist_status"] == 1
    # the distributed route's instance 0 is the batch's instance 0
    nlp, x0, params = flagship(2)
    single = uno_tpu_torch.solve_batch(nlp, x0[:1], params[:1], opts=options(),
                                       device="cpu")
    assert out["dist_iterations"] == int(single.iterations[0])
    assert np.max(np.abs(np.asarray(out["dist_x"]) - single.x[0])) <= X_ATOL


def subgroup_worker(group):
    """Each rank alone (a subgroup of one), then both ranks together, solve
    the batch: tools/multicard_study.py's sharded_scaling and
    tools/multiproc_world.py's node groups."""
    from uno_tpu_torch.parallel import subgroup
    nlp, x0, params = flagship(BATCH)
    alone = [subgroup(group, [r]) for r in range(group.size)][group.rank]
    both = subgroup(group, range(group.size))
    res_alone = solve_batch_sharded(nlp, options(), x0, params, alone)
    res_both = solve_batch_sharded(nlp, options(), x0, params, both)
    return {"alone": (alone.rank, alone.size), "both": (both.rank, both.size),
            "x_alone": res_alone.x, "x_both": res_both.x}


def test_subgroups_solve_the_batch(plain_batch):
    ranks = run_world(subgroup_worker, 2)
    for rank, out in enumerate(ranks):
        assert out["alone"] == (0, 1) and out["both"] == (rank, 2)
        assert np.array_equal(out["x_alone"], plain_batch.x)
        assert np.array_equal(out["x_both"], plain_batch.x)
