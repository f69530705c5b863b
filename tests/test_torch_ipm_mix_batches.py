"""uno_tpu_torch's interior-point method under the ingredient mixes,
held against uno_tpu on the CPU: the identity and zero Hessian models on
the banded backend, one step of a flagship batch from the same state
under each globalization strategy (instances in restoration among them),
flagship batches instance for instance, and LS_batch_candidates > 1 on a
batch.  The single solves are in tests/test_torch_ipm_mixes.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import uno_tpu
import uno_tpu_torch
from bench import _flagship_n
from uno_tpu.model.library import get_problem as j_problem
from uno_tpu.options import preset as j_preset
from uno_tpu.solvers import ipm as jipm
from uno_tpu_torch.interop import state_from_numpy, state_to_numpy
from uno_tpu_torch.linalg import banded_kkt
from uno_tpu_torch.model.library import flagship
from uno_tpu_torch.model.library import get_problem as t_problem
from uno_tpu_torch.solvers import ipm as tipm

STRATEGIES = ("waechter_filter_method", "fletcher_filter_method",
              "funnel_method", "l1_merit")
# a whole solve, or an iterate of one: x within X_TOL of uno_tpu's
X_TOL = 1e-8
# one float64 outer iteration from the same state: the same formulas, with
# sums and AD products rounded in another order (tests/test_torch_ipm.py)
STEP_TOL = 1e-10
FLAGSHIP = dict(scale_functions=False)


def _solve_both(name, **kw):
    ref = uno_tpu.solve(j_problem(name), preset="ipopt", **kw)
    got = uno_tpu_torch.solve(t_problem(name), preset="ipopt", device="cpu", **kw)
    return ref, got


def _banded_iterates(model, iterations, forms=("banded",)):
    """lukvle1_n10's iterates in both packages under `model`, by
    formulation: "banded" (the structured backend), "augmented" (dense)."""
    out = {}
    for form in forms:
        kw = dict(hessian_model=model, max_iterations=iterations, history=True,
                  kkt_formulation=form)
        banded_kkt.reset_counts()
        ref, got = _solve_both("lukvle1_n10", **kw)
        if form == "banded":
            assert banded_kkt.counts["factorizations"] > 0
        assert (got.status, got.iterations) == (ref.status, ref.iterations)
        out[form] = ([np.asarray(s.x) for s in ref.history],
                     [s.x[0].numpy() for s in got.history])
    return out


def test_lukvle1_banded_identity_hessian_matches():
    """The identity band with 1 on the slack diagonal (uno_tpu
    ipm.py:438-446): ten iterations of lukvle1_n10 on the banded backend
    (it needs 2,000 in both packages), iterate for iterate."""
    its = _banded_iterates("identity", 10)["banded"]
    for k, (want, got) in enumerate(zip(*its)):
        np.testing.assert_allclose(got, want, rtol=0, atol=X_TOL,
                                   err_msg=f"iteration {k}")


def test_lukvle1_banded_zero_hessian_matches():
    """The zero band: with no curvature the condensed banded system is so
    ill-conditioned that uno_tpu's own banded iterates lie 4.2e-8 from its
    augmented ones after one iteration and 1.8e-4 after three.  The port's
    augmented iterates equal uno_tpu's within STEP_TOL, and its banded
    iterates lie from uno_tpu's banded ones within twice the banded
    formulation's own gap."""
    its = _banded_iterates("zero", 3, ("banded", "augmented"))
    (ref_b, got_b), (ref_a, got_a) = its["banded"], its["augmented"]
    for k in range(1, 4):
        np.testing.assert_allclose(got_a[k], ref_a[k], rtol=0, atol=STEP_TOL,
                                   err_msg=f"augmented, iteration {k}")
        own_gap = float(np.max(np.abs(ref_b[k] - ref_a[k])))
        assert 0.0 < own_gap < 1e-3
        assert float(np.max(np.abs(got_b[k] - ref_b[k]))) <= 2.0 * own_gap, k


# ---------------------------------------------------------------------------
# flagship batches
# ---------------------------------------------------------------------------

_STEPS = {}


def _jax_step(gs, **over):
    """uno_tpu's vmapped, jitted initial state and step of the flagship
    family under `gs`; built once per test process.  The initial state does
    not read max_line_search_iterations."""
    key = (gs, tuple(sorted(over.items())))
    if key not in _STEPS:
        jn = _flagship_n(1, 8)[0]
        jo = j_preset("ipopt", globalization_strategy=gs, **FLAGSHIP, **over)
        prob, ws, step, _ = jipm.build_ipm(jn, jo)
        n_sl = prob.n - jn.n

        def init(x, p):
            return jipm.canonicalize_state(jipm.make_initial_state(
                prob, ws, jo, x0=jnp.concatenate([x, jnp.zeros(n_sl)]), params=p))

        _STEPS[key] = (jax.jit(jax.vmap(init)), jax.jit(jax.vmap(step)))
    return _STEPS[key]


def _fields(state):
    """A batched uno_tpu state's fields as writable numpy arrays."""
    out = {}
    for name in tipm.IPMState._fields:
        v = getattr(state, name)
        if name == "filter":
            out[name] = tuple(np.array(t) for t in v)
        else:
            out[name] = None if v is None else np.array(v)
    return out


def _restoration_start(batch=16):
    """Flagship instances from seeded random starts in [0, 4]^8: with a line
    search of one trial, some fail it at once and enter restoration."""
    _, _, p = _flagship_n(batch, 8)
    x0 = np.random.default_rng(3).uniform(0.0, 4.0, (batch, 8))
    return x0, p


# the first step after which instances are in restoration, by strategy,
# under max_line_search_iterations=1 from _restoration_start
RESTORATION_STEP = {"waechter_filter_method": 2, "fletcher_filter_method": 2,
                    "funnel_method": 3, "l1_merit": 2}


@pytest.mark.parametrize("gs", STRATEGIES)
def test_one_step_of_a_flagship_batch_matches_from_the_same_state(gs):
    """From uno_tpu's states of a B=16 flagship batch: the step into
    restoration (one line-search trial), then a step of the batch with
    instances in restoration under the default line search; each port step
    from uno_tpu's state equals uno_tpu's, field by field."""
    x0, p = _restoration_start()
    k = RESTORATION_STEP[gs]
    _, step1 = _jax_step(gs, max_line_search_iterations=1)
    init, step = _jax_step(gs)
    s = init(jnp.asarray(x0), jnp.asarray(p))
    for _ in range(k - 1):
        s = step1(s)
    tn = flagship(16)[0]
    for state, jstep, over in ((s, step1, dict(max_line_search_iterations=1)),
                               (step1(s), step, {})):
        start = _fields(state)
        want = _fields(jstep(state))
        _, _, tstep = tipm.build_ipm(tn, uno_tpu_torch.preset(
            "ipopt", globalization_strategy=gs, **FLAGSHIP, **over))
        got = state_to_numpy(tstep(state_from_numpy(start, "cpu")))
        for name, w in want.items():
            if w is None:
                assert got[name] is None, name
                continue
            for gi, wi in (zip(got[name], w) if name == "filter" else [(got[name], w)]):
                np.testing.assert_allclose(gi, wi, rtol=STEP_TOL, atol=STEP_TOL,
                                           err_msg=f"{gs}: {name}")
    assert (start["phase"] == 1).any() and (start["phase"] == 0).any()


@pytest.mark.parametrize("mix", [dict(globalization_strategy=gs) for gs in STRATEGIES]
                         + [dict(filter_type="nonmonotone")])
def test_batch_of_8_matches_instance_for_instance(mix):
    """solve_batch on 8 flagship instances against uno_tpu's vmapped step run
    to the end as its vmap(while_loop) runs it (a finished instance keeps
    its state).  uno_tpu's lanes are independent, so its step compiled for
    the B=16 of the one-step test runs the 8 instances twice over."""
    B = 8
    gs = mix.get("globalization_strategy", "waechter_filter_method")
    over = {k: v for k, v in mix.items() if k != "globalization_strategy"}
    init, step = _jax_step(gs, **over)
    _, x0, p = _flagship_n(B, 8)
    s = init(jnp.asarray(np.tile(x0, (2, 1))), jnp.asarray(np.tile(p, (2, 1))))
    while bool(jnp.any(s.status == jipm.RUNNING)):
        new = step(s)
        run = s.status == jipm.RUNNING
        s = jax.tree_util.tree_map(
            lambda a, b: jnp.where(run.reshape(run.shape + (1,) * (a.ndim - 1)), b, a),
            s, new)
    tn, tx0, tp = flagship(B)
    res = uno_tpu_torch.solve_batch(tn, tx0, tp, preset="ipopt", device="cpu",
                                    **FLAGSHIP, **mix)
    assert res.status.tolist() == np.asarray(s.status)[:B].tolist()
    assert res.iterations.tolist() == np.asarray(s.iteration)[:B].tolist()
    np.testing.assert_allclose(res.x, np.asarray(s.x)[:B, :8], rtol=0, atol=X_TOL)
    assert res.num_solved == B


def test_ls_batch_candidates_batch_equals_the_sequential_batch():
    tn, tx0, tp = flagship(16)
    runs = [uno_tpu_torch.solve_batch(tn, tx0, tp, preset="ipopt", device="cpu",
                                      LS_batch_candidates=nc, **FLAGSHIP)
            for nc in (1, 4)]
    for name in ("status", "iterations", "x", "objective"):
        assert np.array_equal(getattr(runs[0], name), getattr(runs[1], name)), name


