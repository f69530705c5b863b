"""uno_tpu_torch's options, model derivatives and reformulations held
against uno_tpu on the CPU, with inputs made from a seed with numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu.options as jopts
import uno_tpu_torch.options as topts
from bench import _flagship_n
from uno_tpu.model import transforms as jtf
from uno_tpu.model.library import get_problem
from uno_tpu.model.nlp import INF, nlp_from_functions as j_nlp
from uno_tpu_torch.model import transforms as ttf
from uno_tpu_torch.model.library import flagship, hs015
from uno_tpu_torch.model.nlp import nlp_from_functions as t_nlp

# derivatives are exact AD in float64 in both packages; only the order of
# a few roundings may differ
DERIV_RTOL = 1e-12


@pytest.mark.parametrize("name", jopts.available_presets())
def test_presets_equal_field_for_field(name):
    a = dataclasses.asdict(jopts.preset(name))
    b = dataclasses.asdict(topts.preset(name))
    assert a == b
    assert topts.available_presets() == jopts.available_presets()


def _pair(name):
    """(uno_tpu NLP, uno_tpu_torch NLP, params or None)."""
    if name == "hs015":
        return get_problem("hs015"), hs015(), None
    jnlp, _, jp = _flagship_n(4, 8)
    tnlp, _, tp = flagship(4)
    np.testing.assert_array_equal(jp, tp)
    return jnlp, tnlp, tp[1]


def _points(nlp, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, nlp.n)
    y = rng.standard_normal(nlp.m)
    v = rng.standard_normal(nlp.n)
    return x, y, v


@pytest.mark.parametrize("name", ["flagship", "hs015"])
@pytest.mark.parametrize("what", ["gradient", "jacobian", "hessian", "hvp"])
def test_derivatives_match(name, what):
    jnlp, tnlp, p = _pair(name)
    tp = None if p is None else torch.as_tensor(p)[None]
    jp = None if p is None else jnp.asarray(p)
    x, y, v = _points(jnlp, 0)
    tx, ty, tv = (torch.as_tensor(a)[None] for a in (x, y, v))
    sigma = 0.7
    ts = torch.tensor([sigma], dtype=torch.float64)
    if what == "gradient":
        ref = jnlp.objective_gradient(jnp.asarray(x), jp)
        got = tnlp.objective_gradient(tx, tp)
    elif what == "jacobian":
        ref = jnlp.constraint_jacobian(jnp.asarray(x), jp)
        got = tnlp.constraint_jacobian(tx, tp)
    elif what == "hessian":
        ref = jnlp.lagrangian_hessian(jnp.asarray(x), jnp.asarray(y), sigma, jp)
        got = tnlp.lagrangian_hessian(tx, ty, ts, tp)
    else:
        ref = jnlp.lagrangian_hessian_vp(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(v), sigma, jp)
        got = tnlp.lagrangian_hessian_vp(tx, ty, tv, ts, tp)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref),
                               rtol=DERIV_RTOL, atol=DERIV_RTOL)


def _fixed_and_equality_pair():
    """A model with an equality, an inequality and a fixed variable, so that
    every step of reformulate_for_interior_point acts."""
    def jf(x):
        return jnp.sum(x * x) + x[0] * x[2]

    def jc(x):
        return jnp.array([x[0] + x[1], x[1] * x[2], x[0] - x[2] ** 2])

    def tf(x):
        return torch.sum(x * x) + x[0] * x[2]

    def tc(x):
        return torch.stack([x[0] + x[1], x[1] * x[2], x[0] - x[2] ** 2])

    kw = dict(x0=[0.3, 0.2, 1.0], x_lb=[-INF, 0.0, 1.0], x_ub=[2.0, INF, 1.0],
              c_lb=[1.0, 0.5, -INF], c_ub=[1.0, INF, 3.0])
    return j_nlp("fixed_eq", jf, jc, **kw), t_nlp("fixed_eq", tf, tc, **kw), None


@pytest.mark.parametrize("name", ["flagship", "hs015", "fixed_eq"])
def test_reformulate_for_interior_point_matches(name):
    jnlp, tnlp, p = _fixed_and_equality_pair() if name == "fixed_eq" else _pair(name)
    jr = jtf.reformulate_for_interior_point(jtf.scale_model(jnlp), 1e-8)
    tr = ttf.reformulate_for_interior_point(ttf.scale_model(tnlp), 1e-8)
    assert (tr.n, tr.m, tr.num_original_variables) == \
        (jr.n, jr.m, jr.num_original_variables)
    for field in ("x_lb", "x_ub", "c_lb", "c_ub", "x0", "slack_of_constraint",
                  "c_scale"):
        np.testing.assert_allclose(getattr(tr, field), getattr(jr, field),
                                   rtol=DERIV_RTOL, err_msg=field)
    assert tr.f_scale == pytest.approx(jr.f_scale, rel=DERIV_RTOL)
    # the reformulated functions agree at a seeded point
    x = np.random.default_rng(7).uniform(0.1, 1.5, jr.n)
    jp = None if p is None else jnp.asarray(p)
    tp = None if p is None else torch.as_tensor(p)[None]
    tx = torch.as_tensor(x)[None]
    np.testing.assert_allclose(tr.constraints(tx, tp)[0].numpy(),
                               np.asarray(jr.constraints(jnp.asarray(x), jp)),
                               rtol=DERIV_RTOL, atol=DERIV_RTOL)
    np.testing.assert_allclose(tr.constraint_jacobian(tx, tp)[0].numpy(),
                               np.asarray(jr.constraint_jacobian(jnp.asarray(x), jp)),
                               rtol=DERIV_RTOL, atol=DERIV_RTOL)
    np.testing.assert_allclose(float(tr.objective(tx, tp)[0]),
                               float(jr.objective(jnp.asarray(x), jp)),
                               rtol=DERIV_RTOL)


def test_nlp_from_functions_validates():
    with pytest.raises(ValueError):
        t_nlp("bad", lambda x: torch.sum(x), None, x0=[np.nan, 1.0])
    with pytest.raises(ValueError):
        t_nlp("bad", lambda x: torch.sum(x), None, x0=[0.0, 1.0], x_lb=[0.0])
    unc = t_nlp("unc", lambda x: torch.sum(x * x), None, x0=[1.0, 2.0])
    assert unc.m == 0
    assert unc.constraints(torch.ones(3, 2, dtype=torch.float64)).shape == (3, 0)
