"""uno_tpu_torch's AMPL .nl reader held against uno_tpu's on the CPU: the
same files through both readers (every text fixture of tests/fixtures/nl,
its binary twin, and six files of the corpus), the same models, functions
and derivatives; the postfix replay opcode by opcode; errors; ipopt solves
of read models; and the fixtures in the port's get_problem."""

import filecmp
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uno_tpu
import uno_tpu_torch
from uno_tpu.io import nl as j_nl
from uno_tpu.io import read_nl as j_read_nl
from uno_tpu_torch.io import nl as t_nl
from uno_tpu_torch.io import convert_nl_to_binary, read_nl
from uno_tpu_torch.model.library import get_problem

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "nl"
CORPUS = Path(__file__).resolve().parent / "fixtures" / "nl_corpus"
TEXT = sorted(p.name for p in FIXTURES.glob("*.nl") if not p.name.endswith(".bin.nl"))
CORPUS_FILES = ["hs014.nl", "hs015.nl", "hs021.nl", "hs071.nl", "hs100.nl", "polak5.nl"]
# f, c, the gradient, the Jacobian and the Lagrangian Hessian of the same
# program at the same point: the same float64 operations, with products and
# AD sums rounded in another order.  Entry by entry, |port - uno_tpu| <=
# EVAL_RTOL * max(|uno_tpu|, 1)
EVAL_RTOL = 1e-12
# an ipopt solve of a read model: equal status and iterations, objective
# within SOLVE_TOL * max(|uno_tpu's|, 1) (srosenbr's optimum is 0: the two
# end 1.4e-25 apart there)
SOLVE_TOL = 1e-8
META = ("n", "m", "x_lb", "x_ub", "c_lb", "c_ub", "x0", "y0")


def _path(name):
    return (CORPUS if name in CORPUS_FILES else FIXTURES) / name


def _points(nlp, seed=0):
    """x0 and three seeded points around it inside the bounds (the fixtures
    use no kink opcode: abs, min, max or less), and seeded multipliers."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(nlp.x0, dtype=float)
    X = x0 + 0.1 * (1.0 + np.abs(x0)) * rng.standard_normal((3, nlp.n))
    X = np.clip(np.vstack([x0, X]), nlp.x_lb, nlp.x_ub)
    return X, rng.standard_normal((4, nlp.m))


_REFERENCE = {}


def _reference(name):
    """uno_tpu's model of a file and its values at _points: f, c, g, J
    under one jit, the Lagrangian Hessian (sigma 1) column by column as
    jitted Hessian-vector products, which compile far faster here than
    the whole Hessian."""
    if name not in _REFERENCE:
        jn = j_read_nl(_path(name))
        X, Y = _points(jn)

        def values(x):
            return (jn.objective(x), jn.constraints(x), jn.objective_gradient(x),
                    jn.constraint_jacobian(x) if jn.m else jnp.zeros((0, jn.n)))

        f, c, g, J = (np.asarray(a) for a in jax.jit(jax.vmap(values))(jnp.asarray(X)))

        def lag(z, y):
            return jn.objective(z) - (jnp.dot(y, jn.constraints(z)) if jn.m else 0.0)

        hvp = jax.jit(lambda x, y, v: jax.jvp(lambda z: jax.grad(lag)(z, y), (x,), (v,))[1])
        eye = jnp.eye(jn.n)
        H = np.stack([np.stack([np.asarray(hvp(jnp.asarray(x), jnp.asarray(y), eye[k]))
                                for k in range(jn.n)], axis=1) for x, y in zip(X, Y)])
        _REFERENCE[name] = jn, X, Y, dict(f=f, c=c, g=g, J=J, H=H)
    return _REFERENCE[name]


def _assert_meta_equal(a, b):
    for key in META:
        np.testing.assert_array_equal(np.asarray(getattr(a, key)),
                                      np.asarray(getattr(b, key)), err_msg=key)


def _assert_values_match(tn, X, Y, ref):
    x = torch.as_tensor(X)
    got = dict(f=tn.objective(x), c=tn.constraints(x), g=tn.objective_gradient(x),
               J=tn.constraint_jacobian(x),
               H=tn.lagrangian_hessian(x, torch.as_tensor(Y),
                                       torch.ones(len(X), dtype=torch.float64)))
    for key, want in ref.items():
        have = got[key].numpy()
        assert have.shape == want.shape, key
        gap = np.abs(have - want) / np.maximum(np.abs(want), 1.0)
        assert gap.max(initial=0.0) <= EVAL_RTOL, (key, gap.max())


@pytest.mark.parametrize("name", TEXT + CORPUS_FILES)
def test_read_nl_matches_uno_tpu(name):
    jn, X, Y, ref = _reference(name)
    tn = read_nl(_path(name))
    _assert_meta_equal(tn, jn)
    assert tn.name == jn.name == Path(name).stem
    _assert_values_match(tn, X, Y, ref)


@pytest.mark.parametrize("name", TEXT)
def test_binary_twin_matches_uno_tpu(name):
    """The .bin.nl twin through both readers: uno_tpu's gives its text
    model's f and c at the points, the port's everything uno_tpu gives for
    the text."""
    jn, X, Y, ref = _reference(name)
    twin = FIXTURES / name.replace(".nl", ".bin.nl")
    jb, tb = j_read_nl(twin), read_nl(twin)
    _assert_meta_equal(jb, jn)
    _assert_meta_equal(tb, jn)
    f, c = jax.jit(jax.vmap(lambda x: (jb.objective(x), jb.constraints(x))))(jnp.asarray(X))
    for have, want in ((f, ref["f"]), (c, ref["c"])):
        gap = np.abs(np.asarray(have) - want) / np.maximum(np.abs(want), 1.0)
        assert gap.max(initial=0.0) <= EVAL_RTOL
    _assert_values_match(tb, X, Y, ref)


def test_convert_nl_to_binary_gives_the_committed_twin(tmp_path):
    out = tmp_path / "catena_n8.bin.nl"
    convert_nl_to_binary(FIXTURES / "catena_n8.nl", out)
    assert filecmp.cmp(out, FIXTURES / "catena_n8.bin.nl", shallow=False)
    with pytest.raises(ValueError):
        convert_nl_to_binary(FIXTURES / "catena_n8.bin.nl", tmp_path / "again.nl")


def test_malformed_and_missing_files_raise_value_error(tmp_path):
    bad = tmp_path / "bad.nl"
    bad.write_text("g3 1 1 0\n this is not an nl file\n")
    for path in (bad, tmp_path / "missing.nl"):
        for reader in (read_nl, j_read_nl):
            with pytest.raises(ValueError):
                reader(path)


# one program per opcode family of the replay, each over x = (x0, x1, x2):
# (ops, nums) in the parser's token form (-1 constant, -2 variable)
V0, V1, V2 = (-2, 0.0), (-2, 1.0), (-2, 2.0)
PROGRAMS = {
    **{f"unary_{op}": [V0, (op, 0.0)] for op in (13, 14, 16, 37, 38, 40, 41, 44,
                                                  45, 46, 49, 50, 77)},
    "sqrt_log_log10": [V2, (39, 0.0), V2, (43, 0.0), (0, 0.0), V2, (42, 0.0), (2, 0.0)],
    "abs": [V1, (15, 0.0)],
    "atanh_asin_acos": [V0, (47, 0.0), V0, (51, 0.0), (0, 0.0), V0, (53, 0.0), (2, 0.0)],
    "acosh": [V2, (52, 0.0)],
    **{f"binary_{op}": [V1, V2, (op, 0.0)] for op in (0, 1, 2, 3, 4, 48, 55)},
    "pow_integer": [V1, (-1, 4.0), (5, 0.0)],
    "pow_negative_integer": [V2, (-1, -3.0), (5, 0.0)],
    "pow_real": [V2, (-1, 1.5), (5, 0.0)],
    "pow_variable": [V2, V0, (5, 0.0)],
    "pow_constants": [(-1, 2.0), (-1, 3.0), (5, 0.0), V0, (2, 0.0)],
    "less": [V1, V0, (6, 0.0)],
    "minlist": [V0, V1, V2, (11, 3.0)],
    "maxlist": [V0, V1, V2, (12, 3.0)],
    "sumlist": [V0, V1, V2, (-1, 2.5), (54, 4.0)],
    "if_then_else": [V0, V1, (22, 0.0), V2, (-1, 3.0), (35, 0.0)],
    "if_logical": [V0, (-1, 0.0), (29, 0.0), V1, (-1, 0.0), (23, 0.0), (20, 0.0),
                   (34, 0.0), V1, V2, (2, 0.0), V0, (35, 0.0)],
    "constant": [(-1, 2.0), (-1, 3.0), (2, 0.0), (16, 0.0)],
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_postfix_replay_matches_uno_tpu(name):
    """Each opcode family replayed by both packages: the value and the
    gradient at seeded points away from kinks, within EVAL_RTOL."""
    prog = PROGRAMS[name]
    ops = np.array([op for op, _ in prog], dtype=np.int32)
    nums = np.array([v for _, v in prog])
    X = np.random.default_rng(3).uniform([-0.9, -0.8, 1.2], [0.9, 0.8, 2.5], (3, 3))
    for x in X:
        want = jax.value_and_grad(
            lambda z: jnp.asarray(j_nl._eval_postfix(ops, nums, z, {}), dtype=z.dtype))(
                jnp.asarray(x))

        def value(z):
            return t_nl._t(t_nl._eval_postfix(prog, z, {}), z)

        xt = torch.tensor(x, requires_grad=True)
        v = value(xt)
        g = torch.autograd.grad(v, xt)[0] if v.requires_grad else torch.zeros_like(xt)
        for have, ref in ((v.detach().numpy(), want[0]), (g.numpy(), want[1])):
            ref = np.asarray(ref)
            gap = np.abs(have - ref) / np.maximum(np.abs(ref), 1.0)
            assert gap.max(initial=0.0) <= EVAL_RTOL, (name, x, have, ref)


@pytest.mark.parametrize("name", ["hs015.nl", "hs071.nl", "polak5.nl", "catena_n8.nl",
                                  "srosenbr_n10.nl", "lukvle1_n10.nl"])
def test_ipopt_solve_of_a_read_model_matches(name):
    ref = uno_tpu.solve(j_read_nl(_path(name)), preset="ipopt")
    res = uno_tpu_torch.solve(read_nl(_path(name)), preset="ipopt", device="cpu")
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert res.objective == pytest.approx(ref.objective, rel=SOLVE_TOL, abs=SOLVE_TOL)
    assert res.status == "optimal"


def test_get_problem_has_every_text_fixture():
    names = [f"nl_{name[:-3]}" for name in TEXT]
    nlp = get_problem("nl_catena_n8")
    assert (nlp.name, nlp.n, nlp.m) == ("nl_catena_n8", 8, 5)
    with pytest.raises(KeyError) as err:
        get_problem("nl_no_such_model")
    assert all(name in str(err.value) for name in names)
    assert "nl_catena_n8.bin" not in str(err.value)
