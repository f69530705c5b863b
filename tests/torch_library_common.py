"""Helpers shared by the tests/test_torch_library*.py files, which hold the
port's problem registry against uno_tpu's on the CPU: the points each key
is evaluated at and the comparison, at rtol 1e-12 and atol
1e-12 * max(1, |value|)."""

import numpy as np

# the same formulas evaluated by two AD systems, sums in another order
RTOL = 1e-12


def same_structure(a, b):
    """Equal NLPStructure declarations (or both None)."""
    if a is None or b is None:
        return a is None and b is None
    return (a.hess_bandwidth == b.hess_bandwidth and a.jac_width == b.jac_width
            and a.jac_col_limit == b.jac_col_limit
            and ((a.jac_starts is None and b.jac_starts is None)
                 or np.array_equal(a.jac_starts, b.jac_starts)))


def points(nlp, seed=0):
    """x0 clipped into the bounds, and one point drawn from a seeded
    numpy generator inside the bounds, within 1 of that x0."""
    lb, ub = np.asarray(nlp.x_lb), np.asarray(nlp.x_ub)
    x0 = np.clip(np.asarray(nlp.x0, dtype=np.float64), lb, ub)
    lo = np.minimum(np.maximum(lb, x0 - 1.0), x0)
    hi = np.maximum(np.minimum(ub, x0 + 1.0), x0)
    rng = np.random.default_rng(seed)
    return [x0, lo + rng.uniform(0.1, 0.9, nlp.n) * (hi - lo)]


def assert_close(got, want, what=""):
    """Equal shapes; every entry equal, both NaN, or within RTOL of
    max(1, |want|)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    with np.errstate(invalid="ignore"):         # inf - inf where both are
        ok = ((np.isnan(got) & np.isnan(want)) | (got == want)
              | (np.abs(got - want) <= RTOL * np.maximum(1.0, np.abs(want))))
    if not ok.all():
        k = int(np.argmax(~ok.ravel()))
        raise AssertionError(f"{what}: entry {k}: {got.ravel()[k]!r} vs "
                             f"uno_tpu {want.ravel()[k]!r}")


def check_values(j_lib, t_lib, name):
    """f and c of `name` in both packages at points(), raw nlp.f(x, None)
    and nlp.c(x, None) of one instance (uno_tpu's jitted and mapped over
    the points, one compilation a key)."""
    import jax
    import jax.numpy as jnp
    import torch
    jn, tn = j_lib.get_problem(name), t_lib.get_problem(name)

    @jax.jit
    @jax.vmap
    def j_values(x):
        return [jn.f(x, None)] + ([jn.c(x, None)] if jn.m else [])

    X = np.stack(points(jn))
    ref = j_values(jnp.asarray(X))
    for k, x in enumerate(X):
        xt = torch.as_tensor(x)
        assert_close(tn.f(xt, None).numpy(), np.asarray(ref[0][k]), f"f at point {k}")
        if jn.m:
            assert_close(tn.c(xt, None).numpy(), np.asarray(ref[1][k]), f"c at point {k}")


def derivative_keys(names):
    """Every fixed-size key and the smallest size of each family: keys
    "<prefix>_n<N>" grouped by prefix, the least N of each group."""
    import re
    fixed, smallest = [], {}
    for name in names:
        m = re.match(r"(.+)_n(\d+)$", name)
        if m is None:
            fixed.append(name)
        elif m.group(1) not in smallest or int(m.group(2)) < smallest[m.group(1)][0]:
            smallest[m.group(1)] = (int(m.group(2)), name)
    return sorted(fixed + [name for _, name in smallest.values()])


def kink_points(name, n):
    """Points on the kinks of the formulas where the two AD systems could
    part: gulf's maximum(x1, 1e-12) at its tie and |y_i - x2| at 0 (a base
    0 under the power x3), chebyquad's clip on and beyond its bounds, and
    brownal's product with one and with two zero factors."""
    if name == "gulf":
        from uno_tpu_torch.model.library_mgh import _GULF_Y
        return [np.array([1e-12, _GULF_Y[3], 0.15]), np.array([1e-12, 30.0, 2.0])]
    if name.startswith("chebyquad"):
        x = np.linspace(0.0, 1.0, n)
        x[1], x[-2] = -0.25, 1.5
        return [x]
    if name.startswith("brownal"):
        one, two = np.full(n, 0.5), np.full(n, 0.5)
        one[2] = 0.0
        two[[1, 4]] = 0.0
        return [one, two]
    return []


def check_derivatives(j_lib, t_lib, name, seed=1):
    """The gradient, the constraint Jacobian and a Lagrangian Hessian-vector
    product of `name` in both packages (uno_tpu's through jax.grad,
    jax.jacfwd and jax.jvp of the raw nlp.f and nlp.c, jitted) at points()
    and kink_points()."""
    import jax
    import jax.numpy as jnp
    import torch
    jn, tn = j_lib.get_problem(name), t_lib.get_problem(name)
    rng = np.random.default_rng(seed)
    y, v = rng.standard_normal(jn.m), rng.standard_normal(jn.n)

    def lag(z):
        val = jn.f(z, None)
        if jn.m:
            val = val - jnp.dot(jnp.asarray(y), jn.c(z, None))
        return val

    @jax.jit
    def j_all(x):
        out = [jax.grad(lambda z: jn.f(z, None))(x)]
        if jn.m:
            out.append(jax.jacfwd(lambda z: jn.c(z, None))(x))
        out.append(jax.jvp(jax.grad(lag), (x,), (jnp.asarray(v),))[1])
        return out

    one = torch.ones(1, dtype=torch.float64)
    for k, x in enumerate(points(jn) + kink_points(name, jn.n)):
        xt = torch.as_tensor(x)[None]
        ref = j_all(jnp.asarray(x))
        got = [tn.objective_gradient(xt)[0]]
        if jn.m:
            got.append(tn.constraint_jacobian(xt)[0])
        got.append(tn.lagrangian_hessian_vp(xt, torch.as_tensor(y)[None],
                                            torch.as_tensor(v)[None], one)[0])
        for what, g, r in zip(("grad f", "J", "Hv") if jn.m else ("grad f", "Hv"),
                              got, ref):
            assert_close(g.numpy(), np.asarray(r), f"{what} at point {k}")


def check_solve(name, preset):
    """`name` solved under `preset` by both packages: equal status and
    iterations, the objective within 1e-8 relative, x within 1e-6."""
    import uno_tpu
    import uno_tpu_torch
    from uno_tpu.model import library as j_lib
    from uno_tpu_torch.model import library as t_lib
    ref = uno_tpu.solve(j_lib.get_problem(name), preset=preset)
    res = uno_tpu_torch.solve(t_lib.get_problem(name), preset=preset, device="cpu")
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert abs(res.objective - ref.objective) <= 1e-8 * max(1.0, abs(ref.objective))
    np.testing.assert_allclose(res.x, np.asarray(ref.x), rtol=0, atol=1e-6)
    return res
