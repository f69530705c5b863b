"""The witnesses for chip_smoke.py's REGISTRY_PARTS, the registry keys
whose runs may part from uno_tpu's recorded ones: on the CPU, uno_tpu's
own ipopt run parts from itself when x0 moves by one ulp (np.nextafter
toward +inf), its x leaving the unmoved run's by more than 1e-8, as the
port's does; hs009, whose x0 is 0, moved by 1e-16; and hs061's
least-squares system, exactly singular at x0, whose last pivot XLA's fused
multiply-add makes -8.9e-16 where the port, and the formula evaluated a
rounding at a time, make 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import uno_tpu
import uno_tpu_torch
from uno_tpu.linalg.ldlt import ldlt_factor_unrolled as j_unrolled
from uno_tpu.model import library as j_lib
from uno_tpu_torch.linalg.ldlt import ldlt_factor_unrolled as t_unrolled
from uno_tpu_torch.model import library as t_lib

ROUNDING = ("biggs6", "genhumps_n10", "genhumps_n30", "hs050", "meyer",
            "noncvxun_n10", "penalty2_n10", "powell_bs")


def _xs(res, n):
    return [np.asarray(s.x)[:n] for s in res.history]


def test_the_table_has_these_witnesses():
    assert sorted(chip_smoke.REGISTRY_PARTS) == sorted(ROUNDING + ("hs009", "hs061"))


@pytest.mark.parametrize("name", ROUNDING)
def test_uno_tpu_parts_from_itself(name):
    nlp = j_lib.get_problem(name)
    kw = dict(preset="ipopt", max_iterations=2000, history=True)
    ref = uno_tpu.solve(nlp, **kw)
    moved = uno_tpu.solve(dataclasses.replace(nlp, x0=np.nextafter(nlp.x0, np.inf)), **kw)
    gaps = [float(np.max(np.abs(a - b)))
            for a, b in zip(_xs(ref, nlp.n), _xs(moved, nlp.n))]
    assert max(gaps) > 1e-8, gaps


def test_hs009_ends_where_the_port_does_from_a_moved_x0():
    nlp = j_lib.get_problem("hs009")
    ref = uno_tpu.solve(nlp, preset="ipopt")
    moved = uno_tpu.solve(dataclasses.replace(nlp, x0=np.array([1e-16, 0.0])),
                          preset="ipopt")
    port = uno_tpu_torch.solve(t_lib.get_problem("hs009"), preset="ipopt", device="cpu")
    assert (ref.status, ref.iterations) == ("almost_optimal", 17)
    assert (moved.status, moved.iterations) == (port.status, port.iterations) \
        == ("optimal", 4)


def test_hs061_least_squares_pivot():
    """[I J^T; J 0] at x0 = 0, J = [[3, 0, 0], [4, 0, 0]] of rank 1: the
    last pivot -16 + 9 (4/3)^2 is 0 with each product rounded, as the
    port's plain version and numpy compute it; XLA fuses the update into
    one multiply-add and keeps -8.9e-16, so uno_tpu counts no zero pivot
    and keeps the multipliers (0, -8.25), which the port rejects for 0."""
    J = np.array([[3.0, 0.0, 0.0], [4.0, 0.0, 0.0]])
    K = np.block([[np.eye(3), J.T], [J, np.zeros((2, 2))]])
    jf = jax.jit(j_unrolled)(jnp.asarray(K))
    tf = t_unrolled(torch.as_tensor(K)[None])
    l = 4.0 / 3.0
    assert -16.0 - (-9.0) * (l * l) == 0.0
    assert -1e-15 < float(jf.d[-1]) < 0.0 and int(jf.num_zero) == 0
    assert (float(tf.d[0, -1]), int(tf.num_zero[0])) == (0.0, 1)
    ref = uno_tpu.solve(j_lib.get_problem("hs061"), preset="ipopt", history=True)
    port = uno_tpu_torch.solve(t_lib.get_problem("hs061"), preset="ipopt",
                               device="cpu", history=True)
    np.testing.assert_array_equal(np.asarray(ref.history[0].y), [0.0, -8.25])
    assert not port.history[0].y.any()
    assert (ref.status, ref.iterations, port.status, port.iterations) \
        == ("optimal", 18, "optimal", 9)
