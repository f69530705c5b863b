"""The witnesses for chip_smoke.py's REGISTRY_PARTS, the registry keys
whose runs may part from uno_tpu's recorded ones: on the CPU, uno_tpu's
own ipopt run parts from itself when x0 moves by one ulp (np.nextafter
toward +inf), its x leaving the unmoved run's by more than 1e-8, as the
port's does; hs009, whose x0 is 0, moved by 1e-16.  hs061, which parted
while the port rounded the product of each LDL^T update before its
subtraction, is here as the witness that it no longer does: its
least-squares system, exactly singular at x0, keeps the last pivot
-8.9e-16 under the fused multiply-add in both packages."""

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
    assert sorted(chip_smoke.REGISTRY_PARTS) == sorted(ROUNDING + ("hs009",))
    assert sorted(chip_smoke.REGISTRY_VERDICT_PARTS) == ["meyer"]


def test_meyer_verdict_parts_by_rounding():
    """meyer's status is rounding's choice in uno_tpu itself: from x0 it
    ends algorithmic_error in 197 iterations, from x0 with x0[1] moved up
    by one ulp optimal in 194, at the same objective within 1e-11."""
    nlp = j_lib.get_problem("meyer")
    x0 = np.asarray(nlp.x0, dtype=np.float64).copy()
    ref = uno_tpu.solve(nlp, preset="ipopt", max_iterations=2000)
    x0[1] = np.nextafter(x0[1], np.inf)
    moved = uno_tpu.solve(dataclasses.replace(nlp, x0=x0), preset="ipopt",
                          max_iterations=2000)
    assert (ref.status, ref.iterations) == ("algorithmic_error", 197)
    assert (moved.status, moved.iterations) == ("optimal", 194)
    assert abs(moved.objective - ref.objective) <= 1e-11 * abs(ref.objective)


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
    last pivot -16 + 9 (4/3)^2 is 0 with each product rounded, as numpy
    computes it; XLA fuses the update into one multiply-add and keeps
    -8.9e-16, and so does the port's plain version (torch.addcmul), so both
    count no zero pivot, both solves' fused dot chains give the multipliers
    (0, -8.25), and both runs end optimal in 18 iterations."""
    J = np.array([[3.0, 0.0, 0.0], [4.0, 0.0, 0.0]])
    K = np.block([[np.eye(3), J.T], [J, np.zeros((2, 2))]])
    jf = jax.jit(j_unrolled)(jnp.asarray(K))
    tf = t_unrolled(torch.as_tensor(K)[None])
    l = 4.0 / 3.0
    assert -16.0 - (-9.0) * (l * l) == 0.0
    assert float(jf.d[-1]) == float(tf.d[0, -1]) == -8.881784197001252e-16
    assert int(jf.num_zero) == int(tf.num_zero[0]) == 0
    ref = uno_tpu.solve(j_lib.get_problem("hs061"), preset="ipopt", history=True)
    port = uno_tpu_torch.solve(t_lib.get_problem("hs061"), preset="ipopt",
                               device="cpu", history=True)
    np.testing.assert_array_equal(np.asarray(ref.history[0].y), [0.0, -8.25])
    np.testing.assert_array_equal(port.history[0].y[0].numpy(), [0.0, -8.25])
    assert (ref.status, ref.iterations, port.status, port.iterations) \
        == ("optimal", 18, "optimal", 18)
    assert abs(port.objective - ref.objective) <= 1e-8 * abs(ref.objective)
