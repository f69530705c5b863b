"""The port's problem registry against uno_tpu's, key by key, on the CPU:
the same keys and families; for every key the same optimum, acceptable
optima, self-certification, name, sizes, x0, bounds and structure
declaration; and every key's f and c evaluated with x on the meta device,
which fails on a constant that is not made on x's device."""

import numpy as np
import pytest
import torch

from torch_library_common import same_structure
from uno_tpu.model import library as j_lib
from uno_tpu.model import library_cutest as j_cutest
from uno_tpu_torch.model import library as t_lib
from uno_tpu_torch.model import library_cutest as t_cutest

NAMES = j_lib.problem_names()


def test_problem_names_match():
    assert len(NAMES) == 450
    assert t_lib.problem_names() == NAMES


def test_family_names_match():
    assert t_cutest.family_names() == j_cutest.family_names()


def test_unknown_key_raises():
    with pytest.raises(KeyError, match="not in the registry of 450"):
        t_lib.get_problem("hs999")


@pytest.mark.parametrize("name", NAMES)
def test_key_matches(name):
    for what in ("known_optimum", "acceptable_optima", "is_self_certified"):
        assert getattr(t_lib, what)(name) == getattr(j_lib, what)(name), what
    jn, tn = j_lib.get_problem(name), t_lib.get_problem(name)
    assert (tn.name, tn.n, tn.m) == (jn.name, jn.n, jn.m)
    for what in ("x0", "x_lb", "x_ub", "c_lb", "c_ub"):
        np.testing.assert_array_equal(getattr(tn, what), np.asarray(getattr(jn, what)),
                                      err_msg=what)
    assert same_structure(tn.structure, jn.structure)


@pytest.mark.parametrize("name", NAMES)
def test_meta_device(name):
    """f and c of one instance, with x on the meta device, come back on it
    with their shapes (no op of the registry lacks a meta kernel)."""
    nlp = t_lib.get_problem(name)
    x = torch.empty(nlp.n, dtype=torch.float64, device="meta")
    f = nlp.f(x, None)
    assert (f.device.type, tuple(f.shape)) == ("meta", ())
    if nlp.m:
        c = nlp.c(x, None)
        assert (c.device.type, tuple(c.shape)) == ("meta", (nlp.m,))
