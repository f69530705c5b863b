"""The gradient, the constraint Jacobian and a Lagrangian Hessian-vector
product of the port's registry against uno_tpu's, on the CPU, at x0
clipped into the bounds, one seeded point inside them and the points on
the kinks (torch_library_common.kink_points), to rtol 1e-12: every
fixed-size key and each family's smallest size, a third of them here (the
rest in test_torch_library_derivs_a.py, test_torch_library_derivs_b.py)."""

import pytest

from torch_library_common import check_derivatives, derivative_keys
from uno_tpu.model import library as j_lib
from uno_tpu_torch.model import library as t_lib


@pytest.mark.parametrize("name", derivative_keys(j_lib.problem_names())[2::3])
def test_derivatives_match(name):
    check_derivatives(j_lib, t_lib, name)
