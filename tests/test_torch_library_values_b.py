"""f and c of the port's registry against uno_tpu's, on the CPU: every
other key (the second of each pair in problem_names() order; the rest are in
test_torch_library_values_a.py), at x0 clipped into the bounds and at one
seeded point inside them, to rtol 1e-12."""

import pytest

from torch_library_common import check_values
from uno_tpu.model import library as j_lib
from uno_tpu_torch.model import library as t_lib


@pytest.mark.parametrize("name", j_lib.problem_names()[1::2])
def test_values_match(name):
    check_values(j_lib, t_lib, name)
