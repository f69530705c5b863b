"""Registry problems solved by both packages on the CPU (half of the pairs;
the rest in test_torch_library_solve_b.py): equal status and iterations,
the objective within 1e-8 relative, x within 1e-6."""

import pytest

from torch_library_common import check_solve


@pytest.mark.parametrize("name,preset", [
    ("hs076", "ipopt"), ("hs113", "byrd"), ("maratos", "filtersqp"),
    ("bt1", "ipopt"), ("beale", "ipopt"), ("dixon3dq_n10", "funnelsqp")])
def test_solve_matches(name, preset):
    check_solve(name, preset)
