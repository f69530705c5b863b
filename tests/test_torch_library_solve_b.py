"""Registry problems solved by both packages on the CPU (half of the pairs;
the rest in test_torch_library_solve_a.py): equal status and iterations,
the objective within 1e-8 relative, x within 1e-6.  dtoc1_n11 declares its
structure and takes the banded KKT backend."""

import pytest

from torch_library_common import check_solve


@pytest.mark.parametrize("name,preset", [
    ("exthimmelblau_n10", "byrd"), ("polygon_k6", "ipopt"),
    ("dtoc1_n11", "ipopt"), ("sphere_proj_n10", "ipopt"), ("hs059", "ipopt"),
    ("welded_beam", "ipopt")])
def test_solve_matches(name, preset):
    check_solve(name, preset)
