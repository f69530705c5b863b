"""uno_tpu's result on chip_smoke.py's `structured` phase problem, for the
phase to hold the port against: uno_tpu.solvers.structured.solve_structured_ipm
on the two-stage family of tests/test_structured.py (make_two_stage, seed 0)
at S scenarios, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/structured_reference.py [S]

Prints the status, iterations, objective, x0, and the sum and the sum of
squares of xs, as chip_smoke.py's STRUCTURED_REF records them.
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

from test_structured import make_two_stage  # noqa: E402
from uno_tpu.solvers.structured import solve_structured_ipm  # noqa: E402


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    res = solve_structured_ipm(make_two_stage(S=S, seed=0), tol=1e-8)
    print(json.dumps({"S": S, "status": res.status, "iterations": res.iterations,
                      "objective": res.objective, "x0": res.x0.tolist(),
                      "xs_sum": float(np.sum(res.xs)),
                      "xs_sumsq": float(np.sum(res.xs ** 2)),
                      "kkt_error": res.kkt_error}))


if __name__ == "__main__":
    main()
