"""Wall-clock time limit (reference Timer / time_limit, Uno.cpp:61-78).

The port's outer loop runs on the host, so the limit is a host check after
every outer iteration (solvers/ipm.run_ipm)."""

from __future__ import annotations

import math
import time


def over_time_limit(t0: float, time_limit: float) -> bool:
    """True once more than `time_limit` seconds have passed since `t0`
    (a time.monotonic() reading); never for an infinite limit."""
    return math.isfinite(time_limit) and time.monotonic() - t0 > time_limit
