"""User callbacks (reference tools/UserCallbacks.hpp:13-31): three notify
hooks invoked with accepted iterates.

The port's outer loop runs on the host, so `solve(..., callbacks=...)`
calls the hooks after every outer iteration."""

from __future__ import annotations

import numpy as np


class UserCallbacks:
    def notify_acceptable_iterate(self, primals, multipliers, objective_multiplier):
        ...

    def notify_new_primals(self, primals):
        ...

    def notify_new_multipliers(self, multipliers):
        ...


class NoUserCallbacks(UserCallbacks):
    pass


class RecordingCallbacks(UserCallbacks):
    """Records every accepted iterate (handy for tests/plotting)."""

    def __init__(self):
        self.primals: list[np.ndarray] = []
        self.multipliers: list[np.ndarray] = []

    def notify_acceptable_iterate(self, primals, multipliers, objective_multiplier):
        self.primals.append(np.asarray(primals).copy())
        self.multipliers.append(np.asarray(multipliers).copy())
