"""Carry a solver state between uno_tpu and the port as numpy arrays.

`state_to_numpy` gives a dict keyed by the state's field names, the same
names as uno_tpu's IPMState, SQPFState and ByrdFState; "filter" holds the
(h, phi, ub) triple and "params" an array or None.  `state_from_numpy`
takes such a dict, with the batch as the leading axis of every array (a
single uno_tpu state gets one with `arr[None]`), and the state class
(IPMState, the default, sqp_fused.SQPFState or sqp_fused.ByrdFState), so
that a test can start both packages from the same iterate.

`sqp_iterate_from` takes an iterate of uno_tpu's host SQP driver (any
object with the fields of solvers/sqp.SQPIterate, its progress included)
and gives the port's, every array a float64 copy."""

from __future__ import annotations

import numpy as np
import torch

from uno_tpu_torch.ingredients.filters import FilterState
from uno_tpu_torch.solvers.ipm import IPMState
from uno_tpu_torch.solvers.sqp import Progress, SQPIterate


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    else:
        dtype = torch.float64
    return torch.as_tensor(a, dtype=dtype, device=device)


def state_from_numpy(fields: dict, device, cls=IPMState):
    values = {}
    for name in cls._fields:
        v = fields[name]
        if name == "filter":
            values[name] = FilterState(*(_tensor(a, device) for a in v))
        elif name == "params" and v is None:
            values[name] = None
        else:
            values[name] = _tensor(v, device)
    return cls(**values)


def state_to_numpy(state) -> dict:
    out = {}
    for name, v in zip(type(state)._fields, state):
        if name == "filter":
            out[name] = tuple(t.cpu().numpy() for t in v)
        elif v is None:
            out[name] = None
        else:
            out[name] = v.cpu().numpy()
    return out


def sqp_iterate_from(it) -> SQPIterate:
    def arr(v):
        return None if v is None else np.array(v, dtype=np.float64)

    values = {name: arr(getattr(it, name)) for name in
              ("x", "ev", "y", "zl", "zu", "y_f", "zl_f", "zu_f", "zl_el",
               "c", "g", "J")}
    pr = it.progress
    progress = None if pr is None else Progress(
        float(pr.infeasibility), float(pr.objective), float(pr.auxiliary))
    return SQPIterate(f=float(it.f), progress=progress, **values)
