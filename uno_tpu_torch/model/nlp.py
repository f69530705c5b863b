"""NLP model with exact derivatives through torch.func.

Counterpart of uno_tpu/model/nlp.py.  The user gives `f(x, params)` and
`c(x, params)` as torch functions of ONE instance; the gradient, the
Jacobian, the Lagrangian Hessian and its vector product come from
torch.func (grad / jacfwd / hessian / jvp, vjp) in float64.

Every evaluation method is batched: `x` is (B, n) and `params` is None or a
tensor whose leading axis is the batch, and the per-instance function is
mapped with torch.func.vmap.  A single instance is the batch of one.

A model may declare its sparsity (`NLPStructure`: a banded Lagrangian
Hessian and windowed Jacobian rows); the structured KKT backends
(linalg/banded_kkt.py) then extract the band with 2b+1 Hessian-vector
probes and the windows with w Jacobian-vector probes instead of the dense
matrices.

Sign convention (reference AMPLModel.cpp:38-40):
    L(x, y, z) = sigma * f(x) - y^T c(x) - zL^T (x - xL) - zU^T (x - xU)
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jvp, vjp, vmap

INF = np.inf
# |bound| at or above this value is "infinite" (ASL convention of 1e20)
DEFAULT_BOUND_INFINITY = 1e20


def const(cache: dict, arr, like, dtype=None, name: str = ""):
    """`arr` as a tensor on like's device, of like's dtype unless `dtype` is
    given, made once per (name, device, dtype) and kept in `cache`: a
    host-to-device copy on every evaluation would stall the device queue.
    Arrays that share a cache need distinct names."""
    dtype = like.dtype if dtype is None else dtype
    key = (name, like.device, dtype)
    t = cache.get(key)
    if t is None:
        # made outside torch.func's transforms: a tensor made inside a
        # grad or jvp level is wrapped at that level and cannot be cached
        with torch._C._DisableFuncTorch():
            t = cache[key] = torch.as_tensor(np.asarray(arr), dtype=dtype,
                                             device=like.device)
    return t


@dataclass(frozen=True)
class NLPStructure:
    """Static sparsity declared on the model (uno_tpu/model/nlp.py:35-57).

    hess_bandwidth: half-bandwidth b of the Lagrangian Hessian (entries
        (i, j) with |i-j| > b are zero for every (x, y)).
    jac_starts: (m,) first column constraint row i may touch; its nonzeros
        lie in [jac_starts[i], jac_starts[i] + jac_width).
    jac_width: the uniform window width (0 when m == 0).
    jac_col_limit: columns at or beyond it are not probed by the windowed
        extraction (homogenize sets it to exclude the slack columns); None
        probes all."""
    hess_bandwidth: int
    jac_starts: Optional[np.ndarray] = None
    jac_width: int = 0
    jac_col_limit: Optional[int] = None


def _batched(fn, x, *rest, params=None):
    """vmap fn(x_i, *rest_i, params_i) over the leading axis of x, rest and
    params (params may be None: then it is passed through unmapped)."""
    in_dims = (0,) * (1 + len(rest)) + (None if params is None else 0,)
    return vmap(fn, in_dims=in_dims)(x, *rest, params)


@dataclass(frozen=True)
class NLP:
    """A smooth NLP:  min f(x)  s.t.  c_lb <= c(x) <= c_ub,  x_lb <= x <= x_ub.

    `f` and `c` take one instance (x of shape (n,), params); m == 0 is
    allowed (c returns a (0,) tensor)."""

    name: str
    n: int
    m: int
    f: Callable[[torch.Tensor, Any], torch.Tensor]
    c: Callable[[torch.Tensor, Any], torch.Tensor]
    x_lb: np.ndarray
    x_ub: np.ndarray
    c_lb: np.ndarray
    c_ub: np.ndarray
    x0: np.ndarray
    y0: Optional[np.ndarray] = None
    params: Any = None
    # number of "original" variables (before slack augmentation)
    n_orig: Optional[int] = None
    # index into x of the slack of each constraint, -1 if none
    slack_of_constraint: Optional[np.ndarray] = None
    # objective/constraint scaling factors applied by the scale transform
    f_scale: float = 1.0
    c_scale: Optional[np.ndarray] = None
    # declared sparsity (banded Hessian / windowed Jacobian), None = dense;
    # carried through the model transforms
    structure: Optional[NLPStructure] = None
    _consts: dict = field(default_factory=dict, init=False, compare=False,
                          repr=False)

    # ------------------------------------------------------------------ masks
    @property
    def num_original_variables(self) -> int:
        return self.n if self.n_orig is None else self.n_orig

    @property
    def has_x_lb(self) -> np.ndarray:
        return np.isfinite(self.x_lb) & (self.x_lb > -DEFAULT_BOUND_INFINITY)

    @property
    def has_x_ub(self) -> np.ndarray:
        return np.isfinite(self.x_ub) & (self.x_ub < DEFAULT_BOUND_INFINITY)

    @property
    def fixed_variables(self) -> np.ndarray:
        return np.asarray(self.x_lb == self.x_ub) & self.has_x_lb

    @property
    def is_equality(self) -> np.ndarray:
        """Mask of equality constraints (c_lb == c_ub)."""
        if self.m == 0:
            return np.zeros(0, dtype=bool)
        return np.asarray(self.c_lb == self.c_ub) & np.isfinite(self.c_lb)

    # ------------------------------------------------------------- evaluation
    def objective(self, x, params=None):
        """(B,) objective values."""
        return _batched(self.f, x, params=params)

    def constraints(self, x, params=None):
        """(B, m) constraint values."""
        if self.m == 0:
            return x.new_zeros((x.shape[0], 0))
        return _batched(self.c, x, params=params)

    def objective_gradient(self, x, params=None):
        """(B, n) gradients."""
        return _batched(grad(self.f), x, params=params)

    def constraint_jacobian(self, x, params=None):
        """(B, m, n) dense Jacobians."""
        if self.m == 0:
            return x.new_zeros((x.shape[0], 0, self.n))
        return _batched(jacfwd(self.c), x, params=params)

    def _lagrangian(self, x, y, sigma, p):
        val = sigma * self.f(x, p)
        if self.m > 0:
            val = val - torch.dot(y, self.c(x, p))
        return val

    def lagrangian_hessian(self, x, y, sigma, params=None):
        """(B, n, n) Hessians of sigma*f(x) - y^T c(x); sigma is (B,)."""
        return _batched(hessian(self._lagrangian), x, y, sigma, params=params)

    def lagrangian_hessian_vp(self, x, y, v, sigma, params=None):
        """(B, n) Hessian-vector products, forward over reverse."""

        def one(x_, y_, v_, s_, p_):
            def lag_grad(z):
                g = s_ * grad(self.f)(z, p_)
                if self.m > 0:
                    g = g - vjp(lambda w: self.c(w, p_), z)[1](y_)[0]
                return g

            return jvp(lag_grad, (x_,), (v_,))[1]

        return _batched(one, x, y, v, sigma, params=params)

    def lagrangian_hessian_band(self, x, y, sigma, params=None):
        """(B, b+1, n) banded Lagrangian Hessians in lower band storage,
        band[:, d, j] = H[j+d, j], from min(n, 2b+1) strided Hessian-vector
        probes (columns j = k mod ncolors share probe k; their images cannot
        collide within the band), vmapped over the probe axis.  Requires
        `structure`."""
        b = self.structure.hess_bandwidth
        n = self.n
        ncolors = min(n, 2 * b + 1)
        cols = np.arange(n)
        V = const(self._consts, (cols[None, :] % ncolors)
                  == np.arange(ncolors)[:, None], x, name="hess_probes")
        d_idx = np.arange(b + 1)[:, None]
        row = cols[None, :] + d_idx
        ok = row < n
        color = const(self._consts, np.repeat((cols % ncolors)[None], b + 1, 0),
                      x, torch.int64, "hess_color")
        row_t = const(self._consts, np.where(ok, row, 0), x, torch.int64, "hess_row")
        ok_t = const(self._consts, ok, x, name="hess_ok")

        def one(x_, y_, s_, p_):
            def lag_grad(z):
                g = s_ * grad(self.f)(z, p_)
                if self.m > 0:
                    g = g - vjp(lambda w: self.c(w, p_), z)[1](y_)[0]
                return g

            Hv = vmap(lambda v: jvp(lag_grad, (x_,), (v,))[1])(V)
            return Hv[color, row_t] * ok_t

        return _batched(one, x, y, sigma, params=params)

    def constraint_jacobian_windows(self, x, params=None):
        """(B, m, w) windowed Jacobian rows, [:, i, t] = J[i, starts_i + t],
        from min(w, limit) strided Jacobian-vector probes vmapped over the
        probe axis; columns at or beyond structure.jac_col_limit (the
        slack columns) are not probed.  Requires `structure` with
        jac_starts."""
        st = self.structure
        starts, w = st.jac_starts, st.jac_width
        limit = self.n if st.jac_col_limit is None else st.jac_col_limit
        ncolors = min(limit, max(w, 1))
        cols = np.arange(self.n)
        V = const(self._consts, ((cols[None, :] % ncolors)
                                 == np.arange(ncolors)[:, None])
                  & (cols < limit)[None, :], x, name="jac_probes")
        tcol = starts[:, None] + np.arange(w)[None, :]
        ok = tcol < limit
        color = const(self._consts, np.where(ok, tcol, 0) % ncolors, x,
                      torch.int64, "jac_color")
        rows = const(self._consts, np.arange(self.m)[:, None], x, torch.int64,
                     "jac_rows")
        ok_t = const(self._consts, ok, x, name="jac_ok")

        def one(x_, p_):
            Jv = vmap(lambda v: jvp(lambda z: self.c(z, p_), (x_,), (v,))[1])(V)
            return Jv[color, rows] * ok_t

        return _batched(one, x, params=params)

    def constraint_violation(self, cx, norm: str = "L1"):
        """Norm of the violation of c_lb <= cx <= c_ub over the last axis."""
        lb = const(self._consts, self.c_lb, cx, name="c_lb")
        ub = const(self._consts, self.c_ub, cx, name="c_ub")
        viol = torch.clamp(lb - cx, min=0.0) + torch.clamp(cx - ub, min=0.0)
        return vector_norm(viol, norm)


def vector_norm(v, norm: str):
    """Norm over the last axis; 0 for an empty last axis."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    if norm == "L1":
        return torch.sum(torch.abs(v), dim=-1)
    if norm == "L2":
        return torch.sqrt(torch.sum(v * v, dim=-1))
    if norm == "L2_squared":
        return torch.sum(v * v, dim=-1)
    if norm == "INF":
        return torch.amax(torch.abs(v), dim=-1)
    raise ValueError(f"unknown norm {norm!r}")


def nlp_from_functions(
    name: str,
    f: Callable,
    c: Optional[Callable],
    x0,
    x_lb=None,
    x_ub=None,
    c_lb=None,
    c_ub=None,
    y0=None,
    params=None,
    structure: Optional[NLPStructure] = None,
) -> NLP:
    """Convenience constructor.  `f`/`c` may take (x,) or (x, params).

    NaN in x0 or any bound raises ValueError, as do inconsistent bound-array
    lengths."""
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.shape[0]
    if np.isnan(x0).any():
        raise ValueError(f"{name}: initial point x0 contains NaN")

    def wrap(fn):
        if fn is None:
            return None
        try:
            n_args = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            n_args = 2
        if n_args == 1:
            return lambda x, p: fn(x)
        return fn

    fw = wrap(f)
    cw = wrap(c)
    if cw is None:
        m = 0
        cw = lambda x, p: x.new_zeros((0,))  # noqa: E731
        c_lb = np.zeros(0)
        c_ub = np.zeros(0)
    else:
        c_lb = np.asarray(c_lb, dtype=np.float64)
        c_ub = np.asarray(c_ub, dtype=np.float64)
        if c_lb.shape != c_ub.shape:
            raise ValueError(
                f"{name}: c_lb shape {c_lb.shape} != c_ub shape {c_ub.shape}")
        m = c_lb.shape[0]

    x_lb = np.full(n, -INF) if x_lb is None else np.asarray(x_lb, dtype=np.float64)
    x_ub = np.full(n, INF) if x_ub is None else np.asarray(x_ub, dtype=np.float64)
    if x_lb.shape != (n,) or x_ub.shape != (n,):
        raise ValueError(
            f"{name}: bound shapes {x_lb.shape}/{x_ub.shape} != x0 shape ({n},)")
    for tag, arr in (("x_lb", x_lb), ("x_ub", x_ub),
                     ("c_lb", c_lb), ("c_ub", c_ub)):
        if np.isnan(arr).any():
            raise ValueError(f"{name}: {tag} contains NaN")
    y0 = np.zeros(m) if y0 is None else np.asarray(y0, dtype=np.float64)
    return NLP(
        name=name, n=n, m=m, f=fw, c=cw, x_lb=x_lb, x_ub=x_ub,
        c_lb=c_lb, c_ub=c_ub, x0=x0, y0=y0, params=params,
        structure=structure,
    )
