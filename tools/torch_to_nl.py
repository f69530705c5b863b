#!/usr/bin/env python
"""Transcribe uno_tpu_torch's registry problems to AMPL .nl text by
interpreting their traced aten graphs with symbolic expression nodes: the
counterpart of tools/jaxpr_to_nl.py, with PyTorch only.

Each problem's objective and constraint functions are traced once, for one
instance at its concrete shape, with torch.fx's make_fx (the counterpart
of jax.make_jaxpr).  The aten graph is then re-evaluated on numpy object
arrays of expression nodes (the E DSL of tools/gen_nl_fixtures_torch.py):
every aten operator either folds constants (float64 numpy operations) or
builds E trees, in the tree shapes jaxpr_to_nl.py gives the same
primitives (a sum is one o54 list in index order with its constants added
last, x**2 is x*x, a matrix product skips zero and folds unit constants),
and the result is written with write_nl in David Gay's public .nl text
dialect.

Transcription is symbolic work on the host, so it runs on the CPU by
nature: the traces and the checks use CPU tensors whatever card the
machine has.  Every file is verified before it is kept: f and c of the
port's read_nl of the file against the problem's own at x0 and at three
seeded points (x0 + 0.1 N(0, 1), numpy's default_rng(0) for the run).

Usage:
  python tools/torch_to_nl.py [outdir] [--limit N] [--names a,b,c] [--no-resume]
Writes <outdir>/<problem>.nl and <outdir>/manifest.json (per-problem
status, jaxpr_to_nl.py's schema).
"""

from __future__ import annotations

import json
import os
import signal
import sys

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.setrecursionlimit(200000)

from gen_nl_fixtures_torch import E, V, write_nl  # noqa: E402  (same directory)

aten = torch.ops.aten


class Unsupported(Exception):
    pass


def _w(x):
    return x if isinstance(x, E) else E("n", float(x))


def _un(op):
    def f(x):
        return E(op, _w(x))
    return f


def _sumlist(terms):
    terms = [_w(t) for t in terms]
    if not terms:
        return E("n", 0.0)
    if len(terms) == 1:
        return terms[0]
    if len(terms) == 2:
        return terms[0] + terms[1]
    return E(54, *terms)


def _is_obj(a):
    return isinstance(a, np.ndarray) and a.dtype == object


def _arr(a):
    """A value as a numpy array: object arrays stay, numbers become float64
    (booleans and integers keep their dtype)."""
    if isinstance(a, np.ndarray):
        return a
    if isinstance(a, E):
        out = np.empty((), dtype=object)
        out[()] = a
        return out
    if isinstance(a, (bool, np.bool_)):
        return np.asarray(a)
    return np.asarray(a, dtype=np.float64) if not isinstance(a, (int, np.integer)) \
        else np.asarray(a)


def _map_unary(np_fn, e_fn, a):
    """Elementwise: constant-fold float arrays, build E trees otherwise."""
    a = _arr(a)
    if not _is_obj(a):
        return np_fn(np.asarray(a, dtype=np.float64))
    return np.frompyfunc(
        lambda e: e_fn(e) if isinstance(e, E) else float(np_fn(e)), 1, 1)(a)


def _elementwise2(np_fn, op):
    """A binary operator with an ASL opcode: numpy on constants, E(op)
    where either side is symbolic."""
    def impl(a, b):
        a, b = _arr(a), _arr(b)
        if not (_is_obj(a) or _is_obj(b)):
            return np_fn(a, b)
        shp = np.broadcast_shapes(a.shape, b.shape)
        ab, bb = np.broadcast_to(a, shp), np.broadcast_to(b, shp)
        out = np.empty(shp, dtype=object)
        for ix in np.ndindex(*shp):
            x, y = ab[ix], bb[ix]
            if isinstance(x, E) or isinstance(y, E):
                out[ix] = E(op, _w(x), _w(y))
            else:
                out[ix] = np_fn(x, y)
        return out
    return impl


def _select(pred, t, f):
    """where(pred, t, f): ASL's o35 (if-then-else) where any part is
    symbolic."""
    pred, t, f = _arr(pred), _arr(t), _arr(f)
    if not any(_is_obj(v) for v in (pred, t, f)):
        return np.where(np.asarray(pred, bool), t, f)
    shp = np.broadcast_shapes(pred.shape, t.shape, f.shape)
    pb, tb, fb = (np.broadcast_to(v, shp) for v in (pred, t, f))
    out = np.empty(shp, dtype=object)
    for ix in np.ndindex(*shp):
        p, t_, f_ = pb[ix], tb[ix], fb[ix]
        if isinstance(p, E) or isinstance(t_, E) or isinstance(f_, E):
            out[ix] = E(35, _w(p), _w(t_), _w(f_))
        else:
            out[ix] = float(t_) if p else float(f_)
    return out


def _dot2(a2, b2):
    """(I, K) x (K, J) over object arrays: jaxpr_to_nl._dot_general's terms
    (zero constants skipped, unit constants folded, constants summed and
    added last)."""
    K = a2.shape[1]
    if not (_is_obj(a2) or _is_obj(b2)):
        return a2 @ b2
    out = np.empty((a2.shape[0], b2.shape[1]), dtype=object)
    for i in range(a2.shape[0]):
        for j in range(b2.shape[1]):
            terms = []
            for k in range(K):
                x, y = a2[i, k], b2[k, j]
                if not isinstance(x, E) and float(x) == 0.0:
                    continue
                if not isinstance(y, E) and float(y) == 0.0:
                    continue
                if not isinstance(x, E) and not isinstance(y, E):
                    terms.append(float(x) * float(y))
                elif not isinstance(x, E) and float(x) == 1.0:
                    terms.append(y)
                elif not isinstance(y, E) and float(y) == 1.0:
                    terms.append(x)
                else:
                    terms.append(_w(x) * y if isinstance(y, E) else _w(y) * x)
            const = sum(t for t in terms if not isinstance(t, E))
            etx = [t for t in terms if isinstance(t, E)]
            if etx:
                s = _sumlist(etx)
                out[i, j] = s + const if const else s
            else:
                out[i, j] = float(const)
    return out


def _matmul(a, b):
    a, b = _arr(a), _arr(b)
    if a.ndim == 1 and b.ndim == 1:
        return _dot2(a[None, :], b[:, None])[0, 0]
    if a.ndim == 2 and b.ndim == 1:
        return _dot2(a, b[:, None])[:, 0]
    if a.ndim == 1 and b.ndim == 2:
        return _dot2(a[None, :], b)[0]
    if a.ndim == 2 and b.ndim == 2:
        return _dot2(a, b)
    raise Unsupported(f"matrix product of ranks {a.ndim} and {b.ndim}")


def _reduce_sum(a, dims=None, keepdim=False):
    """jaxpr_to_nl._reduce_sum: each output one o54 list in index order
    with its constants summed and added last."""
    a = _arr(a)
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        dims = tuple(range(a.ndim))
    dims = tuple(sorted(d % a.ndim for d in ([dims] if isinstance(dims, int) else dims))) \
        if a.ndim else ()
    if not _is_obj(a):
        return np.sum(a.astype(np.float64), axis=dims, keepdims=keepdim)
    keep = [i for i in range(a.ndim) if i not in dims]
    at = np.transpose(a, list(dims) + keep)
    ksh = tuple(a.shape[i] for i in keep)
    flat = at.reshape((-1, int(np.prod(ksh, dtype=np.int64))))
    out = np.empty(flat.shape[1], dtype=object)
    for j in range(flat.shape[1]):
        col = flat[:, j]
        const = sum(float(t) for t in col if not isinstance(t, E))
        etx = [t for t in col if isinstance(t, E)]
        if etx:
            s = _sumlist(etx)
            out[j] = s + const if const else s
        else:
            out[j] = const
    out = out.reshape(ksh)
    if keepdim:
        out = out.reshape([1 if i in dims else a.shape[i] for i in range(a.ndim)])
    return out


def _prod_tree(terms):
    # a balanced o2 tree keeps the recursion depth at log n
    terms = list(terms)
    while len(terms) > 1:
        nxt = [terms[k] * terms[k + 1] for k in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _reduce_prod(a):
    a = _arr(a)
    if not _is_obj(a):
        return np.prod(a.astype(np.float64))
    const, terms = 1.0, []
    for t in a.reshape(-1):
        if isinstance(t, E):
            terms.append(t)
        else:
            const *= float(t)
    if not terms:
        return np.float64(const)
    tree = _prod_tree(terms)
    return tree * const if const != 1.0 else tree


def _pow_scalar(a, e):
    """x ** e: x * x for the integer 2 (jaxpr_to_nl's integer_pow), o5
    otherwise."""
    a = _arr(a)
    if not _is_obj(a):
        return np.asarray(a, dtype=np.float64) ** e
    if isinstance(e, (int, np.integer)) and not isinstance(e, bool) and e == 2:
        return np.frompyfunc(lambda v: v * v if isinstance(v, E) else float(v) ** 2,
                             1, 1)(a)
    return np.frompyfunc(lambda v: v ** float(e) if isinstance(v, E) else float(v) ** e,
                         1, 1)(a)


def _slice(a, dim=0, start=None, end=None, step=1):
    a = _arr(a)
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(start, end, step)
    return a[tuple(idx)]


def _index(a, indices):
    a = _arr(a)
    idx = []
    for ix in indices:
        if ix is None:
            idx.append(slice(None))
        else:
            ix = _arr(ix)
            if _is_obj(ix):
                raise Unsupported("index with traced indices")
            idx.append(ix.astype(bool) if ix.dtype == bool else ix.astype(np.int64))
    return a[tuple(idx)]


def _index_put(a, indices, values, accumulate=False):
    a, values = _arr(a), _arr(values)
    obj = _is_obj(a) or _is_obj(values)
    out = a.astype(object if obj else np.float64).copy()
    idx = tuple(slice(None) if ix is None else _arr(ix).astype(np.int64) for ix in indices)
    if accumulate:
        np.add.at(out, idx, values)
    else:
        out[idx] = values
    return out


def _slice_scatter(a, src, dim=0, start=None, end=None, step=1):
    a, src = _arr(a), _arr(src)
    obj = _is_obj(a) or _is_obj(src)
    out = a.astype(object if obj else np.float64).copy()
    idx = [slice(None)] * out.ndim
    idx[dim] = slice(start, end, step)
    out[tuple(idx)] = src
    return out


def _cat(tensors, dim=0):
    xs = [_arr(t) for t in tensors]
    xs = [x for x in xs if not (x.ndim == 1 and x.shape[0] == 0)] or xs
    if any(_is_obj(x) for x in xs):
        xs = [x.astype(object) for x in xs]
    return np.concatenate(xs, axis=dim)


def _stack(tensors, dim=0):
    xs = [_arr(t) for t in tensors]
    if any(_is_obj(x) for x in xs):
        xs = [x.astype(object) for x in xs]
    return np.stack(xs, axis=dim)


def _pad(a, pad, value=0.0):
    a = _arr(a)
    cfg = [(0, 0)] * a.ndim
    for k in range(len(pad) // 2):
        lo, hi = pad[2 * k], pad[2 * k + 1]
        if lo < 0 or hi < 0:
            raise Unsupported("constant_pad_nd with cropping")
        cfg[a.ndim - 1 - k] = (lo, hi)
    shape = [d + lo + hi for d, (lo, hi) in zip(a.shape, cfg)]
    out = np.full(shape, float(value), dtype=object if _is_obj(a) else np.float64)
    out[tuple(slice(lo, lo + d) for d, (lo, _) in zip(a.shape, cfg))] = a
    return out


def _clamp(a, lo=None, hi=None):
    """jnp.clip's order: maximum(lo, x), then minimum(hi, .)."""
    if lo is not None:
        a = _maximum(lo, a)
    if hi is not None:
        a = _minimum(hi, a)
    return a


def _expand(a, sizes):
    a = _arr(a)
    lead = len(sizes) - a.ndim
    shape = [a.shape[i - lead] if s == -1 else s for i, s in enumerate(sizes)]
    return np.broadcast_to(a, shape).copy()


def _squeeze(a, dims=None):
    a = _arr(a)
    if dims is None:
        return np.squeeze(a)
    dims = [dims] if isinstance(dims, int) else dims
    dims = tuple(d % a.ndim for d in dims if a.shape[d % a.ndim] == 1) if a.ndim else ()
    return np.squeeze(a, axis=dims)


def _to_copy(a, dtype=None, **_):
    """A dtype conversion: symbolic values stay, constants convert."""
    a = _arr(a)
    if _is_obj(a) or dtype is None:
        return a
    if dtype == torch.bool:
        return a.astype(bool)
    if dtype in (torch.int64, torch.int32):
        return a.astype(np.int64)
    return a.astype(np.float64)


def _const(shape, value):
    return np.full(tuple(shape), float(value))


def _logic(np_fn, op):
    return _elementwise2(lambda a, b: np_fn(np.asarray(a, bool), np.asarray(b, bool)), op)


def _cmp(np_fn, op):
    return _elementwise2(np_fn, op)


_maximum = _elementwise2(np.maximum, 12)
_minimum = _elementwise2(np.minimum, 11)


def _binary(fn):
    """a (op) b for numpy operands, with E's operators on object arrays."""
    def impl(a, b):
        return fn(_arr(a), _arr(b))
    return impl


def _add_alpha(a, b, alpha=1):
    b = _arr(b)
    return _arr(a) + (b if alpha == 1 else b * float(alpha))


def _sub_alpha(a, b, alpha=1):
    b = _arr(b)
    return _arr(a) - (b if alpha == 1 else b * float(alpha))


def _rsub(a, other, alpha=1):
    a = _arr(a)
    return _arr(other) - (a if alpha == 1 else a * float(alpha))


ATEN = {
    aten.add.Tensor: _add_alpha, aten.add.Scalar: _add_alpha,
    aten.sub.Tensor: _sub_alpha, aten.sub.Scalar: _sub_alpha,
    aten.rsub.Scalar: _rsub, aten.rsub.Tensor: _rsub,
    aten.mul.Tensor: _binary(lambda a, b: a * b),
    aten.mul.Scalar: _binary(lambda a, b: a * b),
    aten.div.Tensor: _binary(lambda a, b: a / b),
    aten.div.Scalar: _binary(lambda a, b: a / b),
    aten.neg.default: lambda a: -_arr(a),
    aten.pow.Tensor_Scalar: _pow_scalar,
    aten.pow.Tensor_Tensor: _binary(lambda a, b: a ** b),
    aten.pow.Scalar: _binary(lambda a, b: a ** b),
    aten.reciprocal.default: lambda a: _binary(lambda x, y: x / y)(1.0, a),
    aten.exp.default: lambda a: _map_unary(np.exp, _un(44), a),
    aten.log.default: lambda a: _map_unary(np.log, _un(43), a),
    aten.sin.default: lambda a: _map_unary(np.sin, _un(41), a),
    aten.cos.default: lambda a: _map_unary(np.cos, _un(46), a),
    aten.tan.default: lambda a: _map_unary(np.tan, _un(38), a),
    aten.tanh.default: lambda a: _map_unary(np.tanh, _un(37), a),
    aten.sinh.default: lambda a: _map_unary(np.sinh, _un(40), a),
    aten.cosh.default: lambda a: _map_unary(np.cosh, _un(45), a),
    aten.atan.default: lambda a: _map_unary(np.arctan, _un(49), a),
    aten.asin.default: lambda a: _map_unary(np.arcsin, _un(51), a),
    aten.acos.default: lambda a: _map_unary(np.arccos, _un(53), a),
    aten.sqrt.default: lambda a: _map_unary(np.sqrt, _un(39), a),
    aten.abs.default: lambda a: _map_unary(np.abs, _un(15), a),
    aten.log1p.default: lambda a: _map_unary(np.log1p, lambda e: _un(43)(e + 1.0), a),
    aten.rsqrt.default: lambda a: _map_unary(lambda v: 1.0 / np.sqrt(v),
                                             lambda e: 1.0 / _un(39)(e), a),
    aten.floor.default: lambda a: _map_unary(np.floor, _un(13), a),
    aten.ceil.default: lambda a: _map_unary(np.ceil, _un(14), a),
    aten.sign.default: lambda a: np.sign(np.asarray(a, dtype=np.float64))
    if not _is_obj(_arr(a)) else (_ for _ in ()).throw(Unsupported("sign (traced)")),
    aten.atan2.default: _elementwise2(np.arctan2, 48),
    aten.maximum.default: _maximum,
    aten.minimum.default: _minimum,
    aten.clamp.default: _clamp,
    aten.where.self: _select,
    aten.eq.Scalar: _cmp(np.equal, 24), aten.eq.Tensor: _cmp(np.equal, 24),
    aten.ne.Scalar: _cmp(np.not_equal, 30), aten.ne.Tensor: _cmp(np.not_equal, 30),
    aten.lt.Scalar: _cmp(np.less, 22), aten.lt.Tensor: _cmp(np.less, 22),
    aten.le.Scalar: _cmp(np.less_equal, 23), aten.le.Tensor: _cmp(np.less_equal, 23),
    aten.gt.Scalar: _cmp(np.greater, 29), aten.gt.Tensor: _cmp(np.greater, 29),
    aten.ge.Scalar: _cmp(np.greater_equal, 28), aten.ge.Tensor: _cmp(np.greater_equal, 28),
    aten.bitwise_and.Tensor: _logic(np.logical_and, 21),
    aten.bitwise_or.Tensor: _logic(np.logical_or, 20),
    aten.sum.default: lambda a, dtype=None: _reduce_sum(a),
    aten.sum.dim_IntList: lambda a, dim=None, keepdim=False, dtype=None:
        _reduce_sum(a, dim, keepdim),
    aten.mean.dim: lambda a, dim=None, keepdim=False, dtype=None:
        _reduce_sum(a, dim, keepdim) / float(np.prod(
            [_arr(a).shape[d] for d in ([dim] if isinstance(dim, int) else
                                        (dim or range(_arr(a).ndim)))])),
    aten.prod.default: lambda a, dtype=None: _reduce_prod(a),
    aten.cumsum.default: lambda a, dim, dtype=None: np.cumsum(_arr(a), axis=dim),
    aten.mv.default: _matmul, aten.mm.default: _matmul, aten.dot.default: _matmul,
    aten.select.int: lambda a, dim, index: np.take(_arr(a), index, axis=dim),
    aten.slice.Tensor: _slice,
    aten.index.Tensor: _index,
    aten.index_put.default: _index_put,
    aten.slice_scatter.default: _slice_scatter,
    aten.cat.default: _cat,
    aten.stack.default: _stack,
    aten.view.default: lambda a, shape: np.reshape(_arr(a), shape),
    aten.unsqueeze.default: lambda a, dim: np.expand_dims(_arr(a), dim % (_arr(a).ndim + 1)),
    aten.squeeze.default: _squeeze, aten.squeeze.dim: _squeeze, aten.squeeze.dims: _squeeze,
    aten.expand.default: _expand,
    aten.permute.default: lambda a, dims: np.transpose(_arr(a), dims),
    aten.t.default: lambda a: np.transpose(_arr(a)),
    aten.transpose.int: lambda a, d0, d1: np.swapaxes(_arr(a), d0, d1),
    aten.flip.default: lambda a, dims: np.flip(_arr(a), axis=tuple(dims)),
    aten.constant_pad_nd.default: _pad,
    aten._to_copy.default: _to_copy,
    aten.lift_fresh_copy.default: lambda a: _arr(a),
    aten.detach.default: lambda a: _arr(a),
    aten.clone.default: lambda a, memory_format=None: _arr(a),
    aten.new_zeros.default: lambda a, size, **kw: _const(size, 0.0),
    aten.new_ones.default: lambda a, size, **kw: _const(size, 1.0),
    aten.zeros_like.default: lambda a, **kw: _const(_arr(a).shape, 0.0),
    aten.full_like.default: lambda a, value, **kw: _const(_arr(a).shape, value),
    aten.scalar_tensor.default: lambda v, **kw: np.asarray(float(v)),
    aten.arange.default: lambda end, **kw: np.arange(end, dtype=np.float64),
    aten.arange.start: lambda start, end, **kw: np.arange(start, end, dtype=np.float64),
    aten.arange.start_step: lambda start, end, step=1, **kw:
        np.arange(start, end, step, dtype=np.float64),
}


def _is_reciprocal(node):
    return isinstance(node, torch.fx.Node) and node.op == "call_function" \
        and node.target is aten.reciprocal.default


def interp_graph(gm: torch.fx.GraphModule, *args):
    """Evaluate an aten graph with numpy (object) arrays for its inputs.

    A product with a Python number traces as mul(t, c) whichever side the
    number was written on; it is written c * t, the library's usual form
    (a sum keeps t + c: written either way, and c + t makes fewer
    transcripts equal to jaxpr_to_nl.py's).
    `c / x` traces as reciprocal(x) * c and is written back as the
    division c / x, the primitive jaxpr_to_nl.py sees."""
    env = {}
    inputs = iter(args)

    def load(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(load(v) for v in a)
        return a

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(inputs)
        elif node.op == "get_attr":
            t = getattr(gm, node.target)
            env[node] = t.detach().cpu().numpy().astype(
                np.float64 if t.is_floating_point() else t.detach().cpu().numpy().dtype)
        elif node.op == "call_function":
            fn = ATEN.get(node.target)
            if fn is None:
                raise Unsupported(f"aten operator {node.target}")
            a, kw = load(node.args), load(node.kwargs)
            scalar_rhs = len(node.args) == 2 and not isinstance(node.args[1], torch.fx.Node)
            if node.target in (aten.mul.Tensor, aten.mul.Scalar) and scalar_rhs:
                if _is_reciprocal(node.args[0]):
                    out = _binary(lambda x, y: x / y)(a[1], env[node.args[0].args[0]])
                else:   # c * t and t * c both trace as mul(t, c): write c * t
                    out = _binary(lambda x, y: x * y)(a[1], a[0])
            else:
                out = fn(*a, **kw)
            env[node] = out
        elif node.op == "output":
            return load(node.args[0])
        else:
            raise Unsupported(f"graph node {node.op}")
    raise Unsupported("graph without output")


def trace(fn, n):
    """The aten graph of fn on one instance x of shape (n,), float64, CPU."""
    return make_fx(fn)(torch.zeros(n, dtype=torch.float64))


def nlp_to_nl(nlp, path):
    """Trace nlp.f / nlp.c, interpret them with E nodes, write .nl text.
    Raises Unsupported for programs outside the smooth ASL subset."""
    n = nlp.n
    xs = np.empty(n, dtype=object)
    for i in range(n):
        xs[i] = V(i)

    def unwrap(v):
        v = _arr(v)
        return _w(v.reshape(())[()])

    obj = unwrap(interp_graph(trace(lambda x: nlp.f(x, nlp.params), n), xs))
    cons = []
    if nlp.m:
        c = _arr(interp_graph(trace(lambda x: nlp.c(x, nlp.params), n), xs)).reshape(-1)
        cons = [_w(c[j]) for j in range(nlp.m)]
    write_nl(path, nlp.name, n, np.asarray(nlp.x0, dtype=np.float64),
             np.asarray(nlp.x_lb, dtype=np.float64),
             np.asarray(nlp.x_ub, dtype=np.float64), cons, obj,
             np.asarray(nlp.c_lb, dtype=np.float64) if nlp.m else np.zeros(0),
             np.asarray(nlp.c_ub, dtype=np.float64) if nlp.m else np.zeros(0))


def check_points(nlp, rng):
    """x0 and three seeded points x0 + 0.1 N(0, 1)."""
    x0 = np.asarray(nlp.x0, dtype=np.float64)
    return [x0] + [x0 + 0.1 * rng.standard_normal(nlp.n) for _ in range(3)]


def verify_roundtrip(nlp, path, rng):
    """Read the file back with the port's reader and compare f and c with
    the problem's at check_points (1e-8 relative, as jaxpr_to_nl.py), and
    the bounds exactly."""
    from uno_tpu_torch.io import read_nl
    back = read_nl(path)
    assert back.n == nlp.n and back.m == nlp.m, \
        f"shape mismatch {back.n}x{back.m} vs {nlp.n}x{nlp.m}"
    for x in check_points(nlp, rng):
        xt = torch.as_tensor(x)[None]
        fa = float(nlp.objective(xt, None)[0])
        fb = float(back.objective(xt)[0])
        if not (np.isfinite(fa) and np.isfinite(fb)):
            continue
        assert abs(fa - fb) <= 1e-8 * max(1.0, abs(fa)), f"objective mismatch {fa} vs {fb}"
        if nlp.m:
            ca = nlp.constraints(xt)[0].numpy()
            cb = back.constraints(xt)[0].numpy()
            mask = np.isfinite(ca) & np.isfinite(cb)
            assert np.max(np.abs(ca[mask] - cb[mask]), initial=0.0) <= \
                1e-8 * max(1.0, np.max(np.abs(ca[mask]), initial=1.0)), "constraint mismatch"
    np.testing.assert_array_equal(back.x_lb, np.asarray(nlp.x_lb, dtype=np.float64))
    np.testing.assert_array_equal(back.x_ub, np.asarray(nlp.x_ub, dtype=np.float64))
    if nlp.m:
        np.testing.assert_array_equal(back.c_lb, np.asarray(nlp.c_lb, dtype=np.float64))
        np.testing.assert_array_equal(back.c_ub, np.asarray(nlp.c_ub, dtype=np.float64))


class _Timeout(Exception):
    pass


def _alarm(signum, frame):
    raise _Timeout()


def transcribe(names, outdir, resume=True, seconds=240, log=print):
    """Transcribe and verify each key into outdir; returns the manifest."""
    from uno_tpu_torch.model.library import get_problem, known_optimum
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(0)
    manifest, ok = {}, 0
    old = signal.signal(signal.SIGALRM, _alarm)
    try:
        for name in names:
            path = os.path.join(outdir, f"{name}.nl")
            if resume and os.path.exists(path):
                nlp = get_problem(name)
                manifest[name] = {"status": "ok", "n": nlp.n, "m": nlp.m,
                                  "f_star": known_optimum(name)}
                ok += 1
                continue
            try:
                # large dense problems build O(n^2) trees: bound each key
                signal.alarm(seconds)
                nlp = get_problem(name)
                nlp_to_nl(nlp, path)
                verify_roundtrip(nlp, path, rng)
                manifest[name] = {"status": "ok", "n": nlp.n, "m": nlp.m,
                                  "f_star": known_optimum(name)}
                ok += 1
            except Unsupported as exc:
                manifest[name] = {"status": "unsupported", "reason": str(exc)}
            except _Timeout:
                manifest[name] = {"status": "timeout",
                                  "reason": f"expression build > {seconds} s"}
            except Exception as exc:  # noqa: BLE001 - recorded, the sweep goes on
                manifest[name] = {"status": "error",
                                  "reason": f"{type(exc).__name__}: {exc}"}
            finally:
                signal.alarm(0)
            if manifest[name]["status"] != "ok" and os.path.exists(path):
                os.remove(path)
            if log:
                st = manifest[name]
                log(f"{name}: {st['status']}" + ("" if st["status"] == "ok"
                                                  else f" ({st.get('reason', '')[:90]})"))
    finally:
        signal.signal(signal.SIGALRM, old)
    result = {"emitted": ok, "total": len(names), "problems": manifest}
    with open(os.path.join(outdir, "manifest.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


def main():
    argv = sys.argv[1:]
    outdir, names_filter, limit, rest = "nl_corpus_torch", None, None, []
    i = 0
    while i < len(argv):
        if argv[i] == "--limit":
            limit = int(argv[i + 1])
            i += 2
        elif argv[i] == "--names":
            names_filter = argv[i + 1].split(",")
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    rest = [a for a in rest if a != "--no-resume"]
    if rest:
        outdir = rest[0]
    from uno_tpu_torch.model.library import problem_names
    names = names_filter or [p for p in problem_names() if not p.startswith("nl_")]
    if limit:
        names = names[:limit]
    res = transcribe(names, outdir, resume="--no-resume" not in argv,
                     log=lambda s: print(s, flush=True))
    print(f"\nemitted {res['emitted']}/{res['total']} -> {outdir}")


if __name__ == "__main__":
    main()
