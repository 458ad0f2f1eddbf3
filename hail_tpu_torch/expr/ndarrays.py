"""NDArray expression ops.

Capability parity with the reference's NDArray tier
(`hail/python/hail/expr/expressions/typed_expressions.py`
NDArrayExpression/NDArrayNumericExpression and the Scala emitters under
`is/hail/expr/ir/EmitNDArray/NDArrayIR`), re-architected for this engine:
an ndarray VALUE is a numpy array held in one object-column cell, ops are
numpy delegates with missing propagation, and the device (jax) tier handles
the at-scale linear algebra in hail_tpu.linalg / hail_tpu.ops.

Error surfaces mirror the reference: shape/axis validation raises
ValueError/IndexError at expression-construction time; data-dependent
failures (bounds, singular matrices, ragged nesting) raise HailUserError at
evaluation, matching the reference messages its test-suite asserts on.
"""

from __future__ import annotations

import builtins as _bi

import numpy as np

from .. import types as ht
from ..ir import columns as C
from ..ir.columns import ObjectColumn
from ..utils.misc import FatalError, HailUserError

__all__ = [
    'nd_array', 'nd_getitem', 'nd_map', 'nd_map2', 'nd_binop', 'nd_unary',
    'nd_matmul', 'nd_transpose', 'nd_reshape', 'nd_sum', 'nd_to_array',
    'nd_shape', 'nd_elementwise_unary',
]

_ET_NP = {
    str(ht.tbool): np.bool_,
    str(ht.tint32): np.int32,
    str(ht.tint64): np.int64,
    str(ht.tfloat32): np.float32,
    str(ht.tfloat64): np.float64,
}

_NP_ET = {
    np.dtype(np.bool_): ht.tbool,
    np.dtype(np.int8): ht.tint32,
    np.dtype(np.int16): ht.tint32,
    np.dtype(np.int32): ht.tint32,
    np.dtype(np.int64): ht.tint64,
    np.dtype(np.uint8): ht.tint32,
    np.dtype(np.float32): ht.tfloat32,
    np.dtype(np.float64): ht.tfloat64,
}


def _np_of_et(et):
    return _ET_NP.get(str(et), object)


def _et_of_np(dt):
    return _NP_ET.get(np.dtype(dt), ht.tfloat64)


def _apply(name, typ, f, *exprs):
    from . import functions as F
    return F._apply(name, typ, F._obj_impl(typ, f), *exprs)


def _elem_et(e):
    t = e.dtype
    return t.element_type if isinstance(t, ht.tndarray) else t


def _ndim(e):
    t = e.dtype
    return t.ndim if isinstance(t, ht.tndarray) else 0


def _as_np(v, et=None):
    a = np.asarray(v)
    if a.dtype == object and et is not None and _np_of_et(et) is not object:
        a = a.astype(_np_of_et(et))
    return a


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _list_ndim(t):
    d = 0
    while isinstance(t, ht.tarray):
        d += 1
        t = t.element_type
    return d, t


def _infer_literal(x, dtype):
    """numpy array + element type for a non-expression input."""
    from_list = not isinstance(x, np.ndarray)
    try:
        arr = np.asarray(x)
    except ValueError as e:
        raise ValueError(f'inner dimensions do not match: {e}') from None
    if arr.dtype == object:
        raise ValueError('inner dimensions do not match')
    if dtype is not None:
        et = ht.dtype(dtype) if isinstance(dtype, str) else dtype
        return arr.astype(_np_of_et(et)), et
    if from_list and arr.dtype.kind in 'iu':
        # python ints are int32 in hail (reference nd.array literal typing)
        return arr.astype(np.int32), ht.tint32
    return arr, _et_of_np(arr.dtype)


def _build_nested(v, ndim, npdt, et):
    """Build a numpy array from (possibly nested) python lists, validating
    rectangularity and element presence like the reference's MakeNDArray."""
    def shape_of(u, depth):
        if depth == 0:
            return ()
        if u is None:
            raise HailUserError('ndarray element may not be missing')
        sub = None
        for el in u:
            s = shape_of(el, depth - 1)
            if sub is None:
                sub = s
            elif sub != s:
                raise HailUserError(
                    f'ndarray dimension {ndim - depth + 1} did not match '
                    f'between elements: {sub} vs {s}')
        return (_bi.len(u), *(sub if sub is not None else ((0,) * (depth - 1))))

    shape = shape_of(v, ndim)

    def fill(out, u, depth):
        if depth == 0:
            return
        for i, el in enumerate(u):
            if depth == 1:
                if el is None:
                    raise HailUserError('ndarray element may not be missing')
                out[i] = el
            else:
                fill(out[i], el, depth - 1)

    if npdt is object:
        out = np.empty(shape, dtype=object)
    else:
        out = np.zeros(shape, dtype=npdt)
    if ndim == 0:
        if v is None:
            raise HailUserError('ndarray element may not be missing')
        return np.asarray(v, dtype=npdt if npdt is not object else None)
    fill(out, v, ndim)
    return out


def nd_array(input_array, dtype=None):
    """hl.nd.array (reference nd/nd.py array): scalars are 0-dim, nested
    arrays nest into dimensions, numpy dtypes are preserved."""
    from .expression import Expression, construct_expr, to_expr
    from ..ir.nodes import Literal

    if isinstance(input_array, np.ndarray) or np.isscalar(input_array) \
            or isinstance(input_array, (int, float, bool)):
        arr, et = _infer_literal(input_array, dtype)
        return construct_expr(Literal(arr, ht.tndarray(et, arr.ndim)))

    if isinstance(input_array, (list, tuple)):
        flat_probe = []

        def probe(u):
            if isinstance(u, (list, tuple)):
                for el in u:
                    probe(el)
            else:
                flat_probe.append(u)
        probe(input_array)
        if not any(isinstance(v, Expression) for v in flat_probe):
            arr, et = _infer_literal(input_array, dtype)
            return construct_expr(Literal(arr, ht.tndarray(et, arr.ndim)))
        # expression elements: build a hail array first
        from . import functions as F
        input_array = F.array(list(input_array))

    e = to_expr(input_array)
    t = e.dtype
    if isinstance(t, ht.tndarray):
        if dtype is not None:
            return _cast_nd(e, ht.dtype(dtype) if isinstance(dtype, str) else dtype)
        return e
    if isinstance(t, ht.tarray):
        ndim, et = _list_ndim(t)
    else:
        ndim, et = 0, t
    if dtype is not None:
        et = ht.dtype(dtype) if isinstance(dtype, str) else dtype
    npdt = _np_of_et(et)
    rt = ht.tndarray(et, ndim)
    return _apply('nd_array', rt, lambda v: _build_nested(v, ndim, npdt, et), e)


def _cast_nd(e, et):
    npdt = _np_of_et(et)
    rt = ht.tndarray(et, e.dtype.ndim)
    return _apply('nd_cast', rt, lambda a: np.asarray(a).astype(npdt), e)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def nd_getitem(expr, item):
    """Full numpy indexing semantics: integers (static or expressions, with
    hail's 0<=i<size bounds rule), slices (negative/out-of-range clamp like
    numpy), Ellipsis, np.newaxis (reference NDArrayExpression.__getitem__ +
    NDArrayRef/NDArraySlice)."""
    from .expression import Expression, to_expr
    nd = expr.dtype.ndim
    et = expr.dtype.element_type
    if not isinstance(item, tuple):
        item = (item,)
    n_ell = _bi.sum(1 for s in item if s is Ellipsis)
    if n_ell > 1:
        raise IndexError('an index can only have a single ellipsis (`...`)')
    n_real = _bi.len([s for s in item if s is not Ellipsis and s is not None])
    if n_real > nd:
        raise IndexError(
            f'too many indices for array: array is {nd}-dimensional, '
            f'but {n_real} were indexed')
    items = list(item)
    if n_ell == 0 and n_real < nd:
        items.append(Ellipsis)
    expanded = []
    for s in items:
        if s is Ellipsis:
            expanded.extend([slice(None)] * (nd - n_real))
        else:
            expanded.append(s)

    # descriptors + dynamic scalar expressions, in evaluation order
    descs = []
    dyn = []

    def part(x):
        if isinstance(x, Expression):
            dyn.append(to_expr(x))
            return ('dyn', _bi.len(dyn) - 1)
        return ('lit', None if x is None else _bi.int(x))

    for s in expanded:
        if s is None:
            descs.append(('newaxis',))
        elif isinstance(s, slice):
            descs.append(('slice', part(s.start) if s.start is not None else ('lit', None),
                          part(s.stop) if s.stop is not None else ('lit', None),
                          part(s.step) if s.step is not None else ('lit', None)))
        else:
            if isinstance(s, Expression):
                descs.append(('int', part(s)))
            else:
                descs.append(('int', ('lit', _bi.int(s))))

    out_ndim = _bi.sum(1 for d in descs if d[0] != 'int')
    rt = ht.tndarray(et, out_ndim) if out_ndim else et
    # pure-integer indexing (NDArrayRef) rejects negatives; once a slice or
    # newaxis is present the reference's mixed path wraps them numpy-style
    allow_negative = out_ndim > 0

    def impl(a, *ivs):
        def get(p):
            kind, v = p
            return ivs[v] if kind == 'dyn' else v
        sel = []
        axis = 0
        for d in descs:
            if d[0] == 'newaxis':
                sel.append(None)
                continue
            if d[0] == 'int':
                i = get(d[1])
                if i is None:
                    return None
                i = _bi.int(i)
                size = a.shape[axis]
                j = i + size if (allow_negative and i < 0) else i
                if not (0 <= j < size):
                    raise HailUserError(
                        f'Index {i} is out of bounds for axis {axis} '
                        f'with size {size}')
                sel.append(j)
                axis += 1
                continue
            _, st, en, sp = d
            start, stop, step = get(st), get(en), get(sp)
            if (st != ('lit', None) and start is None) or \
               (en != ('lit', None) and stop is None) or \
               (sp != ('lit', None) and step is None):
                return None
            if step == 0:
                raise HailUserError('Slice step cannot be zero')
            sel.append(slice(None if start is None else _bi.int(start),
                             None if stop is None else _bi.int(stop),
                             None if step is None else _bi.int(step)))
            axis += 1
        v = np.asarray(a)[tuple(sel)]
        if out_ndim == 0:
            if isinstance(v, np.ndarray):
                v = v[()]
            return v.item() if isinstance(v, np.generic) else v
        return v

    return _apply('nd_index', rt, impl, expr, *dyn)


# ---------------------------------------------------------------------------
# shape / reshape / transpose
# ---------------------------------------------------------------------------

def nd_shape(expr):
    nd = expr.dtype.ndim
    rt = ht.ttuple(*([ht.tint64] * nd))
    return _apply('nd_shape', rt,
                  lambda a: tuple(_bi.int(s) for s in np.asarray(a).shape), expr)


def nd_reshape(expr, shape_args):
    """reshape with -1 inference and the reference's error surface
    (NDArrayReshape)."""
    from .expression import Expression, to_expr
    et = expr.dtype.element_type
    if _bi.len(shape_args) == 1 and isinstance(shape_args[0], Expression) \
            and isinstance(shape_args[0].dtype, ht.ttuple):
        tup = shape_args[0]
        for st_ in tup.dtype.types:
            if st_ not in (ht.tint32, ht.tint64):
                raise TypeError(f'reshape: expected int dims, got {st_}')
        out_ndim = _bi.len(tup.dtype.types)
        rt = ht.tndarray(et, out_ndim)
        return _apply('nd_reshape', rt,
                      lambda a, shp: _do_reshape(a, _bi.list(shp)), expr, tup)
    if _bi.len(shape_args) == 1 and isinstance(shape_args[0], (tuple, list)):
        shape_args = tuple(shape_args[0])
    dims = []
    for s in shape_args:
        e = to_expr(s)
        if e.dtype not in (ht.tint32, ht.tint64):
            raise TypeError(f'reshape: expected int dims, got {e.dtype}')
        dims.append(e)
    rt = ht.tndarray(et, _bi.len(dims))
    return _apply('nd_reshape', rt,
                  lambda a, *shp: _do_reshape(a, _bi.list(shp)), expr, *dims)


def _do_reshape(a, dims):
    if any(d is None for d in dims):
        return None
    dims = [_bi.int(d) for d in dims]
    a = np.asarray(a)
    if any(d < -1 for d in dims):
        raise HailUserError(
            f'Invalid shape {tuple(dims)}: must contain only nonnegative '
            f'numbers or -1')
    if dims.count(-1) > 1:
        raise HailUserError(
            f'Invalid shape {tuple(dims)}: may not contain more than one -1')
    if -1 in dims:
        known = 1
        for d in dims:
            if d != -1:
                known *= d
        if known == 0 or a.size % known != 0:
            raise HailUserError(
                f"Can't reshape array of size {a.size} into shape with -1 "
                f'alongside a total of {known} known elements')
        dims[dims.index(-1)] = a.size // known
    total = 1
    for d in dims:
        total *= d
    if total != a.size:
        raise HailUserError(
            f'requested shape is incompatible with number of elements: '
            f'{a.size} vs shape {tuple(dims)}')
    return a.reshape(dims)


def nd_transpose(expr, axes=None):
    nd = expr.dtype.ndim
    if axes is not None:
        axes = tuple(_bi.int(a) for a in axes)
        if _bi.len(axes) != nd:
            raise ValueError(f'Expected {nd} axes, got {_bi.len(axes)}')
        for a in axes:
            if not (0 <= a < nd):
                raise ValueError(f'Invalid axis: {a}')
        if _bi.len(set(axes)) != _bi.len(axes):
            raise ValueError('Axes cannot contain duplicates')
    return _apply('nd_transpose', expr.dtype,
                  lambda a: np.transpose(np.asarray(a), axes), expr)


# ---------------------------------------------------------------------------
# map / elementwise
# ---------------------------------------------------------------------------

def nd_to_array(expr):
    et = expr.dtype.element_type
    rt = ht.tarray(et)

    def impl(a):
        a = np.asarray(a)
        if a.dtype == object:
            return _bi.list(a.ravel())
        return a.ravel().tolist()
    return _apply('nd_to_array', rt, impl, expr)


def _nd_from_flat(flat_expr, shape_expr, et, ndim):
    npdt = _np_of_et(et)
    rt = ht.tndarray(et, ndim)

    def impl(lst, shp):
        if npdt is object:
            out = np.empty(_bi.len(lst), dtype=object)
            for i, v in enumerate(lst):
                out[i] = v
            return out.reshape(shp)
        return np.asarray(lst, dtype=npdt).reshape(shp)
    return _apply('nd_from_flat', rt, impl, flat_expr, shape_expr)


def nd_map(expr, f):
    """Elementwise map through the hail array tier: flatten → array map →
    refold to the original shape (reference NDArrayMap)."""
    flat = nd_to_array(expr)
    mapped = flat.map(f)
    return _nd_from_flat(mapped, nd_shape(expr),
                         mapped.dtype.element_type, expr.dtype.ndim)


def _nd_broadcast_pair(a, b):
    """Broadcast two ndarray expressions to their union shape."""
    na, nb = a.dtype.ndim, b.dtype.ndim
    nd = _bi.max(na, nb)
    ta = ht.tndarray(a.dtype.element_type, nd)
    tb = ht.tndarray(b.dtype.element_type, nd)

    def mk(which, rt):
        def impl(x, y):
            s = np.broadcast_shapes(np.asarray(x).shape, np.asarray(y).shape)
            return np.broadcast_to(np.asarray(x if which == 0 else y), s)
        return impl
    a2 = _apply('nd_bcast', ta, mk(0, ta), a, b)
    b2 = _apply('nd_bcast', tb, mk(1, tb), a, b)
    return a2, b2


def nd_map2(a, other, f):
    from .expression import to_expr
    b = to_expr(other)
    if not isinstance(b.dtype, ht.tndarray):
        b = nd_array(other)
    a2, b2 = _nd_broadcast_pair(a, b)
    fa, fb = nd_to_array(a2), nd_to_array(b2)
    from . import functions as F
    mapped = F.map_(f, fa, fb)
    return _nd_from_flat(mapped, nd_shape(a2),
                         mapped.dtype.element_type, a2.dtype.ndim)


def _promote(et1, et2, div=False):
    d1, d2 = _np_of_et(et1), _np_of_et(et2)
    if d1 is object or d2 is object:
        return ht.tfloat64
    r = np.result_type(d1, d2)
    if div and r.kind in 'ib':
        return ht.tfloat64
    return _et_of_np(r)


def nd_binop(name, npf, left, right, div=False, bool_to_int=False):
    """Elementwise binary op with numpy broadcasting; either side may be a
    scalar/array/np.ndarray (reference NDArrayNumericExpression arithmetic)."""
    from .expression import to_expr
    a = left if hasattr(left, '_ir') else _to_ndish(left)
    b = right if hasattr(right, '_ir') else _to_ndish(right)
    a, b = to_expr(a), to_expr(b)
    et = _promote(_elem_et(a), _elem_et(b), div=div)
    if bool_to_int and et == ht.tbool:
        et = ht.tint32
    nd = _bi.max(_ndim(a), _ndim(b))
    rt = ht.tndarray(et, nd)
    npdt = _np_of_et(et)

    def impl(x, y):
        with np.errstate(all='ignore'):
            out = npf(np.asarray(x), np.asarray(y))
        return np.asarray(out, dtype=npdt)
    return _apply(name, rt, impl, a, b)


def _to_ndish(x):
    """Lift a raw operand: numpy arrays and nested lists become ndarray
    expressions, scalars stay scalars."""
    if isinstance(x, np.ndarray):
        return nd_array(x)
    if isinstance(x, (list, tuple)):
        return nd_array(x)
    return x


def nd_unary(name, npf, expr, et=None):
    et = et or expr.dtype.element_type
    rt = ht.tndarray(et, expr.dtype.ndim)
    npdt = _np_of_et(et)

    def impl(a):
        with np.errstate(all='ignore'):
            return np.asarray(npf(np.asarray(a)), dtype=npdt)
    return _apply(name, rt, impl, expr)


def nd_elementwise_unary(fname, npf, expr, et_out=ht.tfloat64):
    """Broadcast a scalar numeric function over an ndarray (reference
    @ndarray_broadcasting decorator on hl.sqrt/log/floor/...)."""
    return nd_unary(fname, npf, expr, et=et_out)


# ---------------------------------------------------------------------------
# matmul / sum
# ---------------------------------------------------------------------------

def nd_matmul(a, other):
    from .expression import to_expr
    b = _to_ndish(other)
    b = to_expr(b)
    if not isinstance(b.dtype, ht.tndarray) or b.dtype.ndim == 0 \
            or a.dtype.ndim == 0:
        raise ValueError('matmul: operands must be ndarrays of dimension >= 1')
    et = _promote(_elem_et(a), _elem_et(b))
    nd = a.dtype.ndim + b.dtype.ndim - 2
    if a.dtype.ndim > 2 or b.dtype.ndim > 2:
        # stacked matmul broadcasts batch dims (numpy semantics)
        nd = _bi.max(a.dtype.ndim, b.dtype.ndim)
        if a.dtype.ndim == 1 or b.dtype.ndim == 1:
            nd -= 1
    rt = ht.tndarray(et, nd) if nd > 0 else et
    npdt = _np_of_et(et)

    def impl(x, y):
        x, y = np.asarray(x), np.asarray(y)
        kx = x.shape[-1]
        ky = y.shape[-2] if y.ndim >= 2 else y.shape[-1]
        if kx != ky:
            if x.ndim == 2 and y.ndim == 2:
                raise HailUserError(
                    f'Matrix dimensions incompatible: {x.shape} '
                    f"can't be multiplied by matrix with dimensions {y.shape}")
            raise HailUserError(
                f'Matrix dimensions incompatible: {x.shape} vs {y.shape}')
        out = np.matmul(x, y)
        if nd == 0:
            return np.asarray(out, dtype=npdt).item()
        return np.asarray(out, dtype=npdt)
    return _apply('nd_matmul', rt, impl, a, b)


def nd_sum(expr, axis=None):
    nd = expr.dtype.ndim
    et = expr.dtype.element_type
    if et == ht.tbool:
        et_out = ht.tint64
    elif et in (ht.tint32, ht.tint64):
        et_out = ht.tint64
    else:
        et_out = et
    if axis is None:
        axes = tuple(_bi.range(nd))
    elif isinstance(axis, (tuple, list)):
        axes = tuple(_bi.int(a) for a in axis)
    else:
        axes = (_bi.int(axis),)
    for a in axes:
        if not (0 <= a < nd):
            raise ValueError(
                f'axis {a} is out of bounds for ndarray of dimension {nd}')
    if _bi.len(set(axes)) != _bi.len(axes):
        raise ValueError(f'duplicate axis in {axes}')
    out_ndim = nd - _bi.len(axes)
    rt = ht.tndarray(et_out, out_ndim) if out_ndim else et_out
    npdt = _np_of_et(et_out)

    def impl(a):
        # axis=() sums nothing (numpy semantics, reference m.sum(()) test)
        out = np.sum(np.asarray(a), axis=axes)
        if out_ndim == 0:
            return np.asarray(out, dtype=npdt).item()
        return np.asarray(out, dtype=npdt)
    return _apply('nd_sum', rt, impl, expr)
