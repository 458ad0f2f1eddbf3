"""`hl.nd` — ndarray constructors and linear algebra.

Capability parity with reference hail/python/hail/nd/nd.py. NDArray values
are numpy arrays in object cells (see hail_tpu/expr/ndarrays.py); small
decompositions run on the host via LAPACK — the device (jax) tier in
hail_tpu.linalg / hail_tpu.ops handles at-scale linear algebra, exactly the
split the reference makes between Breeze-on-driver and BlockMatrix.
"""

from __future__ import annotations

import builtins as _bi

import numpy as np

from .. import types as ht
from ..expr import functions as F
from ..expr import ndarrays as nds
from ..expr.expression import Expression, to_expr
from ..expr.ndarrays import _apply, _np_of_et
from ..utils.misc import HailUserError

#: alias of numpy's newaxis (None) for slice expressions
newaxis = None

array = nds.nd_array


def arange(start, stop=None, step=1):
    """Integer range ndarray (reference nd.arange); step 0 fails at eval."""
    if stop is None:
        start, stop = 0, start
    rt = ht.tndarray(ht.tint32, 1)

    def impl(s, e, st):
        if st == 0:
            raise HailUserError('Array range cannot have step size 0')
        return np.arange(s, e, st, dtype=np.int32)
    return _apply('nd_arange', rt, impl, to_expr(start), to_expr(stop),
                  to_expr(step))


def _shape_exprs(shape):
    if isinstance(shape, Expression) and isinstance(shape.dtype, ht.ttuple):
        return None, shape
    if isinstance(shape, (tuple, list)):
        return [to_expr(s) for s in shape], None
    return [to_expr(shape)], None


def full(shape, value, dtype=None):
    dims, tup = _shape_exprs(shape)
    v = to_expr(value)
    et = (ht.dtype(dtype) if isinstance(dtype, str) else dtype) or v.dtype
    npdt = _np_of_et(et)
    ndim = _bi.len(dims) if dims is not None else _bi.len(tup.dtype.types)
    rt = ht.tndarray(et, ndim)
    if tup is not None:
        return _apply('nd_full', rt,
                      lambda shp, val: np.full(tuple(_bi.int(s) for s in shp), val, dtype=npdt),
                      tup, v)
    return _apply('nd_full', rt,
                  lambda *a: np.full(tuple(_bi.int(s) for s in a[:-1]), a[-1], dtype=npdt),
                  *dims, v)


def zeros(shape, dtype=ht.tfloat64):
    return full(shape, 0, dtype=dtype)


def ones(shape, dtype=ht.tfloat64):
    return full(shape, 1, dtype=dtype)


def eye(N, M=None, dtype=ht.tfloat64):
    et = ht.dtype(dtype) if isinstance(dtype, str) else dtype
    npdt = _np_of_et(et)
    rt = ht.tndarray(et, 2)
    return _apply('nd_eye', rt,
                  lambda n, m: np.eye(_bi.int(n), _bi.int(m), dtype=npdt),
                  to_expr(N), to_expr(M if M is not None else N))


def identity(N):
    return eye(N)


def diagonal(nd):
    """Principal diagonal of a matrix (reference nd.diagonal)."""
    assert nd.dtype.ndim == 2, 'diagonal requires 2 dimensional ndarray'
    rt = ht.tndarray(nd.dtype.element_type, 1)
    return _apply('nd_diagonal', rt, lambda a: np.diagonal(np.asarray(a)).copy(), nd)


def _as_nd(x):
    if isinstance(x, Expression):
        return x
    return array(x)


def solve(a, b, no_crash: bool = False):
    """Solve ax = b (reference nd.solve / LAPACK dgesv); singular systems
    raise HailUserError unless no_crash."""
    a, b = _as_nd(a), _as_nd(b)
    b_ndim = b.dtype.ndim
    rt = ht.tndarray(ht.tfloat64, b_ndim)

    def impl(av, bv):
        av = np.asarray(av, dtype=np.float64)
        bv = np.asarray(bv, dtype=np.float64)
        rhs = bv.reshape(-1, 1) if bv.ndim == 1 else bv
        try:
            out = np.linalg.solve(av, rhs)
        except np.linalg.LinAlgError:
            if no_crash:
                return None
            raise HailUserError('solve: matrix was singular') from None
        return out[:, 0] if bv.ndim == 1 else out
    if no_crash:
        rt2 = ht.ttuple(rt, ht.tbool)

        def impl2(av, bv):
            out = impl(av, bv)
            if out is None:
                return (np.zeros_like(np.asarray(bv, dtype=np.float64)), True)
            return (out, False)
        return _apply('nd_solve', rt2, impl2, a, b)
    return _apply('nd_solve', rt, impl, a, b)


def solve_triangular(nd_coef, nd_dep, lower: bool = False,
                     no_crash: bool = False):
    """Solve Tx = b for triangular T (reference nd.solve_triangular /
    dtrtrs)."""
    a, b = _as_nd(nd_coef), _as_nd(nd_dep)
    b_ndim = b.dtype.ndim
    rt = ht.tndarray(ht.tfloat64, b_ndim)

    def impl(av, bv):
        av = np.asarray(av, dtype=np.float64)
        bv = np.asarray(bv, dtype=np.float64)
        if np.any(np.diagonal(av) == 0):
            if no_crash:
                return None
            raise HailUserError('solve_triangular: matrix is singular') from None
        tri = np.tril(av) if lower else np.triu(av)
        rhs = bv.reshape(-1, 1) if bv.ndim == 1 else bv
        out = np.linalg.solve(tri, rhs)
        return out[:, 0] if bv.ndim == 1 else out
    if no_crash:
        rt2 = ht.ttuple(rt, ht.tbool)

        def impl2(av, bv):
            out = impl(av, bv)
            if out is None:
                return (np.zeros_like(np.asarray(bv, dtype=np.float64)), True)
            return (out, False)
        return _apply('nd_solve_triangular', rt2, impl2, a, b)
    return _apply('nd_solve_triangular', rt, impl, a, b)


def qr(nd, mode: str = 'reduced'):
    """QR decomposition (reference nd.qr / dgeqrf+dorgqr); modes
    reduced/complete/r/raw like numpy."""
    if mode not in ('reduced', 'complete', 'r', 'raw'):
        raise ValueError(f'Unrecognized mode: {mode}')
    nd = _as_nd(nd)
    assert nd.dtype.ndim == 2, 'qr requires 2 dimensional ndarray'
    f2 = ht.tndarray(ht.tfloat64, 2)
    f1 = ht.tndarray(ht.tfloat64, 1)
    if mode == 'r':
        return _apply('nd_qr_r', f2,
                      lambda a: np.linalg.qr(np.asarray(a, np.float64), mode='r'), nd)
    if mode == 'raw':
        rt = ht.ttuple(f2, f1)
        return _apply('nd_qr_raw', rt,
                      lambda a: tuple(np.linalg.qr(np.asarray(a, np.float64), mode='raw')), nd)
    rt = ht.ttuple(f2, f2)
    return _apply(f'nd_qr_{mode}', rt,
                  lambda a: tuple(np.linalg.qr(np.asarray(a, np.float64), mode=mode)), nd)


def svd(nd, full_matrices: bool = True, compute_uv: bool = True):
    """Singular value decomposition (reference nd.svd / dgesdd)."""
    nd = _as_nd(nd)
    f2 = ht.tndarray(ht.tfloat64, 2)
    f1 = ht.tndarray(ht.tfloat64, 1)
    if compute_uv:
        rt = ht.ttuple(f2, f1, f2)
        return _apply('nd_svd', rt,
                      lambda a: tuple(np.linalg.svd(np.asarray(a, np.float64),
                                                    full_matrices=full_matrices)), nd)
    return _apply('nd_svd_s', f1,
                  lambda a: np.linalg.svd(np.asarray(a, np.float64),
                                          compute_uv=False), nd)


def eigh(nd, eigvals_only: bool = False):
    """Symmetric eigendecomposition (reference nd.eigh / dsyevr)."""
    nd = _as_nd(nd)
    f2 = ht.tndarray(ht.tfloat64, 2)
    f1 = ht.tndarray(ht.tfloat64, 1)
    if eigvals_only:
        return _apply('nd_eigvalsh', f1,
                      lambda a: np.linalg.eigvalsh(np.asarray(a, np.float64)), nd)
    rt = ht.ttuple(f1, f2)
    return _apply('nd_eigh', rt,
                  lambda a: tuple(np.linalg.eigh(np.asarray(a, np.float64))), nd)


def inv(nd):
    """Matrix inverse (reference nd.inv / dgetri)."""
    nd = _as_nd(nd)
    f2 = ht.tndarray(ht.tfloat64, 2)

    def impl(a):
        try:
            return np.linalg.inv(np.asarray(a, np.float64))
        except np.linalg.LinAlgError:
            raise HailUserError('inv: matrix is singular') from None
    return _apply('nd_inv', f2, impl, nd)


def _check_concat_elements(nds_list):
    # element-type agreement is checked before dimensionality (reference
    # nd.concatenate error precedence)
    ets = [e.dtype.element_type for e in nds_list]
    if _bi.len({str(t) for t in ets}) != 1:
        raise ValueError(
            'hl.nd.concatenate: ndarrays must have same element types, '
            f'found these element types: ({", ".join(str(t) for t in ets)})')
    ndims = [e.dtype.ndim for e in nds_list]
    if _bi.len(set(ndims)) != 1:
        raise ValueError(
            'hl.nd.concatenate: ndarrays must have same number of '
            f'dimensions, found: {", ".join(str(n) for n in ndims)}')


def concatenate(nds, axis: int = 0):
    """Join ndarrays along an axis (reference nd.concatenate /
    NDArrayConcat)."""
    if isinstance(nds, Expression) and isinstance(nds.dtype, ht.tarray):
        et = nds.dtype.element_type
        rt = et

        def impl(vs):
            return np.concatenate([np.asarray(v) for v in vs], axis=axis)
        return _apply('nd_concat', rt, impl, nds)
    exprs = [_as_nd(x) for x in nds]
    _check_concat_elements(exprs)
    rt = exprs[0].dtype

    def impl(*vs):
        return np.concatenate([np.asarray(v) for v in vs], axis=axis)
    return _apply('nd_concat', rt, impl, *exprs)


def vstack(arrs):
    """Stack vertically; 1-d inputs become rows (reference nd.vstack)."""
    if isinstance(arrs, Expression) and isinstance(arrs.dtype, ht.tarray):
        et = arrs.dtype.element_type
        rt = ht.tndarray(et.element_type, 2)

        def impl(vs):
            return np.vstack([np.asarray(v) for v in vs])
        return _apply('nd_vstack', rt, impl, arrs)
    exprs = [_as_nd(x) for x in arrs]
    rt = ht.tndarray(exprs[0].dtype.element_type, 2)

    def impl(*vs):
        return np.vstack([np.asarray(v) for v in vs])
    return _apply('nd_vstack', rt, impl, *exprs)


def hstack(arrs):
    """Stack horizontally (reference nd.hstack)."""
    if isinstance(arrs, Expression) and isinstance(arrs.dtype, ht.tarray):
        et = arrs.dtype.element_type
        rt = et

        def impl(vs):
            return np.hstack([np.asarray(v) for v in vs])
        return _apply('nd_hstack', rt, impl, arrs)
    exprs = [_as_nd(x) for x in arrs]
    rt = exprs[0].dtype

    def impl(*vs):
        return np.hstack([np.asarray(v) for v in vs])
    return _apply('nd_hstack', rt, impl, *exprs)


def maximum(nd1, nd2):
    """Elementwise max, NaN-propagating (reference nd.maximum)."""
    return nds.nd_binop('nd_maximum', np.maximum, _as_nd(nd1), _as_nd(nd2))


def minimum(nd1, nd2):
    """Elementwise min, NaN-propagating (reference nd.minimum)."""
    return nds.nd_binop('nd_minimum', np.minimum, _as_nd(nd1), _as_nd(nd2))


def from_column_major(a, shape):
    """Interpret a flat column-major buffer as a 2-d ndarray."""
    e = to_expr(a)
    rt = ht.tndarray(e.dtype.element_type if isinstance(e.dtype, ht.tarray)
                     else ht.tfloat64, 2)

    def impl(v, r, c):
        return np.asarray(v).reshape((_bi.int(c), _bi.int(r))).T
    return _apply('nd_from_column_major', rt, impl, e,
                  to_expr(shape[0]), to_expr(shape[1]))


def solve_helper(nd_coef, nd_dep, nd_dep_ndim_orig):
    """Shape normalization used by solve paths (reference nd.solve_helper):
    promotes 1-d dependents to column vectors."""
    a, b = _as_nd(nd_coef), _as_nd(nd_dep)
    if nd_dep_ndim_orig == 1:
        b = b.reshape((-1, 1))
    return a, b
