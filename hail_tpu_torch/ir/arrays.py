"""Array/collection IR nodes: lambda ops (map/filter/fold), len, indexing.

Analogue of the reference's Stream* IR nodes + EmitStream
(`is/hail/expr/ir/streams/EmitStream.scala`) — but instead of compiling
streams to state machines, dense primitive arrays evaluate vectorized over a
trailing width axis, and everything else falls back to per-element python
evaluation.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .. import types as ht
from . import columns as C
from .columns import Column, DenseArrayColumn, ObjectColumn, PrimitiveColumn
from .nodes import IR, Cast, EvalEnv


def _mix_uid(row_uid, elem_index):
    """Derive a per-(row, element) uid from the row uid — splitmix64 step, so
    randomness inside collection lambdas varies per element (the reference
    splits stream-element UIDs the same way, ir/random uid machinery)."""
    x = (np.asarray(row_uid, dtype=np.uint64)
         + np.uint64(0x9E3779B97F4A7C15) * (np.asarray(elem_index, dtype=np.uint64) + np.uint64(1)))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return ((x ^ (x >> np.uint64(31))) >> np.uint64(1)).astype(np.int64)


def _elem_env(env: EvalEnv, arr_shape, width) -> EvalEnv:
    """Environment for vectorized lambda evaluation: every outer binding gets a
    trailing broadcast axis; the lambda var will have shape arr_shape+(width,)."""
    new = {}
    for k, c in env.bindings.items():
        new[k] = c.reshape(c.shape + (1,))
    uid = new.get('__row_idx__')
    if uid is None and width:
        # no outer uid context (hl.eval of a literal collection): the element
        # index alone is the uid word, matching the reference's zip-iota
        k = 0
        while f'__uid_w{k}__' in new:
            k += 1
        idx_w = np.arange(width, dtype=np.int64).reshape(
            (1,) * len(arr_shape) + (width,))
        new[f'__uid_w{k}__'] = PrimitiveColumn(
            ht.tint64, np.broadcast_to(idx_w, tuple(1 for _ in arr_shape) + (width,)).copy())
    if uid is not None and width:
        vals = np.broadcast_to(np.asarray(uid.values, dtype=np.int64)[..., :1],
                               uid.values.shape[:-1] + (width,))
        mixed = _mix_uid(vals, np.arange(width, dtype=np.int64))
        new['__row_idx__'] = PrimitiveColumn(ht.tint64, mixed)
        # uid WORDS gain the element index (reference stream uids append the
        # zip-iota; randomness.md) — derive w0 from the row uid when the
        # context hasn't established words yet
        k = 0
        while f'__uid_w{k}__' in new:
            k += 1
        if k == 0:
            new['__uid_w0__'] = PrimitiveColumn(ht.tint64, vals.copy())
            k = 1
        idx_w = np.broadcast_to(np.arange(width, dtype=np.int64),
                                vals.shape).copy()
        new[f'__uid_w{k}__'] = PrimitiveColumn(ht.tint64, idx_w)
    return EvalEnv(new, tuple(arr_shape) + (width,))


class ArrayLen(IR):
    def __init__(self, arr: IR):
        self.arr = arr
        self.typ = ht.tint32

    @property
    def children(self):
        return (self.arr,)

    def map_children(self, f):
        return ArrayLen(f(self.arr))

    def evaluate(self, env):
        col = self.arr.evaluate(env)
        if isinstance(col, DenseArrayColumn):
            return PrimitiveColumn(ht.tint32, col.lengths, col.missing)
        obj = C.to_object(col)
        vals = np.frompyfunc(lambda v: None if v is None else len(v), 1, 1)(obj.values)
        return C.from_pylist(ht.tint32, list(vals.ravel())).reshape(obj.shape)


class ArrayMap(IR):
    def __init__(self, arr: IR, var: str, body: IR):
        assert isinstance(arr.typ, (ht.tarray, ht.tset)), arr.typ
        self.arr = arr
        self.var = var
        self.body = body
        self.typ = ht.tset(body.typ) if isinstance(arr.typ, ht.tset) else ht.tarray(body.typ)

    @property
    def children(self):
        return (self.arr, self.body)

    def map_children(self, f):
        return ArrayMap(f(self.arr), self.var, f(self.body))

    def evaluate(self, env):
        col = self.arr.evaluate(env)
        bt = self.body.typ
        if isinstance(col, DenseArrayColumn) and bt.numpy_dtype is not None:
            inner_env = _elem_env(env, col.shape, col.width)
            elem_col = PrimitiveColumn(col.typ.element_type, col.values, col.elem_missing)
            inner_env = inner_env.bind(self.var, elem_col)
            res = self.body.evaluate(inner_env)
            if isinstance(res, PrimitiveColumn):
                # the body may broadcast against wider env axes (e.g. a row
                # array combined with an entry value) — take the union shape
                out_shape = np.broadcast_shapes(res.values.shape, col.values.shape)
                vals = np.broadcast_to(res.values, out_shape)
                em = res.missing
                if em is not None:
                    em = np.broadcast_to(em, out_shape)
                lengths = np.broadcast_to(col.lengths, out_shape[:-1])
                miss = (np.broadcast_to(col.missing, out_shape[:-1])
                        if col.missing is not None else None)
                return DenseArrayColumn(ht.tarray(bt), vals, lengths, em, miss)
        # object fallback: per-element scalar evaluation
        return _object_lambda(self, col, env, mode='map')


class ArrayFilter(IR):
    def __init__(self, arr: IR, var: str, body: IR):
        self.arr = arr
        self.var = var
        self.body = body
        self.typ = arr.typ

    @property
    def children(self):
        return (self.arr, self.body)

    def map_children(self, f):
        return ArrayFilter(f(self.arr), self.var, f(self.body))

    def evaluate(self, env):
        col = self.arr.evaluate(env)
        return _object_lambda(self, col, env, mode='filter')


class ArrayFold(IR):
    def __init__(self, arr: IR, zero: IR, accum_var: str, elem_var: str, body: IR):
        self.arr = arr
        self.zero = zero
        self.accum_var = accum_var
        self.elem_var = elem_var
        self.body = body
        self.typ = body.typ

    @property
    def children(self):
        return (self.arr, self.zero, self.body)

    def map_children(self, f):
        return ArrayFold(f(self.arr), f(self.zero), self.accum_var, self.elem_var, f(self.body))

    def evaluate(self, env):
        col = self.arr.evaluate(env)
        zc = self.zero.evaluate(env)
        obj = C.to_object(col)
        zobj = C.to_object(zc).broadcast_to(obj.shape)
        out = np.empty(obj.shape, dtype=object)
        flat_arr = obj.values.ravel()
        flat_z = zobj.values.ravel()
        flat_out = out.ravel()
        for i in range(flat_arr.size):
            a = flat_arr[i]
            if a is None:
                flat_out[i] = None
                continue
            acc = flat_z[i]
            for j, x in enumerate(a):
                acc = _eval_scalar_body(self.body, env,
                                        {self.accum_var: (self.typ, acc), self.elem_var: (self.arr.typ.element_type, x)},
                                        elem_index=j)
            flat_out[i] = acc
        return C.from_pylist(self.typ, list(flat_out)).reshape(obj.shape)


class ArrayScan(IR):
    """Running fold: returns [zero, f(zero, a0), f(f(zero, a0), a1), ...]
    (length n+1, reference `array_scan`)."""

    def __init__(self, arr: IR, zero: IR, accum_var: str, elem_var: str, body: IR):
        self.arr = arr
        self.zero = zero
        self.accum_var = accum_var
        self.elem_var = elem_var
        self.body = body
        self.typ = ht.tarray(body.typ)

    @property
    def children(self):
        return (self.arr, self.zero, self.body)

    def map_children(self, f):
        return ArrayScan(f(self.arr), f(self.zero), self.accum_var, self.elem_var, f(self.body))

    def evaluate(self, env):
        col = self.arr.evaluate(env)
        zc = self.zero.evaluate(env)
        obj = C.to_object(col)
        zobj = C.to_object(zc).broadcast_to(obj.shape)
        out = np.empty(obj.shape, dtype=object)
        flat_arr = obj.values.ravel()
        flat_z = zobj.values.ravel()
        flat_out = out.ravel()
        et = self.arr.typ.element_type
        bt = self.body.typ
        for i in range(flat_arr.size):
            a = flat_arr[i]
            if a is None:
                flat_out[i] = None
                continue
            acc = flat_z[i]
            accs = [acc]
            for j, x in enumerate(a):
                acc = _eval_scalar_body(self.body, env,
                                        {self.accum_var: (bt, acc), self.elem_var: (et, x)},
                                        elem_index=j)
                accs.append(acc)
            flat_out[i] = accs
        return C.from_pylist(self.typ, list(flat_out)).reshape(obj.shape)


class ArraySlice(IR):
    def __init__(self, arr: IR, start: Optional[IR], stop: Optional[IR], step: Optional[IR] = None):
        self.arr = arr
        self.start = start
        self.stop = stop
        self.step = step
        self.typ = arr.typ

    @property
    def children(self):
        return tuple(x for x in (self.arr, self.start, self.stop, self.step) if x is not None)

    def evaluate(self, env):
        col = self.arr.evaluate(env)
        obj = C.to_object(col)
        sc = self.start.evaluate(env) if self.start is not None else None
        ec = self.stop.evaluate(env) if self.stop is not None else None
        stc = self.step.evaluate(env) if self.step is not None else None
        def get(c, i):
            if c is None:
                return None
            v = C.to_object(c).broadcast_to(obj.shape).values.ravel()[i]
            return v
        out = np.empty(obj.shape, dtype=object)
        flat = obj.values.ravel()
        fo = out.ravel()
        for i in range(flat.size):
            v = flat[i]
            if v is None:
                fo[i] = None
                continue
            step = get(stc, i)
            if step == 0:
                from ..utils.java import HailUserError
                raise HailUserError('step cannot be 0 for array slice')
            fo[i] = list(v)[slice(get(sc, i), get(ec, i), step)]
        return C.from_pylist(self.typ, list(fo)).reshape(obj.shape)


class ToSet(IR):
    def __init__(self, arr: IR):
        self.arr = arr
        et = arr.typ.element_type
        self.typ = ht.tset(et)

    @property
    def children(self):
        return (self.arr,)

    def map_children(self, f):
        return ToSet(f(self.arr))

    def evaluate(self, env):
        col = self.arr.evaluate(env)
        obj = C.to_object(col)
        from ..utils.structs import freeze

        vals = np.frompyfunc(
            lambda v: None if v is None else frozenset(freeze(e) for e in v),
            1, 1)(obj.values)
        return ObjectColumn(self.typ, vals)


class ToArray(IR):
    def __init__(self, x: IR):
        self.x = x
        if isinstance(x.typ, ht.tset):
            self.typ = ht.tarray(x.typ.element_type)
        elif isinstance(x.typ, ht.tdict):
            # reference hl.array(dict) yields (key, value) tuples
            self.typ = ht.tarray(ht.ttuple(x.typ.key_type, x.typ.value_type))
        else:
            self.typ = x.typ

    @property
    def children(self):
        return (self.x,)

    def map_children(self, f):
        return ToArray(f(self.x))

    def evaluate(self, env):
        col = self.x.evaluate(env)
        obj = C.to_object(col)
        def conv(v):
            if v is None:
                return None
            if isinstance(v, (frozenset, set)):
                try:
                    return sorted(v, key=lambda x: (x is None, x))
                except TypeError:  # unorderable elements (Call, Struct, ...)
                    return sorted(v, key=lambda x: (x is None, str(x)))
            if hasattr(v, 'items'):
                return [(k, x) for k, x in v.items()]
            return list(v)
        return ObjectColumn(self.typ, np.frompyfunc(conv, 1, 1)(obj.values))


def _object_lambda(node, col: Column, env: EvalEnv, mode: str) -> Column:
    obj = C.to_object(col)
    # a row-dependent body must be evaluated per environment position even
    # when the array itself is row-independent (shape (1,)) — broadcast the
    # array over the env shape rather than collapsing to one evaluation
    full_shape = np.broadcast_shapes(obj.shape, env.shape) if env.shape else obj.shape
    vals = np.broadcast_to(obj.values, full_shape)
    out = np.empty(full_shape, dtype=object)
    flat = vals.ravel()
    fo = out.ravel()
    et = node.arr.typ.element_type
    for i in range(flat.size):
        v = flat[i]
        if v is None:
            fo[i] = None
            continue
        elems = sorted(v, key=_sort_key) if isinstance(v, (set, frozenset)) else list(v)
        res = []
        for j, x in enumerate(elems):
            r = _eval_scalar_body(node.body, env, {node.var: (et, x)},
                                  flat_index=i, full_shape=full_shape, elem_index=j)
            if mode == 'map':
                res.append(r)
            elif mode == 'filter':
                if r is True:
                    res.append(x)
        fo[i] = frozenset(res) if isinstance(node.typ, ht.tset) else res
    return C.from_pylist(node.typ, list(fo)).reshape(full_shape)


def _sort_key(x):
    import functools
    from ..expr.functions import _cmp_values
    return functools.cmp_to_key(_cmp_values)(x)


def _eval_scalar_body(body: IR, env: EvalEnv, extra: dict,
                      flat_index: Optional[int] = None,
                      full_shape=None, elem_index: Optional[int] = None):
    """Evaluate `body` for a single element: bindings become length-1 columns."""
    bindings = {}
    for k, c in env.bindings.items():
        if flat_index is not None:
            if full_shape is not None and tuple(c.shape) != tuple(full_shape):
                c = c.broadcast_to(full_shape) if hasattr(c, 'broadcast_to') else c
            flatc = c.reshape((int(np.prod(c.shape)),)) if int(np.prod(c.shape)) > 1 else c.reshape((c.length if c.shape else 1,))
            idx = min(flat_index, flatc.length - 1)
            bindings[k] = flatc.gather(np.asarray([idx]))
        else:
            bindings[k] = c.reshape((int(np.prod(c.shape)),)).gather(np.asarray([0]))
    if elem_index is not None:
        # uid words gain the element index (reference stream-uid appending);
        # the mixed single-word __row_idx__ stays for legacy consumers. In a
        # scalar/eval context with no row uid, the element index is the
        # whole message.
        k = 0
        while f'__uid_w{k}__' in bindings:
            k += 1
        if k == 0 and '__row_idx__' in bindings:
            base = np.asarray(bindings['__row_idx__'].values).ravel()
            bindings['__uid_w0__'] = PrimitiveColumn(ht.tint64, base.copy())
            k = 1
        bindings[f'__uid_w{k}__'] = PrimitiveColumn(
            ht.tint64, np.asarray([elem_index], dtype=np.int64))
        if '__row_idx__' in bindings:
            base = np.asarray(bindings['__row_idx__'].values).ravel()
            bindings['__row_idx__'] = PrimitiveColumn(
                ht.tint64, _mix_uid(base, np.asarray([elem_index], dtype=np.int64)))
    for k, (t, v) in extra.items():
        bindings[k] = C.from_pylist(t, [v])
    scalar_env = EvalEnv(bindings, (1,))
    res = body.evaluate(scalar_env)
    lst = res.to_pylist()
    return lst[0] if lst else None
