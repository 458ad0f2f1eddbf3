"""Builtin function library (`hl.*`).

Capability parity with the reference's ~400 builtins
(`hail/python/hail/expr/functions.py` + `is/hail/expr/ir/functions/`):
each function builds an `Apply` IR node with a vectorized columnar impl.
Fresh implementation; scipy provides the statistical distributions the
reference gets from Apache commons-math.
"""

from __future__ import annotations

import json as _json
import math
import re as _re
from typing import Any, Optional, Sequence, Union

import numpy as np

from .. import types as ht
from ..genetics.call import Call
from ..genetics.locus import Locus
from ..genetics import allele_type as _at  # module, not the function
from importlib import import_module as _imp
_at = _imp("hail_tpu_torch.genetics.allele_type")
from ..utils.structs import Interval, Struct, frozendict
from ..ir import columns as C
from ..ir.columns import (Column, DenseArrayColumn, LocusColumn, ObjectColumn,
                          PrimitiveColumn, StructColumn)
from ..ir.nodes import (IR, Apply, Cast, Coalesce, If, IsMissing, Literal,
                        MakeArray, MakeStruct, MakeTuple, NA, Ref, RngUidTuple, RowIndex,
                        eval_binop)
from ..ir import arrays as ira
from .expression import (ArrayExpression, BooleanExpression, CallExpression,
                         Expression, Indices, StructExpression, construct_expr,
                         eval_scalar, impute_type, to_expr, unify_all, _fresh_name)

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _apply(name: str, result_typ: ht.HailType, impl, *exprs: Expression) -> Expression:
    exprs = [to_expr(e) for e in exprs]
    ind = unify_all(*exprs)
    return construct_expr(Apply(name, result_typ, [e._ir for e in exprs], impl), ind)


def _obj_ufunc(f, *cols: Column):
    objs = [C.to_object(c) for c in cols]
    shape = np.broadcast_shapes(*[o.shape for o in objs])
    vals = [np.broadcast_to(o.values, shape) for o in objs]
    return np.frompyfunc(f, len(cols), 1)(*vals), shape


def _obj_impl(result_typ: ht.HailType, f):
    """Build an impl applying python f elementwise (None-propagating unless f
    handles None itself when `strict=False`)."""
    def impl(*cols):
        def g(*vs):
            if any(v is None for v in vs):
                return None
            return f(*vs)
        vals, shape = _obj_ufunc(g, *cols)
        return C.from_pylist(result_typ, list(vals.ravel())).reshape(shape)
    return impl


def _obj_impl_lenient(result_typ: ht.HailType, f):
    def impl(*cols):
        vals, shape = _obj_ufunc(f, *cols)
        return C.from_pylist(result_typ, list(vals.ravel())).reshape(shape)
    return impl


def _prim_impl(result_typ: ht.HailType, npf, domain_check=None):
    """Numeric unary/n-ary impl: vectorized over PrimitiveColumns."""
    def impl(*cols):
        if all(isinstance(c, PrimitiveColumn) for c in cols):
            shape = np.broadcast_shapes(*[c.shape for c in cols])
            vals = [np.broadcast_to(c.values, shape) for c in cols]
            with np.errstate(all='ignore'):
                out = npf(*[v.astype(np.float64) if v.dtype != np.float64 and result_typ in (ht.tfloat64,) else v for v in vals])
            missing = None
            for c in cols:
                missing = C._merge_missing(missing, np.broadcast_to(c.missing, shape) if c.missing is not None else None)
            if result_typ.numpy_dtype is not None and out.dtype != result_typ.numpy_dtype:
                out = out.astype(result_typ.numpy_dtype)
            return PrimitiveColumn(result_typ, out, missing)
        return _obj_impl(result_typ, lambda *vs: npf(*vs))(*cols)
    return impl


# ---------------------------------------------------------------------------
# core constructors / control flow
# ---------------------------------------------------------------------------

def _free_refs(ir, bound=frozenset()):
    out = set()
    if isinstance(ir, Ref):
        if ir.name not in bound:
            out.add(ir.name)
        return out
    binders = set()
    for attr in ('var', 'accum_var', 'elem_var'):
        v = getattr(ir, attr, None)
        if isinstance(v, str):
            binders.add(v)
    if type(ir).__name__ == 'Let':
        v = getattr(ir, 'name', None)
        if isinstance(v, str):
            binders.add(v)
    b = bound | binders
    for ch in ir.children:
        out |= _free_refs(ch, b)
    return out


def _sanitize_missing(value):
    """Map pandas NA (and friends) to None recursively so host values from
    to_pandas round-trip through literals."""
    try:
        import pandas as pd
        na = pd.NA
    except Exception:
        return value
    if value is na:
        return None
    if isinstance(value, list):
        return [_sanitize_missing(v) for v in value]
    if isinstance(value, tuple):
        return _bi.tuple(_sanitize_missing(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return _bi.frozenset(_sanitize_missing(v) for v in value)
    if isinstance(value, dict):
        return {k: _sanitize_missing(v) for k, v in value.items()}
    return value


def literal(value: Any, dtype: Optional[ht.HailType] = None) -> Expression:
    if not isinstance(value, Expression):
        value = _sanitize_missing(value)
    if isinstance(value, Expression):
        # reference python/hail/expr/functions.py:393-442: an expression with
        # free variables cannot be captured as a literal; a bound scalar/global
        # expression is evaluated and re-broadcast
        if _free_refs(value._ir):
            raise ValueError(
                "'literal' cannot be used with hail expressions that depend "
                "on other expressions. Use expression 'x' directly "
                "instead of passing it to 'literal'.")
        if value._indices is not None and getattr(value._indices, 'axes', None):
            from .typefuncs import ExpressionException
            raise ExpressionException(
                f"'literal' can only accept scalar or global expression arguments,"
                f" found indices {value._indices.axes}")
    return to_expr(value, dtype)


def missing(dtype) -> Expression:
    return construct_expr(NA(ht.dtype(dtype)))


null = missing


def str_(x) -> Expression:
    e = to_expr(x)
    if e.dtype == ht.tstr:
        return e
    if isinstance(e.dtype, (ht.tstruct, ht.ttuple, ht.tarray, ht.tset,
                            ht.tdict, ht.tinterval)) or isinstance(
            e.dtype, ht.tndarray):
        # containers stringify as compact JSON (reference str doctest:
        # hl.str(struct(a=5, b=7)) == '{"a":5,"b":7}')
        return json(e)
    return construct_expr(Cast(e._ir, ht.tstr), e._indices)


def bool_(x) -> Expression:
    e = to_expr(x)
    if e.dtype == ht.tstr:
        return _apply('to_bool', ht.tbool, _obj_impl(ht.tbool, lambda s: {'true': True, 'false': False}[s.lower()]), e)
    return construct_expr(Cast(e._ir, ht.tbool), e._indices)


def _num_conv(name, t):
    def f(x) -> Expression:
        e = to_expr(x)
        if e.dtype == t:
            return e
        if e.dtype == ht.tstr:
            import builtins
            pyt = builtins.int if t in (ht.tint32, ht.tint64) else builtins.float
            return _apply(name, t, _obj_impl(t, lambda s: pyt(s)), e)
        return construct_expr(Cast(e._ir, t), e._indices)
    return f


int32 = _num_conv('to_int32', ht.tint32)
int64 = _num_conv('to_int64', ht.tint64)
float32 = _num_conv('to_float32', ht.tfloat32)
float64 = _num_conv('to_float64', ht.tfloat64)
int = int32
float = float64


def if_else(condition, consequent, alternate, missing_false: bool = False) -> Expression:
    c = to_expr(condition)
    if missing_false:
        c = coalesce(c, False)
    a = to_expr(consequent)
    try:
        b = to_expr(alternate, a.dtype)
    except Exception:
        b = to_expr(alternate)
    ind = unify_all(c, a, b)
    return construct_expr(If(c._ir, a._ir, b._ir), ind)


cond = if_else


def coalesce(*args) -> Expression:
    exprs = [to_expr(a) for a in args]
    t = exprs[0].dtype
    for e in exprs[1:]:
        u = ht.unify_types(t, e.dtype)
        if u is None:
            raise TypeError(f'coalesce: cannot unify types {t} and {e.dtype}')
        t = u
    exprs = [_numeric_cast(e, t) for e in exprs]
    ind = unify_all(*exprs)
    return construct_expr(Coalesce([e._ir for e in exprs]), ind)


def _numeric_cast(e, t):
    if e.dtype == t:
        return e
    if t == ht.tfloat64:
        return float64(e)
    if t == ht.tfloat32:
        return float32(e)
    if t == ht.tint64:
        return int64(e)
    if t == ht.tint32:
        return int32(e)
    return e


def or_else(a, b) -> Expression:
    return coalesce(a, b)


def or_missing(predicate, value) -> Expression:
    p = to_expr(predicate)
    v = to_expr(value)
    return if_else(p, v, missing(v.dtype))


def is_missing(expr) -> BooleanExpression:
    return to_expr(expr).is_missing()


def is_defined(expr) -> BooleanExpression:
    return to_expr(expr).is_defined()


class CaseBuilder:
    """hl.case().when(c, v).when(...).default(v) / .or_missing()"""

    def __init__(self, missing_false=False):
        self._cases = []
        self._missing_false = missing_false

    def when(self, condition, value) -> 'CaseBuilder':
        self._cases.append((condition, value))
        return self

    def default(self, value) -> Expression:
        out = to_expr(value)
        for c, v in reversed(self._cases):
            out = if_else(c, v, out, missing_false=self._missing_false)
        return out

    def or_missing(self) -> Expression:
        t = to_expr(self._cases[-1][1]).dtype
        return self.default(missing(t))

    def or_error(self, message) -> Expression:
        """Raise HailUserError when no case matches (reference
        CaseBuilder.or_error)."""
        from ..utils.misc import HailUserError
        res = self.or_missing()
        # the else clause is only REACHED when every condition is literally
        # False — a missing condition makes the whole case missing (If(NA)
        # is NA in the engine), so it does not error
        reached_else = to_expr(True)
        for c, _ in self._cases:
            reached_else = reached_else & coalesce(~to_expr(c), False)
        msg = to_expr(message)
        t = res.dtype

        def impl(v, m, mg):
            if m is True:
                raise HailUserError(
                    f'Error summary: HailException: the else clause of'
                    f' .or_error("{mg}") was reached')
            return v
        return _apply('or_error', t, _obj_impl_lenient(t, impl), res, reached_else, msg)


def case(missing_false: bool = False) -> CaseBuilder:
    return CaseBuilder(missing_false)


class SwitchBuilder:
    def __init__(self, expr):
        self._base = to_expr(expr)
        self._cases = []
        self._default = None

    def when(self, value, then) -> 'SwitchBuilder':
        self._cases.append((value, then))
        return self

    def when_missing(self, then) -> 'SwitchBuilder':
        self._missing = then
        return self

    def default(self, value) -> Expression:
        out = to_expr(value)
        for v, then in reversed(self._cases):
            out = if_else(self._base == v, then, out, missing_false=True)
        # a missing subject matches no case: result is missing unless
        # when_missing was given (reference SwitchBuilder semantics)
        if hasattr(self, '_missing'):
            out = if_else(self._base.is_missing(), self._missing, out)
        else:
            out = if_else(self._base.is_missing(), missing(out.dtype), out)
        return out

    def or_missing(self) -> Expression:
        t = to_expr(self._cases[-1][1]).dtype
        return self.default(missing(t))

    def or_error(self, message) -> Expression:
        from ..utils.misc import HailUserError
        res = self.or_missing()
        matched = self._base.is_missing() if hasattr(self, '_missing') \
            else to_expr(False)
        for v, _ in self._cases:
            matched = matched | coalesce(self._base == v, False)
        msg = to_expr(message)
        t = res.dtype

        def impl(r, m, mg):
            if m is not True:
                raise HailUserError(
                    f'Error summary: HailException: the else clause of'
                    f' .or_error("{mg}") was reached')
            return r
        return _apply('or_error', t, _obj_impl_lenient(t, impl), res, matched, msg)


def switch(expr) -> SwitchBuilder:
    return SwitchBuilder(expr)


_bind_counter = [0]


def _sub_refs(ir, mapping):
    from ..ir.nodes import Ref, AggOp, _AGGREGATOR_IR_ATTRS
    if isinstance(ir, Ref) and ir.name in mapping:
        return mapping[ir.name]
    if isinstance(ir, AggOp):
        agg2 = ir.aggregator
        held = [(a, getattr(agg2, a)) for a in _AGGREGATOR_IR_ATTRS
                if getattr(agg2, a, None) is not None]
        if held:
            import copy as _copy
            agg2 = _copy.copy(agg2)
            for a, h in held:
                setattr(agg2, a, _sub_refs(h, mapping))
        new = type(ir)(agg2, [_sub_refs(a, mapping) for a in ir.args],
                       ir.typ,
                       None if ir.filter_ir is None
                       else _sub_refs(ir.filter_ir, mapping),
                       ir.init_args)
        new.uid = ir.uid
        return new
    return ir.map_children(lambda c: _sub_refs(c, mapping))


def bind(f, *exprs, _ctx=None):
    """hl.bind(f, *args): apply f to expressions. A bound variable may not
    be referenced inside an aggregation (reference scope rule,
    test_aggregator_bindings) unless `_ctx='agg'/'scan'` opts in."""
    from ..ir.nodes import AggOp, Ref, walk_ir
    from .typefuncs import ExpressionException
    exprs_ = [to_expr(e) for e in exprs]
    # a tail-loop recur result may not be bound as a value (reference
    # loop.py check_tail_recursive on ir.Let)
    if _bi.any(getattr(n, '_is_recur', False)
               for e in exprs_ for n in walk_ir(e._ir)):
        raise TypeError("bound value used in other expression can't contain "
                        "recursive call!")
    _bind_counter[0] += 1
    names = [f'__bind_{_bind_counter[0]}_{i}' for i in range(_bi.len(exprs_))]
    vars_ = [construct_expr(Ref(n, e.dtype), e._indices)
             for n, e in zip(names, exprs_)]
    body = to_expr(f(*vars_))
    if _ctx is None:
        nameset = _bi.set(names)
        has_agg = _bi.any(isinstance(n, AggOp) for n in walk_ir(body._ir))
        refs_var = _bi.any(isinstance(n, Ref) and n.name in nameset
                           for n in walk_ir(body._ir))
        if has_agg and refs_var:
            # a bind variable may not cross an aggregation boundary in
            # either direction (reference scope rule,
            # test_aggregator_bindings); _ctx='agg'/'scan' opts in
            raise ExpressionException(
                'dynamic variables created by hl.bind or lambda methods '
                'cannot be aggregated')
    sub_map = {n: e._ir for n, e in zip(names, exprs_)}
    out_ir = _sub_refs(body._ir, sub_map)
    return construct_expr(out_ir, unify_all(body, *exprs_))


def rbind(*exprs_and_f, _ctx=None):
    *exprs, f = exprs_and_f
    return bind(f, *exprs, _ctx=_ctx)


def struct(**kwargs) -> StructExpression:
    exprs = {k: to_expr(v) for k, v in kwargs.items()}
    ind = unify_all(*exprs.values()) if exprs else Indices()
    return construct_expr(MakeStruct({k: e._ir for k, e in exprs.items()}), ind)


def tuple_(iterable) -> Expression:
    exprs = [to_expr(v) for v in iterable]
    return construct_expr(MakeTuple([e._ir for e in exprs]), unify_all(*exprs))


def array(collection) -> ArrayExpression:
    if isinstance(collection, Expression):
        if isinstance(collection.dtype, ht.tarray):
            return collection
        if isinstance(collection.dtype, ht.tdict):
            # dicts convert to (key, value) tuple arrays (reference hl.array)
            return collection.items()
        if isinstance(collection.dtype, ht.tndarray):
            if collection.dtype.ndim != 1:
                raise ValueError(
                    f"array: only one dimensional ndarrays are supported: {collection.dtype}")
            return collection._to_array()
        return construct_expr(ira.ToArray(collection._ir), collection._indices)
    if isinstance(collection, (dict, frozendict)):
        return array([tuple_([to_expr(k), to_expr(v)])
                      for k, v in collection.items()])
    if isinstance(collection, (set, frozenset)):
        # set -> array comes out in the engine's set order: sorted
        # (reference hl.array doctest: ['Alice', 'Bob', 'Charlie'])
        e = to_expr(frozenset(collection))
        return construct_expr(ira.ToArray(e._ir), e._indices)
    if isinstance(collection, (list, tuple, np.ndarray)):
        if any(isinstance(v, Expression) for v in collection):
            exprs = []
            t = ht.unify_types(*[to_expr(v).dtype for v in collection if v is not None])
            for v in collection:
                exprs.append(to_expr(v, t) if v is not None else missing(t))
            return construct_expr(MakeArray([e._ir for e in exprs], ht.tarray(t)), unify_all(*exprs))
        return to_expr(list(collection))
    return to_expr(list(collection))


def set_(collection) -> Expression:
    a = array(collection) if not isinstance(collection, (set, frozenset)) else to_expr(frozenset(collection))
    if isinstance(a.dtype, ht.tset):
        return a
    return construct_expr(ira.ToSet(a._ir), a._indices)


def dict_(collection) -> Expression:
    if isinstance(collection, (dict, frozendict)):
        if _bi.any(isinstance(k, Expression) or isinstance(v, Expression)
                   for k, v in collection.items()):
            # expression keys/values (e.g. a missing key) build through the
            # pair-array path
            collection = [tuple_([to_expr(k), to_expr(v)])
                          for k, v in collection.items()]
        else:
            return to_expr(frozendict(collection))
    a = array(collection)
    et = a.dtype.element_type
    if isinstance(et, ht.ttuple):
        kt, vt = et[0], et[1]
    else:
        kt, vt = et.fields['key'], et.fields['value']
    def impl(col):
        from ..utils.structs import freeze
        obj = C.to_object(col)
        def f(v):
            if v is None:
                return None
            # dict KEYS must be hashable; values keep their python form
            # (reference freezes values only when the dict itself lands in a
            # set — handled by freeze() at that point). Materialized dicts
            # iterate in key order (the engine's ordered-map semantics).
            from functools import cmp_to_key
            d = {freeze(p[0]): p[1] for p in v}
            return frozendict(sorted(
                d.items(), key=cmp_to_key(lambda x, y: _cmp_values(x[0], y[0]))))
        return ObjectColumn(ht.tdict(kt, vt), np.frompyfunc(f, 1, 1)(obj.values))
    return _apply('dict', ht.tdict(kt, vt), impl, a)


def empty_array(t) -> Expression:
    return to_expr([], ht.tarray(ht.dtype(t)))


def empty_set(t) -> Expression:
    return construct_expr(ira.ToSet(empty_array(t)._ir))


def empty_dict(kt, vt) -> Expression:
    return literal(frozendict({}), ht.tdict(ht.dtype(kt), ht.dtype(vt)))


def range_(start, stop=None, step=1) -> ArrayExpression:
    if stop is None:
        start, stop = 0, start
    s, e, st = to_expr(start), to_expr(stop), to_expr(step)

    def f(a, b, c):
        if c == 0:
            from ..utils.misc import HailUserError
            raise HailUserError('Array range cannot have step size 0')
        return list(range(a, b, c))
    impl = _obj_impl(ht.tarray(ht.tint32), f)
    return _apply('range', ht.tarray(ht.tint32), impl, s, e, st)


def len_(x) -> Expression:
    e = to_expr(x)
    if e.dtype == ht.tstr:
        return e.length()
    return construct_expr(ira.ArrayLen(ira.ToArray(e._ir)), e._indices)


# ---------------------------------------------------------------------------
# numeric math
# ---------------------------------------------------------------------------

def _unary_math(name, npf, result=ht.tfloat64):
    def f(x):
        e = to_expr(x)
        if isinstance(e.dtype, ht.tndarray):
            # numeric functions broadcast over ndarrays (reference
            # @ndarray_broadcasting on hl.sqrt/log/floor/...)
            from . import ndarrays as nds
            return nds.nd_elementwise_unary(name, npf, e, result)
        return _apply(name, result, _prim_impl(result, npf), e)
    f.__name__ = name
    return f


exp = _unary_math('exp', np.exp)
log10 = _unary_math('log10', np.log10)
sqrt = _unary_math('sqrt', np.sqrt)
# scalar libm exp: numpy's SIMD exp differs from the JVM in the last ulp
def _scalar_exp(x):
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf


expit = _unary_math('expit', lambda v: 1.0 / (1.0 + np.frompyfunc(
    _scalar_exp, 1, 1)(-np.asarray(v, np.float64)).astype(np.float64)))
logit = _unary_math('logit', lambda v: np.log(v / (1.0 - v)))
floor = _unary_math('floor', np.floor)
ceil = _unary_math('ceil', np.ceil)
is_nan = _unary_math('is_nan', np.isnan, ht.tbool)
is_finite = _unary_math('is_finite', np.isfinite, ht.tbool)
is_infinite = _unary_math('is_infinite', np.isinf, ht.tbool)
acos = _unary_math('acos', np.arccos)
asin = _unary_math('asin', np.arcsin)
atan = _unary_math('atan', np.arctan)
cos = _unary_math('cos', np.cos)
sin = _unary_math('sin', np.sin)
tan = _unary_math('tan', np.tan)
cosh = _unary_math('cosh', np.cosh)
sinh = _unary_math('sinh', np.sinh)
tanh = _unary_math('tanh', np.tanh)


def log(x, base=None):
    e = to_expr(x)
    if isinstance(e.dtype, ht.tndarray):
        from . import ndarrays as nds
        if base is None:
            return nds.nd_elementwise_unary('log', np.log, e)
        b = base
        return nds.nd_elementwise_unary('log', lambda v: np.log(v) / np.log(b), e)
    if base is None:
        return _apply('log', ht.tfloat64, _prim_impl(ht.tfloat64, np.log), e)
    return _apply('log', ht.tfloat64,
                  _prim_impl(ht.tfloat64, lambda v, b: np.log(v) / np.log(b)),
                  e, to_expr(base))


def abs(x):
    e = to_expr(x)
    if isinstance(e.dtype, ht.tarray):
        return e.map(lambda v: abs(v))
    return _apply('abs', e.dtype, _prim_impl(e.dtype, np.abs), e)


def sign(x):
    e = to_expr(x)
    return _apply('sign', e.dtype, _prim_impl(e.dtype, np.sign), e)


def atan2(y, x):
    return _apply('atan2', ht.tfloat64, _prim_impl(ht.tfloat64, np.arctan2), to_expr(y), to_expr(x))


def _minmax_red(vals, is_min, filter_missing, ignore_nan):
    """Value-level min/max with the engine's missing/NaN rules: missing
    filtered (or poisoning when filter_missing=False); NaN propagates unless
    ignore_nan (hl.nanmin/nanmax)."""
    import math
    vals = _bi.list(vals)
    if not filter_missing and _bi.any(v is None for v in vals):
        return None
    vs = [v for v in vals if v is not None]
    if not vs:
        return None
    nans = [v for v in vs if isinstance(v, _bi.float) and math.isnan(v)]
    if nans:
        if not ignore_nan:
            return _bi.float('nan')
        vs = [v for v in vs if not (isinstance(v, _bi.float) and math.isnan(v))]
        if not vs:
            return _bi.float('nan')
    return (_bi.min if is_min else _bi.max)(vs)


def _minmax(name, npf, py_red, ignore_nan=False):
    is_min = name.endswith('min')

    def f(*exprs, filter_missing: bool = True):
        if _bi.len(exprs) == 1 and isinstance(to_expr(exprs[0]).dtype, (ht.tarray, ht.tset)):
            e = to_expr(exprs[0])
            et = e.dtype.element_type

            def impl(col):
                obj = C.to_object(col)
                out = np.frompyfunc(
                    lambda v: None if v is None else
                    _minmax_red(v, is_min, filter_missing, ignore_nan),
                    1, 1)(obj.values)
                return C.from_pylist(et, _bi.list(out.ravel())).reshape(obj.shape)
            return _apply(name, et, impl, e)
        es = [to_expr(x) for x in exprs]
        t = ht.unify_types(*[e.dtype for e in es])
        es = [_numeric_cast(e, t) for e in es]
        return _apply(name, t, _obj_impl_lenient(
            t, lambda *vs: _minmax_red(vs, is_min, filter_missing, ignore_nan)),
            *es)
    f.__name__ = name
    return f


import builtins as _bi

min = _minmax('min', np.min, _bi.min)
max = _minmax('max', np.max, _bi.max)


def sum_(collection, filter_missing: bool = True):
    e = to_expr(collection)
    et = e.dtype.element_type
    rt = et  # hl.sum preserves the element type (unlike agg.sum)
    def impl(col):
        if isinstance(col, DenseArrayColumn) and filter_missing:
            ok = np.arange(col.width)[None] < col.lengths.reshape(-1, 1)
            ok = ok.reshape(col.shape + (col.width,))
            if col.elem_missing is not None:
                ok = ok & ~col.elem_missing
            dt = rt.numpy_dtype if getattr(rt, 'numpy_dtype', None) is not None else np.float64
            vals = np.where(ok, col.values, 0).astype(dt)
            return PrimitiveColumn(rt, vals.sum(axis=-1, dtype=dt), col.missing)
        def f(v):
            if not filter_missing and _bi.any(x is None for x in v):
                return None
            return _bi.sum(x for x in v if x is not None)
        return _obj_impl_lenient(rt, lambda v: None if v is None else f(v))(col)
    return _apply('sum', rt, impl, e)


def product(collection, filter_missing: bool = True):
    e = to_expr(collection)
    et = e.dtype.element_type
    rt = et  # hl.product preserves the element type
    def f(v):
        if not filter_missing and _bi.any(x is None for x in v):
            return None
        return math.prod(x for x in v if x is not None)
    return _apply('product', rt,
                  _obj_impl_lenient(rt, lambda v: None if v is None else f(v)), e)


def mean(collection, filter_missing: bool = True):
    e = to_expr(collection)
    def impl(col):
        def f(v):
            if not filter_missing and _bi.any(x is None for x in v):
                return None
            vs = [x for x in v if x is not None]
            # mean of an empty collection is NaN (reference sum/length)
            return (_bi.sum(vs) / _bi.len(vs)) if vs else math.nan
        return _obj_impl_lenient(ht.tfloat64, lambda v: None if v is None else f(v))(col)
    return _apply('mean', ht.tfloat64, impl, e)


def median(collection, filter_missing: bool = True):
    """Median VALUE of the collection — the engine returns an element of
    the collection (element dtype; even counts take the lower middle:
    reference functions.py:5095 doctest median([1,3,5,6,7,9]) == 5)."""
    e = to_expr(collection)
    et = e.dtype.element_type
    def f(v):
        if not filter_missing and _bi.any(x is None for x in v):
            return None
        vs = sorted(x for x in v if x is not None)
        n = _bi.len(vs)
        if n == 0:
            return None
        return vs[(n - 1) // 2]
    return _apply('median', et,
                  _obj_impl_lenient(et, lambda v: None if v is None else f(v)), e)


def argmin(array_expr, unique: bool = False):
    e = to_expr(array_expr)
    def f(v):
        best, bi_, n_best = None, None, 0
        for i, x in enumerate(v):
            if x is None:
                continue
            if best is None or x < best:
                best, bi_, n_best = x, i, 1
            elif x == best:
                n_best += 1
        if unique and n_best > 1:
            return None
        return bi_
    return _apply('argmin', ht.tint32, _obj_impl_lenient(ht.tint32, f), e)


def argmax(array_expr, unique: bool = False):
    e = to_expr(array_expr)
    def f(v):
        best, bi_, n_best = None, None, 0
        for i, x in enumerate(v):
            if x is None:
                continue
            if best is None or x > best:
                best, bi_, n_best = x, i, 1
            elif x == best:
                n_best += 1
        if unique and n_best > 1:
            return None
        return bi_
    return _apply('argmax', ht.tint32, _obj_impl_lenient(ht.tint32, f), e)


# ---------------------------------------------------------------------------
# collections
# ---------------------------------------------------------------------------

def map_(f, *collections):
    if _bi.len(collections) == 1:
        return to_expr(collections[0]).map(f)
    arrs = [array(c) for c in collections]
    zipped = zip_(*arrs)
    return zipped.map(lambda t: f(*[t[i] for i in _bi.range(_bi.len(arrs))]))


def filter_(f, collection):
    return to_expr(collection).filter(f)


def flatmap(f, collection):
    e = to_expr(collection)
    res = flatten(e.map(f))
    # the result keeps the input's collection kind (reference flatmap)
    if isinstance(e.dtype, ht.tset) and not isinstance(res.dtype, ht.tset):
        return set_(res)
    return res


def flatten(collection):
    e = to_expr(collection)
    et = e.dtype.element_type
    as_set = isinstance(et, ht.tset)
    def f(v):
        out = []
        for x in v:
            if x is not None:
                out.extend(x)
        if as_set:
            from ..utils.structs import freeze
            return _bi.frozenset(freeze(x) for x in out)
        return out
    return _apply('flatten', et, _obj_impl(et, f), e)


def any_(*args):
    if args and _bi.callable(args[0]):
        f = args[0]
        return any_(*[map_(f, c) for c in args[1:]])
    if _bi.len(args) == 1 and isinstance(to_expr(args[0]).dtype, (ht.tarray, ht.tset)):
        e = to_expr(args[0])
        return _apply('array_any', ht.tbool, _obj_impl(ht.tbool, lambda v: _bi.any(x is True for x in v)), e)
    out = to_expr(False)
    for a in args:
        out = out | to_expr(a)
    return out


def all_(*args):
    if args and _bi.callable(args[0]):
        # hl.all(f, collection) maps the predicate first (reference hl.all)
        f = args[0]
        return all_(*[map_(f, c) for c in args[1:]])
    if _bi.len(args) == 1 and isinstance(to_expr(args[0]).dtype, (ht.tarray, ht.tset)):
        e = to_expr(args[0])
        return _apply('array_all', ht.tbool, _obj_impl(ht.tbool, lambda v: _bi.all(x is True for x in v)), e)
    out = to_expr(True)
    for a in args:
        out = out & to_expr(a)
    return out


def sorted_(collection, key=None, reverse=False):
    c = to_expr(collection)
    if isinstance(c.dtype, ht.tdict):
        # dicts sort as (key, value) tuples by key (reference hl.sorted)
        c = c.items()
    e = array(c)
    import functools
    kcmp = functools.cmp_to_key(_cmp_values)
    if key is None:
        def f(v):
            present = [x for x in v if x is not None]
            return _bi.sorted(present, key=kcmp, reverse=reverse) + \
                [None] * (_bi.len(v) - _bi.len(present))
        return _apply('sorted', e.dtype, _obj_impl(e.dtype, f), e)
    # sort by key expression: evaluate keys then sort (missing keys last)
    keyed = e.map(lambda x: struct(k=key(x), v=x))
    def f(v):
        present = [p for p in v if p['k'] is not None]
        rest = [p['v'] for p in v if p['k'] is None]
        return [p['v'] for p in _bi.sorted(present, key=lambda p: kcmp(p['k']),
                                           reverse=reverse)] + rest
    return _apply('sorted_by', e.dtype, _obj_impl(e.dtype, f), keyed)


def reversed_(collection):
    e = to_expr(collection)
    if e.dtype == ht.tstr:
        return _apply('reversed', ht.tstr, _obj_impl(ht.tstr, lambda s: s[::-1]), e)
    e = array(collection)
    return _apply('reversed', e.dtype, _obj_impl(e.dtype, lambda v: list(_bi.reversed(v))), e)


def zip_(*arrays, fill_missing: bool = False):
    es = [array(a) for a in arrays]
    t = ht.tarray(ht.ttuple(*[e.dtype.element_type for e in es]))
    def impl(*cols):
        objs = [C.to_object(c) for c in cols]
        shape = np.broadcast_shapes(*[o.shape for o in objs])
        vs = [np.broadcast_to(o.values, shape) for o in objs]
        out = np.empty(shape, dtype=object)
        fo = out.ravel()
        flats = [v.ravel() for v in vs]
        for i in _bi.range(fo.size):
            rows = [fv[i] for fv in flats]
            if any(r is None for r in rows):
                fo[i] = None
                continue
            if fill_missing:
                n = _bi.max(_bi.len(r) for r in rows)
                fo[i] = [tuple((r[j] if j < _bi.len(r) else None) for r in rows) for j in _bi.range(n)]
            else:
                fo[i] = [tuple(t_) for t_ in _bi.zip(*rows)]
        return ObjectColumn(t, out)
    return _apply('zip', t, impl, *es)


def enumerate_(collection, start=0, index_first=True):
    e = array(collection)
    et = e.dtype.element_type
    t = ht.tarray(ht.ttuple(ht.tint32, et) if index_first else ht.ttuple(et, ht.tint32))
    def f(v, s):
        if index_first:
            return [(i + s, x) for i, x in _bi.enumerate(v)]
        return [(x, i + s) for i, x in _bi.enumerate(v)]
    return _apply('enumerate', t, _obj_impl(t, f), e, to_expr(start))


zip_with_index = enumerate_


def delimit(collection, delimiter=',') -> Expression:
    e = array(collection)
    d = to_expr(delimiter)
    def f(v, dl):
        return dl.join('' if x is None else _bi.str(x) for x in v)
    return _apply('delimit', ht.tstr, _obj_impl(ht.tstr, f), e, d)


def group_by(f, collection):
    e = array(collection)
    et = e.dtype.element_type
    keyed = e.map(lambda x: struct(k=f(x), v=x))
    kt = keyed.dtype.element_type.fields['k']
    t = ht.tdict(kt, ht.tarray(et))
    def g(v):
        out = {}
        for p in v:
            out.setdefault(p['k'], []).append(p['v'])
        return frozendict(out)
    return _apply('group_by', t, _obj_impl(t, g), keyed)


def starmap(f, collection):
    e = array(collection)
    return e.map(lambda t: f(*[t[i] for i in _bi.range(_bi.len(e.dtype.element_type))]))


def keyed_intersection(*arrays, key):
    """Intersection of keyed struct arrays (reference hl.keyed_intersection)."""
    key = [key] if isinstance(key, str) else list(key)
    es = [array(a) for a in arrays]
    t = es[0].dtype
    def impl(*cols):
        objs = [C.to_object(c) for c in cols]
        shape = np.broadcast_shapes(*[o.shape for o in objs])
        flats = [np.broadcast_to(o.values, shape).ravel() for o in objs]
        out = np.empty(_bi.len(flats[0]), dtype=object)
        for i in _bi.range(_bi.len(flats[0])):
            rows_list = [f[i] for f in flats]
            if any(r is None for r in rows_list):
                out[i] = None
                continue
            keysets = [{tuple(x[k2] for k2 in key) for x in r} for r in rows_list[1:]]
            out[i] = [x for x in rows_list[0]
                      if _bi.all(tuple(x[k2] for k2 in key) in ks for ks in keysets)]
        return C.from_pylist(t, _bi.list(out)).reshape(shape)
    return _apply('keyed_intersection', t, impl, *es)


def keyed_union(*arrays, key):
    """Union of keyed struct arrays, first occurrence wins (reference
    hl.keyed_union)."""
    key = [key] if isinstance(key, str) else list(key)
    es = [array(a) for a in arrays]
    t = es[0].dtype
    def impl(*cols):
        objs = [C.to_object(c) for c in cols]
        shape = np.broadcast_shapes(*[o.shape for o in objs])
        flats = [np.broadcast_to(o.values, shape).ravel() for o in objs]
        out = np.empty(_bi.len(flats[0]), dtype=object)
        for i in _bi.range(_bi.len(flats[0])):
            seen = {}
            rows_list = [f[i] for f in flats]
            if _bi.all(r is None for r in rows_list):
                out[i] = None
                continue
            for r in rows_list:
                if r is None:
                    continue
                for x in r:
                    kt = tuple(x[k2] for k2 in key)
                    if kt not in seen:
                        seen[kt] = x
            # result is key-sorted (the engine merges sorted streams)
            import functools
            out[i] = [seen[k2] for k2 in
                      _bi.sorted(seen, key=functools.cmp_to_key(_cmp_values))]
        return C.from_pylist(t, _bi.list(out)).reshape(shape)
    return _apply('keyed_union', t, impl, *es)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------

def _string_method(expr, name, result_typ, *args):
    sargs = [a for a in args]
    if name == 'length':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s: _bi.len(s)), expr)
    if name == 'lower':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s: s.lower()), expr)
    if name == 'upper':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s: s.upper()), expr)
    if name == 'strip':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s: s.strip()), expr)
    if name == 'contains':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s, sub: sub in s), expr, to_expr(args[0]))
    if name == 'startswith':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s, p: s.startswith(p)), expr, to_expr(args[0]))
    if name == 'endswith':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s, p: s.endswith(p)), expr, to_expr(args[0]))
    if name == 'matches':
        regex, full = args
        if isinstance(regex, Expression):
            def f2(s, r):
                pat = _re.compile(r)
                return (pat.fullmatch(s) if full else pat.search(s)) is not None
            return _apply(name, result_typ, _obj_impl(result_typ, f2), expr, regex)
        pat = _re.compile(regex)
        f = (lambda s: pat.fullmatch(s) is not None) if full else (lambda s: pat.search(s) is not None)
        return _apply(name, result_typ, _obj_impl(result_typ, f), expr)
    if name == 'replace':
        pattern, repl = args
        pat = _re.compile(pattern)
        repl2 = _re.sub(r'\$(\d)', r'\\\1', repl)
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s: pat.sub(repl2, s)), expr)
    if name == 'split':
        delim, n = args
        return _apply(name, result_typ,
                      _obj_impl(result_typ,
                                lambda s, d: _re.split(d, s, maxsplit=(n - 1 if n else 0))),
                      expr, to_expr(delim))
    if name == 'first_match_in':
        pat = _re.compile(args[0])
        def f(s):
            m = pat.search(s)
            return None if m is None else list(m.groups())
        return _apply(name, result_typ, _obj_impl(result_typ, f), expr)
    if name == 'slice':
        start, stop, step = args
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s: s[start:stop:step]), expr)
    if name == 'index':
        i = args[0]
        if isinstance(i, Expression):
            return _apply(
                name, result_typ,
                _obj_impl(result_typ,
                          lambda s, ix: s[ix] if -_bi.len(s) <= ix < _bi.len(s) else None),
                expr, i)
        return _apply(name, result_typ, _obj_impl(result_typ, lambda s: s[i] if -_bi.len(s) <= i < _bi.len(s) else None), expr)
    raise ValueError(name)


def format(fmt, *args):
    """Java-Formatter-style string formatting with hail value rendering
    (reference hl.format / strFormat: missing prints 'null', booleans
    lowercase, structs `{k: v}`, arrays `[a,b]`, tuples `(a, b)`, loci
    contig:pos; %b/%B treat null as false and non-bool values as true)."""
    f = to_expr(fmt)
    es = [to_expr(a) for a in args]

    def render(v):
        if v is None:
            return 'null'
        if v is True:
            return 'true'
        if v is False:
            return 'false'
        if isinstance(v, Locus):
            return f'{v.contig}:{v.position}'
        if isinstance(v, Struct):
            return '{' + ', '.join(f'{k}: {render(x)}' for k, x in v.items()) + '}'
        if isinstance(v, list):
            return '[' + ','.join(render(x) for x in v) + ']'
        if isinstance(v, tuple):
            return '(' + ', '.join(render(x) for x in v) + ')'
        if isinstance(v, (frozendict, dict)):
            return '{' + ','.join(f'{render(k)}:{render(x)}' for k, x in v.items()) + '}'
        if isinstance(v, (frozenset, set)):
            return '{' + ','.join(render(x) for x in _bi.sorted(v, key=_bi.str)) + '}'
        return _bi.str(v)

    def impl(fc, *cols):
        def g(fv, *vs):
            s = fv
            for v in vs:
                m = _re.search(r'%[-#0-9.+ ]*[sdfexXobB]', s)
                if not m:
                    break
                spec = m.group(0)
                conv = spec[-1]
                if conv in 'bB':
                    rep = 'true' if (v is not None and v is not False) else 'false'
                    if conv == 'B':
                        rep = rep.upper()
                elif v is None:
                    rep = 'null'
                elif conv == 's':
                    rep = spec % render(v)
                else:
                    try:
                        rep = spec % v
                    except Exception:
                        rep = render(v)
                s = s[:m.start()] + rep + s[m.end():]
            return s
        vals, shape = _obj_ufunc(lambda fv, *vs: None if fv is None else g(fv, *vs), fc, *cols)
        return C.from_pylist(ht.tstr, list(vals.ravel())).reshape(shape)
    return _apply('format', ht.tstr, impl, f, *es)


def json(value) -> Expression:
    e = to_expr(value)
    def conv(v):
        if isinstance(v, Struct):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (frozendict, dict)):
            return {_bi.str(k): conv(x) for k, x in v.items()}
        if isinstance(v, (frozenset, set)):
            return _bi.sorted(conv(x) for x in v)
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, Call):
            return _bi.str(v)
        if isinstance(v, Locus):
            return {'contig': v.contig, 'position': v.position}
        from ..utils.structs import Interval as _Interval
        if isinstance(v, _Interval):
            return {'start': conv(v.start), 'end': conv(v.end),
                    'includeStart': v.includes_start, 'includeEnd': v.includes_end}
        if isinstance(v, (np.integer, np.floating, np.bool_)):
            return v.item()
        if isinstance(v, _bi.float) and (v != v or v in (_bi.float('inf'), _bi.float('-inf'))):
            return v
        return v
    return _apply('json', ht.tstr, _obj_impl(
        ht.tstr, lambda v: _json.dumps(conv(v), separators=(',', ':'))), e)


def hamming(s1, s2):
    return _apply('hamming', ht.tint32,
                  _obj_impl(ht.tint32, lambda a, b: _bi.sum(1 for x, y in _bi.zip(a, b) if x != y) if _bi.len(a) == _bi.len(b) else None),
                  to_expr(s1), to_expr(s2))


def entropy(s):
    def f(v):
        if not v:
            return 0.0
        counts = {}
        for ch in v:
            counts[ch] = counts.get(ch, 0) + 1
        n = _bi.len(v)
        # the engine's exact evaluation order (is/hail/stats/package.scala
        # entropy): (ln(n) - Σ c·ln(c) / n) / ln(2)
        acc = 0.0
        for c in counts.values():
            acc += c * math.log(c)
        return (math.log(n) - acc / n) / math.log(2)
    return _apply('entropy', ht.tfloat64, _obj_impl(ht.tfloat64, f), to_expr(s))


def reverse_complement(s, rna=False):
    comp = {'A': 'U' if rna else 'T', 'T': 'A', 'U': 'A', 'G': 'C', 'C': 'G', 'N': 'N',
            'a': 'u' if rna else 't', 't': 'a', 'u': 'a', 'g': 'c', 'c': 'g', 'n': 'n'}
    return _apply('reverse_complement', ht.tstr,
                  _obj_impl(ht.tstr, lambda v: ''.join(comp.get(ch, ch) for ch in _bi.reversed(v))),
                  to_expr(s))


def parse_int32(s):
    return _apply('parse_int32', ht.tint32, _obj_impl_lenient(ht.tint32, _lenient_parser(_bi.int)), to_expr(s))


def parse_int64(s):
    return _apply('parse_int64', ht.tint64, _obj_impl_lenient(ht.tint64, _lenient_parser(_bi.int)), to_expr(s))


def parse_float64(s):
    return _apply('parse_float64', ht.tfloat64, _obj_impl_lenient(ht.tfloat64, _lenient_parser(_bi.float)), to_expr(s))


parse_float = parse_float64
parse_int = parse_int32


def _lenient_parser(f):
    def g(v):
        if v is None:
            return None
        try:
            return f(v)
        except ValueError:
            return None
    return g


# ---------------------------------------------------------------------------
# collection method impls used by expression classes
# ---------------------------------------------------------------------------

def _deep_freeze(x):
    """Deep-freeze unhashable query values so membership queries against
    frozensets/dicts (whose elements are frozen at construction, see
    ir/arrays.py ToSet) hash correctly. Lists become frozenlist — NOT tuple —
    because stored elements are frozenlists and FrozenList.__eq__ accepts
    lists/FrozenLists but rejects tuples (a tuple query would hash to the
    right bucket yet compare unequal; reference test_mendel_errors_8 exercises
    this via set-of-(locus, alleles) containment)."""
    from ..utils.structs import frozenlist
    if isinstance(x, tuple):
        return tuple(_deep_freeze(e) for e in x)
    if isinstance(x, list):
        return frozenlist([_deep_freeze(e) for e in x])
    return x


def _hashed_lookup(op):
    def f(v, x):
        try:
            return op(v, x)
        except TypeError:
            return op(v, _deep_freeze(x))
    return f


def _sorted_by_key(it, key=None):
    import functools
    k = functools.cmp_to_key(_cmp_values)
    if key is None:
        return _bi.sorted(it, key=k)
    return _bi.sorted(it, key=lambda x: k(key(x)))


def _collection_method(expr, name, result_typ, *args):
    impls = {
        'contains': _hashed_lookup(lambda v, x: x in v),
        'append': lambda v, x: list(v) + [x],
        'extend': lambda v, x: list(v) + list(x),
        'index_of': lambda v, x: v.index(x) if x in v else None,
        'set_add': _hashed_lookup(lambda v, x: frozenset(v) | {x}),
        'set_remove': _hashed_lookup(lambda v, x: frozenset(v) - {x}),
        'set_union': lambda v, x: frozenset(v) | frozenset(x),
        'set_intersection': lambda v, x: frozenset(v) & frozenset(x),
        'set_difference': lambda v, x: frozenset(v) - frozenset(x),
        'set_is_subset': lambda v, x: frozenset(v) <= frozenset(x),
        'dict_get': _hashed_lookup(lambda v, x: v.get(x)),
        'dict_get_strict': _hashed_lookup(lambda v, x: v.get(x)),
        'dict_contains': _hashed_lookup(lambda v, x: x in v),
        # dict iteration order is key-sorted (engine dicts are sorted maps)
        'dict_keys': lambda v: _sorted_by_key(v.keys()),
        'dict_values': lambda v: [x[1] for x in _sorted_by_key(v.items(), key=lambda p: p[0])],
        'dict_items': lambda v: _sorted_by_key(v.items(), key=lambda p: p[0]),
        'dict_size': lambda v: _bi.len(v),
    }
    f = impls[name]
    if name == 'dict_get':
        impl = _obj_impl_lenient(
            result_typ,
            _hashed_lookup(lambda v, x: None if v is None else v.get(x)))
    elif name == 'dict_get_strict':
        def strict(v, x):
            if v is None:
                return None
            from ..utils.misc import HailUserError
            sentinel = _bi.object()
            out = v.get(x, sentinel)
            if out is sentinel:
                ks = 'NA' if x is None else repr(x)
                raise HailUserError(f'Key {ks} not found in dictionary')
            return out
        impl = _obj_impl_lenient(result_typ, _hashed_lookup(strict))
    else:
        impl = _obj_impl(result_typ, f)
    return _apply(name, result_typ, impl, expr, *args)


def _dict_map_values(expr, f):
    kt = expr.dtype.key_type
    vt_in = expr.dtype.value_type
    var = _fresh_name('v')
    velem = construct_expr(Ref(var, vt_in), expr._indices)
    body = to_expr(f(velem))
    vt = body.dtype
    items = _collection_method(expr, 'dict_items', ht.tarray(ht.ttuple(kt, vt_in)))
    mapped = items.map(lambda t: tuple_([t[0], f(t[1])]))
    return dict_(mapped)


# ---------------------------------------------------------------------------
# call / locus / interval / genetics methods
# ---------------------------------------------------------------------------

def _call_method(expr, name, result_typ, *args):
    from ..genetics import call as cc
    vec = {
        'ploidy': lambda p: (p & cc.PLOIDY_MASK).astype(np.int32),
        'phased': lambda p: (p & cc.PHASED_BIT) != 0,
        'n_alt_alleles': cc.calls_n_alt_alleles,
        'is_het': cc.calls_is_het,
        'is_hom_ref': cc.calls_is_hom_ref,
        'is_hom_var': cc.calls_is_hom_var,
        'is_het_ref': cc.calls_is_het_ref,
        'is_het_non_ref': cc.calls_is_het_non_ref,
        'is_non_ref': cc.calls_is_non_ref,
        'is_haploid': lambda p: (p & cc.PLOIDY_MASK) == 1,
        'is_diploid': lambda p: (p & cc.PLOIDY_MASK) == 2,
        'unphased_diploid_gt_index': cc.calls_unphased_diploid_gt_index,
    }
    if name in vec:
        f = vec[name]
        def impl(col):
            vals = f(col.values)
            if result_typ.numpy_dtype is not None and vals.dtype != result_typ.numpy_dtype:
                vals = vals.astype(result_typ.numpy_dtype)
            return PrimitiveColumn(result_typ, vals, col.missing)
        return _apply(name, result_typ, impl, expr)
    if name == 'allele_at':
        def impl(col, icol):
            from ..genetics.call import calls_allele_j, calls_allele_k, PLOIDY_MASK
            shape = np.broadcast_shapes(col.shape, icol.shape)
            p = np.broadcast_to(col.values, shape)
            i = np.broadcast_to(icol.values, shape)
            j = calls_allele_j(p)
            k = calls_allele_k(p)
            vals = np.where(i == 0, j, k).astype(np.int32)
            oob = (i < 0) | (i >= (p & PLOIDY_MASK))
            miss = C._merge_missing(C._merge_missing(
                _bcast_mask(col.missing, shape), _bcast_mask(icol.missing, shape)), oob)
            return PrimitiveColumn(ht.tint32, vals, miss)
        return _apply(name, result_typ, impl, expr, *args)
    if name == 'one_hot_alleles':
        def impl(col, ncol):
            from ..genetics.call import calls_allele_j, calls_allele_k, PLOIDY_MASK
            shape = np.broadcast_shapes(col.shape, ncol.shape)
            p = np.broadcast_to(col.values, shape).astype(np.int64)
            n = _bi.int(np.max(ncol.values)) if ncol.values.size else 2
            ploidy = p & PLOIDY_MASK
            j = calls_allele_j(p)
            k = calls_allele_k(p)
            out = np.zeros(shape + (n,), dtype=np.int32)
            oh_j = (np.arange(n) == j[..., None]) & (ploidy >= 1)[..., None]
            oh_k = (np.arange(n) == k[..., None]) & (ploidy == 2)[..., None]
            out = oh_j.astype(np.int32) + oh_k.astype(np.int32)
            lengths = np.broadcast_to(np.asarray(ncol.values), shape).astype(np.int32)
            miss = C._merge_missing(_bcast_mask(col.missing, shape), _bcast_mask(ncol.missing, shape))
            return DenseArrayColumn(ht.tarray(ht.tint32), out, lengths, None, miss)
        return _apply(name, result_typ, impl, expr, *args)
    raise ValueError(name)


def _bcast_mask(m, shape):
    return None if m is None else np.broadcast_to(m, shape)


def _locus_method(expr, name, result_typ, *args):
    rg = expr.dtype.reference_genome
    def impl(col: LocusColumn):
        if name == 'contig':
            arr = np.asarray(rg.contigs, dtype=object)[col.contig_idx]
            out = np.empty(col.shape, dtype=object)
            out[...] = arr
            if col.missing is not None:
                out[col.missing] = None
            return ObjectColumn(ht.tstr, out)
        if name == 'position':
            return PrimitiveColumn(ht.tint32, col.position, col.missing)
        if name == 'global_position':
            return PrimitiveColumn(ht.tint64, col.global_position(), col.missing)
        # boolean classifications — vectorized via per-contig lookup tables
        x_idx = np.asarray([rg.contig_index(c) for c in rg.x_contigs], dtype=np.int32)
        y_idx = np.asarray([rg.contig_index(c) for c in rg.y_contigs], dtype=np.int32)
        mt_idx = np.asarray([rg.contig_index(c) for c in rg.mt_contigs], dtype=np.int32)
        is_x = np.isin(col.contig_idx, x_idx)
        is_y = np.isin(col.contig_idx, y_idx)
        is_mt = np.isin(col.contig_idx, mt_idx)
        in_par = np.zeros(col.shape, dtype=bool)
        for (c0, s, c1, e) in rg._par_tuples:
            ci = rg.contig_index(c0)
            in_par |= (col.contig_idx == ci) & (col.position >= s) & (col.position < e)
        outv = {
            'in_autosome': ~(is_x | is_y | is_mt),
            'in_x_par': is_x & in_par,
            'in_x_nonpar': is_x & ~in_par,
            'in_y_par': is_y & in_par,
            'in_y_nonpar': is_y & ~in_par,
            'in_mito': is_mt,
        }[name]
        return PrimitiveColumn(ht.tbool, outv, col.missing)
    return _apply(name, result_typ, impl, expr)


def _interval_method(expr, name, result_typ, *args):
    if name in ('start', 'end', 'includes_start', 'includes_end'):
        attr = name
        return _apply(name, result_typ, _obj_impl(result_typ, lambda iv: getattr(iv, attr)), expr)
    if name == 'interval_contains':
        return _apply(name, result_typ, _obj_impl(result_typ, lambda iv, p: iv.contains(p)), expr, *args)
    if name == 'interval_overlaps':
        def f(a, b):
            return not (b.end < a.start or a.end < b.start
                        or (a.end == b.start and not (a.includes_end and b.includes_start))
                        or (b.end == a.start and not (b.includes_end and a.includes_start)))
        return _apply(name, result_typ, _obj_impl(result_typ, f), expr, *args)
    raise ValueError(name)


def interval(start, end, includes_start=True, includes_end=False):
    s = to_expr(start)
    e = to_expr(end)
    t = ht.tinterval(s.dtype)
    return _apply('interval', t,
                  _obj_impl(t, lambda a, b, cs, ce: Interval(a, b, cs, ce)),
                  s, e, to_expr(includes_start), to_expr(includes_end))


def locus_interval(contig, start, end, includes_start=True, includes_end=False,
                   reference_genome='default', invalid_missing=False):
    """Locus interval with the engine's canonicalization: endpoints are
    validated against contig bounds and normalized (reference
    ReferenceGenome.toLocusInterval, variant/ReferenceGenome.scala:227)."""
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    t = ht.tinterval(ht.tlocus(rg))

    def f(c, s, e):
        return rg.to_locus_interval(c, _bi.int(s), _bi.int(e),
                                    includes_start, includes_end,
                                    invalid_missing)
    return _apply('locus_interval', t, _obj_impl(t, f),
                  to_expr(contig), to_expr(start), to_expr(end))


def parse_locus_interval(s, reference_genome='default', invalid_missing=False):
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    t = ht.tinterval(ht.tlocus(rg))
    def f(v):
        # forms: contig:start-end, contig:start-contig2:end, contig (whole)
        inc_s, inc_e = True, False
        if v.startswith('['):
            inc_s = True
            v = v[1:]
        elif v.startswith('('):
            inc_s = False
            v = v[1:]
        if v.endswith(']'):
            inc_e = True
            v = v[:-1]
        elif v.endswith(')'):
            inc_e = False
            v = v[:-1]
        if '-' not in v:
            c = v
            return Interval(Locus(c, 1, rg), Locus(c, rg.contig_length(c), rg), True, True)
        a, b = v.rsplit('-', 1)
        if ':' not in a and ':' not in b and a in rg.contigs and b in rg.contigs:
            # whole-contig span 'c1-c2' (reference grammar): [c1:1, c2:END]
            return Interval(Locus(a, 1, rg),
                            Locus(b, rg.contig_length(b), rg), True, True)
        ca, pa = a.rsplit(':', 1)
        if ':' in b:
            cb, pb = b.rsplit(':', 1)
        else:
            cb = ca
            pb = b
        def parse_pos(contig, p):
            if p.lower() == 'start':
                return 1
            if p.lower() == 'end':
                return rg.contig_length(contig)
            mult = 1
            pl = p.lower()
            if pl.endswith('k'):
                mult, p = 1000, p[:-1]
            elif pl.endswith('m'):
                mult, p = 1000000, p[:-1]
            return _bi.int(_bi.float(p) * mult)
        if ca == cb:
            # same-contig intervals go through the canonicalizer so
            # invalid/empty forms normalize or go missing (reference
            # toLocusInterval)
            return rg.to_locus_interval(ca, parse_pos(ca, pa),
                                        parse_pos(cb, pb), inc_s, inc_e,
                                        invalid_missing)
        return Interval(Locus(ca, parse_pos(ca, pa), rg), Locus(cb, parse_pos(cb, pb), rg), inc_s, inc_e)
    return _apply('parse_locus_interval', t, _obj_impl(t, f), to_expr(s))


def locus(contig, pos, reference_genome='default'):
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    t = ht.tlocus(rg)
    c = to_expr(contig)
    p = to_expr(pos)
    def impl(ccol, pcol):
        shape = np.broadcast_shapes(ccol.shape, pcol.shape)
        cobj = np.broadcast_to(C.to_object(ccol).values, shape)
        cidx = np.frompyfunc(lambda v: 0 if v is None else rg.contig_index(v), 1, 1)(cobj).astype(np.int32)
        miss_c = np.frompyfunc(lambda v: v is None, 1, 1)(cobj).astype(_bi.bool)
        pv = np.broadcast_to(pcol.values, shape).astype(np.int32)
        miss = C._merge_missing(miss_c if miss_c.any() else None, _bcast_mask(pcol.missing, shape))
        return LocusColumn(t, cidx, pv, miss)
    return _apply('locus', t, impl, c, p)


def parse_locus(s, reference_genome='default'):
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    t = ht.tlocus(rg)
    return _apply('parse_locus', t, _obj_impl(t, lambda v: Locus.parse(v, rg)), to_expr(s))


def locus_from_global_position(gpos, reference_genome='default'):
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    t = ht.tlocus(rg)
    def impl(col):
        g = np.asarray(col.values, dtype=np.int64)
        offsets = np.asarray([rg._global_offsets[c] for c in rg.contigs], dtype=np.int64)
        cidx = (np.searchsorted(offsets, g, side='right') - 1).astype(np.int32)
        pos = (g - offsets[cidx] + 1).astype(np.int32)
        return LocusColumn(t, cidx, pos, col.missing)
    return _apply('locus_from_global_position', t, impl, to_expr(gpos))


def parse_variant(s, reference_genome='default'):
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    def f(v):
        parts = v.split(':')
        return Struct(locus=Locus(parts[0], _bi.int(parts[1]), rg), alleles=[parts[2]] + parts[3].split(','))
    return _apply('parse_variant', t, _obj_impl(t, f), to_expr(s))


def variant_str(*args):
    """contig:pos:ref:alt1,... string; accepts (locus, alleles) or a single
    struct{locus, alleles} (reference functions.py variant_str)."""
    if _bi.len(args) == 1:
        s = to_expr(args[0])
        locus_expr, alleles_expr = s.locus, s.alleles
    elif _bi.len(args) == 2:
        locus_expr, alleles_expr = to_expr(args[0]), to_expr(args[1])
    else:
        raise ValueError(
            'variant_str: expects either one struct{locus, alleles} '
            'argument or (locus, alleles) arguments')
    return (locus_expr.contig + ':' + str_(locus_expr.position) + ':'
            + alleles_expr[0] + ':' + delimit(alleles_expr[1:], ','))


def call(*alleles, phased=False) -> CallExpression:
    es = [to_expr(a) for a in alleles]
    ph = to_expr(phased) if isinstance(phased, Expression) else None
    def impl(*cols):
        from ..genetics.call import J_SHIFT, K_SHIFT, PHASED_BIT
        if ph is not None:
            ph_col, cols = cols[-1], cols[:-1]
        shape = np.broadcast_shapes(*[c.shape for c in cols]) if cols else (1,)
        if ph is not None:
            shape = np.broadcast_shapes(shape, ph_col.shape)
            phased_arr = np.broadcast_to(np.asarray(ph_col.values, dtype=bool), shape)
            base = _bi.len(cols) | np.where(phased_arr, PHASED_BIT, 0)
        else:
            base = _bi.len(cols) | (PHASED_BIT if phased else 0)
        packed = np.broadcast_to(np.asarray(base, dtype=np.int32), shape).copy() if ph is not None \
            else np.full(shape, base, dtype=np.int32)
        if _bi.len(cols) == 2:
            # unphased diploid calls are normalized j <= k (reference
            # Call.apply sorts unless phased)
            a0 = np.broadcast_to(cols[0].values, shape).astype(np.int32)
            a1 = np.broadcast_to(cols[1].values, shape).astype(np.int32)
            if ph is not None:
                unph = ~np.broadcast_to(np.asarray(ph_col.values, bool), shape)
            else:
                unph = not phased
            j = np.where(unph, np.minimum(a0, a1), a0)
            k = np.where(unph, np.maximum(a0, a1), a1)
            packed = packed | (j << J_SHIFT) | (k << K_SHIFT)
        elif _bi.len(cols) == 1:
            packed = packed | (np.broadcast_to(cols[0].values, shape).astype(np.int32) << J_SHIFT)
        miss = None
        for c in cols:
            miss = C._merge_missing(miss, _bcast_mask(c.missing, shape))
        if ph is not None:
            miss = C._merge_missing(miss, _bcast_mask(ph_col.missing, shape))
        return PrimitiveColumn(ht.tcall, packed.astype(np.int32), miss)
    args = es + ([ph] if ph is not None else [])
    return _apply('call', ht.tcall, impl, *args)


def unphased_diploid_gt_index_call(gt_index) -> CallExpression:
    e = to_expr(gt_index)
    def impl(col):
        from ..genetics.call import J_SHIFT, K_SHIFT
        g = np.asarray(col.values, dtype=np.int64)
        k = ((np.sqrt(8.0 * g + 1) - 1) / 2).astype(np.int64)
        j = g - k * (k + 1) // 2
        packed = (2 | (j.astype(np.int32) << J_SHIFT) | (k.astype(np.int32) << K_SHIFT)).astype(np.int32)
        return PrimitiveColumn(ht.tcall, packed, col.missing)
    return _apply('unphased_diploid_gt_index_call', ht.tcall, impl, e)


def _parse_call_str(v):
    phased = '|' in v
    sep = '|' if phased else '/'
    if v in ('.', './.', '.|.'):
        return None
    parts = v.split(sep)
    return Call([_bi.int(p) for p in parts if p != '.'], phased)


def parse_call(s) -> CallExpression:
    return _apply('parse_call', ht.tcall,
                  _obj_impl_lenient(ht.tcall, lambda v: None if v is None else _parse_call_str(v)),
                  to_expr(s))


def downcode(c, i):
    ce = to_expr(c)
    ie = to_expr(i)
    def impl(ccol, icol):
        from ..genetics.call import calls_allele_j, calls_allele_k, PLOIDY_MASK, PHASED_BIT, J_SHIFT, K_SHIFT
        shape = np.broadcast_shapes(ccol.shape, icol.shape)
        p = np.broadcast_to(ccol.values, shape)
        i_ = np.broadcast_to(icol.values, shape)
        j = np.where(calls_allele_j(p) == i_, 1, 0).astype(np.int32)
        k = np.where(calls_allele_k(p) == i_, 1, 0).astype(np.int32)
        packed = ((p & (PLOIDY_MASK | PHASED_BIT)) | (j << J_SHIFT) | (k << K_SHIFT)).astype(np.int32)
        miss = C._merge_missing(_bcast_mask(ccol.missing, shape), _bcast_mask(icol.missing, shape))
        return PrimitiveColumn(ht.tcall, packed, miss)
    return _apply('downcode', ht.tcall, impl, ce, ie)


# allele classification over (ref, alt) strings
def _allele_pair(name, f):
    def g(ref, alt):
        return _apply(name, ht.tbool, _obj_impl(ht.tbool, f), to_expr(ref), to_expr(alt))
    g.__name__ = name
    return g


is_snp = _allele_pair('is_snp', _at.is_snp)
is_mnp = _allele_pair('is_mnp', _at.is_mnp)
is_insertion = _allele_pair('is_insertion', _at.is_insertion)
is_deletion = _allele_pair('is_deletion', _at.is_deletion)
is_indel = _allele_pair('is_indel', _at.is_indel)
is_star = _allele_pair('is_star', _at.is_star)
is_complex = _allele_pair('is_complex', _at.is_complex)
is_transition = _allele_pair('is_transition', _at.is_transition)
is_transversion = _allele_pair('is_transversion', _at.is_transversion)


def allele_type(ref, alt):
    return _apply('allele_type', ht.tstr,
                  _obj_impl(ht.tstr, lambda r, a: _at.allele_type(r, a).pretty_name),
                  to_expr(ref), to_expr(alt))


def _resolve_rg(reference_genome):
    """Resolve 'default' / a name / a ReferenceGenome object."""
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    if reference_genome == 'default':
        return default_reference()
    if isinstance(reference_genome, _bi.str):
        return ReferenceGenome.get(reference_genome)
    return reference_genome


def is_valid_contig(contig, reference_genome='default'):
    rg = _resolve_rg(reference_genome)
    return _apply('is_valid_contig', ht.tbool, _obj_impl(ht.tbool, lambda c: rg.has_contig(c)), to_expr(contig))


def is_valid_locus(contig, position, reference_genome='default'):
    rg = _resolve_rg(reference_genome)
    return _apply('is_valid_locus', ht.tbool,
                  _obj_impl(ht.tbool, lambda c, p: rg.has_contig(c) and 1 <= p <= rg.contig_length(c)),
                  to_expr(contig), to_expr(position))


def contig_length(contig, reference_genome='default'):
    rg = _resolve_rg(reference_genome)
    return _apply('contig_length', ht.tint32, _obj_impl(ht.tint32, lambda c: rg.contig_length(c)), to_expr(contig))


def is_strand_ambiguous(ref, alt):
    pairs = {('A', 'T'), ('T', 'A'), ('G', 'C'), ('C', 'G')}
    return _apply('is_strand_ambiguous', ht.tbool,
                  _obj_impl(ht.tbool, lambda r, a: (r, a) in pairs),
                  to_expr(ref), to_expr(alt))


def _min_rep_py(lo, al):
    """Scalar minimal representation (reference
    `is/hail/variant/VariantMethods.minRep`); shared by the min_rep
    expression and host-side splitters."""
    from ..utils.misc import FatalError
    if lo is None or al is None:
        return None
    if not al:
        raise FatalError('min_rep: expect at least one allele')
    if _bi.any(a is None for a in al):
        raise FatalError('min_rep: found null allele')
    ref = al[0]
    # '*' (spanning deletion) alleles are excluded from trimming
    # (reference VariantMethods.minRep)
    alts = [a for a in al[1:] if a != '*']
    nonstar = [ref] + alts
    # trim right
    min_len = _bi.min([_bi.len(a) for a in nonstar])
    r = 0
    while r < min_len - 1 and _bi.all(
            a[_bi.len(a) - 1 - r] == ref[_bi.len(ref) - 1 - r] for a in alts):
        r += 1
    trimmed = [a if a == '*' else a[:_bi.len(a) - r] for a in al]
    # trim left
    ns_trimmed = [a for a in trimmed if a != '*']
    min_len = _bi.min([_bi.len(a) for a in ns_trimmed])
    l = 0
    while l < min_len - 1 and _bi.all(
            a[l] == ns_trimmed[0][l] for a in ns_trimmed[1:]):
        l += 1
    out = [a if a == '*' else a[l:] for a in trimmed]
    return Struct(locus=Locus(lo.contig, lo.position + l, lo.reference_genome), alleles=out)


def min_rep(locus_expr, alleles_expr):
    """Minimal representation of (locus, alleles) (reference
    `is/hail/variant/VariantMethods.minRep`)."""
    t = ht.tstruct(locus=locus_expr.dtype, alleles=ht.tarray(ht.tstr))
    def impl(lcol, acol):
        lobj = C.to_object(lcol)
        aobj = C.to_object(acol)
        shape = np.broadcast_shapes(lobj.shape, aobj.shape)
        lv = np.broadcast_to(lobj.values, shape)
        av = np.broadcast_to(aobj.values, shape)
        vals = np.frompyfunc(_min_rep_py, 2, 1)(lv, av)
        return C.from_pylist(t, list(vals.ravel())).reshape(shape)
    return _apply('min_rep', t, impl, locus_expr, alleles_expr)


# genotype-likelihood helpers
def pl_dosage(pl):
    """Expected dosage from phred-scaled likelihoods (biallelic)."""
    e = to_expr(pl)
    def impl(col):
        if isinstance(col, DenseArrayColumn):
            p = np.power(10.0, -col.values[..., :3].astype(np.float64) / 10.0)
            p = p / p.sum(axis=-1, keepdims=True)
            d = p[..., 1] + 2 * p[..., 2]
            miss = col.missing
            if col.elem_missing is not None:
                em = col.elem_missing[..., :3].any(axis=-1)
                miss = em if miss is None else (miss | em)
            return PrimitiveColumn(ht.tfloat64, d, miss)
        return _obj_impl(ht.tfloat64, lambda v: _pl_dosage_py(v))(col)
    return _apply('pl_dosage', ht.tfloat64, impl, e)


def _pl_dosage_py(v):
    if _bi.any(x is None for x in v[:3]):
        return None
    p = [10.0 ** (-x / 10.0) for x in v[:3]]
    s = _bi.sum(p)
    p = [x / s for x in p]
    return p[1] + 2 * p[2]


def gp_dosage(gp):
    e = to_expr(gp)
    def impl(col):
        if isinstance(col, DenseArrayColumn):
            d = col.values[..., 1].astype(np.float64) + 2 * col.values[..., 2].astype(np.float64)
            return PrimitiveColumn(ht.tfloat64, d, col.missing)
        return _obj_impl(ht.tfloat64, lambda v: v[1] + 2 * v[2])(col)
    return _apply('gp_dosage', ht.tfloat64, impl, e)


def plToGP(pl):
    e = to_expr(pl)
    t = ht.tarray(ht.tfloat64)
    def impl(col):
        if isinstance(col, DenseArrayColumn):
            p = np.power(10.0, -col.values.astype(np.float64) / 10.0)
            p = p / p.sum(axis=-1, keepdims=True)
            return DenseArrayColumn(t, p, col.lengths, col.elem_missing, col.missing)
        def f(v):
            p = [10.0 ** (-x / 10.0) for x in v]
            s = _bi.sum(p)
            return [x / s for x in p]
        return _obj_impl(t, f)(col)
    return _apply('pl_to_gp', t, impl, e)


pl_to_gp = plToGP


# ---------------------------------------------------------------------------
# statistics (scipy-backed; reference uses commons-math/custom)
# ---------------------------------------------------------------------------

def _scipy_stats():
    import scipy.stats as st
    import scipy.special as sp
    return st, sp


def pnorm(x, mu=0, sigma=1, lower_tail=True, log_p=False):
    """Normal CDF (jdistlib Normal.cumulative = R pnorm.c Cody port in
    stats/rmath.py pnorm_std)."""
    def f(v, m, s):
        from ..stats import rmath
        if s <= 0:
            if s < 0:
                return _bi.float('nan')
            lo = v < m
            p_ = 1.0 if (lo == (not lower_tail)) else 0.0
            return math.log(p_) if log_p else p_
        return rmath.pnorm_std((v - m) / s, lower_tail=lower_tail,
                               log_p=log_p)
    return _apply('pnorm', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(mu), to_expr(sigma))


def qnorm(p, mu=0, sigma=1, lower_tail=True, log_p=False):
    """Normal quantile (jdistlib Normal.quantile = AS 241, bit-exact port
    in stats/rmath.py)."""
    def f(v, m, s):
        from ..stats import rmath
        return rmath.qnorm(v, m, s, lower_tail=lower_tail, log_p=log_p)
    return _apply('qnorm', ht.tfloat64, _obj_impl(ht.tfloat64, f), to_expr(p), to_expr(mu), to_expr(sigma))


def dnorm(x, mu=0, sigma=1, log_p=False):
    """Normal density (jdistlib Normal.density = R dnorm.c port in
    stats/rmath.py dnorm_std)."""
    def f(v, m, s):
        from ..stats import rmath
        z = (v - m) / s
        d = rmath.dnorm_std(z, give_log=log_p)
        return d - math.log(s) if log_p else d / s
    return _apply('dnorm', ht.tfloat64, _obj_impl(ht.tfloat64, f), to_expr(x), to_expr(mu), to_expr(sigma))


def pchisqtail(x, df, ncp=None, lower_tail=False, log_p=False):
    def f(v, d, nc):
        if nc is None:
            from ..stats import rmath
            return rmath.pchisq(v, d, lower_tail=lower_tail, log_p=log_p)
        st, sp = _scipy_stats()
        p = st.ncx2.cdf(v, d, nc) if lower_tail else st.ncx2.sf(v, d, nc)
        return math.log(p) if log_p else p
    if ncp is None:
        return _apply('pchisqtail', ht.tfloat64,
                      _obj_impl(ht.tfloat64, lambda v, d: f(v, d, None)),
                      to_expr(x), to_expr(df))
    return _apply('pnchisqtail', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(df), to_expr(ncp))


def qchisqtail(p, df, ncp=None, lower_tail=False, log_p=False):
    def f(v, d, nc):
        st, sp = _scipy_stats()
        if log_p:
            v = math.exp(v)
        if nc is None:
            return st.chi2.ppf(v, d) if lower_tail else st.chi2.isf(v, d)
        return st.ncx2.ppf(v, d, nc) if lower_tail else st.ncx2.isf(v, d, nc)
    if ncp is None:
        return _apply('qchisqtail', ht.tfloat64,
                      _obj_impl(ht.tfloat64, lambda v, d: f(v, d, None)),
                      to_expr(p), to_expr(df))
    return _apply('qnchisqtail', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(p), to_expr(df), to_expr(ncp))


def ppois(x, lamb, lower_tail=True, log_p=False):
    def f(v, l):
        from ..stats import rmath
        return rmath.ppois(v, l, lower_tail=lower_tail, log_p=log_p)
    return _apply('ppois', ht.tfloat64, _obj_impl(ht.tfloat64, f), to_expr(x), to_expr(lamb))


def dpois(x, lamb, log_p=False):
    def f(v, l):
        from ..stats import rmath
        return rmath.dpois(v, l, give_log=log_p)
    return _apply('dpois', ht.tfloat64, _obj_impl(ht.tfloat64, f), to_expr(x), to_expr(lamb))


def qpois(p, lamb, lower_tail=True, log_p=False):
    def f(v, l):
        st, sp = _scipy_stats()
        return _bi.int(st.poisson.ppf(v if lower_tail else 1 - v, l))
    return _apply('qpois', ht.tint32, _obj_impl(ht.tint32, f), to_expr(p), to_expr(lamb))


def dbeta(x, a, b):
    def f(v, aa, bb):
        st, sp = _scipy_stats()
        return st.beta.pdf(v, aa, bb)
    return _apply('dbeta', ht.tfloat64, _obj_impl(ht.tfloat64, f), to_expr(x), to_expr(a), to_expr(b))


def pgenchisq(x, w, k, lam, mu, sigma, max_iterations=None, min_accuracy=None):
    """CDF of a generalized chi-squared distribution (reference
    `is/hail/stats/GeneralizedChiSquaredDistribution.scala`, Davies' AS 155;
    python/hail/expr/functions.py:2387 for defaults lim=10_000, acc=1e-5)."""
    t = ht.tstruct(value=ht.tfloat64, n_iterations=ht.tint32, converged=ht.tbool, fault=ht.tint32)
    if max_iterations is None:
        max_iterations = 10_000
    if min_accuracy is None:
        min_accuracy = 1e-5
    def f(xv, wv, kv, lamv, muv, sigmav, limv, accv):
        from ..stats.genchisq import pgenchisq_py
        val, it, conv, fault = pgenchisq_py(xv, wv, kv, lamv, muv, sigmav,
                                            max_iterations=limv, min_accuracy=accv)
        return Struct(value=val, n_iterations=it, converged=conv, fault=fault)
    return _apply('pgenchisq', t, _obj_impl(t, f),
                  to_expr(x), to_expr(w), to_expr(k), to_expr(lam), to_expr(mu), to_expr(sigma),
                  to_expr(max_iterations), to_expr(min_accuracy))


def binom_test(x, n, p, alternative: str = 'two-sided'):
    def f(xv, nv, pv):
        st, sp = _scipy_stats()
        alt = {'two-sided': 'two-sided', 'two.sided': 'two-sided', 'greater': 'greater', 'less': 'less'}[alternative]
        return st.binomtest(_bi.int(xv), _bi.int(nv), pv, alternative=alt).pvalue
    return _apply('binom_test', ht.tfloat64, _obj_impl(ht.tfloat64, f), to_expr(x), to_expr(n), to_expr(p))


def fisher_exact_test(c1, c2, c3, c4):
    t = ht.tstruct(p_value=ht.tfloat64, odds_ratio=ht.tfloat64,
                   ci_95_lower=ht.tfloat64, ci_95_upper=ht.tfloat64)
    def f(a, b, c, d):
        from ..stats.exact_tests import fisher_exact_test as fet
        p, orat, lo, hi = fet(_bi.int(a), _bi.int(b), _bi.int(c), _bi.int(d))
        return Struct(p_value=p, odds_ratio=orat, ci_95_lower=lo, ci_95_upper=hi)
    return _apply('fisher_exact_test', t, _obj_impl(t, f),
                  to_expr(c1), to_expr(c2), to_expr(c3), to_expr(c4))


def chi_squared_test(c1, c2, c3, c4):
    t = ht.tstruct(p_value=ht.tfloat64, odds_ratio=ht.tfloat64)
    def f(a, b, c, d):
        from ..stats.exact_tests import chi_squared_test as cst
        p, orat = cst(_bi.int(a), _bi.int(b), _bi.int(c), _bi.int(d))
        return Struct(p_value=p, odds_ratio=orat)
    return _apply('chi_squared_test', t, _obj_impl(t, f),
                  to_expr(c1), to_expr(c2), to_expr(c3), to_expr(c4))


def contingency_table_test(c1, c2, c3, c4, min_cell_count):
    t = ht.tstruct(p_value=ht.tfloat64, odds_ratio=ht.tfloat64)
    mcc = to_expr(min_cell_count)
    def f(a, b, c, d, m):
        from ..stats.exact_tests import contingency_table_test as ctt
        p, orat = ctt(_bi.int(a), _bi.int(b), _bi.int(c), _bi.int(d), _bi.int(m))
        return Struct(p_value=p, odds_ratio=orat)
    return _apply('contingency_table_test', t, _obj_impl(t, f),
                  to_expr(c1), to_expr(c2), to_expr(c3), to_expr(c4), mcc)


def hardy_weinberg_test(n_hom_ref, n_het, n_hom_var, one_sided=False):
    t = ht.tstruct(het_freq_hwe=ht.tfloat64, p_value=ht.tfloat64)
    def f(a, b, c):
        from ..stats.hwe import hwe_test
        hf, p = hwe_test(_bi.int(a), _bi.int(b), _bi.int(c), one_sided=one_sided)
        return Struct(het_freq_hwe=hf, p_value=p)
    return _apply('hardy_weinberg_test', t, _obj_impl(t, f),
                  to_expr(n_hom_ref), to_expr(n_het), to_expr(n_hom_var))


# ---------------------------------------------------------------------------
# deterministic randomness (counter-based, keyed by row index — mirrors the
# reference's Threefry-based RNG, is/hail/expr/ir/Random.scala)
# ---------------------------------------------------------------------------

def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


_rand_counter = [0]


def _static_rng_uid(seed):
    """Reference _seeded_func (functions.py:121): a fresh sequential static
    uid per seeded-function application, or -seed-1 for an explicit seed."""
    from ..context import Env
    if seed is None:
        return Env.next_static_rng_uid()
    return -seed - 1


def _rng_nonce() -> int:
    from ..context import Env
    try:
        import builtins
        return builtins.int(Env.hc().flags.get('rng_nonce') or '0x0', 0)
    except ValueError:
        return 0


def _uid_words(uid_struct_col):
    """Unpack the RngUidTuple StructColumn into flat int64 word arrays;
    an empty list means the reference's empty dynamic message."""
    shape = uid_struct_col.shape
    words = [np.asarray(c.values, dtype=np.int64).ravel()
             for c in uid_struct_col.fields.values()]
    return words, shape


def _uid_n(words, shape):
    # empty partitions give genuinely zero-length word columns
    import builtins
    if words:
        return builtins.int(words[0].shape[0])
    return builtins.int(np.prod(shape)) if shape else 1


def _rand_uniform_impl(seed):
    """Uniform [0,1) per row, bit-exact with the reference's rand_unif
    (RandomSeededFunctions._rand_unif over PMAC(nonce, staticUID,
    uid words) — Random.scala + randomness.md)."""
    sid = _static_rng_uid(seed)
    nonce = None
    def impl(uid_col):
        from ..ir.random import rand_unif_exact
        nl = _rng_nonce() if nonce is None else nonce
        words, shape = _uid_words(uid_col)
        u = rand_unif_exact(nl, sid, words,
                            n=_uid_n(words, shape)).reshape(shape)
        return PrimitiveColumn(ht.tfloat64, u, None)
    return impl


def rand_unif(lo=0.0, hi=1.0, seed=None):
    u = construct_expr(Apply('rand_unif', ht.tfloat64, [RngUidTuple()], _rand_uniform_impl(seed)))
    return u * (to_expr(hi) - to_expr(lo)) + to_expr(lo)


def rand_bool(p, seed=None):
    return rand_unif(seed=seed) < to_expr(p)


def rand_norm(mean=0.0, sd=1.0, seed=None, size=None):
    """Normal sample (engine rnorm = mean + sd*nextGaussian, the polar
    method — Random.scala:441,520; bit-exact)."""
    sid = _static_rng_uid(seed)
    def impl(uid_col, mcol, scol):
        from ..ir.random import rand_norm_exact
        words, shape = _uid_words(uid_col)
        mv = np.broadcast_to(np.asarray(mcol.values, np.float64), shape).ravel()
        sv = np.broadcast_to(np.asarray(scol.values, np.float64), shape).ravel()
        vals = rand_norm_exact(_rng_nonce(), sid, words, mv, sv,
                               n=_uid_n(words, shape)).reshape(shape)
        return PrimitiveColumn(ht.tfloat64, vals, None)
    return _apply('rand_norm', ht.tfloat64, impl,
                  construct_expr(RngUidTuple(), Indices()),
                  to_expr(mean, ht.tfloat64), to_expr(sd, ht.tfloat64))


def _rand_int32_expr(bound, seed):
    sid = _static_rng_uid(seed)
    def impl(uid_col, bcol):
        from ..ir.random import rand_int32_bounded
        words, shape = _uid_words(uid_col)
        bv = np.broadcast_to(np.asarray(bcol.values, dtype=np.int64),
                             shape).ravel()
        vals = rand_int32_bounded(_rng_nonce(), sid, words, bv,
                                  n=_uid_n(words, shape)).reshape(shape)
        return PrimitiveColumn(ht.tint32, vals, None)
    return _apply('rand_int32', ht.tint32, impl, construct_expr(
        RngUidTuple(), Indices()), to_expr(bound))


def rand_int32(a, b=None, *, seed=None):
    """Uniform 32-bit integers over [0, a) or [a, b) (reference
    functions.py:3223 → engine nextInt(n), Random.scala:491)."""
    if b is None:
        return _rand_int32_expr(a, seed)
    return _rand_int32_expr(to_expr(b) - to_expr(a), seed) + to_expr(a)


def _rand_int64_expr(bound, seed):
    sid = _static_rng_uid(seed)
    full = bound is None
    def impl(uid_col, bcol):
        from ..ir.random import rand_int64_full, rand_int64_bounded
        words, shape = _uid_words(uid_col)
        if full:
            vals = rand_int64_full(_rng_nonce(), sid, words,
                                   n=_uid_n(words, shape)).reshape(shape)
        else:
            bv = np.broadcast_to(np.asarray(bcol.values, dtype=np.int64),
                                 shape).ravel()
            vals = rand_int64_bounded(_rng_nonce(), sid, words, bv,
                                      n=_uid_n(words, shape)).reshape(shape)
        return PrimitiveColumn(ht.tint64, vals, None)
    return _apply('rand_int64', ht.tint64, impl, construct_expr(
        RngUidTuple(), Indices()), to_expr(0 if bound is None else bound))


def rand_int64(a=None, b=None, *, seed=None):
    """Uniform 64-bit integers over all of int64, [0, a), or [a, b)
    (reference functions.py:3262 → engine nextLong, Random.scala:473-518)."""
    if a is None:
        return _rand_int64_expr(None, seed)
    if b is None:
        return _rand_int64_expr(a, seed)
    return _rand_int64_expr(int64(to_expr(b)) - int64(to_expr(a)), seed) \
        + int64(to_expr(a))


def rand_pois(lamb, seed=None):
    """Poisson sample (engine rpois = jdistlib Poisson.random = R rpois.c;
    bit-exact port in ir/random.py)."""
    sid = _static_rng_uid(seed)
    def impl(uid_col, lcol):
        from ..ir.random import rand_pois_exact
        words, shape = _uid_words(uid_col)
        lv = np.broadcast_to(np.asarray(lcol.values, np.float64), shape).ravel()
        vals = rand_pois_exact(_rng_nonce(), sid, words, lv,
                               n=_uid_n(words, shape)).reshape(shape)
        return PrimitiveColumn(ht.tfloat64, vals,
                               _bcast_mask(lcol.missing, shape))
    return _apply('rand_pois', ht.tfloat64, impl,
                  construct_expr(RngUidTuple(), Indices()),
                  to_expr(lamb, ht.tfloat64))


def rand_beta(a, b, lower=None, upper=None, seed=None):
    """Beta sample (engine rbeta = Cheng BB/BC; bounds rejection-resample —
    RandomSeededFunctions rand_beta; bit-exact port in ir/random.py)."""
    sid = _static_rng_uid(seed)
    lo_v = lower
    hi_v = upper
    def impl(uid_col, acol, bcol):
        from ..ir.random import rand_beta_exact
        words, shape = _uid_words(uid_col)
        av = np.broadcast_to(np.asarray(acol.values, np.float64), shape).ravel()
        bv = np.broadcast_to(np.asarray(bcol.values, np.float64), shape).ravel()
        vals = rand_beta_exact(_rng_nonce(), sid, words, av, bv,
                               lo=lo_v, hi=hi_v,
                               n=_uid_n(words, shape)).reshape(shape)
        miss = C._merge_missing(_bcast_mask(acol.missing, shape),
                                _bcast_mask(bcol.missing, shape))
        return PrimitiveColumn(ht.tfloat64, vals, miss)
    return _apply('rand_beta', ht.tfloat64, impl,
                  construct_expr(RngUidTuple(), Indices()),
                  to_expr(a, ht.tfloat64), to_expr(b, ht.tfloat64))


def rand_gamma(shape, scale, seed=None):
    """Gamma sample (engine rgamma = jdistlib Gamma.random = R rgamma.c
    GS/GD; bit-exact port in ir/random.py)."""
    sid = _static_rng_uid(seed)
    def impl(uid_col, kcol, scol):
        from ..ir.random import rand_gamma_exact
        words, shp = _uid_words(uid_col)
        kv = np.broadcast_to(np.asarray(kcol.values, np.float64), shp).ravel()
        sv = np.broadcast_to(np.asarray(scol.values, np.float64), shp).ravel()
        vals = rand_gamma_exact(_rng_nonce(), sid, words, kv, sv,
                                n=_uid_n(words, shp)).reshape(shp)
        return PrimitiveColumn(ht.tfloat64, vals, None)
    return _apply('rand_gamma', ht.tfloat64, impl,
                  construct_expr(RngUidTuple(), Indices()),
                  to_expr(shape, ht.tfloat64), to_expr(scale, ht.tfloat64))


def rand_cat(prob_array, seed=None):
    """Categorical sample (RandomSeededFunctions rand_cat: u*sum(w) with a
    subtraction scan; bit-exact port in ir/random.py)."""
    sid = _static_rng_uid(seed)
    p = array(prob_array)
    def impl(uid_col, pcol):
        from ..ir.random import rand_cat_exact
        pobj = C.to_object(pcol)
        words, shape = _uid_words(uid_col)
        n = _uid_n(words, shape)
        pv = np.broadcast_to(pobj.values, shape).ravel()
        w = np.stack([np.asarray(x, dtype=np.float64) for x in pv])
        vals = rand_cat_exact(_rng_nonce(), sid, words, w, n=n).reshape(shape)
        return PrimitiveColumn(ht.tint32, vals, None)
    return _apply('rand_cat', ht.tint32, impl,
                  construct_expr(RngUidTuple(), Indices()), p)


def rand_dirichlet(a, seed=None):
    """Dirichlet sample: normalized per-component gammas (reference
    functions.py rand_dirichlet — same gamma draws; normalization happens
    AFTER a single evaluation of the gamma array, matching the reference's
    bind semantics where the array is bound once)."""
    ae = array(a)
    g = ae.map(lambda p: if_else(p == 0.0, 0.0, rand_gamma(p, 1, seed=seed)))
    t = ht.tarray(ht.tfloat64)
    def impl(col):
        obj = C.to_object(col)
        out = np.empty(obj.shape, dtype=object)
        fo = out.ravel()
        for i, v in _bi.enumerate(obj.values.ravel()):
            if v is None:
                fo[i] = None
                continue
            vals = np.asarray(v, dtype=np.float64)
            tot = 0.0
            for x in vals:      # left-to-right, like the engine's sum fold
                tot += _bi.float(x)
            fo[i] = [_bi.float(x / tot) for x in vals]
        return C.from_pylist(t, _bi.list(fo)).reshape(obj.shape)
    return _apply('rand_dirichlet', t, impl, g)


# ---------------------------------------------------------------------------
# ndarray methods (numpy-backed object columns; device tier in hail_tpu.nd)
# ---------------------------------------------------------------------------

def _ndarray_method(expr, name, result_typ, *args):
    ops = {
        'nd_matmul': lambda a, b: a @ b,
        'nd_add': lambda a, b: a + b,
        'nd_sub': lambda a, b: a - b,
        'nd_mul': lambda a, b: a * b,
        'nd_div': lambda a, b: a / b,
        'nd_transpose': lambda a: a.T,
        'nd_shape': lambda a: tuple(_bi.int(s) for s in a.shape),
        'nd_to_array': lambda a: _bi.list(np.asarray(a).tolist()),
    }
    if name == 'nd_reshape':
        def impl(col, *shape_cols):
            obj = C.to_object(col)
            dims = [_bi.int(C.to_object(s).values.ravel()[0]) for s in shape_cols]
            vals = np.frompyfunc(lambda a: None if a is None else np.asarray(a).reshape(dims), 1, 1)(obj.values)
            return ObjectColumn(result_typ, vals)
        return _apply(name, result_typ, impl, expr, *args)
    f = ops[name]
    return _apply(name, result_typ, _obj_impl(result_typ, f), expr, *args)


def _ndarray_getitem(expr, item):
    """NDArray indexing (reference NDArrayExpression.__getitem__): integer
    indices (expressions allowed) select elements; python slices (static
    bounds) select subarrays; mixed forms reduce ndim per integer index."""
    nd = expr.dtype.ndim
    if not isinstance(item, tuple):
        item = (item,)
    if _bi.len(item) != nd:
        raise ValueError(f'expected {nd} indices, got {_bi.len(item)}')
    slice_positions = [i for i, s in enumerate(item)
                       if isinstance(s, slice)]
    out_ndim = _bi.len(slice_positions)
    et = expr.dtype.element_type
    result_typ = ht.tndarray(et, out_ndim) if out_ndim else et
    static = [s if isinstance(s, slice) else None for s in item]
    idx_exprs = [to_expr(s) for s in item if not isinstance(s, slice)]

    def impl(col, *idx_cols):
        obj = C.to_object(col)
        idxs = [C.to_object(c) for c in idx_cols]
        shape = np.broadcast_shapes(obj.shape, *[c.shape for c in idxs])
        ov = np.broadcast_to(obj.values, shape)
        fis = [np.broadcast_to(c.values, shape).ravel() for c in idxs]
        out = np.empty(shape, dtype=object)
        fo, fa = out.ravel(), ov.ravel()
        for i in range(fo.size):
            a = fa[i]
            if a is None or any(f[i] is None for f in fis):
                fo[i] = None
                continue
            sel = []
            j = 0
            for s in static:
                if s is not None:
                    sel.append(s)
                else:
                    sel.append(_bi.int(fis[j][i]))
                    j += 1
            v = np.asarray(a)[tuple(sel)]
            fo[i] = v.item() if np.ndim(v) == 0 else v
        return C.from_pylist(result_typ, _bi.list(fo)).reshape(shape)

    return _apply('nd_index', result_typ, impl, expr, *idx_exprs)


def _ndarray_sum(expr, axis):
    if axis is None:
        t = expr.dtype.element_type
        return _apply('nd_sum_all', t, _obj_impl(t, lambda a: np.asarray(a).sum().item()), expr)
    nd = expr.dtype.ndim - (1 if isinstance(axis, _bi.int) else _bi.len(axis))
    t = ht.tndarray(expr.dtype.element_type, _bi.max(nd, 1)) if nd > 0 else expr.dtype.element_type
    return _apply('nd_sum', t, _obj_impl(t, lambda a: np.asarray(a).sum(axis=axis)), expr)


def eval_expr(expr):
    return eval_scalar(to_expr(expr))


eval = eval_expr


def eval_typed(expression):
    """Evaluate and return (value, dtype) (reference
    expression_utils.eval_typed)."""
    e = to_expr(expression)
    return eval_scalar(e), e.dtype


def eval_timed(expression):
    """Evaluate and return (value, timings) — a nested stage tree, the
    analogue of the reference's X-Hail-Timings response header
    (`utils/ExecutionTimer.scala:12`, `py4j_backend.py:309`)."""
    from ..utils.timer import timed as _timed_ctx
    e = to_expr(expression)
    with _timed_ctx('eval', log=False) as t:
        v = eval_scalar(e)
    return v, t.finish().to_dict()


def _cmp_values(a, b):
    """Recursive total-order compare on python values mirroring the engine's
    orderings (missing sorts last; containers lexicographic; sets/dicts by
    sorted contents) — backs hl._compare (reference ApplyComparisonOp)."""
    if a is None and b is None:
        return 0
    if a is None:
        return 1
    if b is None:
        return -1
    if isinstance(a, Struct):
        for k in a:
            c = _cmp_values(a[k], b[k])
            if c:
                return c
        return 0
    if isinstance(a, (list, tuple)) and not isinstance(a, _bi.str):
        for x, y in zip(a, b):
            c = _cmp_values(x, y)
            if c:
                return c
        return (_bi.len(a) > _bi.len(b)) - (_bi.len(a) < _bi.len(b))
    if isinstance(a, (set, frozenset)):
        import functools
        ka = _bi.sorted(a, key=functools.cmp_to_key(_cmp_values))
        kb = _bi.sorted(b, key=functools.cmp_to_key(_cmp_values))
        return _cmp_values(ka, kb)
    if isinstance(a, dict):
        import functools
        ka = _bi.sorted(a.items(), key=functools.cmp_to_key(
            lambda p, q: _cmp_values(p[0], q[0])))
        kb = _bi.sorted(b.items(), key=functools.cmp_to_key(
            lambda p, q: _cmp_values(p[0], q[0])))
        return _cmp_values([list(p) for p in ka], [list(p) for p in kb])
    from ..genetics.locus import Locus as _LocusV
    if isinstance(a, _LocusV):
        c = _cmp_values(a.global_position() if hasattr(a, 'global_position') else a.contig,
                        b.global_position() if hasattr(b, 'global_position') else b.contig)
        if c:
            return c
        return _cmp_values(a.position, b.position)
    if isinstance(a, Call):
        if a == b:
            return 0
        return _cmp_values((a.ploidy, a.alleles, a.phased),
                           (b.ploidy, b.alleles, b.phased))
    from ..utils.structs import Interval
    if isinstance(a, Interval):
        # engine interval ordering: start (an included start sorts first),
        # then end (an included end sorts last)
        c = _cmp_values(a.start, b.start)
        if c:
            return c
        c = (not a.includes_start) - (not b.includes_start)
        if c:
            return c
        c = _cmp_values(a.end, b.end)
        if c:
            return c
        return a.includes_end - b.includes_end
    return (a > b) - (a < b)


def _compare(left, right):
    """Total-order comparison to int32 (reference hl._compare)."""
    l, r = to_expr(left), to_expr(right)
    if l.dtype != r.dtype:
        raise TypeError(
            f"'compare' expected 'left' and 'right' to have the same type: "
            f'found {l.dtype} vs {r.dtype}')
    return _apply('compare', ht.tint32,
                  _obj_impl_lenient(ht.tint32, _cmp_values), l, r)


def _sort_by(collection, less_than):
    """Sort with an expression comparator (reference hl._sort_by /
    ArraySort): missing elements sort last; a comparator that evaluates to
    missing is a fatal error."""
    from ..utils.misc import FatalError
    e = to_expr(collection)
    et = e.dtype.element_type

    def impl(v):
        import functools

        def lt(a, b):
            r = eval_scalar(less_than(literal(a, et), literal(b, et)))
            if r is None:
                raise FatalError('_sort_by: comparison returned missing')
            return _bi.bool(r)

        present = [x for x in v if x is not None]
        out = _bi.sorted(present, key=functools.cmp_to_key(
            lambda a, b: -1 if lt(a, b) else (1 if lt(b, a) else 0)))
        return out + [None] * (_bi.len(v) - _bi.len(present))
    return _apply('sort_by', e.dtype, _obj_impl(e.dtype, impl), e)


def _similar_values(a, b, tolerance, absolute):
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    if isinstance(a, _bi.float) or isinstance(b, _bi.float):
        import math
        if math.isnan(a) and math.isnan(b):
            return True
        if absolute:
            return _bi.abs(a - b) <= tolerance
        return _bi.abs(a - b) <= tolerance * _bi.max(_bi.abs(a), _bi.abs(b), 1e-300)
    if isinstance(a, Struct):
        return _bi.all(_similar_values(a[k], b[k], tolerance, absolute) for k in a)
    if isinstance(a, (list, tuple)) and not isinstance(a, _bi.str):
        return _bi.len(a) == _bi.len(b) and _bi.all(
            _similar_values(x, y, tolerance, absolute) for x, y in zip(a, b))
    if isinstance(a, (set, frozenset)):
        return a == b
    if isinstance(a, dict):
        return _bi.set(a) == _bi.set(b) and _bi.all(
            _similar_values(a[k], b[k], tolerance, absolute) for k in a)
    return a == b


def _locus_windows_per_contig(coords, radius):
    """Window [start, stop) ranges for per-contig coordinate lists flattened
    to global indices (reference hl._locus_windows_per_contig)."""
    rt = ht.ttuple(ht.tarray(ht.tint32), ht.tarray(ht.tint32))

    def f(groups, rad):
        from ..linalg.utils.misc import array_windows
        starts, stops = [], []
        off = 0
        for g in groups:
            s, t = array_windows(np.asarray(g, dtype=np.float64), rad)
            starts.extend((s + off).tolist())
            stops.extend((t + off).tolist())
            off += _bi.len(g)
        return ([_bi.int(x) for x in starts], [_bi.int(x) for x in stops])
    return _apply('locus_windows_per_contig', rt, _obj_impl(rt, f),
                  to_expr(coords), to_expr(radius))


def _values_similar(left, right, tolerance=1e-6, absolute=False):
    """Approximate equality with missing-agreement (reference
    hl._values_similar / valuesSimilar)."""
    l, r = to_expr(left), to_expr(right)
    assert l.dtype == r.dtype
    return _apply('values_similar', ht.tbool,
                  _obj_impl_lenient(ht.tbool,
                                    lambda a, b: _similar_values(a, b, tolerance, absolute)),
                  l, r)


# ---------------------------------------------------------------------------
# additional builtins (breadth batch 2)
# ---------------------------------------------------------------------------

def find(f, collection):
    """First element satisfying f, or missing (reference hl.find)."""
    e = array(collection)
    et = e.dtype.element_type
    mapped = e.map(lambda x: struct(v=x, k=f(x)))
    def impl(col):
        obj = C.to_object(col)
        def g(v):
            if v is None:
                return None
            for p in v:
                if p['k'] is True:
                    return p['v']
            return None
        return C.from_pylist(et, [g(x) for x in obj.values.ravel()]).reshape(obj.shape)
    return _apply('find', et, impl, mapped)


def binary_search(array_expr, elem):
    """Index of the first element >= elem (reference hl.binary_search)."""
    import bisect
    e = array(array_expr)
    def f(v, x):
        return bisect.bisect_left(v, x)
    return _apply('binary_search', ht.tint32, _obj_impl(ht.tint32, f), e, to_expr(elem))


def uniroot(f, min, max, *, max_iter: int = 1000, epsilon: float = 2.22e-16,
            tolerance: float = 1.22e-4):
    """Root of f on [min, max] via Brent's method (reference hl.uniroot)."""
    lo = to_expr(min)
    hi = to_expr(max)
    var = _fresh_name('uniroot_x')
    x = construct_expr(Ref(var, ht.tfloat64))
    body = to_expr(f(x))
    def impl(lo_c, hi_c):
        import numpy as _np
        from ..utils.java import FatalError, HailUserError
        lov = C.to_object(lo_c).values.ravel()[0]
        hiv = C.to_object(hi_c).values.ravel()[0]
        if lov is None or hiv is None:
            return C.from_pylist(ht.tfloat64, [None])
        lov, hiv = _bi.float(lov), _bi.float(hiv)
        if not lov < hiv:
            raise HailUserError(
                f"'uniroot': min must be less than max in uniroot, got: min {lov}, max {hiv}")
        def scalar_f(xv):
            from ..ir.nodes import EvalEnv
            env = EvalEnv({var: C.from_pylist(ht.tfloat64, [xv])}, (1,))
            res = body._ir.evaluate(env).to_pylist()
            if res[0] is None:
                raise FatalError("'uniroot': value of f(x) is missing")
            return _bi.float(res[0])
        flo, fhi = scalar_f(lov), scalar_f(hiv)
        if (flo > 0 and fhi > 0) or (flo < 0 and fhi < 0):
            raise HailUserError(
                f"'uniroot': sign of endpoints must have opposite signs, "
                f"got: f(min) = {flo}, f(max) = {fhi}")
        from ..stats.exact_tests import uniroot as _brent
        root = _brent(scalar_f, lov, hiv, tolerance=tolerance)
        return C.from_pylist(ht.tfloat64, [root])
    return _apply('uniroot', ht.tfloat64, impl, lo, hi)


def approx_equal(x, y, tolerance=1e-6, absolute=False, nan_same=False):
    def f(a, b, t):
        if math.isnan(a) and math.isnan(b):
            return nan_same
        if absolute:
            return _bi.abs(a - b) <= t
        return _bi.abs(a - b) <= t * _bi.max(_bi.abs(a), _bi.abs(b))
    return _apply('approx_equal', ht.tbool, _obj_impl(ht.tbool, f),
                  to_expr(x), to_expr(y), to_expr(tolerance))


def _bit_op(name, npf):
    def f(a, b):
        ea, eb = to_expr(a), to_expr(b)
        t = ht.unify_types(ea.dtype, eb.dtype) or ht.tint32
        return _apply(name, t, _prim_impl(t, npf), ea, eb)
    f.__name__ = name
    return f


bit_and = _bit_op('bit_and', np.bitwise_and)
bit_or = _bit_op('bit_or', np.bitwise_or)
bit_xor = _bit_op('bit_xor', np.bitwise_xor)


def _shift_op(x, y, op):
    """Fixed-width shift with the reference's edge semantics
    (python/hail/expr/functions.py:6853 `_shift_op`): shifting by >= the
    word size gives sign(x) for arithmetic right shift and 0 otherwise;
    negative shifts raise a HailUserError."""
    ex, ey = to_expr(x), to_expr(y)
    t = ex.dtype
    word_size = 64 if t == ht.tint64 else 32

    def f(xv, yv):
        xv = _bi.int(xv)
        yv = _bi.int(yv)
        if yv >= word_size:
            if op == '>>':
                return (xv > 0) - (xv < 0)
            return 0
        if yv < 0:
            from ..utils.java import HailUserError
            raise HailUserError(
                f'cannot shift by a negative value: {xv} {op} {yv}')
        mask = (1 << word_size) - 1
        if op == '<<':
            r = (xv << yv) & mask
        elif op == '>>':
            r = xv >> yv  # python >> is arithmetic for negatives
            return r if -(1 << (word_size - 1)) <= r < (1 << (word_size - 1)) else \
                ((r & mask) - (1 << word_size) if (r & mask) >= (1 << (word_size - 1)) else r & mask)
        else:  # '>>>'
            r = (xv & mask) >> yv
        if r >= 1 << (word_size - 1):
            r -= 1 << word_size
        return r
    return _apply(f'bit_shift{op}', t, _obj_impl(t, f), ex, ey)


def bit_lshift(x, y):
    return _shift_op(x, y, '<<')


def bit_rshift(a, b, logical: bool = False):
    """Right shift; logical=True shifts in zeros (reference bit_rshift)."""
    return _shift_op(a, b, '>>>' if logical else '>>')


def bit_not(x):
    e = to_expr(x)
    return _apply('bit_not', e.dtype, _prim_impl(e.dtype, np.invert), e)


def bit_count(x):
    e = to_expr(x)
    def impl(col):
        v = np.asarray(col.values)
        cnt = np.vectorize(lambda a: _bi.bin(_bi.int(a) & 0xFFFFFFFFFFFFFFFF).count('1'))(v.astype(np.int64))
        return PrimitiveColumn(ht.tint32, cnt.astype(np.int32), col.missing)
    return _apply('bit_count', ht.tint32, impl, e)


nanmin = _minmax('nanmin', np.nanmin, _bi.min, ignore_nan=True)


nanmax = _minmax('nanmax', np.nanmax, _bi.max, ignore_nan=True)



def corr(x, y):
    """Pearson correlation of two float arrays (reference hl.corr)."""
    xe, ye = array(x), array(y)
    def f(a, b):
        import numpy as _np
        pairs = [(p, q) for p, q in _bi.zip(a, b) if p is not None and q is not None]
        if _bi.len(pairs) < 2:
            return None
        # the engine's moment formula (CorrAggregator: n*sxy - sx*sy over
        # sqrt terms) — np.corrcoef's centered form differs in the last ulp
        n = _bi.len(pairs)
        sx = math.fsum(p for p, _ in pairs) if False else _bi.sum(p for p, _ in pairs)
        sy = _bi.sum(q for _, q in pairs)
        sxx = _bi.sum(p * p for p, _ in pairs)
        syy = _bi.sum(q * q for _, q in pairs)
        sxy = _bi.sum(p * q for p, q in pairs)
        den = math.sqrt(n * sxx - sx * sx) * math.sqrt(n * syy - sy * sy)
        if den == 0:
            return None
        return (n * sxy - sx * sy) / den
    return _apply('corr', ht.tfloat64, _obj_impl(ht.tfloat64, f), xe, ye)


def shuffle(a, seed=None):
    """Randomly permute an array (reference functions.py:7177: sorted by a
    per-element rand_unif key — same keys, same permutation)."""
    return sorted_(array(a), key=lambda _: rand_unif(0.0, 1.0, seed=seed))


def triangle(n):
    e = to_expr(n)
    return e * (e + 1) // 2


def liftover(x, dest_reference_genome, min_match: float = 0.95,
             include_strand: bool = False):
    """Lift a locus (or locus interval) to another reference genome
    (reference hl.liftover; requires rg.add_liftover with a chain file)."""
    from ..genetics.reference_genome import ReferenceGenome
    from ..genetics.locus import Locus
    e = to_expr(x)
    dest = ReferenceGenome.get(dest_reference_genome) if isinstance(dest_reference_genome, str) \
        else dest_reference_genome
    if isinstance(e.dtype, ht.tlocus):
        src_rg = e.dtype.reference_genome
        if not src_rg.has_liftover(dest.name):
            raise ValueError(f'no liftover chain from {src_rg.name} to {dest.name}; '
                             f'call rg.add_liftover(chain_file, dest) first')
        lo = src_rg.liftover(dest.name)
        if include_strand:
            t = ht.tstruct(result=ht.tlocus(dest), is_negative_strand=ht.tbool)
            def f(l):
                r = lo.lift(l.contig, l.position)
                if r is None or not dest.has_contig(r[0]):
                    return None
                return Struct(result=Locus(r[0], r[1], dest), is_negative_strand=r[2])
            return _apply('liftover', t, _obj_impl(t, f), e)
        t = ht.tlocus(dest)
        def f2(l):
            r = lo.lift(l.contig, l.position)
            if r is None or not dest.has_contig(r[0]):
                return None
            return Locus(r[0], r[1], dest)
        return _apply('liftover', t, _obj_impl(t, f2), e)
    if isinstance(e.dtype, ht.tinterval):
        pt = e.dtype.point_type
        src_rg = pt.reference_genome
        lo = src_rg.liftover(dest.name)
        t = ht.tinterval(ht.tlocus(dest))
        def f3(iv):
            a = lo.lift(iv.start.contig, iv.start.position)
            b = lo.lift(iv.end.contig, iv.end.position)
            if a is None or b is None or a[0] != b[0]:
                return None
            lo_l = Locus(a[0], _bi.min(a[1], b[1]), dest)
            hi_l = Locus(a[0], _bi.max(a[1], b[1]), dest)
            return Interval(lo_l, hi_l, iv.includes_start, iv.includes_end)
        return _apply('liftover', t, _obj_impl(t, f3), e)
    raise TypeError(f'liftover: unsupported type {e.dtype}')


def get_sequence(contig, position, before=0, after=0, reference_genome='default'):
    """Reference base(s) at a locus (reference hl.get_sequence; requires
    rg.add_sequence with a FASTA)."""
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    if not rg.has_sequence():
        raise ValueError(f'reference genome {rg.name} has no sequence loaded; '
                         'call rg.add_sequence(fasta) first')
    be = to_expr(before)
    ae = to_expr(after)
    def f(c, p, b, a):
        return rg.sequence(c, p, b, a)
    return _apply('get_sequence', ht.tstr, _obj_impl(ht.tstr, f),
                  to_expr(contig), to_expr(position), be, ae)


def mendel_error_code(locus, is_female, father, mother, child):
    """Mendel error code for a trio genotype configuration, exactly the
    reference's 12-code table (hl.mendel_error_code: auto codes 1-8, hemi-X
    9-10, hemi-Y 11-12, missing_false genotype conditions)."""
    t = ht.tint32

    def f(l, fem, dad, mom, kid):
        if l is None:
            return None
        rg = l.reference_genome

        def na(c2):
            return None if c2 is None else c2.n_alt_alleles()
        d, m2, k = na(dad), na(mom), na(kid)

        def eq(v, n):
            return v is not None and v == n

        def gt0(v):
            return v is not None and v > 0
        nonpar = not rg.in_par(l.contig, l.position)
        x_nonpar = rg.is_x(l.contig) and nonpar
        y_nonpar = rg.is_y(l.contig) and nonpar
        auto_or_par = not x_nonpar and not y_nonpar and not rg.is_mitochondrial(l.contig)
        if auto_or_par or fem is True:
            if eq(d, 2) and eq(m2, 2) and eq(k, 1):
                return 1
            if eq(d, 0) and eq(m2, 0) and eq(k, 1):
                return 2
            if eq(d, 0) and eq(m2, 0) and eq(k, 2):
                return 5
            if eq(d, 2) and eq(m2, 2) and eq(k, 0):
                return 8
            if eq(d, 0) and eq(k, 2):
                return 3
            if eq(m2, 0) and eq(k, 2):
                return 4
            if eq(d, 2) and eq(k, 0):
                return 6
            if eq(m2, 2) and eq(k, 0):
                return 7
            return None
        if fem is None:
            return None
        if x_nonpar:
            if eq(m2, 2) and eq(k, 0):
                return 9
            if eq(m2, 0) and gt0(k):
                return 10
            return None
        if y_nonpar:
            if gt0(d) and eq(k, 0):
                return 11
            if eq(d, 0) and gt0(k):
                return 12
            return None
        return None
    return _apply('mendel_error_code', t, _obj_impl_lenient(t, f),
                  to_expr(locus), to_expr(is_female), to_expr(father),
                  to_expr(mother), to_expr(child))


# ---------------------------------------------------------------------------
# round-2 breadth: folds/scans, gamma/chisq/hypergeometric families, misc
# (reference python/hail/expr/functions.py parity)
# ---------------------------------------------------------------------------

def fold(f, zero, collection):
    """Reduce a collection with `f` starting from `zero`
    (reference functions.py `fold`)."""
    return array(collection).fold(f, zero)


def array_scan(f, zero, a):
    """Running fold over `a`: length ``len(a)+1`` array starting at `zero`
    (reference functions.py `array_scan`)."""
    return array(a).scan(f, zero)


def cumulative_sum(a, filter_missing: bool = True):
    """Array of running sums of `a` (reference functions.py
    `cumulative_sum`)."""
    e = array(a)
    et = e.dtype.element_type
    rt = et  # running sums keep the element type (reference cumulative_sum)

    def impl(v):
        out = []
        acc = 0
        for x in v:
            if x is None:
                if filter_missing:
                    out.append(acc)
                else:
                    out.append(None)
            else:
                acc = acc + x
                out.append(acc)
        return out
    return _apply('cumulative_sum', ht.tarray(rt), _obj_impl(ht.tarray(rt), impl), e)


def gq_from_pl(pl):
    """Genotype quality from Phred-scaled likelihoods: difference of the two
    smallest PL values, each capped at 99 (reference
    `is/hail/variant/Genotype.scala:60` gqFromPL)."""
    def impl(v):
        m, m2 = 99, 99
        for x in v:
            if x is None:
                continue
            if x < m:
                m2 = m
                m = x
            elif x < m2:
                m2 = x
        return m2 - m
    return _apply('gq_from_pl', ht.tint32, _obj_impl(ht.tint32, impl), array(pl))


# module-level for doctest/namespace parity with the reference's
# `from hail.genetics.allele_type import AlleleType` in functions.py
from ..genetics.allele_type import AlleleType  # noqa: E402


def numeric_allele_type(ref, alt):
    """Allele polymorphism type as the AlleleType integer enum
    (reference functions.py `numeric_allele_type`)."""
    def impl(r, a):
        return _bi.int(_at.allele_type(r, a).value)
    return _apply('numeric_allele_type', ht.tint32, _obj_impl(ht.tint32, impl),
                  to_expr(ref), to_expr(alt))


def parse_float32(s):
    return _apply('parse_float32', ht.tfloat32,
                  _obj_impl_lenient(ht.tfloat32, _lenient_parser(_bi.float)), to_expr(s))


def parse_json(x, dtype):
    """Parse a JSON string into `dtype` (reference functions.py
    `parse_json`)."""
    t = ht.dtype(dtype) if isinstance(dtype, _bi.str) else dtype

    def conv(v, typ):
        if v is None:
            return None
        if isinstance(typ, ht.tstruct):
            return Struct(**{k: conv(v.get(k), ft) for k, ft in typ.items()})
        if isinstance(typ, ht.ttuple):
            return _bi.tuple(conv(e, et) for e, et in _bi.zip(v, typ.types))
        if isinstance(typ, ht.tlocus):
            from ..genetics.locus import Locus as _Locus
            return _Locus(v['contig'], _bi.int(v['position']),
                          typ.reference_genome)
        if isinstance(typ, ht.tinterval):
            from ..utils.structs import Interval as _Interval
            return _Interval(conv(v['start'], typ.point_type),
                             conv(v['end'], typ.point_type),
                             _bi.bool(v.get('includeStart', True)),
                             _bi.bool(v.get('includeEnd', False)),
                             point_type=typ.point_type)
        if typ == ht.tcall:
            from ..genetics.call import Call as _Call
            return _parse_call_str(v)
        if isinstance(typ, ht.tarray):
            return [conv(e, typ.element_type) for e in v]
        if isinstance(typ, ht.tset):
            from ..utils.structs import freeze
            return _bi.frozenset(freeze(conv(e, typ.element_type)) for e in v)
        if isinstance(typ, ht.tdict):
            if isinstance(v, _bi.dict):
                return {conv(k, typ.key_type): conv(val, typ.value_type) for k, val in v.items()}
            return {conv(e[0], typ.key_type): conv(e[1], typ.value_type) for e in v}
        if typ in (ht.tint32, ht.tint64):
            return _bi.int(v)
        if typ in (ht.tfloat32, ht.tfloat64):
            return _bi.float(v)
        return v
    return _apply('parse_json', t,
                  _obj_impl_lenient(t, lambda v: None if v is None else conv(_json.loads(v), t)),
                  to_expr(x))


def repeat(expr, n):
    """Array of `n` copies of `expr` (reference functions.py `repeat`). A
    callable is invoked per element (stream-map semantics: randomness inside
    draws independently per position, reference repeat's lambda form)."""
    if _bi.callable(expr):
        return range_(to_expr(n)).map(lambda _: expr())
    e = to_expr(expr)
    ne = to_expr(n)
    t = ht.tarray(e.dtype)
    return _apply('repeat', t,
                  _obj_impl(t, lambda v, k: [v] * _bi.max(_bi.int(k), 0)), e, ne)


def zeros(length):
    """Array of `length` zeros (reference functions.py `zeros`)."""
    ne = to_expr(length)
    t = ht.tarray(ht.tint32)
    return _apply('zeros', t,
                  _obj_impl(t, lambda k: [0] * _bi.max(_bi.int(k), 0)), ne)


def dchisq(x, df, ncp=None, log_p=False):
    def f(v, d, nc):
        from ..stats import rmath
        if nc is None:
            return rmath.dchisq(v, d, give_log=log_p)
        return rmath.dnchisq(v, d, nc, give_log=log_p)
    nce = to_expr(0.0) if ncp is None else to_expr(ncp)
    if ncp is None:
        return _apply('dchisq', ht.tfloat64,
                      _obj_impl(ht.tfloat64, lambda v, d: f(v, d, None)),
                      to_expr(x), to_expr(df))
    return _apply('dnchisq', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(df), nce)


def dgamma(x, shape, scale, log_p=False):
    """Gamma density with `shape`/`scale` parameterization (reference
    functions.py `dgamma`)."""
    def f(v, a, s):
        from ..stats import rmath
        return rmath.dgamma(v, a, s, give_log=log_p)
    return _apply('dgamma', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(shape), to_expr(scale))


def pgamma(x, shape, scale, lower_tail=True, log_p=False):
    def f(v, a, s):
        from ..stats import rmath
        return rmath.pgamma(v, a, s, lower_tail=lower_tail, log_p=log_p)
    return _apply('pgamma', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(shape), to_expr(scale))


def qgamma(p, shape, scale, lower_tail=True, log_p=False):
    def f(v, a, s):
        st, sp = _scipy_stats()
        if log_p:
            v = math.exp(v)
        return st.gamma.ppf(v, a, scale=s) if lower_tail else st.gamma.isf(v, a, scale=s)
    return _apply('qgamma', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(p), to_expr(shape), to_expr(scale))


def phyper(x, popsize, ngood, nsample, log_p=False):
    """Hypergeometric probability mass P(X == x) — despite the name, the
    reference computes the density (stats/package.scala:469 phyper ->
    HypergeometricDistribution.probability)."""
    def f(v, pop, good, samp):
        st, sp = _scipy_stats()
        if log_p:
            return st.hypergeom.logpmf(v, _bi.int(pop), _bi.int(good), _bi.int(samp))
        return st.hypergeom.pmf(v, _bi.int(pop), _bi.int(good), _bi.int(samp))
    return _apply('phyper', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(popsize), to_expr(ngood), to_expr(nsample))


def pT(x, n, lower_tail=True, log_p=False):
    """Student's t CDF with `n` degrees of freedom (reference functions.py
    pT → jdistlib T.cumulative; bit-exact R pt.c port)."""
    def f(v, df):
        from ..stats import rmath
        return rmath.pt(v, df, lower_tail=lower_tail, log_p=log_p)
    return _apply('pT', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(n))


def pF(x, df1, df2, lower_tail=True, log_p=False):
    """F-distribution CDF (reference functions.py pF → jdistlib
    F.cumulative; bit-exact R pf.c port)."""
    def f(v, d1, d2):
        from ..stats import rmath
        return rmath.pf(v, d1, d2, lower_tail=lower_tail, log_p=log_p)
    return _apply('pF', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(x), to_expr(df1), to_expr(df2))


def cochran_mantel_haenszel_test(a, b, c, d):
    """Cochran-Mantel-Haenszel test for association across strata; returns
    struct(test_statistic, p_value) with the 0.5 continuity correction
    (reference functions.py `cochran_mantel_haenszel_test`)."""
    t = ht.tstruct(test_statistic=ht.tfloat64, p_value=ht.tfloat64)

    def f(av, bv, cv, dv):
        from ..stats.rmath import pchisq
        num = 0.0
        den = 0.0
        for ai, bi, ci, di in _bi.zip(av, bv, cv, dv):
            n1 = ai + bi
            n2 = ci + di
            m1 = ai + ci
            m2 = bi + di
            tt = n1 + n2
            num += ai - n1 * m1 / tt
            den += n1 * n2 * m1 * m2 / (tt ** 3 - tt ** 2)
        stat = (_bi.abs(num) - 0.5) ** 2 / den
        return Struct(test_statistic=stat, p_value=pchisq(stat, 1, lower_tail=False))
    return _apply('cochran_mantel_haenszel_test', t, _obj_impl(t, f),
                  array(a), array(b), array(c), array(d))


def rand_hyper(popsize, ngood, nsample, seed=None):
    """Hypergeometric sample (engine rhyper = jdistlib HyperGeometric.random
    = R rhyper.c HIN/H2PE; bit-exact port in ir/random.py —
    RandomSeededFunctions.scala:334)."""
    sid = _static_rng_uid(seed)
    def impl(uid_col, pcol, gcol, ncol):
        from ..ir.random import rand_hyper_exact
        words, shape = _uid_words(uid_col)
        pv = np.broadcast_to(np.asarray(pcol.values, np.int64), shape).ravel()
        gv = np.broadcast_to(np.asarray(gcol.values, np.int64), shape).ravel()
        nv = np.broadcast_to(np.asarray(ncol.values, np.int64), shape).ravel()
        vals = rand_hyper_exact(_rng_nonce(), sid, words, pv, gv, nv,
                                n=_uid_n(words, shape)).reshape(shape)
        return PrimitiveColumn(ht.tint32, vals, None)
    return _apply('rand_hyper', ht.tint32, impl,
                  construct_expr(RngUidTuple(), Indices()),
                  to_expr(popsize, ht.tint32), to_expr(ngood, ht.tint32),
                  to_expr(nsample, ht.tint32))


def rand_multi_hyper(colors, nsample, seed=None):
    """Multivariate hypergeometric sample: sequential conditional rhyper
    draws off one engine stream (RandomSeededFunctions.scala:366-402;
    bit-exact port in ir/random.py)."""
    ce = array(colors)
    ne = to_expr(nsample, ht.tint32)
    t = ht.tarray(ht.tint32)
    sid = _static_rng_uid(seed)

    def impl(uid_col, ccol, ncol):
        from ..ir.random import rand_multi_hyper_exact
        words, shape = _uid_words(uid_col)
        n = _uid_n(words, shape)
        cobj = C.to_object(ccol)
        cv = np.broadcast_to(cobj.values, shape).ravel()
        w = np.stack([np.asarray(x, dtype=np.int64) for x in cv])
        nv = np.broadcast_to(np.asarray(ncol.values, np.int64), shape).ravel()
        draws = rand_multi_hyper_exact(_rng_nonce(), sid, words, w, nv, n=n)
        out = [[_bi.int(x) for x in row] for row in draws]
        return C.from_pylist(t, out).reshape(shape)
    return _apply('rand_multi_hyper', t, impl,
                  construct_expr(RngUidTuple(), Indices()), ce, ne)


def rand_norm2d(mean=None, cov=None, seed=None):
    """Bivariate normal sample (reference functions.py:3093 — the same
    Cholesky-style construction over two per-element rand_norm draws)."""
    if mean is None:
        mean = [0, 0]
    if cov is None:
        cov = [1, 0, 1]

    def f(mean, cov):
        m1 = mean[0]
        m2 = mean[1]
        s11 = cov[0]
        s12 = cov[1]
        s22 = cov[2]
        x = range_(0, 2).map(lambda i: rand_norm(seed=seed))
        return rbind(
            sqrt(s11),
            lambda root_s11: array([
                m1 + root_s11 * x[0],
                m2 + (s12 / root_s11) * x[0]
                + sqrt(s22 - s12 * s12 / s11) * x[1],
            ]))

    return rbind(to_expr(mean, ht.tarray(ht.tfloat64)),
                 to_expr(cov, ht.tarray(ht.tfloat64)), f)


# ---------------------------------------------------------------------------
# approx_cdf internals (reference hail/expr/functions.py:160-280)
# ---------------------------------------------------------------------------

_RAW_CDF_T = ht.tstruct(levels=ht.tarray(ht.tint32), items=ht.tarray(ht.tfloat64),
                        _compaction_counts=ht.tarray(ht.tint32))
_CDF_T = ht.tstruct(values=ht.tarray(ht.tfloat64), ranks=ht.tarray(ht.tint64),
                    _compaction_counts=ht.tarray(ht.tint32))


def _result_from_raw_cdf(raw_cdf):
    """Convert a raw KLL sketch (levels offsets + items) into the cdf result
    shape {values, ranks, _compaction_counts} (reference
    `hail/expr/functions.py:173` `_result_from_raw_cdf`)."""
    def f(raw):
        weights: dict = {}
        levels = raw['levels']
        items = raw['items']
        for lvl in range(len(levels) - 1):
            for i in range(levels[lvl], levels[lvl + 1]):
                v = items[i]
                weights[v] = weights.get(v, 0) + (1 << lvl)
        vals = sorted(weights)
        ranks = [0]
        for v in vals:
            ranks.append(ranks[-1] + weights[v])
        return Struct(values=vals, ranks=ranks,
                      _compaction_counts=list(raw['_compaction_counts']))
    return _apply('result_from_raw_cdf', _CDF_T, _obj_impl(_CDF_T, f),
                  to_expr(raw_cdf))


def _cdf_combine(k, left, right):
    """Merge two raw KLL sketches (reference `approxCDFCombine`,
    `hail/expr/functions.py:192`)."""
    from ..ir.agg import ApproxCDFAgg

    def f(a, b):
        agg_ = ApproxCDFAgg()

        def state(raw):
            lv, it = raw['levels'], raw['items']
            levels = [np.asarray(it[lv[h]:lv[h + 1]], np.float64)
                      for h in range(len(lv) - 1)]
            counts = list(raw['_compaction_counts'])
            n = sum(lvl.size << h for h, lvl in enumerate(levels))
            return (levels, counts, np.int64(n))

        levels, counts, _n = agg_.comb(state(a), state(b), (k, True))
        offsets = [0]
        parts = []
        for lvl in levels:
            parts.append(np.sort(lvl))
            offsets.append(offsets[-1] + lvl.size)
        items = np.concatenate(parts) if parts else np.empty(0)
        return Struct(levels=[_bi.int(o) for o in offsets],
                      items=[_bi.float(v) for v in items],
                      _compaction_counts=[_bi.int(c) for c in counts])

    return _apply('approxCDFCombine', _RAW_CDF_T, _obj_impl(_RAW_CDF_T, f),
                  to_expr(left), to_expr(right))


def _cdf_error_bound(compaction_counts, n, failure_prob, all_quantiles):
    import math
    s_num = sum(c * (2 ** (2 * i)) for i, c in enumerate(compaction_counts))
    if n == 0:
        return math.inf
    s = s_num / (n * n)

    def single(fp):
        return math.sqrt(math.log(2 / fp) * s / 2)

    if not all_quantiles:
        return single(failure_prob)
    if s == 0:
        return 0.0
    p = 1 / failure_prob
    for _ in range(5):
        p = 4 * math.sqrt(math.log(2 * p / failure_prob) / (2 * s))
    return 1 / p + single(failure_prob / p)


def _error_from_cdf(cdf, failure_prob, all_quantiles=False):
    """Hoeffding error bound on approx_cdf quantile estimates (reference
    `hail/expr/functions.py:198` `_error_from_cdf`)."""
    def f(c, fp):
        return _cdf_error_bound(c['_compaction_counts'], c['ranks'][-1],
                                fp, all_quantiles)
    return _apply('error_from_cdf', ht.tfloat64, _obj_impl(ht.tfloat64, f),
                  to_expr(cdf), to_expr(failure_prob))


def _error_from_cdf_python(cdf, failure_prob, all_quantiles=False):
    """Python-value twin of :func:`._error_from_cdf` (reference
    `hail/expr/functions.py:241`)."""
    return _cdf_error_bound(cdf['_compaction_counts'], cdf['ranks'][-1],
                            failure_prob, all_quantiles)


def _zip_streams(*streams, fill_missing: bool = False):
    """Zip streams into tuples (reference hl._zip_streams → StreamZip)."""
    from ..ir.nodes import StreamZip
    out = zip_(*streams, fill_missing=fill_missing)
    return construct_expr(StreamZip(out._ir), out._indices)


def _stream_range(start, stop=None, step=1):
    """Stream form of hl.range (streams are arrays here; reference
    hl._stream_range)."""
    return range_(start, stop, step)


def _zip_join_producers(contexts, stream_f, key, join_f):
    """Zip-join keyed streams produced per context: the sorted union of keys,
    with per-producer values (missing where a producer lacks the key), mapped
    through `join_f(key_struct, vals)` (reference functions.py
    `_zip_join_producers` / StreamZipJoinProducers)."""
    import functools
    ce = to_expr(contexts)
    ctx_t = ce.dtype.element_type
    ctxs = eval_expr(ce)
    streams = []
    elem_t = None
    for c in ctxs:
        se = to_expr(stream_f(literal(c, ctx_t)))
        elem_t = se.dtype.element_type
        streams.append(eval_expr(se) or [])
    key = [key] if isinstance(key, _bi.str) else _bi.list(key)
    key_t = ht.tstruct(**{k: elem_t[k] for k in key})
    all_keys = []
    seen = _bi.set()
    for s in streams:
        for x in s:
            kt = _bi.tuple(x[k] for k in key)
            if kt not in seen:
                seen.add(kt)
                all_keys.append(kt)
    all_keys.sort(key=functools.cmp_to_key(_cmp_values))
    out = []
    res_t = None
    for kt in all_keys:
        kstruct = Struct(**{k: v for k, v in _bi.zip(key, kt)})
        vals = []
        for s in streams:
            hit = None
            for x in s:
                if _bi.tuple(x[k] for k in key) == kt:
                    hit = x
                    break
            vals.append(hit)
        je = to_expr(join_f(literal(kstruct, key_t),
                            literal(vals, ht.tarray(elem_t))))
        res_t = je.dtype
        out.append(eval_expr(je))
    if res_t is None:
        res_t = key_t
    return literal(out, ht.tarray(res_t))
