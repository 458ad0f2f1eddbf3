"""Typed value IR + vectorized columnar evaluator.

This replaces the reference's Python-IR → Scala-IR → Emit/JVM-bytecode stack
(`hail/python/hail/ir/`, `is/hail/expr/ir/Emit.scala`): expressions build a
small typed IR; evaluation is vectorized over columns (numpy host tier), with
hot relational methods lowering to jitted jnp kernels separately
(hail_tpu/ops, hail_tpu/methods). Missingness follows Hail's 3-valued
semantics: strict propagation for most ops, Kleene logic for &/|, and
missing-aware builtins (is_defined, coalesce, if_else).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as ht
from ..utils.structs import Struct
from . import columns as C
from .columns import (Batch, Column, DenseArrayColumn, LocusColumn, ObjectColumn,
                      PrimitiveColumn, StructColumn, null_column)


class EvalEnv:
    """Evaluation environment: name → Column, with a common broadcast ndim."""

    __slots__ = ('bindings', 'shape')

    def __init__(self, bindings: Dict[str, Column], shape: Tuple[int, ...]):
        self.bindings = bindings
        self.shape = shape

    def bind(self, name: str, col: Column) -> 'EvalEnv':
        d = dict(self.bindings)
        d[name] = col
        return EvalEnv(d, self.shape)

    def with_shape(self, shape) -> 'EvalEnv':
        return EvalEnv(dict(self.bindings), shape)


_AGGREGATOR_IR_ATTRS = ('key_ir', 'inner_ir', 'arr_ir', 'zero_ir',
                        'seq_ir', 'comb_ir')


def aggregator_held_irs(aggregator):
    """IRs stored on an aggregator object itself (group_by keys, explode
    arrays, fold lambdas) — part of the expression tree for scope analysis
    even though they are not AggOp children."""
    return [getattr(aggregator, a) for a in _AGGREGATOR_IR_ATTRS
            if getattr(aggregator, a, None) is not None]


def walk_ir(root):
    """Yield every IR node of a tree (pre-order); non-IR child entries
    (field-name pairs etc.) are skipped. AggOp nodes also descend into
    aggregator-held IRs (group_by key, explode array, fold lambdas)."""
    stack = [root]
    while stack:
        n = stack.pop()
        if not hasattr(n, 'children'):
            continue
        yield n
        if isinstance(n, AggOp):
            stack.extend(aggregator_held_irs(n.aggregator))
        ch = n.children() if callable(n.children) else n.children
        for c in ch:
            if c is None:
                continue
            if isinstance(c, (tuple, list)):
                stack.extend(x for x in c if hasattr(x, 'children'))
            else:
                stack.append(c)


class IR:
    """Base IR node."""

    typ: ht.HailType

    @property
    def children(self) -> Sequence['IR']:
        return ()

    def evaluate(self, env: EvalEnv) -> Column:
        raise NotImplementedError(type(self).__name__)

    def map_children(self, f: Callable[['IR'], 'IR']) -> 'IR':
        return self

    def base_search(self, f) -> list:
        """All nodes in the tree matching predicate `f` (reference
        BaseIR.base_search, used by test_stream_randomness)."""
        return [n for n in walk_ir(self) if f(n)]

    # -- rendering (for tests / semantic hashing) -------------------------
    def render(self) -> str:
        parts = [type(self).__name__] + [c.render() for c in self.children]
        head = self._render_head()
        if head:
            parts.insert(1, head)
        return '(' + ' '.join(parts) + ')'

    def _render_head(self) -> str:
        return ''

    def free_refs(self) -> set:
        out = set()
        for c in self.children:
            out |= c.free_refs()
        return out


def required_fields(irs, ref_names=('row', 'va', 'sa', 'g')) -> Optional[Dict[str, set]]:
    """Which fields of each env struct an expression actually touches — the
    analysis behind projection pushdown into reads (the reference's
    `PruneDeadFields.scala` over its 146-node IR collapses to this walk over
    the typed evaluator IR). Returns {ref_name: field set}; None means the
    expression uses a whole struct opaquely (no pruning possible)."""
    out: Dict[str, set] = {n: set() for n in ref_names}
    whole = False

    def rec(node):
        nonlocal whole
        if isinstance(node, GetField) and isinstance(node.struct, Ref) \
                and node.struct.name in ref_names:
            out[node.struct.name].add(node.name)
            return
        if isinstance(node, Ref) and node.name in ref_names:
            whole = True
            return
        for c in node.children:
            rec(c)

    for ir in ([irs] if isinstance(irs, IR) else irs):
        rec(ir)
    return None if whole else out


def find_nodes(ir: IR, pred) -> List[IR]:
    out = []
    def rec(node):
        if pred(node):
            out.append(node)
        for c in node.children:
            rec(c)
    rec(ir)
    return out


class Ref(IR):
    def __init__(self, name: str, typ: ht.HailType):
        self.name = name
        self.typ = typ

    def evaluate(self, env):
        col = env.bindings[self.name]
        return col

    def _render_head(self):
        return self.name

    def free_refs(self):
        return {self.name}


class Literal(IR):
    def __init__(self, value: Any, typ: ht.HailType):
        self.value = value
        self.typ = typ

    def evaluate(self, env):
        ones = (1,) * len(env.shape)
        return C.from_pylist(self.typ, [self.value]).reshape(ones)

    def _render_head(self):
        return repr(self.value)


class ColumnLiteral(IR):
    """A pre-materialized column injected into the IR (used when substituting
    aggregation results back into the post-agg expression)."""

    def __init__(self, col: Column):
        self.col = col
        self.typ = col.typ

    def evaluate(self, env):
        return self.col

    def _render_head(self):
        return f'<column {self.col.shape}>'


class GetField(IR):
    def __init__(self, struct: IR, name: str):
        assert isinstance(struct.typ, ht.tstruct), struct.typ
        if name not in struct.typ.fields:
            raise KeyError(f'struct has no field {name!r}; fields: {list(struct.typ.fields)}')
        self.struct = struct
        self.name = name
        self.typ = struct.typ[name]

    @property
    def children(self):
        return (self.struct,)

    def map_children(self, f):
        return GetField(f(self.struct), self.name)

    def evaluate(self, env):
        s = self.struct.evaluate(env)
        if isinstance(s, StructColumn):
            return s.fields[self.name].with_missing(s.missing)
        # object struct column fallback
        vals = np.frompyfunc(lambda x: None if x is None else C._struct_get(x, self.name), 1, 1)(s.values)
        return C.from_pylist(self.typ, list(vals.ravel())).reshape(s.shape)

    def _render_head(self):
        return self.name


class GetTupleElement(IR):
    def __init__(self, tup: IR, idx: int):
        assert isinstance(tup.typ, ht.ttuple)
        self.tup = tup
        self.idx = idx
        self.typ = tup.typ[idx]

    @property
    def children(self):
        return (self.tup,)

    def map_children(self, f):
        return GetTupleElement(f(self.tup), self.idx)

    def evaluate(self, env):
        t = self.tup.evaluate(env)
        vals = np.frompyfunc(lambda x: None if x is None else x[self.idx], 1, 1)(C.to_object(t).values)
        return C.from_pylist(self.typ, list(vals.ravel())).reshape(t.shape)


class MakeStruct(IR):
    def __init__(self, fields: Dict[str, IR]):
        self.fields = dict(fields)
        self.typ = ht.tstruct(**{k: v.typ for k, v in fields.items()})

    @property
    def children(self):
        return tuple(self.fields.values())

    def map_children(self, f):
        return MakeStruct({k: f(v) for k, v in self.fields.items()})

    def evaluate(self, env):
        cols = {k: v.evaluate(env) for k, v in self.fields.items()}
        shape = _common_shape([c.shape for c in cols.values()], env.shape)
        cols = {k: c.broadcast_to(shape) if c.shape != shape else c for k, c in cols.items()}
        return StructColumn(self.typ, cols, None, shape)


class MakeTuple(IR):
    def __init__(self, elements: Sequence[IR]):
        self.elements = list(elements)
        self.typ = ht.ttuple(*[e.typ for e in elements])

    @property
    def children(self):
        return tuple(self.elements)

    def map_children(self, f):
        return MakeTuple([f(e) for e in self.elements])

    def evaluate(self, env):
        cols = [C.to_object(e.evaluate(env)) for e in self.elements]
        shape = _common_shape([c.shape for c in cols], env.shape)
        cols = [c.broadcast_to(shape) for c in cols]
        n = int(np.prod(shape))
        out = np.empty(shape, dtype=object)
        flat = out.ravel()
        flats = [c.values.ravel() for c in cols]
        for i in range(n):
            flat[i] = tuple(fv[i] for fv in flats)
        return ObjectColumn(self.typ, out)


class MakeArray(IR):
    def __init__(self, elements: Sequence[IR], typ: Optional[ht.tarray] = None):
        self.elements = list(elements)
        if typ is None:
            et = ht.unify_types(*[e.typ for e in elements])
            if et is None:
                raise TypeError('cannot unify array element types')
            typ = ht.tarray(et)
        self.typ = typ

    @property
    def children(self):
        return tuple(self.elements)

    def map_children(self, f):
        return MakeArray([f(e) for e in self.elements], self.typ)

    def evaluate(self, env):
        et = self.typ.element_type
        if et.numpy_dtype is not None and self.elements:
            cols = [Cast(e, et).evaluate(env) if e.typ != et else e.evaluate(env) for e in self.elements]
            shape = _common_shape([c.shape for c in cols], env.shape)
            cols = [c.broadcast_to(shape) if c.shape != shape else c for c in cols]
            vals = np.stack([c.values for c in cols], axis=-1)
            em = np.stack([c.missing_mask() for c in cols], axis=-1)
            w = len(cols)
            lengths = np.full(shape, w, dtype=np.int32)
            return DenseArrayColumn(self.typ, vals, lengths, em if em.any() else None, None)
        obj_cols = [C.to_object(e.evaluate(env)) for e in self.elements]
        shape = _common_shape([c.shape for c in obj_cols], env.shape) if obj_cols else (1,) * len(env.shape)
        out = np.empty(shape, dtype=object)
        flat = out.ravel()
        flats = [c.broadcast_to(shape).values.ravel() for c in obj_cols]
        for i in range(flat.size):
            flat[i] = [fv[i] for fv in flats]
        return ObjectColumn(self.typ, out)


class Cast(IR):
    def __init__(self, x: IR, typ: ht.HailType):
        self.x = x
        self.typ = typ

    @property
    def children(self):
        return (self.x,)

    def map_children(self, f):
        return Cast(f(self.x), self.typ)

    def evaluate(self, env):
        col = self.x.evaluate(env)
        if self.typ == self.x.typ:
            return col
        if isinstance(col, PrimitiveColumn) and self.typ.numpy_dtype is not None:
            return PrimitiveColumn(self.typ, col.values.astype(self.typ.numpy_dtype), col.missing)
        if self.typ == ht.tstr:
            obj = C.to_object(col)
            def conv(v):
                if v is None:
                    return None
                if isinstance(v, (bool, np.bool_)):
                    return 'true' if v else 'false'
                if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
                    return f'{v:.5e}' if False else repr(v)
                return str(v)
            return ObjectColumn(ht.tstr, np.frompyfunc(conv, 1, 1)(obj.values))
        if isinstance(col, DenseArrayColumn) and isinstance(self.typ, ht.tarray):
            et = self.typ.element_type
            if et.numpy_dtype is not None:
                return DenseArrayColumn(self.typ, col.values.astype(et.numpy_dtype),
                                        col.lengths, col.elem_missing, col.missing)
        obj = C.to_object(col)
        return ObjectColumn(self.typ, obj.values)


# ---------------------------------------------------------------------------
# Binary / unary operations
# ---------------------------------------------------------------------------

_ARITH_RESULT = {
    '+': None, '-': None, '*': None, '**': ht.tfloat64, '/': ht.tfloat64,
    '//': None, '%': None,
}
_CMP_OPS = {'==', '!=', '<', '<=', '>', '>='}
_BOOL_OPS = {'&', '|'}

_NP_BINOP = {
    '+': np.add, '-': np.subtract, '*': np.multiply, '/': np.true_divide,
    '//': np.floor_divide, '%': np.mod, '**': np.power,
    '==': np.equal, '!=': np.not_equal, '<': np.less, '<=': np.less_equal,
    '>': np.greater, '>=': np.greater_equal,
}


def binop_type(op: str, lt: ht.HailType, rt: ht.HailType) -> ht.HailType:
    if op in _CMP_OPS or op in _BOOL_OPS:
        return ht.tbool
    # numeric ops broadcast over arrays (reference: scalar <op> array and
    # array <op> array are elementwise)
    if isinstance(lt, ht.tarray) or isinstance(rt, ht.tarray):
        le = lt.element_type if isinstance(lt, ht.tarray) else lt
        re_ = rt.element_type if isinstance(rt, ht.tarray) else rt
        return ht.tarray(binop_type(op, le, re_))
    if op == '*' and ((lt == ht.tstr and rt in (ht.tint32, ht.tint64))
                      or (rt == ht.tstr and lt in (ht.tint32, ht.tint64))):
        # string repetition
        return ht.tstr
    if op == '/':
        if lt == ht.tfloat32 and rt in (ht.tfloat32, ht.tint32, ht.tint64):
            return ht.tfloat32
        if rt == ht.tfloat32 and lt in (ht.tint32, ht.tint64):
            return ht.tfloat32
        return ht.tfloat64
    if op == '**':
        return ht.tfloat64
    if op == '+' and (lt == ht.tstr or rt == ht.tstr):
        return ht.tstr
    u = ht.unify_types(lt, rt)
    if u == ht.tbool:
        u = ht.tint32
    if u is None:
        raise TypeError(f'invalid operands for {op}: {lt}, {rt}')
    return u


class ApplyBinaryOp(IR):
    def __init__(self, op: str, l: IR, r: IR):
        self.op = op
        self.l = l
        self.r = r
        self.typ = binop_type(op, l.typ, r.typ)

    @property
    def children(self):
        return (self.l, self.r)

    def map_children(self, f):
        return ApplyBinaryOp(self.op, f(self.l), f(self.r))

    def _render_head(self):
        return self.op

    def evaluate(self, env):
        lc = self.l.evaluate(env)
        rc = self.r.evaluate(env)
        return eval_binop(self.op, lc, rc, self.typ)


def eval_binop(op: str, lc: Column, rc: Column, out_typ: ht.HailType) -> Column:
    if op in _BOOL_OPS:
        return _kleene(op, lc, rc)
    # locus / object comparisons
    if isinstance(lc, LocusColumn) or isinstance(rc, LocusColumn):
        if op in _CMP_OPS and isinstance(lc, LocusColumn) and isinstance(rc, LocusColumn):
            lv, rv = lc.global_position(), rc.global_position()
            vals = _NP_BINOP[op](lv, rv)
            return PrimitiveColumn(ht.tbool, vals, C._merge_missing(lc.missing, rc.missing))
    if isinstance(lc, PrimitiveColumn) and isinstance(rc, PrimitiveColumn):
        with np.errstate(all='ignore'):
            lv, rv = lc.values, rc.values
            if op not in _CMP_OPS:
                # bools participate in arithmetic as 0/1 (numpy rejects e.g.
                # boolean subtract)
                if getattr(lv, 'dtype', None) == np.bool_:
                    lv = lv.astype(np.int32)
                if getattr(rv, 'dtype', None) == np.bool_:
                    rv = rv.astype(np.int32)
            if op == '**':
                # x ** y is float64 regardless of inputs (numpy raises on
                # int ** negative-int; the engine never does integer pow)
                lv = np.asarray(lv, dtype=np.float64)
                rv = np.asarray(rv, dtype=np.float64)
            vals = _NP_BINOP[op](lv, rv)
        missing = C._merge_missing(lc.missing, rc.missing)
        if out_typ.numpy_dtype is not None and vals.dtype != out_typ.numpy_dtype:
            vals = vals.astype(out_typ.numpy_dtype)
        return PrimitiveColumn(out_typ, vals, missing)
    # dense array elementwise with scalar / array
    if isinstance(lc, DenseArrayColumn) and isinstance(rc, PrimitiveColumn):
        with np.errstate(all='ignore'):
            if op == '**':
                vals = _NP_BINOP[op](np.asarray(lc.values, np.float64),
                                     np.asarray(rc.values, np.float64)[..., None])
            else:
                vals = _NP_BINOP[op](lc.values, rc.values[..., None])
        et = out_typ.element_type if isinstance(out_typ, ht.tarray) else out_typ
        missing = C._merge_missing(lc.missing, rc.missing)
        return DenseArrayColumn(ht.tarray(et), vals.astype(et.numpy_dtype), lc.lengths, lc.elem_missing, missing)
    # object fallback (strings, sets, structs...)
    lo, ro = C.to_object(lc), C.to_object(rc)
    shape = np.broadcast_shapes(lo.shape, ro.shape)
    lov = np.broadcast_to(lo.values, shape)
    rov = np.broadcast_to(ro.values, shape)
    py_op = _PY_BINOP[op]
    def f(a, b):
        if a is None or b is None:
            return None
        if op not in _CMP_OPS and isinstance(out_typ, ht.tarray):
            # numeric broadcast over arrays ('+' on lists must NOT
            # concatenate; elementwise with per-element missingness)
            def el(x, y):
                return None if x is None or y is None else py_op(x, y)
            if isinstance(a, list) and isinstance(b, list):
                return [el(x, y) for x, y in zip(a, b)]
            if isinstance(a, list):
                return [el(x, b) for x in a]
            if isinstance(b, list):
                return [el(a, y) for y in b]
        return py_op(a, b)
    vals = np.frompyfunc(f, 2, 1)(lov, rov)
    return C.from_pylist(out_typ, list(vals.ravel())).reshape(shape)


import operator as _opmod

_PY_BINOP = {
    '+': _opmod.add, '-': _opmod.sub, '*': _opmod.mul, '/': _opmod.truediv,
    '//': _opmod.floordiv, '%': _opmod.mod, '**': _opmod.pow,
    '==': _opmod.eq, '!=': _opmod.ne, '<': _opmod.lt, '<=': _opmod.le,
    '>': _opmod.gt, '>=': _opmod.ge,
}


def _kleene(op: str, lc: Column, rc: Column) -> Column:
    """Kleene 3-valued logic for & and | (Hail semantics:
    False & NA = False; True | NA = True)."""
    lv = np.asarray(lc.values if isinstance(lc, PrimitiveColumn) else C.to_object(lc).values == True, dtype=bool)
    rv = np.asarray(rc.values if isinstance(rc, PrimitiveColumn) else C.to_object(rc).values == True, dtype=bool)
    lm = lc.missing_mask()
    rm = rc.missing_mask()
    lv = np.where(lm, False, lv)
    rv = np.where(rm, False, rv)
    if op == '&':
        vals = lv & rv
        # missing unless either side is definitively False
        definite_false = (~lm & ~lv) | (~rm & ~rv)
        missing = (lm | rm) & ~definite_false
    else:
        vals = lv | rv
        definite_true = (~lm & lv) | (~rm & rv)
        missing = (lm | rm) & ~definite_true
    vals, missing = np.broadcast_arrays(vals | np.zeros(missing.shape, bool), missing)
    return PrimitiveColumn(ht.tbool, vals, missing if missing.any() else None)


class ApplyUnaryOp(IR):
    def __init__(self, op: str, x: IR):
        self.op = op
        self.x = x
        self.typ = ht.tbool if op == '!' else x.typ

    @property
    def children(self):
        return (self.x,)

    def map_children(self, f):
        return ApplyUnaryOp(self.op, f(self.x))

    def _render_head(self):
        return self.op

    def evaluate(self, env):
        col = self.x.evaluate(env)
        if isinstance(col, PrimitiveColumn):
            if self.op == '-':
                return PrimitiveColumn(self.typ, -col.values, col.missing)
            if self.op == '!':
                return PrimitiveColumn(ht.tbool, ~col.values.astype(bool), col.missing)
            if self.op == '~':
                return PrimitiveColumn(self.typ, ~col.values, col.missing)
        obj = C.to_object(col)
        f = {'-': lambda v: None if v is None else -v,
             '!': lambda v: None if v is None else not v,
             '~': lambda v: None if v is None else ~v}[self.op]
        return C.from_pylist(self.typ, list(np.frompyfunc(f, 1, 1)(obj.values).ravel())).reshape(obj.shape)


class If(IR):
    def __init__(self, cond: IR, cnsq: IR, altr: IR):
        assert cond.typ == ht.tbool
        t = ht.unify_types(cnsq.typ, altr.typ)
        if t is None:
            raise TypeError(f'if_else branches have incompatible types: {cnsq.typ}, {altr.typ}')
        self.cond = cond
        self.cnsq = cnsq if cnsq.typ == t else Cast(cnsq, t)
        self.altr = altr if altr.typ == t else Cast(altr, t)
        self.typ = t

    @property
    def children(self):
        return (self.cond, self.cnsq, self.altr)

    def map_children(self, f):
        return If(f(self.cond), f(self.cnsq), f(self.altr))

    def evaluate(self, env):
        cc = self.cond.evaluate(env)
        ac = self.cnsq.evaluate(env)
        bc = self.altr.evaluate(env)
        cm = cc.missing_mask()
        cv = np.where(cm, False, np.asarray(cc.values if isinstance(cc, PrimitiveColumn) else C.to_object(cc).values == True, dtype=bool))
        if isinstance(ac, PrimitiveColumn) and isinstance(bc, PrimitiveColumn):
            shape = np.broadcast_shapes(cv.shape, ac.shape, bc.shape)
            cv_b = np.broadcast_to(cv, shape)
            vals = np.where(cv_b, np.broadcast_to(ac.values, shape), np.broadcast_to(bc.values, shape))
            miss = np.where(cv_b, np.broadcast_to(ac.missing_mask(), shape), np.broadcast_to(bc.missing_mask(), shape))
            miss = miss | np.broadcast_to(cm, shape)
            return PrimitiveColumn(self.typ, vals, miss if miss.any() else None)
        ao, bo = C.to_object(ac), C.to_object(bc)
        shape = np.broadcast_shapes(cv.shape, ao.shape, bo.shape)
        cv_b = np.broadcast_to(cv, shape)
        vals = np.where(cv_b, np.broadcast_to(ao.values, shape), np.broadcast_to(bo.values, shape))
        vals = np.where(np.broadcast_to(cm, shape), None, vals)
        return C.from_pylist(self.typ, list(vals.ravel())).reshape(shape)


class IsMissing(IR):
    def __init__(self, x: IR):
        self.x = x
        self.typ = ht.tbool

    @property
    def children(self):
        return (self.x,)

    def map_children(self, f):
        return IsMissing(f(self.x))

    def evaluate(self, env):
        col = self.x.evaluate(env)
        return PrimitiveColumn(ht.tbool, col.missing_mask().copy(), None)


class Coalesce(IR):
    def __init__(self, args: Sequence[IR]):
        t = ht.unify_types(*[a.typ for a in args])
        if t is None:
            raise TypeError('coalesce arguments have incompatible types')
        self.args = [a if a.typ == t else Cast(a, t) for a in args]
        self.typ = t

    @property
    def children(self):
        return tuple(self.args)

    def map_children(self, f):
        return Coalesce([f(a) for a in self.args])

    def evaluate(self, env):
        cols = [a.evaluate(env) for a in self.args]
        shape = _common_shape([c.shape for c in cols], env.shape)
        out = cols[0].broadcast_to(shape)
        for c in cols[1:]:
            cb = c.broadcast_to(shape)
            m = out.missing_mask()
            if not m.any():
                break
            if isinstance(out, PrimitiveColumn) and isinstance(cb, PrimitiveColumn):
                vals = np.where(m, cb.values, out.values)
                miss = m & cb.missing_mask()
                out = PrimitiveColumn(self.typ, vals, miss if miss.any() else None)
            else:
                ov, cv = C.to_object(out).values, C.to_object(cb).values
                vals = np.where(m, cv, ov)
                out = C.from_pylist(self.typ, list(vals.ravel())).reshape(shape)
        return out


class NA(IR):
    def __init__(self, typ: ht.HailType):
        self.typ = typ

    def evaluate(self, env):
        return null_column(self.typ, (1,) * len(env.shape))


class ArrayRef(IR):
    def __init__(self, arr: IR, idx: IR):
        assert isinstance(arr.typ, ht.tarray), arr.typ
        self.arr = arr
        self.idx = idx
        self.typ = arr.typ.element_type

    @property
    def children(self):
        return (self.arr, self.idx)

    def map_children(self, f):
        return ArrayRef(f(self.arr), f(self.idx))

    def evaluate(self, env):
        ac = self.arr.evaluate(env)
        ic = self.idx.evaluate(env)
        if isinstance(ac, DenseArrayColumn) and isinstance(ic, PrimitiveColumn):
            shape = np.broadcast_shapes(ac.shape, ic.shape)
            ac2 = ac.broadcast_to(shape) if ac.shape != shape else ac
            iv = np.broadcast_to(ic.values, shape)
            res = ac2.index(iv)
            return res.with_missing(ic.missing_mask() if ic.missing is not None else None)
        ao = C.to_object(ac)
        io_ = C.to_object(ic)
        shape = np.broadcast_shapes(ao.shape, io_.shape)
        av = np.broadcast_to(ao.values, shape)
        iv = np.broadcast_to(io_.values, shape)
        def f(a, i):
            if a is None or i is None:
                return None
            if -len(a) <= i < len(a):
                return a[i]
            return None
        vals = np.frompyfunc(f, 2, 1)(av, iv)
        return C.from_pylist(self.typ, list(vals.ravel())).reshape(shape)


class Apply(IR):
    """Builtin function application: vectorized impl over columns.

    The registry analogue of the reference's `IRFunctionRegistry`
    (`is/hail/expr/ir/functions/Functions.scala`); impls live in
    hail_tpu/expr/functions.py.
    """

    def __init__(self, name: str, typ: ht.HailType, args: Sequence[IR],
                 impl: Callable[..., Column]):
        self.name = name
        self.typ = typ
        self.args = list(args)
        self.impl = impl

    @property
    def children(self):
        return tuple(self.args)

    def map_children(self, f):
        return Apply(self.name, self.typ, [f(a) for a in self.args], self.impl)

    def _render_head(self):
        return self.name

    def evaluate(self, env):
        cols = [a.evaluate(env) for a in self.args]
        return self.impl(*cols)


class RowIndex(IR):
    """The global row index within the table (used for UIDs/randomness;
    analogue of the reference's row UIDs, `ir/table_ir.py` uid machinery)."""

    def __init__(self):
        self.typ = ht.tint64

    def evaluate(self, env):
        col = env.bindings.get('__row_idx__')
        if col is None:
            raise ValueError('row index not available in this context')
        return col


class _StreamMarker(IR):
    """Transparent stream-boundary node: our evaluator treats arrays and
    streams uniformly, but the reference IR reifies the boundaries (ToArray/
    ToStream/StreamZip/StreamIota...). These markers give the expression
    tree the same observable shape (test_stream_randomness asserts node
    classes) while evaluation simply delegates."""

    def __init__(self, equiv: 'IR', extra_children=()):
        self.equiv = equiv
        self.typ = equiv.typ
        self._extra = tuple(extra_children)

    @property
    def children(self):
        return (self.equiv,) + self._extra

    def map_children(self, f):
        return type(self)(f(self.equiv), [f(c) for c in self._extra])

    def evaluate(self, env):
        return self.equiv.evaluate(env)


class ToArray(_StreamMarker):
    pass


class ToStream(_StreamMarker):
    pass


class StreamZip(_StreamMarker):
    pass


class StreamIota(IR):
    """Marker leaf: an unbounded 0,1,2,... stream (reference StreamIota);
    only appears inside StreamZip markers whose equiv computes the values."""

    def __init__(self):
        self.typ = ht.tarray(ht.tint32)

    def evaluate(self, env):
        raise NotImplementedError('StreamIota evaluates through its StreamZip')


class StreamFlatMap(_StreamMarker):
    pass


class StreamAgg(_StreamMarker):
    pass


class StreamAggScan(_StreamMarker):
    pass


class TableGetGlobals(_StreamMarker):
    pass


class RngUidTuple(IR):
    """The tuple of 64-bit uid words identifying the current evaluation
    context (reference randomness.md: the dynamic RNGSplit message — a row's
    uid, an entry's (row uid, col idx), an exploded element's
    (row uid, element idx)). Evaluates to a StructColumn of int64 words."""

    def __init__(self):
        self.typ = ht.tstruct(w0=ht.tint64)  # nominal; width is contextual

    def evaluate(self, env):
        from .columns import StructColumn
        words = []
        k = 0
        while f'__uid_w{k}__' in env.bindings:
            words.append(env.bindings[f'__uid_w{k}__'])
            k += 1
        if not words:
            col = env.bindings.get('__row_idx__')
            if col is None:
                # scalar/eval context: the reference's dynamic message is
                # empty (RNGStateLiteral + static split only)
                return StructColumn(ht.tstruct(), {}, None, env.shape)
            words = [col]
        # the uid columns may be wider than the env shape (rand inside an
        # array lambda evaluates element-wise while the env is still the
        # outer row shape): take the broadcast superset
        target = np.broadcast_shapes(env.shape, *[w.shape for w in words])
        ws = [w if w.shape == target else w.broadcast_to(target)
              for w in words]
        t = ht.tstruct(**{f'w{i}': ht.tint64 for i in range(len(ws))})
        return StructColumn(t, {f'w{i}': w for i, w in enumerate(ws)}, None,
                            target)


class AggOp(IR):
    """An aggregator application. Only valid inside aggregation contexts;
    evaluation is handled by hail_tpu.ir.agg (extract/seq/comb/result split,
    mirroring reference agg.Extract, `is/hail/expr/ir/agg/Extract.scala:26`)."""

    _counter = 0

    def __init__(self, aggregator, args: Sequence[IR], typ: ht.HailType,
                 filter_ir: Optional[IR] = None, init_args: Sequence[Any] = ()):
        self.aggregator = aggregator
        self.args = list(args)
        self.typ = typ
        self.filter_ir = filter_ir
        self.init_args = tuple(init_args)
        AggOp._counter += 1
        self.uid = f'__agg_{AggOp._counter}'

    @property
    def children(self):
        out = list(self.args)
        if self.filter_ir is not None:
            out.append(self.filter_ir)
        return tuple(out)

    def evaluate(self, env):
        raise ValueError(
            f'aggregator {self.aggregator.name} used outside of an aggregation context')

    def _render_head(self):
        return self.aggregator.name


def _common_shape(shapes: Sequence[Tuple[int, ...]], env_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if not shapes:
        return (1,) * len(env_shape)
    return np.broadcast_shapes(*shapes)


# ---------------------------------------------------------------------------
# substitution helper: replace AggOp nodes by materialized columns
# ---------------------------------------------------------------------------

def substitute_aggs(ir: IR, results: Dict[str, Column]) -> IR:
    if isinstance(ir, AggOp):
        return ColumnLiteral(results[ir.uid])
    return ir.map_children(lambda c: substitute_aggs(c, results))
