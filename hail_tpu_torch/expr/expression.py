"""Lazy typed expressions over the value IR.

Capability parity with the reference expression system
(`hail/python/hail/expr/expressions/`): expressions carry a type, an IR, and
dimensional indices (row/column/global) relative to a source Table or
MatrixTable; operators and methods build IR; evaluation is columnar
(hail_tpu.ir). Fresh implementation.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Optional, Sequence, Tuple, Union

import numpy as np

from .. import types as ht
from ..genetics.call import Call
from ..genetics.locus import Locus
from ..utils.structs import Interval, Struct, frozendict
from ..ir import nodes as irn
from ..ir import arrays as ira
from ..ir.nodes import (IR, Apply, ApplyBinaryOp, ApplyUnaryOp, ArrayRef, Cast,
                        Coalesce, GetField, GetTupleElement, If, IsMissing,
                        Literal, MakeArray, MakeStruct, MakeTuple, NA, Ref)


class Indices:
    __slots__ = ('source', 'axes')

    def __init__(self, source=None, axes: FrozenSet[str] = frozenset()):
        self.source = source
        self.axes = frozenset(axes)

    def __eq__(self, other):
        return isinstance(other, Indices) and self.source is other.source and self.axes == other.axes

    def __repr__(self):
        return f'Indices(axes={set(self.axes)})'

    @staticmethod
    def unify(*indices: 'Indices') -> 'Indices':
        src = None
        axes = set()
        for ind in indices:
            if ind.source is not None:
                if src is not None and src is not ind.source:
                    from .typefuncs import ExpressionException
                    raise ExpressionException(
                        'Cannot combine expressions from different source objects.'
                        '\n    Found fields from 2 objects:'
                        f'\n        {type(src).__name__}'
                        f'\n        {type(ind.source).__name__}')
                src = ind.source
            axes |= ind.axes
        return Indices(src, frozenset(axes))


class Expression:
    """Base expression: wraps an IR node, a type, and indices."""

    # keep numpy from broadcasting python ops over expressions elementwise:
    # np.ndarray <op> Expression must defer to our reflected methods
    # (reference base_expression.py:552)
    __array_ufunc__ = None

    def __init__(self, ir: IR, indices: Optional[Indices] = None):
        self._ir = ir
        self._indices = indices or Indices()

    @property
    def dtype(self) -> ht.HailType:
        return self._ir.typ

    @property
    def _type(self) -> ht.HailType:
        # reference Expression._type (base_expression.py)
        return self._ir.typ

    def __repr__(self):
        return f'<{type(self).__name__} of type {self.dtype}>'

    # -- helpers -----------------------------------------------------------
    def _bin_op(self, op: str, other, reverse=False) -> 'Expression':
        o = to_expr(other)
        if isinstance(o.dtype, ht.tndarray) and \
                not isinstance(self.dtype, ht.tndarray):
            # scalar <op> ndarray broadcasts elementwise over the ndarray
            from . import ndarrays as nds
            import numpy as _np
            npf = {'+': _np.add, '-': _np.subtract, '*': _np.multiply,
                   '/': _np.true_divide, '//': _np.floor_divide,
                   '**': _np.power}.get(op)
            if npf is not None:
                l, r = (o, self) if reverse else (self, o)
                return nds.nd_binop(f'nd_{op}', npf, l, r,
                                    div=op in ('/', '**'))
        l, r = (o, self) if reverse else (self, o)
        ind = Indices.unify(l._indices, r._indices)
        return construct_expr(ApplyBinaryOp(op, l._ir, r._ir), ind)

    # -- comparison --------------------------------------------------------
    def __eq__(self, other):
        return self._bin_op('==', other)

    def __ne__(self, other):
        return self._bin_op('!=', other)

    def __hash__(self):
        return object.__hash__(self)

    def __bool__(self):
        raise TypeError(
            'cannot convert a Hail expression to bool; use hl.if_else / & / | for conditionals')

    def __iter__(self):
        # without this, python's iter-protocol would loop forever over
        # __getitem__(0), __getitem__(1), ... (reference base_expression.py)
        from .typefuncs import ExpressionException
        raise ExpressionException(f'{self!r} object is not iterable')

    # -- missingness -------------------------------------------------------
    def is_missing(self) -> 'BooleanExpression':
        return construct_expr(IsMissing(self._ir), self._indices)

    def is_defined(self) -> 'BooleanExpression':
        return construct_expr(ApplyUnaryOp('!', IsMissing(self._ir)), self._indices)

    # -- execution ---------------------------------------------------------
    def collect(self, _localize: bool = True):
        src = self._indices.source
        if src is None:
            # source-free expressions collect to their single value
            out = [eval_scalar(self)]
            if not _localize:
                from .functions import literal
                return literal(out, ht.tarray(self.dtype))
            return out
        if not self._indices.axes:
            # globals-indexed: a single value
            from ..utils.structs import thaw
            col = self._ir.evaluate(src._globals_env())
            vals = col.to_pylist()
            out = [thaw(vals[0]) if vals else None]
            if not _localize:
                from .functions import literal
                return literal(out, ht.tarray(self.dtype))
            return out
        from ..utils.structs import thaw
        out = [thaw(v) for v in src._collect_expr(self)]
        if not _localize:
            from .functions import literal
            return literal(out, ht.tarray(self.dtype))
        return out

    def take(self, n: int, _localize: bool = True):
        if not _localize:
            from .functions import literal
            return literal(self.take(n), ht.tarray(self.dtype))
        return self.collect()[:n]

    def _to_relational(self):
        """Build (table, field_name) presenting this expression relationally
        (reference Expression._to_relational_preserving_rows_and_cols)."""
        from ..table import Table
        src = self._indices.source
        axes = self._indices.axes
        if isinstance(src, Table):
            t = src
        else:
            if axes == {'row'}:
                t = src.rows()
            elif axes == {'column'}:
                t = src.cols()
            else:
                t = src.entries()
        if not axes:
            # globals-indexed: a one-row keyless table of just the value
            # (reference shows globals without any key column)
            from ..table import range_table
            from . import functions as F
            val = eval_scalar(self)
            t0 = range_table(1).key_by()
            return t0.select(**{'<expr>': F.literal(val, self.dtype)}), '<expr>'
        # a bare reference to an existing field keeps its own name
        ir_ = self._ir
        name = getattr(ir_, 'name', None)
        if isinstance(name, str) and name in t.row:
            if name in t.key:
                return t.select(), name
            return t.select(name), name
        if isinstance(src, Table):
            return t.select(**{'<expr>': self}), '<expr>'
        # matrix-sourced computed expressions re-anchor through select_*
        if axes == {'row'}:
            return src.select_rows(**{'<expr>': self}).rows().select('<expr>'), '<expr>'
        if axes == {'column'}:
            return src.select_cols(**{'<expr>': self}).cols().select('<expr>'), '<expr>'
        # evaluate the entry expr BEFORE dropping the row/col fields it may
        # reference (test_show_5: mt.af * mt.GT.n_alt_alleles())
        t2 = src.select_entries(**{'<expr>': self}).select_rows().select_cols().entries()
        return t2.select('<expr>'), '<expr>'

    def _to_relational_preserving_rows_and_cols(self, fallback_name='<expr>'):
        """(name, table) pair; full row/col/entry struct expressions map back
        to their source tables (reference base_expression.py:982)."""
        from ..table import Table
        source = self._indices.source
        if isinstance(source, Table):
            if self is source.row:
                return None, source
            if self is source.key:
                return None, source.select()
        elif source is not None:
            if self is source.row:
                return None, source.rows()
            if self is source.row_key:
                return None, source.rows().select()
            if self is source.col:
                return None, source.key_cols_by().cols()
            if self is source.col_key:
                return None, source.select_cols().key_cols_by().cols()
            if self is source.entry:
                return None, source.select_rows().select_cols()
        t, name = self._to_relational()
        return name, t

    def show(self, n=None, width=None, truncate=None,
             types: bool = True, handler=None):
        """Print (or hand to `handler`) a formatted table of values
        (reference Expression.show)."""
        if handler is None:
            handler = print
        if self._indices.source is None:
            # source-free expression: a one-row keyless table of the value
            # (reference: hl.literal(123).show() renders an <expr> table)
            from ..table import range_table
            from . import functions as F
            t0 = range_table(1).key_by().select(
                **{'<expr>': F.literal(eval_scalar(self), self.dtype)})
            return handler(t0._show(n, width, truncate, types))
        # full row/col/entry struct expressions show as their source table
        # (reference _show via _to_relational_preserving_rows_and_cols)
        _name, t = self._to_relational_preserving_rows_and_cols()
        from ..table import Table as _Table
        if not isinstance(t, _Table):
            # an entry struct maps back to its (pruned) MatrixTable
            return t.show(n_rows=n, width=width, truncate=truncate,
                          types=types, handler=handler)
        return handler(t._show(n, width, truncate, types))

    def _persist(self):
        """Eagerly evaluate and pin the value (reference Expression._persist:
        the persisted expression no longer depends on its inputs)."""
        from . import functions as F
        return F.literal(eval_scalar(self), self.dtype)

    def persist(self):
        return self._persist()

    def describe(self, handler=print):
        """Print the type and index context (reference
        Expression.describe)."""
        src = self._indices.source
        handler(f'Type: {self.dtype}')
        handler(f'Indices: {sorted(self._indices.axes)}')
        if src is not None:
            handler(f'Source: {type(src).__name__}')

    def export(self, path, delimiter='\t', missing='NA', header=True):
        """Export values as text (reference Expression.export): entry
        expressions write a row-key x column matrix with the col keys as
        the header; row/col expressions write key + value columns."""
        from ..genetics.call import Call as _Call
        from ..genetics.locus import Locus as _Locus
        from ..utils.structs import Struct as _Struct

        def render(v):
            import json as _json
            if v is None:
                return missing
            if v is True:
                return 'true'
            if v is False:
                return 'false'
            if isinstance(v, _Call):
                return str(v)
            if isinstance(v, _Locus):
                return f'{v.contig}:{v.position}'
            if isinstance(v, (list, tuple)):
                return _json.dumps([_json_safe(x) for x in v],
                                   separators=(',', ':'))
            if isinstance(v, (set, frozenset)):
                return _json.dumps(sorted(_json_safe(x) for x in v),
                                   separators=(',', ':'))
            if isinstance(v, (_Struct, dict)):
                return _json.dumps(_json_safe(v), separators=(',', ':'))
            import numpy as _np
            if isinstance(v, (float, _np.floating)):
                # the engine's TSV export writes doubles as %.4e
                return f'{float(v):.4e}'
            return str(v)

        def _json_safe(v):
            if isinstance(v, (_Struct, dict)):
                return {k: _json_safe(x) for k, x in v.items()}
            if isinstance(v, (list, tuple, set, frozenset)):
                return [_json_safe(x) for x in v]
            if isinstance(v, _Call):
                return str(v)
            return v

        src = self._indices.source
        axes = self._indices.axes
        from ..matrixtable import MatrixTable as _MT

        def _w(pth):
            import gzip as _gzip
            if pth.endswith('.gz') or pth.endswith('.bgz'):
                return _gzip.open(pth, 'wt')
            return open(pth, 'w')
        if isinstance(src, _MT) and axes == frozenset({'row', 'column'}):
            st = src._stage
            key_names = list(st.row_key)
            col_keys = st.cols.to_pylist()
            if len(st.col_key) == 1:
                col_hdrs = [render(k[st.col_key[0]]) for k in col_keys]
            else:
                # compound col keys render as JSON OBJECTS in the header
                # (reference export notes: "each compound column key is
                # converted to JSON")
                import json as _json2
                col_hdrs = [_json2.dumps({f: _json_safe(k[f])
                                          for f in st.col_key},
                                         separators=(',', ':'))
                            for k in col_keys]
            with _w(path) as f:
                if header:
                    f.write(delimiter.join(key_names + col_hdrs) + '\n')
                for i, ctx in enumerate(st.contexts):
                    mb = st.partition_fn(ctx)
                    env = src._entry_env(mb, i)
                    col = self._ir.evaluate(env)
                    if col.shape != env.shape:
                        col = col.broadcast_to(env.shape)
                    vals = col.to_pylist()
                    keys = [mb.rows.columns[k].to_pylist() for k in key_names]
                    for r in range(mb.n_rows):
                        parts = [render(keys[j][r]) for j in range(len(key_names))]
                        parts += [render(v) for v in vals[r]]
                        f.write(delimiter.join(parts) + '\n')
            return
        # row/col-indexed (or table rows): key fields + the value
        from ..ir.nodes import GetField
        name = self._ir.name if isinstance(self._ir, GetField) else 'value'
        if src is not None and not axes:
            # globals-indexed: single row, no key columns
            key_names, kvals = [], []
            vals = [eval_scalar(self)]
        elif isinstance(src, _MT) and axes == frozenset({'column'}):
            st = src._stage
            key_names = list(st.col_key)
            kvals = [st.cols.columns[k].to_pylist() for k in key_names]
            vals = src._collect_expr(self)
        elif src is not None:
            st = src._stage
            key_names = list(st.key) if hasattr(st, 'key') else list(st.row_key)
            rows = src.rows().collect() if isinstance(src, _MT) else src.collect()
            kvals = [[r[k] for r in rows] for k in key_names]
            vals = src._collect_expr(self) if not isinstance(src, _MT) \
                else src.rows()._collect_expr(self) if False else src._collect_expr(self)
        else:
            key_names, kvals = [], []
            vals = [eval_scalar(self)]
        with _w(path) as f:
            if header:
                f.write(delimiter.join(key_names + [name]) + '\n')
            for i, v in enumerate(vals):
                parts = [render(kv[i]) for kv in kvals] + [render(v)]
                f.write(delimiter.join(parts) + '\n')

    def summarize(self, handler=None):
        """Print summary statistics of the evaluated values (reference
        Expression.summarize)."""
        vals = self.collect() if self._indices.source is not None else [
            __import__('hail_tpu_torch').eval(self)]
        n_missing = sum(1 for v in vals if v is None)
        out = [f'{len(vals)} records, {n_missing} missing']
        nums = [v for v in vals if isinstance(v, (int, float)) and v is not None]
        if nums:
            import statistics
            out.append(f'min {min(nums)}, max {max(nums)}, mean {statistics.fmean(nums):.4g}')
        (handler or print)('\n'.join(out))

    def _promote_numeric(self, typ):
        if self.dtype == typ:
            return self
        return construct_expr(Cast(self._ir, typ), self._indices)


class NumericExpression(Expression):
    def __add__(self, other):
        return self._bin_op('+', other)

    def __radd__(self, other):
        return self._bin_op('+', other, reverse=True)

    def __sub__(self, other):
        return self._bin_op('-', other)

    def __rsub__(self, other):
        return self._bin_op('-', other, reverse=True)

    def __mul__(self, other):
        return self._bin_op('*', other)

    def __rmul__(self, other):
        return self._bin_op('*', other, reverse=True)

    def __truediv__(self, other):
        return self._bin_op('/', other)

    def __rtruediv__(self, other):
        return self._bin_op('/', other, reverse=True)

    def __floordiv__(self, other):
        return self._bin_op('//', other)

    def __rfloordiv__(self, other):
        return self._bin_op('//', other, reverse=True)

    def __mod__(self, other):
        return self._bin_op('%', other)

    def __rmod__(self, other):
        return self._bin_op('%', other, reverse=True)

    def __pow__(self, other):
        return self._bin_op('**', other)

    def __rpow__(self, other):
        return self._bin_op('**', other, reverse=True)

    def __neg__(self):
        return construct_expr(ApplyUnaryOp('-', self._ir), self._indices)

    def __pos__(self):
        return self

    def __lt__(self, other):
        return self._bin_op('<', other)

    def __le__(self, other):
        return self._bin_op('<=', other)

    def __gt__(self, other):
        return self._bin_op('>', other)

    def __ge__(self, other):
        return self._bin_op('>=', other)

    def __abs__(self):
        from . import functions as F
        return F.abs(self)


class BooleanExpression(NumericExpression):
    """Booleans support arithmetic (as 0/1) like the reference's
    BooleanExpression(NumericExpression)."""

    def __and__(self, other):
        return self._bin_op('&', other)

    def __rand__(self, other):
        return self._bin_op('&', other, reverse=True)

    def __or__(self, other):
        return self._bin_op('|', other)

    def __ror__(self, other):
        return self._bin_op('|', other, reverse=True)

    def __invert__(self):
        return construct_expr(ApplyUnaryOp('!', self._ir), self._indices)


class Int32Expression(NumericExpression):
    pass


class Int64Expression(NumericExpression):
    pass


class Float32Expression(NumericExpression):
    pass


class Float64Expression(NumericExpression):
    pass


class StringExpression(Expression):
    def __add__(self, other):
        return self._bin_op('+', other)

    def __radd__(self, other):
        return self._bin_op('+', other, reverse=True)

    def __mul__(self, other):
        # string repetition (reference StringExpression.__mul__)
        return self._bin_op('*', other)

    def __rmul__(self, other):
        return self._bin_op('*', other, reverse=True)

    def __lt__(self, other):
        return self._bin_op('<', other)

    def __le__(self, other):
        return self._bin_op('<=', other)

    def __gt__(self, other):
        return self._bin_op('>', other)

    def __ge__(self, other):
        return self._bin_op('>=', other)

    def _str_method(self, name, result_typ, *args):
        from . import functions as F
        return F._string_method(self, name, result_typ, *args)

    def length(self):
        return self._str_method('length', ht.tint32)

    def find(self, sub):
        """Index of first occurrence of `sub`, -1 if absent (reference
        StringExpression.find)."""
        from . import functions as F
        sube = to_expr(sub)
        return F._apply('str_find', ht.tint32,
                        F._obj_impl(ht.tint32, lambda a, b: a.find(b)),
                        self, sube)

    def reverse(self):
        from . import functions as F
        return F._apply('str_reverse', ht.tstr,
                        F._obj_impl(ht.tstr, lambda a: a[::-1]), self)

    def translate(self, mapping):
        """Character-by-character translation via a dict (reference
        StringExpression.translate)."""
        from . import functions as F
        me = to_expr(mapping)

        def f(a, m):
            from ..utils.misc import FatalError
            for k in m:
                if k is None or len(k) != 1:
                    raise FatalError(
                        f'translate: mapping keys must be one character, '
                        f'found {k!r}')
            return ''.join(m.get(ch, ch) for ch in a)
        return F._apply('str_translate', ht.tstr, F._obj_impl(ht.tstr, f),
                        self, me)

    def lower(self):
        return self._str_method('lower', ht.tstr)

    def upper(self):
        return self._str_method('upper', ht.tstr)

    def strip(self):
        return self._str_method('strip', ht.tstr)

    def contains(self, sub):
        return self._str_method('contains', ht.tbool, sub)

    def startswith(self, prefix):
        return self._str_method('startswith', ht.tbool, prefix)

    def endswith(self, suffix):
        return self._str_method('endswith', ht.tbool, suffix)

    def matches(self, regex, full_match=False):
        return self._str_method('matches', ht.tbool, regex, full_match)

    def replace(self, pattern, replacement):
        return self._str_method('replace', ht.tstr, pattern, replacement)

    def split(self, delim, n=None):
        return self._str_method('split', ht.tarray(ht.tstr), delim, n)

    def first_match_in(self, regex):
        return self._str_method('first_match_in', ht.tarray(ht.tstr), regex)

    def _split_line(self, delim, missing=('NA',), quote=None, regex=False):
        """TSV-style field splitting with quote support and missing-token
        substitution (reference StringExpression._split_line, the
        import_table line splitter)."""
        from . import functions as F
        import re as _re2
        miss = set(missing)
        pat = _re2.compile(delim if regex else _re2.escape(delim))

        def f(s):
            out = []
            i, n = 0, len(s)
            while i <= n:
                if quote and i < n and s[i] == quote:
                    j = s.index(quote, i + 1)
                    out.append(s[i + 1:j])
                    i = j + 1
                    m = pat.match(s, i)
                    if m:
                        i = m.end()
                    elif i >= n:
                        break
                else:
                    m = pat.search(s, i)
                    if m:
                        out.append(s[i:m.start()])
                        i = m.end()
                    else:
                        out.append(s[i:])
                        break
            return [None if t in miss else t for t in out]
        return F._apply('split_line', ht.tarray(ht.tstr),
                        F._obj_impl(ht.tarray(ht.tstr), f), self)

    def join(self, array):
        from . import functions as F
        c = to_expr(array)
        et = c.dtype.element_type
        if et != ht.tstr:
            raise TypeError(f'Expected str collection, {et} found')
        return F.delimit(c, self)

    def __getitem__(self, item):
        if isinstance(item, slice):
            return self._str_method('slice', ht.tstr,
                                    item.start, item.stop, item.step)
        return self._str_method('index', ht.tstr, item)


class CollectionExpression(Expression):
    def length(self):
        return construct_expr(ira.ArrayLen(ira.ToArray(self._ir)), self._indices)

    def size(self):
        return self.length()

    def map(self, f) -> 'Expression':
        from ..ir.nodes import ToStream
        et = self.dtype.element_type
        var = _fresh_name('elem')
        elem = construct_expr(Ref(var, et), self._indices)
        body = to_expr(f(elem))
        return construct_expr(ira.ArrayMap(ToStream(self._ir), var, body._ir),
                              Indices.unify(self._indices, body._indices))

    def filter(self, f) -> 'Expression':
        et = self.dtype.element_type
        var = _fresh_name('elem')
        elem = construct_expr(Ref(var, et), self._indices)
        body = to_expr(f(elem))
        return construct_expr(ira.ArrayFilter(self._ir, var, body._ir),
                              Indices.unify(self._indices, body._indices))

    def fold(self, f, zero) -> 'Expression':
        et = self.dtype.element_type
        zero = to_expr(zero)
        av = _fresh_name('acc')
        ev = _fresh_name('elem')
        acc = construct_expr(Ref(av, zero.dtype), self._indices)
        elem = construct_expr(Ref(ev, et), self._indices)
        body = to_expr(f(acc, elem))
        return construct_expr(ira.ArrayFold(ira.ToArray(self._ir), zero._ir, av, ev, body._ir),
                              Indices.unify(self._indices, zero._indices, body._indices))

    def scan(self, f, zero) -> 'Expression':
        et = self.dtype.element_type
        zero = to_expr(zero)
        av = _fresh_name('acc')
        ev = _fresh_name('elem')
        acc = construct_expr(Ref(av, zero.dtype), self._indices)
        elem = construct_expr(Ref(ev, et), self._indices)
        body = to_expr(f(acc, elem))
        return construct_expr(ira.ArrayScan(ira.ToArray(self._ir), zero._ir, av, ev, body._ir),
                              Indices.unify(self._indices, zero._indices, body._indices))

    def exists(self, f):
        # Kleene OR-reduce: any([False, NA]) is NA, any([True, NA]) is True
        return self.fold(lambda acc, x: acc | f(x), False)

    def any(self, f):
        return self.exists(f)

    def find(self, f):
        from . import functions as F
        return F.find(f, self)

    def flatmap(self, f):
        from . import functions as F
        from ..ir.nodes import StreamFlatMap
        out = F.flatmap(f, self)
        return construct_expr(StreamFlatMap(out._ir), out._indices)

    def group_by(self, f):
        from . import functions as F
        return F.group_by(f, self)

    def starmap(self, f):
        return self.map(lambda t: f(*[t[i] for i in range(len(t.dtype.types))]))

    def __getattr__(self, name):
        # struct-element field broadcast: array<struct{a,...}>.a -> array<a>,
        # recursing through nested collections: array<array<struct>>.a works
        # (reference ArrayStructExpression / SetStructExpression)
        if name.startswith('_'):
            raise AttributeError(name)
        et = self.dtype.element_type
        if isinstance(et, ht.tstruct) and name in et.fields:
            return self.map(lambda s: s[name])
        if isinstance(et, (ht.tarray, ht.tset)):
            leaf = et
            while isinstance(leaf, (ht.tarray, ht.tset)):
                leaf = leaf.element_type
            if isinstance(leaf, ht.tstruct) and name in leaf.fields:
                return self.map(lambda inner: getattr(inner, name))
        kind = 'Set' if isinstance(self.dtype, ht.tset) else 'Array'
        struct = 'Struct' if isinstance(et, ht.tstruct) else ''
        raise AttributeError(
            f'{kind}{struct}Expression instance has no field, method, or property {name!r}')

    def all(self, f):
        # Kleene AND-reduce: all([True, NA]) is NA, all([False, NA]) is False
        return self.fold(lambda acc, x: acc & f(x), True)

    def contains(self, item):
        from . import functions as F
        return F._collection_method(self, 'contains', ht.tbool, to_expr(item))


class ArrayExpression(CollectionExpression):
    # streams are arrays in this engine: conversion hooks are transparent
    # markers so the tree keeps the reference's observable stream boundaries
    def to_array(self):
        from ..ir.nodes import ToArray
        return construct_expr(ToArray(self._ir), self._indices)

    def _to_stream(self):
        return self

    def zip_with_index(self, start, index_first=True):
        """Stream of (index, element) tuples (reference
        StreamExpression.zip_with_index → StreamZip with a StreamIota)."""
        from . import functions as F
        from ..ir.nodes import StreamIota, StreamZip
        start_e = to_expr(start)
        n = self.length()
        idxs = F.range_(start_e, start_e + n)
        pair = F.zip_(idxs, self) if index_first else F.zip_(self, idxs)
        return construct_expr(StreamZip(pair._ir, [StreamIota()]),
                              pair._indices)

    # arrays order lexicographically (hail total order; reference
    # test_operators x45-x52)
    def __lt__(self, other):
        return self._bin_op('<', other)

    def __le__(self, other):
        return self._bin_op('<=', other)

    def __gt__(self, other):
        return self._bin_op('>', other)

    def __ge__(self, other):
        return self._bin_op('>=', other)

    def __getitem__(self, item):
        if isinstance(item, str):
            # field broadcast: array<struct{a,...}>["a"] == array.a
            return getattr(self, item)
        if isinstance(item, slice):
            s = None if item.start is None else to_expr(item.start)._ir
            e = None if item.stop is None else to_expr(item.stop)._ir
            st = None if item.step is None else to_expr(item.step)._ir
            return construct_expr(ira.ArraySlice(self._ir, s, e, st), self._indices)
        idx = to_expr(item)
        return construct_expr(ArrayRef(self._ir, idx._ir),
                              Indices.unify(self._indices, idx._indices))

    def first(self):
        return self[0]

    def last(self):
        return self[-1]

    def append(self, item):
        from . import functions as F
        return F._collection_method(self, 'append', self.dtype, to_expr(item))

    def extend(self, other):
        from . import functions as F
        return F._collection_method(self, 'extend', self.dtype, to_expr(other))

    def index(self, x):
        from . import functions as F
        if callable(x) and not isinstance(x, Expression):
            mapped = F.enumerate_(self).filter(lambda t: x(t[1])).map(lambda t: t[0])
            return F.or_missing(mapped.length() > 0, mapped.first())
        return F._collection_method(self, 'index_of', ht.tint32, to_expr(x))

    def _aggregate_scan(self, f):
        """Exclusive running scan over the array's elements (reference
        StreamExpression.aggregate_scan); only scan aggregators allowed."""
        from ..ir import agg as aggmod
        from ..ir import columns as C
        from ..ir.nodes import EvalEnv, substitute_aggs
        from .scans import ScanOp
        from .typefuncs import ExpressionException
        et = self.dtype.element_type
        var = _fresh_name('scan_elem')
        elem = construct_expr(Ref(var, et), self._indices)
        body = to_expr(f(elem))
        nodes = aggmod.collect_agg_nodes(body._ir)
        if any(not isinstance(n, ScanOp) for n in nodes):
            raise ExpressionException('local stream scan cannot aggregate')
        rt = ht.tarray(body.dtype)
        body_ir = body._ir
        arr_ir = self._ir

        class _LocalArrayScan(IR):
            def __init__(self, arr):
                self.arr = arr
                self.typ = rt

            @property
            def children(self):
                return (self.arr,)

            def map_children(self, fn):
                return _LocalArrayScan(fn(self.arr))

            def evaluate(self, env):
                col = self.arr.evaluate(env)
                obj = C.to_object(col)
                out = []
                for lst in obj.values.ravel():
                    if lst is None:
                        out.append(None)
                        continue
                    inner = EvalEnv(
                        {var: C.from_pylist(et, list(lst)),
                         '__row_idx__': C.PrimitiveColumn(
                             ht.tint64, np.arange(len(lst), dtype=np.int64))},
                        (len(lst),))
                    results = {}
                    for n_ in nodes:
                        rcol, _ = aggmod.scan_partition(n_, inner, None)
                        results[n_.uid] = rcol
                    rescol = substitute_aggs(body_ir, results).evaluate(inner)
                    if rescol.shape != (len(lst),):
                        rescol = rescol.broadcast_to((len(lst),))
                    out.append(rescol.to_pylist())
                return C.from_pylist(rt, out).reshape(obj.shape)
        from ..ir.nodes import StreamAggScan
        return construct_expr(StreamAggScan(_LocalArrayScan(arr_ir)), self._indices)

    def aggregate(self, f):
        """Aggregate over the array's elements with an aggregator expression
        (reference ArrayExpression.aggregate / _aggregate_local_array)."""
        from ..ir import agg as aggmod
        from ..ir import columns as C
        from ..ir.nodes import EvalEnv
        et = self.dtype.element_type
        var = _fresh_name('elem')
        elem = construct_expr(Ref(var, et), self._indices)
        body = to_expr(f(elem))
        body_ir = body._ir
        agg_nodes = aggmod.collect_agg_nodes(body_ir)
        rt = body.dtype
        arr_ir = self._ir

        class _LocalArrayAgg(IR):
            def __init__(self, arr):
                self.arr = arr
                self.typ = rt

            @property
            def children(self):
                return (self.arr,)

            def map_children(self, fn):
                return _LocalArrayAgg(fn(self.arr))

            def evaluate(self, env):
                import numpy as np
                col = self.arr.evaluate(env)
                obj = C.to_object(col)
                out = []
                for lst in obj.values.ravel():
                    if lst is None:
                        out.append(None)
                        continue
                    inner = EvalEnv({var: C.from_pylist(et, list(lst)),
                                     '__row_idx__': C.PrimitiveColumn(
                                         ht.tint64, np.arange(len(lst), dtype=np.int64))},
                                    (len(lst),))
                    states = aggmod.partial_aggregate(agg_nodes, inner, (0,))
                    res = aggmod.finalize_aggregate(body_ir, agg_nodes, states,
                                                    EvalEnv({}, (1,)))
                    vals = res.to_pylist()
                    out.append(vals[0] if vals else None)
                return C.from_pylist(rt, out).reshape(obj.shape)
        from ..ir.nodes import StreamAgg
        return construct_expr(StreamAgg(_LocalArrayAgg(arr_ir)),
                              self._indices)

    def head(self):
        """First element, or missing if empty (reference head)."""
        from . import functions as F
        return F.or_missing(self.length() > 0, self[0])

    def grouped(self, group_size):
        """Partition into consecutive groups of `group_size` (reference
        grouped)."""
        from . import functions as F
        n = to_expr(group_size)
        return F.range_(0, (self.length() + n - 1) // n).map(
            lambda i: self[i * n:(i + 1) * n])

    # -- elementwise arithmetic (reference ArrayNumericExpression) ----------
    def _arr_binop(self, other, op, reverse=False):
        if isinstance(other, ArrayExpression) or (
                not isinstance(other, Expression) and isinstance(other, (list, tuple))):
            o = to_expr(other)
            from . import functions as F
            pair = F.zip_(self, o)
            if reverse:
                return pair.map(lambda t: op(t[1], t[0]))
            return pair.map(lambda t: op(t[0], t[1]))
        oe = to_expr(other)
        if reverse:
            return self.map(lambda x: op(oe, x))
        return self.map(lambda x: op(oe if False else x, oe) if not reverse else op(oe, x))

    def __neg__(self):
        return self.map(lambda x: -x)

    def __add__(self, other):
        return self._arr_binop(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._arr_binop(other, lambda a, b: a + b, reverse=True)

    def __sub__(self, other):
        return self._arr_binop(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._arr_binop(other, lambda a, b: a - b, reverse=True)

    def __mul__(self, other):
        return self._arr_binop(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._arr_binop(other, lambda a, b: a * b, reverse=True)

    def __truediv__(self, other):
        return self._arr_binop(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._arr_binop(other, lambda a, b: a / b, reverse=True)

    def __floordiv__(self, other):
        return self._arr_binop(other, lambda a, b: a // b)

    def __rfloordiv__(self, other):
        return self._arr_binop(other, lambda a, b: a // b, reverse=True)

    def __mod__(self, other):
        return self._arr_binop(other, lambda a, b: a % b)

    def __rmod__(self, other):
        return self._arr_binop(other, lambda a, b: a % b, reverse=True)

    def __pow__(self, other):
        return self._arr_binop(other, lambda a, b: a ** b)

    def __rpow__(self, other):
        return self._arr_binop(other, lambda a, b: a ** b, reverse=True)


class SetExpression(CollectionExpression):
    def add(self, item):
        from . import functions as F
        return F._collection_method(self, 'set_add', self.dtype, to_expr(item))

    def remove(self, item):
        from . import functions as F
        return F._collection_method(self, 'set_remove', self.dtype, to_expr(item))

    def union(self, other):
        from . import functions as F
        return F._collection_method(self, 'set_union', self.dtype, to_expr(other))

    def intersection(self, other):
        from . import functions as F
        return F._collection_method(self, 'set_intersection', self.dtype, to_expr(other))

    def difference(self, other):
        from . import functions as F
        return F._collection_method(self, 'set_difference', self.dtype, to_expr(other))

    def is_subset(self, other):
        from . import functions as F
        return F._collection_method(self, 'set_is_subset', ht.tbool, to_expr(other))

    def __sub__(self, other):
        return self.difference(to_expr(other))

    def __rsub__(self, other):
        from . import functions as F
        return F._collection_method(to_expr(other), 'set_difference',
                                    self.dtype, self)

    def __and__(self, other):
        return self.intersection(to_expr(other))

    __rand__ = __and__

    def __or__(self, other):
        return self.union(to_expr(other))

    __ror__ = __or__

    def __xor__(self, other):
        u = self.union(to_expr(other))
        i = self.intersection(to_expr(other))
        return u.difference(i)

    __rxor__ = __xor__

    # comparisons are SUBSET relations (reference SetExpression ordering)
    def __le__(self, other):
        return self.is_subset(to_expr(other))

    def __lt__(self, other):
        o = to_expr(other)
        return self.is_subset(o) & (self != o)

    def __ge__(self, other):
        from . import functions as F
        return F._collection_method(to_expr(other), 'set_is_subset',
                                    ht.tbool, self)

    def __gt__(self, other):
        o = to_expr(other)
        return self.__ge__(o) & (self != o)


class DictExpression(Expression):
    def __getitem__(self, key):
        from . import functions as F
        return F._collection_method(self, 'dict_get_strict', self.dtype.value_type, to_expr(key))

    def key_set(self):
        """The keys as a set (reference DictExpression.key_set)."""
        from . import functions as F
        return F.set_(self.keys())

    def get(self, key, default=None):
        from . import functions as F
        if default is None:
            return F._collection_method(self, 'dict_get', self.dtype.value_type, to_expr(key))
        return F.coalesce(self.get(key), default)

    def contains(self, key):
        from . import functions as F
        return F._collection_method(self, 'dict_contains', ht.tbool, to_expr(key))

    def keys(self):
        from . import functions as F
        return F._collection_method(self, 'dict_keys', ht.tarray(self.dtype.key_type))

    def values(self):
        from . import functions as F
        return F._collection_method(self, 'dict_values', ht.tarray(self.dtype.value_type))

    def items(self):
        from . import functions as F
        return F._collection_method(
            self, 'dict_items',
            ht.tarray(ht.ttuple(self.dtype.key_type, self.dtype.value_type)))

    def size(self):
        from . import functions as F
        return F._collection_method(self, 'dict_size', ht.tint32)

    def map_values(self, f):
        from . import functions as F
        return F._dict_map_values(self, f)


def _ordering_key(v):
    """Recursive total-order key over Hail values: missing sorts last,
    loci by global position, structs/arrays lexicographically."""
    if v is None:
        return (1,)
    if isinstance(v, Locus):
        return (0, v.global_position())
    if isinstance(v, Struct):
        return (0, tuple(_ordering_key(x) for x in v.values()))
    if isinstance(v, (list, tuple)):
        return (0, tuple(_ordering_key(x) for x in v))
    return (0, v)


class StructExpression(Expression):
    @staticmethod
    def _from_fields(fields):
        """Build a struct expression from {name: expr} (reference
        StructExpression._from_fields)."""
        from . import functions as F
        return F.struct(**fields)

    @property
    def _warn_on_shadowed_name(self):
        """Field names that shadow Expression attributes; accessing the
        shadowing attribute warns once and removes the name from the set
        (reference base_expression shadowed-name warning)."""
        cached = self.__dict__.get('_shadowed_names')
        if cached is None:
            cached = {f for f in self.dtype.fields
                      if f.startswith('_') or hasattr(type(self), f)}
            self.__dict__['_shadowed_names'] = cached
        return cached

    def __getattribute__(self, name):
        if name != '__dict__':
            shadowed = object.__getattribute__(self, '__dict__').get('_shadowed_names')
            if shadowed and name in shadowed:
                import warnings
                warnings.warn(
                    f'Field {name} is shadowed by another method or attribute. '
                    f'Use ["{name}"] syntax to access the field.')
                shadowed.discard(name)
        return object.__getattribute__(self, name)

    def __getattr__(self, name: str):
        if name.startswith('_'):
            raise AttributeError(name)
        ir_ = object.__getattribute__(self, '_ir')
        if name in ir_.typ.fields:
            return self[name]
        raise AttributeError(f'StructExpression has no field or method {name!r}; fields: {list(ir_.typ.fields)}')

    def __getitem__(self, name):
        # use raw attribute access so internal field projection does not
        # consume _warn_on_shadowed_name entries
        ir_ = object.__getattribute__(self, '_ir')
        indices = object.__getattribute__(self, '_indices')
        if isinstance(name, slice):
            # positional field slicing (reference StructExpression slices)
            fields = list(ir_.typ.fields)[name]
            return self.select(*fields)
        if isinstance(name, int):
            name = list(ir_.typ.fields)[name]
        return construct_expr(GetField(ir_, name), indices)

    def __iter__(self):
        return iter(self.dtype.fields)

    def __len__(self):
        return len(self.dtype.fields)

    def __contains__(self, name):
        return name in self.dtype.fields

    def keys(self):
        return list(self.dtype.fields)

    def values(self):
        return [self[k] for k in self.dtype.fields]

    def items(self):
        return [(k, self[k]) for k in self.dtype.fields]

    def _order_op(self, other, py_op):
        """Lexicographic struct ordering over fields (reference struct
        ordering: orderings.scala struct comparison)."""
        from . import functions as F
        other = to_expr(other, self.dtype)

        def cmp(a, b):
            return py_op(_ordering_key(a), _ordering_key(b))
        return F._apply(f'struct_{py_op.__name__}', ht.tbool,
                        F._obj_impl(ht.tbool, cmp), self, other)

    def __lt__(self, other):
        import operator
        return self._order_op(other, operator.lt)

    def __le__(self, other):
        import operator
        return self._order_op(other, operator.le)

    def __gt__(self, other):
        import operator
        return self._order_op(other, operator.gt)

    def __ge__(self, other):
        import operator
        return self._order_op(other, operator.ge)

    def get(self, k, default=None):
        """Field by name, or `default` when absent (reference
        StructExpression.get)."""
        if k in self.dtype.fields:
            return self[k]
        from . import functions as F
        if default is None:
            raise ValueError(f'Struct has no field {k!r} and no default given')
        return to_expr(default)

    def annotate(self, **named_exprs) -> 'StructExpression':
        fields = {k: GetField(self._ir, k) for k in self.dtype.fields}
        inds = [self._indices]
        for k, v in named_exprs.items():
            e = to_expr(v)
            fields[k] = e._ir
            inds.append(e._indices)
        return construct_expr(MakeStruct(fields), Indices.unify(*inds))

    def select(self, *names, **named_exprs) -> 'StructExpression':
        fields = {k: GetField(self._ir, k) for k in names}
        inds = [self._indices]
        for k, v in named_exprs.items():
            e = to_expr(v)
            fields[k] = e._ir
            inds.append(e._indices)
        return construct_expr(MakeStruct(fields), Indices.unify(*inds))

    def drop(self, *names) -> 'StructExpression':
        fields = {k: GetField(self._ir, k) for k in self.dtype.fields if k not in names}
        return construct_expr(MakeStruct(fields), self._indices)

    def rename(self, mapping: Dict[str, str]) -> 'StructExpression':
        """Rename fields: unrenamed fields keep their order, renamed fields
        are appended (reference StructExpression.rename)."""
        old_fields = set(self.dtype.fields)
        new_to_old = {}
        for old, new in mapping.items():
            if old not in old_fields:
                raise ValueError(f'{old} is not a field of this struct: {self.dtype}.')
            if new in old_fields and new not in mapping:
                raise ValueError(
                    f'{old} is renamed to {new} but {new} is already in the struct: {self.dtype}.')
            if new in new_to_old:
                raise ValueError(f'{new} is the new name of both {old} and {new_to_old[new]}.')
            new_to_old[new] = old
        fields = {k: GetField(self._ir, k) for k in self.dtype.fields if k not in mapping}
        fields.update({new: GetField(self._ir, old) for old, new in mapping.items()})
        return construct_expr(MakeStruct(fields), self._indices)

    def flatten(self) -> 'StructExpression':
        fields = {}
        def rec(prefix, ir, typ):
            for k, t in typ.fields.items():
                name = f'{prefix}{k}'
                if isinstance(t, ht.tstruct):
                    rec(f'{name}.', GetField(ir, k), t)
                else:
                    fields[name] = GetField(ir, k)
        rec('', self._ir, self.dtype)
        return construct_expr(MakeStruct(fields), self._indices)


class TupleExpression(Expression):
    def __iter__(self):
        # statically-sized, so iteration/star-unpacking is well-defined
        # (reference TupleExpression.__iter__)
        for i in range(len(self.dtype.types)):
            yield self[i]

    def __len__(self):
        return len(self.dtype.types)

    # tuples order lexicographically, like structs/arrays
    def __lt__(self, other):
        return self._bin_op('<', other)

    def __le__(self, other):
        return self._bin_op('<=', other)

    def __gt__(self, other):
        return self._bin_op('>', other)

    def __ge__(self, other):
        return self._bin_op('>=', other)

    def count(self, value):
        """Number of tuple elements equal to `value` (reference
        TupleExpression.count)."""
        from . import functions as F
        out = to_expr(0)
        for i in range(len(self.dtype.types)):
            out = out + F.int32(F.coalesce(self[i] == value, False))
        return out

    def index(self, value, start=0, end=None):
        """Index of the first element equal to `value` (reference
        TupleExpression.index); missing if absent."""
        from . import functions as F
        n = len(self.dtype.types)
        end = n if end is None else end
        out = F.missing(ht.tint32)
        for i in reversed(range(start, min(end, n))):
            out = F.if_else(F.coalesce(self[i] == value, False), i, out)
        return out

    def __getitem__(self, i):
        if isinstance(i, slice):
            idxs = range(len(self.dtype.types))[i]
            elems = [self[j] for j in idxs]
            ind = Indices.unify(*[e._indices for e in elems]) if elems \
                else self._indices
            return construct_expr(MakeTuple([e._ir for e in elems]), ind)
        return construct_expr(GetTupleElement(self._ir, i), self._indices)

    def __len__(self):
        return len(self.dtype)


class CallExpression(Expression):
    def _call_method(self, name, result_typ, *args):
        from . import functions as F
        return F._call_method(self, name, result_typ, *args)

    @property
    def ploidy(self):
        return self._call_method('ploidy', ht.tint32)

    @property
    def phased(self):
        return self._call_method('phased', ht.tbool)

    def __getitem__(self, i):
        return self._call_method('allele_at', ht.tint32, to_expr(i))

    def n_alt_alleles(self):
        return self._call_method('n_alt_alleles', ht.tint32)

    def is_het(self):
        return self._call_method('is_het', ht.tbool)

    def is_hom_ref(self):
        return self._call_method('is_hom_ref', ht.tbool)

    def is_hom_var(self):
        return self._call_method('is_hom_var', ht.tbool)

    def is_het_ref(self):
        return self._call_method('is_het_ref', ht.tbool)

    def is_het_non_ref(self):
        return self._call_method('is_het_non_ref', ht.tbool)

    def is_non_ref(self):
        return self._call_method('is_non_ref', ht.tbool)

    def is_haploid(self):
        return self._call_method('is_haploid', ht.tbool)

    def is_diploid(self):
        return self._call_method('is_diploid', ht.tbool)

    def unphased_diploid_gt_index(self):
        return self._call_method('unphased_diploid_gt_index', ht.tint32)

    def one_hot_alleles(self, alleles):
        """`alleles` may be the allele COUNT or the alleles array itself
        (reference one_hot_alleles deprecated-overload: an array argument
        counts its elements)."""
        e = to_expr(alleles)
        if isinstance(e.dtype, ht.tarray):
            from . import functions as F
            e = F.len_(e)
        return self._call_method('one_hot_alleles', ht.tarray(ht.tint32), e)


    def unphase(self):
        """The unphased version of this call (reference CallExpression
        .unphase)."""
        from ..ir.nodes import Apply
        from . import functions as F
        from ..ir.columns import PrimitiveColumn
        from ..genetics.call import PHASED_BIT, PLOIDY_MASK, J_SHIFT, K_SHIFT, J_MASK, K_MASK

        def impl(col):
            import numpy as np
            p = np.asarray(col.values)
            j = (p >> J_SHIFT) & J_MASK
            k = (p >> K_SHIFT) & K_MASK
            diploid = (p & PLOIDY_MASK) == 2
            lo = np.where(diploid, np.minimum(j, k), j)
            hi = np.where(diploid, np.maximum(j, k), k)
            newp = ((p & PLOIDY_MASK) | (lo << J_SHIFT) | (hi << K_SHIFT)).astype(np.int32)
            return PrimitiveColumn(ht.tcall, newp, col.missing)
        return F._apply('unphase', ht.tcall, impl, self)

    def contains_allele(self, allele):
        """Whether the call has at least one copy of `allele` (reference
        CallExpression.contains_allele)."""
        from . import functions as F
        from ..ir.columns import PrimitiveColumn
        from ..genetics.call import PLOIDY_MASK, J_SHIFT, K_SHIFT, J_MASK, K_MASK
        ae = to_expr(allele)

        def impl(col, acol):
            import numpy as np
            shape = np.broadcast_shapes(col.shape, acol.shape)
            p = np.broadcast_to(np.asarray(col.values), shape)
            a = np.broadcast_to(np.asarray(acol.values), shape)
            j = (p >> J_SHIFT) & J_MASK
            k = (p >> K_SHIFT) & K_MASK
            ploidy = p & PLOIDY_MASK
            hit = ((ploidy >= 1) & (j == a)) | ((ploidy == 2) & (k == a))
            from ..ir.columns import _merge_missing
            m = _merge_missing(
                np.broadcast_to(col.missing_mask(), shape).copy() if col.missing is not None else None,
                np.broadcast_to(acol.missing_mask(), shape).copy() if acol.missing is not None else None)
            return PrimitiveColumn(ht.tbool, hit, m)
        return F._apply('contains_allele', ht.tbool, impl, self, ae)


class LocusExpression(Expression):
    def _locus_method(self, name, result_typ, *args):
        from . import functions as F
        return F._locus_method(self, name, result_typ, *args)

    def __add__(self, other):
        # shift position, clamped to the contig bounds (reference
        # LocusExpression.__add__)
        from . import functions as F
        rg = self.dtype.reference_genome
        n = to_expr(other)
        newpos = F.int32(F.min(F.max(F.int64(self.position) + F.int64(n),
                                     F.int64(1)),
                               F.int64(F.contig_length(self.contig, rg))))
        return F.locus(self.contig, newpos, rg)

    def __sub__(self, other):
        return self.__add__(to_expr(other) * -1)

    @property
    def contig(self):
        return self._locus_method('contig', ht.tstr)

    @property
    def position(self):
        return self._locus_method('position', ht.tint32)

    def global_position(self):
        return self._locus_method('global_position', ht.tint64)

    def in_autosome(self):
        return self._locus_method('in_autosome', ht.tbool)

    def in_x_par(self):
        return self._locus_method('in_x_par', ht.tbool)

    def in_x_nonpar(self):
        return self._locus_method('in_x_nonpar', ht.tbool)

    def in_y_par(self):
        return self._locus_method('in_y_par', ht.tbool)

    def in_y_nonpar(self):
        return self._locus_method('in_y_nonpar', ht.tbool)

    def in_mito(self):
        return self._locus_method('in_mito', ht.tbool)

    @property
    def contig_idx(self):
        """Index of the contig in the reference genome (reference
        LocusExpression.contig_idx)."""
        from . import functions as F

        def impl(col):
            import numpy as np
            from ..ir.columns import LocusColumn, PrimitiveColumn
            from ..ir import columns as C
            if isinstance(col, LocusColumn):
                return PrimitiveColumn(ht.tint32,
                                       np.asarray(col.contig_idx, np.int32),
                                       col.missing)
            obj = C.to_object(col)
            vals = np.asarray([(-1 if l is None else
                                l.reference_genome.contig_index(l.contig))
                               for l in obj.values.ravel()], np.int32).reshape(col.shape)
            miss = np.asarray([l is None for l in obj.values.ravel()],
                              bool).reshape(col.shape)
            return PrimitiveColumn(ht.tint32, vals, miss if miss.any() else None)
        return F._apply('contig_idx', ht.tint32, impl, self)

    def in_autosome_or_par(self):
        return self.in_autosome() | self.in_x_par() | self.in_y_par()

    def window(self, before, after):
        """Interval of loci from `before` bases upstream to `after` bases
        downstream, clipped to the contig (reference LocusExpression
        .window)."""
        from . import functions as F
        t = ht.tinterval(self.dtype)
        from ..ir.columns import ObjectColumn
        be, ae = to_expr(before), to_expr(after)

        def impl(lcol, bcol, acol):
            import numpy as np
            from ..ir import columns as C
            from ..utils.structs import Interval
            lobj = C.to_object(lcol)
            shape = np.broadcast_shapes(lobj.shape, bcol.shape, acol.shape)
            lv = np.broadcast_to(lobj.values, shape)
            bv = np.broadcast_to(np.asarray(bcol.values), shape)
            av = np.broadcast_to(np.asarray(acol.values), shape)
            out = np.empty(shape, dtype=object)
            fo, fl, fb, fa = out.ravel(), lv.ravel(), bv.ravel(), av.ravel()
            for i in range(fo.size):
                loc = fl[i]
                if loc is None:
                    fo[i] = None
                    continue
                rg = loc.reference_genome
                clen = rg.contig_length(loc.contig)
                start = max(1, loc.position - int(fb[i]))
                end = min(clen, loc.position + int(fa[i]))
                fo[i] = Interval(type(loc)(loc.contig, start, rg),
                                 type(loc)(loc.contig, end, rg), True, True)
            return C.from_pylist(t, list(fo)).reshape(shape)
        return F._apply('locus_window', t, impl, self, be, ae)

    def sequence_context(self, before=0, after=0):
        """Reference bases around the locus (requires a loaded FASTA,
        reference LocusExpression.sequence_context)."""
        from . import functions as F
        return F.get_sequence(self.contig, self.position, before, after)

    def __lt__(self, other):
        return self._bin_op('<', other)

    def __le__(self, other):
        return self._bin_op('<=', other)

    def __gt__(self, other):
        return self._bin_op('>', other)

    def __ge__(self, other):
        return self._bin_op('>=', other)


class IntervalExpression(Expression):
    def _interval_method(self, name, result_typ, *args):
        from . import functions as F
        return F._interval_method(self, name, result_typ, *args)

    @property
    def start(self):
        return self._interval_method('start', self.dtype.point_type)

    @property
    def end(self):
        return self._interval_method('end', self.dtype.point_type)

    @property
    def includes_start(self):
        return self._interval_method('includes_start', ht.tbool)

    @property
    def includes_end(self):
        return self._interval_method('includes_end', ht.tbool)

    def contains(self, point):
        return self._interval_method('interval_contains', ht.tbool, to_expr(point))

    def overlaps(self, other):
        return self._interval_method('interval_overlaps', ht.tbool, to_expr(other))


class NDArrayExpression(Expression):
    """NDArray surface (reference NDArrayExpression/NDArrayNumericExpression,
    expressions/typed_expressions.py); ops delegate to expr.ndarrays."""

    @property
    def ndim(self):
        return self.dtype.ndim

    @property
    def shape(self):
        from . import ndarrays as nds
        return nds.nd_shape(self)

    def _binop(self, name, npf, other, div=False, reflected=False):
        from . import ndarrays as nds
        if reflected:
            return nds.nd_binop(name, npf, other, self, div=div)
        return nds.nd_binop(name, npf, self, other, div=div)

    def __matmul__(self, other):
        from . import ndarrays as nds
        return nds.nd_matmul(self, other)

    def __rmatmul__(self, other):
        from . import ndarrays as nds
        return nds.nd_matmul(nds.nd_array(other), self)

    def __add__(self, other):
        import numpy as _np
        return self._binop('nd_add', _np.add, other)

    def __radd__(self, other):
        import numpy as _np
        return self._binop('nd_add', _np.add, other, reflected=True)

    def __sub__(self, other):
        import numpy as _np
        return self._binop('nd_sub', _np.subtract, other)

    def __rsub__(self, other):
        import numpy as _np
        return self._binop('nd_sub', _np.subtract, other, reflected=True)

    def __mul__(self, other):
        import numpy as _np
        return self._binop('nd_mul', _np.multiply, other)

    def __rmul__(self, other):
        import numpy as _np
        return self._binop('nd_mul', _np.multiply, other, reflected=True)

    def __truediv__(self, other):
        import numpy as _np
        return self._binop('nd_div', _np.true_divide, other, div=True)

    def __rtruediv__(self, other):
        import numpy as _np
        return self._binop('nd_div', _np.true_divide, other, div=True,
                           reflected=True)

    def __floordiv__(self, other):
        import numpy as _np
        return self._binop('nd_floordiv', _np.floor_divide, other)

    def __rfloordiv__(self, other):
        import numpy as _np
        return self._binop('nd_floordiv', _np.floor_divide, other,
                           reflected=True)

    def __pow__(self, other):
        import numpy as _np
        return self._binop('nd_pow', _np.power, other, div=True)

    def __neg__(self):
        from . import ndarrays as nds
        import numpy as _np
        return nds.nd_unary('nd_neg', _np.negative, self)

    @property
    def T(self):
        from . import ndarrays as nds
        return nds.nd_transpose(self)

    def transpose(self, axes=None):
        from . import ndarrays as nds
        return nds.nd_transpose(self, axes)

    def reshape(self, *shape):
        from . import ndarrays as nds
        return nds.nd_reshape(self, shape)

    def map(self, f):
        from . import ndarrays as nds
        return nds.nd_map(self, f)

    def map2(self, other, f):
        from . import ndarrays as nds
        return nds.nd_map2(self, other, f)

    def sum(self, axis=None):
        from . import ndarrays as nds
        return nds.nd_sum(self, axis)

    def __getitem__(self, item):
        from . import ndarrays as nds
        return nds.nd_getitem(self, item)

    def _to_array(self):
        from . import ndarrays as nds
        return nds.nd_to_array(self)

    def to_numpy(self):
        from . import functions as F
        return F.eval_expr(self)


_EXPR_CLASS = {
    'bool': BooleanExpression,
    'int32': Int32Expression,
    'int64': Int64Expression,
    'float32': Float32Expression,
    'float64': Float64Expression,
    'str': StringExpression,
    'call': CallExpression,
}


def construct_expr(ir: IR, indices: Optional[Indices] = None) -> Expression:
    t = ir.typ
    cls = _EXPR_CLASS.get(str(t))
    if cls is None:
        if isinstance(t, ht.tarray):
            cls = ArrayExpression
        elif isinstance(t, ht.tset):
            cls = SetExpression
        elif isinstance(t, ht.tdict):
            cls = DictExpression
        elif isinstance(t, ht.tstruct):
            cls = StructExpression
        elif isinstance(t, ht.ttuple):
            cls = TupleExpression
        elif isinstance(t, ht.tlocus):
            cls = LocusExpression
        elif isinstance(t, ht.tinterval):
            cls = IntervalExpression
        elif isinstance(t, ht.tndarray):
            cls = NDArrayExpression
        else:
            cls = Expression
    return cls(ir, indices)


_name_counter = [0]


def _fresh_name(prefix: str) -> str:
    _name_counter[0] += 1
    return f'__{prefix}_{_name_counter[0]}'


def impute_type(value: Any) -> ht.HailType:
    if isinstance(value, Expression):
        return value.dtype
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return ht.tbool
    if isinstance(value, (int, np.integer)):
        if -(2**31) <= int(value) < 2**31:
            return ht.tint32
        return ht.tint64
    if isinstance(value, np.float32):
        return ht.tfloat32
    if isinstance(value, (float, np.floating)):
        return ht.tfloat64
    if isinstance(value, str):
        return ht.tstr
    if isinstance(value, bytes):
        return ht.tbinary
    if isinstance(value, Call):
        return ht.tcall
    if isinstance(value, Locus):
        return ht.tlocus(value.reference_genome)
    if isinstance(value, Interval):
        return ht.tinterval(impute_type(value.start))
    if isinstance(value, Struct):
        return ht.tstruct(**{k: (ht.tvoid if v is None else impute_type(v))
                             for k, v in value.items()})
    if isinstance(value, list):
        ets = [impute_type(v) for v in value if v is not None]
        et = ht.unify_types(*ets) if ets else ht.tint32
        if et is None:
            from .typefuncs import ExpressionException
            raise ExpressionException(
                f'cannot impute array elements of heterogeneous types: '
                f'{sorted({str(t) for t in ets})}')
        return ht.tarray(et)
    if isinstance(value, tuple):
        return ht.ttuple(*[impute_type(v) for v in value])
    if isinstance(value, (set, frozenset)):
        ets = [impute_type(v) for v in value if v is not None]
        et = ht.unify_types(*ets) if ets else ht.tint32
        return ht.tset(et)
    if isinstance(value, (dict, frozendict)):
        kts = [impute_type(k) for k in value.keys()]
        vts = [impute_type(v) for v in value.values() if v is not None]
        kt = ht.unify_types(*kts) if kts else ht.tstr
        vt = ht.unify_types(*vts) if vts else ht.tint32
        if vt is None and kt == ht.tstr and not isinstance(value, frozendict):
            # str-keyed dicts with heterogeneous values impute as structs
            # (reference _impute_type Mapping fallback)
            return ht.tstruct(**{k: (ht.tvoid if v is None else impute_type(v))
                                 for k, v in value.items()})
        return ht.tdict(kt, vt)
    if isinstance(value, np.ndarray):
        et = {np.dtype(np.int32): ht.tint32, np.dtype(np.int64): ht.tint64,
              np.dtype(np.float32): ht.tfloat32, np.dtype(np.float64): ht.tfloat64,
              np.dtype(np.bool_): ht.tbool}.get(value.dtype, ht.tfloat64)
        return ht.tndarray(et, value.ndim)
    raise TypeError(f'cannot impute type of {value!r} ({type(value)})')


def _container_has_exprs(value) -> bool:
    from ..utils.structs import Struct as _Struct
    if isinstance(value, _Struct):
        return any(isinstance(v, Expression) or _container_has_exprs(v)
                   for v in value.values())
    if isinstance(value, (list, tuple, set, frozenset)):
        return any(isinstance(v, Expression) or _container_has_exprs(v) for v in value)
    if isinstance(value, dict):
        return any(isinstance(v, Expression) or _container_has_exprs(v)
                   for kv in value.items() for v in kv)
    return False


def to_expr(value: Any, dtype: Optional[ht.HailType] = None) -> Expression:
    if isinstance(dtype, str):
        dtype = ht.dtype(dtype)
    if isinstance(value, Expression):
        if dtype is not None and value.dtype != dtype:
            return construct_expr(Cast(value._ir, dtype), value._indices)
        return value
    if value is None:
        if dtype is None:
            raise TypeError('cannot create an expression from None without a type (use hl.missing(t))')
        return construct_expr(NA(dtype))
    # containers holding expressions build expression containers
    if _container_has_exprs(value):
        from ..utils.structs import Struct as _Struct
        if isinstance(value, _Struct):
            from . import functions as F
            return F.struct(**{k: to_expr(v) for k, v in value.items()})
        if isinstance(value, (list,)):
            elems = [to_expr(v) for v in value]
            t_el = elems[0].dtype
            for e in elems[1:]:
                u = ht.unify_types(t_el, e.dtype)
                t_el = u if u is not None else t_el
            elems = [e if e.dtype == t_el else
                     construct_expr(Cast(e._ir, t_el), e._indices) for e in elems]
            ind = Indices.unify(*[e._indices for e in elems])
            return construct_expr(MakeArray([e._ir for e in elems], ht.tarray(t_el)), ind)
        if isinstance(value, tuple):
            elems = [to_expr(v) for v in value]
            ind = Indices.unify(*[e._indices for e in elems])
            return construct_expr(MakeTuple([e._ir for e in elems]), ind)
        if isinstance(value, (set, frozenset)):
            from . import functions as F
            return F.set_(to_expr(list(value)))
        if isinstance(value, dict):
            from . import functions as F
            return F.dict_([(to_expr(k), to_expr(v)) for k, v in value.items()])
    t = dtype or impute_type(value)
    return construct_expr(Literal(value, t))


def unify_all(*exprs: Expression) -> Indices:
    return Indices.unify(*[e._indices for e in exprs])


def eval_scalar(expr: Expression):
    """Evaluate a source-free expression to a python value (hl.eval)."""
    from ..ir.nodes import EvalEnv
    from ..ir import agg as aggmod
    src = expr._indices.source
    if src is not None:
        # global-indexed expression on a table: bind globals
        if not expr._indices.axes:
            return src._eval_global_expr(expr)
        raise ValueError('cannot eval an expression with row/column indices; use collect()')
    agg_nodes = aggmod.collect_agg_nodes(expr._ir)
    if agg_nodes:
        raise ValueError('cannot eval an aggregation outside of a table context')
    # fast-restarts execution cache: skip re-evaluation of semantically
    # identical queries across sessions (reference SemanticHash.scala +
    # use_fast_restarts flag)
    from ..ir.semhash import execution_cache, semhash
    cache = execution_cache()
    key = semhash(expr._ir) if cache is not None else None
    if key is not None:
        hit, val = cache.lookup(key)
        if hit:
            return val
    from ..ir import columns as _C
    from .. import types as _ht
    import numpy as _np
    # NOTE: no uid bindings — the reference's hl.eval evaluates with an
    # EMPTY dynamic rng message (RNGStateLiteral + static split only), so
    # seeded functions here must see zero uid words for stream parity
    env = EvalEnv({}, (1,))
    col = expr._ir.evaluate(env)
    vals = col.to_pylist()
    from ..utils.structs import thaw
    out = thaw(vals[0]) if vals else None
    if key is not None:
        cache.put(key, out)
    return out


# late import (typefuncs itself imports this module): re-exported because the
# reference exposes ExpressionException at hail.expr.expressions
from .typefuncs import ExpressionException  # noqa: E402,F401
