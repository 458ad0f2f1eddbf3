"""Typecheck markers, coercers, and analysis helpers from the reference's
`hail.expr` namespace (expressions/typed_expressions + check.py): downstream
toolkits (e.g. gnomad) import these directly.
"""

from __future__ import annotations

from .. import types as ht
from .expression import (Expression, construct_expr, to_expr, impute_type,
                         unify_all, Indices)


class ExpressionException(Exception):
    """Raised on invalid expression construction/use (reference
    expressions/base_expression.py)."""


# -- typecheck markers (reference expressions/typed_expressions.py):
# callables validating/coercing arguments in @typecheck signatures. Here they
# are predicate-style coercers: expr_x(arg) -> Expression of that type.
def _marker(check):
    def coerce(arg):
        e = to_expr(arg)
        if not check(e.dtype):
            raise ExpressionException(f'type mismatch: found {e.dtype}')
        return e
    return coerce


expr_any = lambda arg: to_expr(arg)
expr_int32 = _marker(lambda t: t == ht.tint32)
expr_int64 = _marker(lambda t: t in (ht.tint32, ht.tint64))
expr_float32 = _marker(lambda t: t == ht.tfloat32)
expr_float64 = _marker(lambda t: t in (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64))
expr_numeric = _marker(lambda t: t in (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64))
expr_bool = _marker(lambda t: t == ht.tbool)
expr_str = _marker(lambda t: t == ht.tstr)
expr_call = _marker(lambda t: t == ht.tcall)
expr_locus = _marker(lambda t: isinstance(t, ht.tlocus))
expr_array = _marker(lambda t: isinstance(t, ht.tarray))
expr_set = _marker(lambda t: isinstance(t, ht.tset))
expr_dict = _marker(lambda t: isinstance(t, ht.tdict))
expr_struct = _marker(lambda t: isinstance(t, ht.tstruct))
expr_tuple = _marker(lambda t: isinstance(t, ht.ttuple))
expr_interval = _marker(lambda t: isinstance(t, ht.tinterval))
expr_ndarray = _marker(lambda t: isinstance(t, ht.tndarray))


def expr_oneof(*checks):
    def coerce(arg):
        e = to_expr(arg)
        for c in checks:
            try:
                return c(e)
            except Exception:
                continue
        raise ExpressionException(f'no matching type for {e.dtype}')
    return coerce


def hail_type(t):
    """Coerce a type or type string to a HailType (reference
    typecheck hail_type)."""
    return ht.dtype(t) if isinstance(t, str) else t


def unify_types(*ts):
    return ht.unify_types(*ts)


def unify_types_limited(*ts):
    return ht.unify_types(*ts)


def types_match(ts1, ts2) -> bool:
    return [t.dtype if isinstance(t, Expression) else t for t in ts1] == \
           [t.dtype if isinstance(t, Expression) else t for t in ts2]


def unify_exprs(*exprs):
    es = [to_expr(e) for e in exprs]
    t = None
    for e in es:
        t = e.dtype if t is None else ht.unify_types(t, e.dtype)
    if t is None:
        return es + [False]
    return [e if e.dtype == t else e._promote(t) if hasattr(e, '_promote') else e
            for e in es] + [True]


def is_numeric(t) -> bool:
    return t in (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64)


def is_primitive(t) -> bool:
    return t in (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64, ht.tbool, ht.tstr)


def is_container(t) -> bool:
    return isinstance(t, (ht.tarray, ht.tset, ht.tdict))


def is_compound(t) -> bool:
    return isinstance(t, (ht.tstruct, ht.ttuple)) or is_container(t)


def coercer_from_dtype(t):
    """A coercer callable for `t` (reference expressions.coercer_from_dtype):
    coerce(x) returns an Expression of type t."""
    t = hail_type(t)

    class _Coercer:
        def coerce(self, x):
            e = to_expr(x)
            if e.dtype == t:
                return e
            from . import functions as F
            if t == ht.tfloat64:
                return F.float64(e)
            if t == ht.tfloat32:
                return F.float32(e)
            if t == ht.tint64:
                return F.int64(e)
            if t == ht.tint32:
                return F.int32(e)
            return e

        def can_coerce(self, typ):
            return typ == t or ht.unify_types(typ, t) == t

        def requires_conversion(self, typ):
            # a value already of the target type needs no conversion
            return self.can_coerce(typ) and typ != t
    return _Coercer()


def matrix_table_source(caller: str, expr):
    """The MatrixTable an expression is bound to (reference check.py)."""
    from ..matrixtable import MatrixTable
    src = to_expr(expr)._indices.source
    if not isinstance(src, MatrixTable):
        raise ExpressionException(f'{caller}: expected a MatrixTable-bound '
                                  f'expression, found {type(src).__name__}')
    return src


def table_source(caller: str, expr):
    from ..table import Table
    src = to_expr(expr)._indices.source
    if not isinstance(src, Table):
        raise ExpressionException(f'{caller}: expected a Table-bound '
                                  f'expression, found {type(src).__name__}')
    return src


def raise_unless_row_indexed(caller: str, expr):
    e = to_expr(expr)
    if 'row' not in e._indices.axes:
        raise ExpressionException(f'{caller}: expression must be row-indexed')


def raise_unless_column_indexed(caller: str, expr):
    e = to_expr(expr)
    if 'col' not in e._indices.axes and 'column' not in e._indices.axes:
        raise ExpressionException(f'{caller}: expression must be column-indexed')


def raise_unless_entry_indexed(caller: str, expr):
    e = to_expr(expr)
    if not {'row', 'col'} <= set(a if a != 'column' else 'col' for a in e._indices.axes):
        raise ExpressionException(f'{caller}: expression must be entry-indexed')


def analyze(caller: str, expr, expected_indices, aggregation_axes=frozenset()):
    """Validate an expression against expected indices (reference
    expressions/check.py analyze). Index discipline is enforced at
    construction here, so this validates the source binding."""
    e = to_expr(expr)
    if hasattr(expected_indices, 'source') and expected_indices.source is not None:
        if e._indices.source is not None and e._indices.source is not expected_indices.source:
            raise ExpressionException(f'{caller}: expression bound to a different source')
    return e


def eval_typed(expr):
    """(value, type) of a source-free expression (reference eval_typed)."""
    e = to_expr(expr)
    from .functions import eval_expr
    return eval_expr(e), e.dtype


def eval_timed(expr):
    """(value, timings) (reference eval_timed)."""
    import time
    t0 = time.time()
    from .functions import eval_expr
    v = eval_expr(to_expr(expr))
    return v, {'total_ms': (time.time() - t0) * 1000.0}


#: hl.expr type aliases (reference exports tint/tfloat as int32/float64)
tint = ht.tint32
tfloat = ht.tfloat64


class Aggregation:
    """Marker for aggregation-context expressions (reference
    expressions/base_expression.py Aggregation)."""

    def __init__(self, *exprs):
        self.exprs = exprs


# -- internal helpers re-exported by hail.expr (reference functions.py) ------

def _console_log(message, result):
    """Print `message` when evaluated, then return `result` (reference
    _console_log)."""
    from . import functions as F
    me = to_expr(message)
    re_ = to_expr(result)

    def impl(mcol, rcol):
        import numpy as np
        from ..ir import columns as C
        mobj = C.to_object(mcol)
        for m in mobj.values.ravel():
            if m is not None:
                print(m)
        return rcol
    return F._apply('console_log', re_.dtype, impl, me, re_)


def _showstr(expr):
    """Hail display rendering of an expression's value (reference _showstr)."""
    from . import functions as F
    e = to_expr(expr)

    def render(v):
        if v is None:
            return 'NA'
        if v is True:
            return 'True'
        if v is False:
            return 'False'
        if isinstance(v, str):
            return f'"{v}"'
        if isinstance(v, (list, tuple)):
            return '[' + ','.join(render(x) for x in v) + ']'
        return str(v)
    return F._apply('showstr', ht.tstr,
                    F._obj_impl_lenient(ht.tstr, render), e)


def _sort_by(collection, f):
    """Sort by a binary less-than comparator (reference _sort_by)."""
    import functools as _ft
    from . import functions as F
    e = to_expr(collection)
    et = e.dtype.element_type

    def impl(col):
        import numpy as np
        from ..ir import columns as C
        obj = C.to_object(col)
        out = np.empty(obj.shape, dtype=object)
        fo, fv = out.ravel(), obj.values.ravel()
        from .functions import eval_expr, literal

        def lt(a, b):
            r = eval_expr(to_expr(f(literal(a, et) if a is not None else F.missing(et),
                                    literal(b, et) if b is not None else F.missing(et))))
            return -1 if r else 1
        for i in range(fo.size):
            v = fv[i]
            fo[i] = None if v is None else sorted(v, key=_ft.cmp_to_key(lt))
        return C.from_pylist(e.dtype, list(fo)).reshape(obj.shape)
    return F._apply('sort_by', e.dtype, impl, e)


def _compare(left, right):
    """Three-way comparison (reference _compare): -1/0/1."""
    from . import functions as F
    le, re_ = to_expr(left), to_expr(right)

    def cmp(a, b):
        if a == b:
            return 0
        return -1 if (b is None or (a is not None and a < b)) else 1
    return F._apply('compare', ht.tint32, F._obj_impl(ht.tint32, cmp), le, re_)


def _values_similar(left, right, tolerance=1e-6, absolute=False):
    from . import functions as F
    le, re_ = to_expr(left), to_expr(right)

    def sim(a, b):
        from ..table import _values_same
        return _values_same(a, b, tolerance, absolute)
    return F._apply('values_similar', ht.tbool,
                    F._obj_impl_lenient(ht.tbool, lambda a, b: sim(a, b)), le, re_)


def _stream_range(start, stop=None, step=1):
    from . import functions as F
    return F.range_(start, stop, step)


def _zip_func(*arrays, f):
    from . import functions as F
    return F.map_(f, *arrays)


def _locus_windows_per_contig(coords, radius):
    """Per-contig window start/stop arrays (reference
    _locus_windows_per_contig): coords is array<array<float64>> grouped by
    contig; returns struct(starts, stops) over the flattened array."""
    from . import functions as F
    ce = to_expr(coords)
    t = ht.tstruct(starts=ht.tarray(ht.tint32), stops=ht.tarray(ht.tint32))

    def impl(v, r):
        import numpy as np
        from ...linalg.utils import array_windows  # pragma: no cover
        starts_all, stops_all, off = [], [], 0
        for contig_coords in v:
            a = np.asarray(list(contig_coords), dtype=np.float64)
            s, e = array_windows(a, r)
            starts_all.extend((s + off).tolist())
            stops_all.extend((e + off).tolist())
            off += len(a)
        from ..utils.structs import Struct  # pragma: no cover
        return Struct(starts=starts_all, stops=stops_all)

    def impl2(v, r):
        import numpy as np
        from ..linalg.utils.misc import array_windows
        from ..utils.structs import Struct
        starts_all, stops_all, off = [], [], 0
        for contig_coords in v:
            a = np.asarray(list(contig_coords), dtype=np.float64)
            s, e = array_windows(a, r)
            starts_all.extend(int(x) + off for x in s)
            stops_all.extend(int(x) + off for x in e)
            off += len(a)
        return Struct(starts=starts_all, stops=stops_all)
    from . import functions as F
    return F._apply('locus_windows_per_contig', t,
                    F._obj_impl(t, impl2), ce, to_expr(radius))


# -- remaining hail.expr exports (aliases/type objects) ----------------------

#: GATK HTS entry schema (reference expr/__init__ hts_entry_schema)
hts_entry_schema = ht.tstruct(GT=ht.tcall, AD=ht.tarray(ht.tint32),
                              DP=ht.tint32, GQ=ht.tint32,
                              PL=ht.tarray(ht.tint32))


class tvariable:
    """Type variable placeholder (reference types.tvariable)."""

    def __init__(self, name='T', cond=None):
        self.name = name
        self.cond = cond


class tstream:
    def __init__(self, element_type):
        self.element_type = element_type


class ttable:
    def __init__(self, global_type=None, row_type=None, row_key=()):
        self.global_type = global_type
        self.row_type = row_type
        self.row_key = list(row_key)

    def _as_tuple(self):
        return (str(self.global_type), str(self.row_type), tuple(self.row_key))

    def __eq__(self, other):
        return isinstance(other, ttable) and self._as_tuple() == other._as_tuple()

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self._as_tuple())

    def __repr__(self):
        return (f'ttable(global_type={self.global_type}, '
                f'row_type={self.row_type}, row_key={self.row_key})')


class tmatrix:
    def __init__(self, global_type=None, col_type=None, col_key=(),
                 row_type=None, row_key=(), entry_type=None):
        self.global_type = global_type
        self.col_type = col_type
        self.col_key = list(col_key)
        self.row_type = row_type
        self.row_key = list(row_key)
        self.entry_type = entry_type

    def _as_tuple(self):
        return (str(self.global_type), str(self.col_type), tuple(self.col_key),
                str(self.row_type), tuple(self.row_key), str(self.entry_type))

    def __eq__(self, other):
        return isinstance(other, tmatrix) and self._as_tuple() == other._as_tuple()

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self._as_tuple())

    def __repr__(self):
        return (f'tmatrix(global_type={self.global_type}, '
                f'col_type={self.col_type}, col_key={self.col_key}, '
                f'row_type={self.row_type}, row_key={self.row_key}, '
                f'entry_type={self.entry_type})')


class tblockmatrix:
    def __init__(self, element_type=None, shape=(), is_row_vector=False,
                 block_size=4096):
        self.element_type = element_type
        self.shape = list(shape)
        self.is_row_vector = is_row_vector
        self.block_size = block_size


def construct_variable(name, typ, indices=None, aggregations=None):
    from .expression import construct_expr as _ce, Ref
    return _ce(Ref(name, typ), indices)


def construct_reference(name, typ, indices=None):
    return construct_variable(name, typ, indices)


def apply_expr(f, result_type, *args):
    es = [to_expr(a) for a in args]
    return f(*[e._ir for e in es])


def cast_expr(expr, dtype):
    return to_expr(expr, dtype)


def get_refs(*exprs):
    from ..ir.nodes import Ref
    out = {}

    def walk(ir):
        if isinstance(ir, Ref):
            out[ir.name] = ir.typ
        for c in ir.children:
            walk(c)
    for e in exprs:
        walk(to_expr(e)._ir)
    return out


def extract_refs_by_indices(exprs, indices):
    return {n for e in exprs for n in get_refs(e)}


def _zip_streams(*streams, fill_missing=False):
    from . import functions as F
    return F.zip_(*streams)


def _zip_join_producers(contexts, stream_f, key, joined_f):
    raise NotImplementedError(
        '_zip_join_producers is a lowering-internal stream combinator; use '
        'Table.multi_way_zip_join')
