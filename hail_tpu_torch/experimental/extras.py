"""Experimental-module parity batch (reference hail/python/hail/experimental):
tidyr reshapes, time formatting, expression persistence, define_function/loop,
filtering AF, haplotype EM, trio-matrix explode/phase, sparse-MT ops,
per-column export, ndarray blocking, ROC/metadata plots, block-matrix export.
"""

from __future__ import annotations

import json
import math
import os
import pickle
from typing import List, Optional

import numpy as np

from .. import types as ht
from ..expr import functions as F
from ..expr.expression import Expression, construct_expr, to_expr
from ..ir import columns as C
from ..ir.columns import Batch, DenseArrayColumn, ObjectColumn, PrimitiveColumn, StructColumn
from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
from ..table import Table, TableStage
from ..utils.structs import Struct


# ---------------------------------------------------------------------------
# tidyr: gather / spread / separate (reference experimental/tidyr.py)
# ---------------------------------------------------------------------------

def gather(ht_, key: str, value: str, *fields) -> Table:
    """Wide-to-long: collapse `fields` into (key, value) pairs, one output row
    per input row per field (reference tidyr.py:8)."""
    rows = ht_.collect()
    other = [f for f in ht_.row if f not in fields]
    out = []
    for r in rows:
        base = {f: r[f] for f in other}
        for f in fields:
            out.append(Struct(**base, **{key: f, value: r[f]}))
    vt = ht_.row.dtype[fields[0]]
    t_row = ht.tstruct(**{f: ht_.row.dtype[f] for f in other},
                       **{key: ht.tstr, value: vt})
    return Table(TableStage.from_batches(Batch({}, 1), [], t_row,
                                         [Batch.from_pylist(t_row, out)]))


def spread(ht_, field: str, value: str, key=None) -> Table:
    """Long-to-wide pivot: distinct values of `field` become new fields filled
    from `value` (reference tidyr.py:44)."""
    rows = ht_.collect()
    key_fields = list(key) if key is not None else \
        [f for f in ht_.row if f not in (field, value)]
    new_cols = sorted({r[field] for r in rows if r[field] is not None})
    vt = ht_.row.dtype[value]
    grouped = {}
    order = []
    for r in rows:
        k = tuple(_hashable(r[f]) for f in key_fields)
        if k not in grouped:
            grouped[k] = {f: r[f] for f in key_fields}
            order.append(k)
        grouped[k][str(r[field])] = r[value]
    out = [Struct(**{c: grouped[k].get(c) for c in
                     key_fields + [str(c) for c in new_cols]})
           for k in order]
    t_row = ht.tstruct(**{f: ht_.row.dtype[f] for f in key_fields},
                       **{str(c): vt for c in new_cols})
    return Table(TableStage.from_batches(Batch({}, 1), [], t_row,
                                         [Batch.from_pylist(t_row, out)]))


def separate(ht_, field: str, into: List[str], delim: str) -> Table:
    """Split a string field on `delim` into the `into` fields (reference
    tidyr.py:102)."""
    fe = ht_[field]
    parts = fe.split(delim)
    t2 = ht_.annotate(**{name: parts[i] for i, name in enumerate(into)})
    return t2.drop(field) if field not in into else t2


def _hashable(v):
    return tuple(v) if isinstance(v, list) else v


# ---------------------------------------------------------------------------
# time (reference experimental/time.py — C-style format, IANA zone ids)
# ---------------------------------------------------------------------------

# C/strftime(3) directives Python's strptime/strftime lack (the reference
# engine parses with a full strftime grammar)
_C_TIME_ALIASES = {
    '%D': '%m/%d/%y',
    '%F': '%Y-%m-%d',
    '%T': '%H:%M:%S',
    '%R': '%H:%M',
    '%r': '%I:%M:%S %p',
    '%l': '%I',    # hour 1-12, blank-padded (strptime is pad-lenient)
    '%e': '%d',    # day, blank-padded
    '%k': '%H',    # hour 0-23, blank-padded
    '%h': '%b',
    '%n': ' ',
    '%t': ' ',
}


def _c_time_format(fmt: str) -> str:
    for k, v in _C_TIME_ALIASES.items():
        fmt = fmt.replace(k, v)
    return fmt


def _zone(z: str):
    import datetime
    import re as _re
    from zoneinfo import ZoneInfo
    try:
        return ZoneInfo(z)
    except Exception:
        # java.time accepts 'GMT+2'-style ids (sign = offset FROM UTC,
        # unlike POSIX); tzdata has no file for them
        m = _re.fullmatch(r'(?:GMT|UTC)?([+-])(\d{1,2})(?::?(\d{2}))?', z)
        if m:
            sign = 1 if m.group(1) == '+' else -1
            return datetime.timezone(sign * datetime.timedelta(
                hours=int(m.group(2)), minutes=int(m.group(3) or 0)))
        raise


def strftime(format, time, zone_id):
    """Format unix seconds as a string in the given IANA time zone
    (reference time.py:8)."""
    def impl(fmt, t, z):
        import datetime
        import re as _re
        dt = datetime.datetime.fromtimestamp(t, tz=_zone(z))
        out = dt.strftime(_c_time_format(fmt))
        if '%z' in fmt:
            # the engine prints offsets colon-separated ('-04:00')
            raw = dt.strftime('%z')
            out = out.replace(raw, raw[:3] + ':' + raw[3:])
        return out
    return F._apply('strftime', ht.tstr, F._obj_impl(ht.tstr, impl),
                    to_expr(format), to_expr(time), to_expr(zone_id))


def strptime(time, format, zone_id):
    """Parse a time string with a C-style format in the given zone to unix
    seconds (reference time.py:53)."""
    def impl(t, fmt, z):
        import datetime
        dt = datetime.datetime.strptime(t, _c_time_format(fmt))
        dt = dt.replace(tzinfo=_zone(z))
        return int(dt.timestamp())
    return F._apply('strptime', ht.tint64, F._obj_impl(ht.tint64, impl),
                    to_expr(time), to_expr(format), to_expr(zone_id))


# ---------------------------------------------------------------------------
# expression persistence + function definition (reference expressions.py,
# function.py, loop.py)
# ---------------------------------------------------------------------------

def write_expression(expr, path: str, overwrite: bool = False):
    """Persist an evaluated expression value + type (reference
    expressions.py:9)."""
    e = to_expr(expr)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f'{path} exists; use overwrite=True')
    val = F.eval_expr(e)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump({'type': str(e.dtype), 'value': val}, f)


def read_expression(path: str, _assert_type=None) -> Expression:
    """Read an expression written by :func:`write_expression` (reference
    expressions.py:50)."""
    with open(path, 'rb') as f:
        d = pickle.load(f)
    t = ht.dtype(d['type'])
    if _assert_type is not None and t != _assert_type:
        raise TypeError(f'expected {_assert_type}, found {t}')
    return F.literal(d['value'], t)


class Function:
    """A named reusable expression function (reference function.py:10)."""

    def __init__(self, f, param_types, ret_type, name):
        self._f = f
        self._param_types = param_types
        self._ret_type = ret_type
        self._name = name

    def __call__(self, *args):
        return self._f(*(to_expr(a) for a in args))


def define_function(f, *param_types, _name: Optional[str] = None) -> Function:
    """Define a reusable expression function (reference function.py:30). In
    the reference this compiles the body once server-side; here expressions
    trace per call, so this is a typed wrapper."""
    return Function(f, [ht.dtype(p) if isinstance(p, str) else p for p in param_types],
                    None, _name or 'f')


class _RecurSentinel:
    __slots__ = ('args',)

    def __init__(self, args):
        self.args = args


class _NonLocalRecur(Exception):
    """A nested loop's body tail-called an ENCLOSING loop's recur: unwind out
    of the inner loop up to the frame whose name matches (reference: Recur
    may reference any enclosing TailLoop name; JVM codegen jumps frames)."""

    def __init__(self, loop_name, vals):
        super().__init__(loop_name)
        self.loop_name = loop_name
        self.vals = vals


class _RecurIR:
    """Marker IR for a tail-recursive continuation inside `loop` bodies
    (reference ir.Recur)."""

    _is_recur = True

    def __init__(self, loop_name, arg_irs, typ):
        self.loop_name = loop_name
        self.arg_irs = arg_irs
        self.typ = typ

    @property
    def children(self):
        return tuple(self.arg_irs)

    def map_children(self, f):
        return _RecurIR(self.loop_name, [f(a) for a in self.arg_irs], self.typ)

    def evaluate(self, env):
        raise RuntimeError('recur escaped tail position in hl.experimental.loop')


_loop_uid = [0]


class _TailLoopIR:
    """Tail-recursive loop node (reference ir.TailLoop): evaluates its body
    per element with the loop parameters rebound each iteration. Branches are
    interpreted lazily so `recur` fires only on the taken path; a foreign
    loop's recur unwinds via _NonLocalRecur to its owning frame."""

    def __init__(self, loop_name, names, arg_irs, arg_types, body, typ):
        self.loop_name = loop_name
        self.names = names
        self.arg_irs = arg_irs
        self.arg_types = arg_types
        self.body = body
        self.typ = typ

    @property
    def children(self):
        return (self.body, *self.arg_irs)

    def map_children(self, f):
        return _TailLoopIR(self.loop_name, self.names,
                           [f(a) for a in self.arg_irs], self.arg_types,
                           f(self.body), self.typ)

    def evaluate(self, env):
        from ..ir.nodes import If, Coalesce
        from ..ir.arrays import _eval_scalar_body
        arg_cols = [a.evaluate(env) for a in self.arg_irs]
        shapes = [tuple(c.shape) for c in arg_cols]
        shape = np.broadcast_shapes(env.shape, *shapes) if shapes else tuple(env.shape)
        objs = [C.to_object(c).broadcast_to(shape) for c in arg_cols]
        total = int(np.prod(shape)) if shape else 1
        flats = [o.values.ravel() for o in objs]

        def interp(ir, bind, i):
            if isinstance(ir, _RecurIR):
                vals = [_eval_scalar_body(a, env, bind, flat_index=i,
                                          full_shape=shape)
                        for a in ir.arg_irs]
                if ir.loop_name != self.loop_name:
                    raise _NonLocalRecur(ir.loop_name, vals)
                return _RecurSentinel(vals)
            if isinstance(ir, If):
                c = _eval_scalar_body(ir.cond, env, bind, flat_index=i,
                                      full_shape=shape)
                return interp(ir.cnsq if c is True else ir.altr, bind, i)
            if isinstance(ir, Coalesce):
                for child in ir.children:
                    v = interp(child, bind, i)
                    if isinstance(v, _RecurSentinel) or v is not None:
                        return v
                return None
            return _eval_scalar_body(ir, env, bind, flat_index=i,
                                     full_shape=shape)

        def run_one(i):
            cur = [fl[i] for fl in flats]
            remaining = 100_000_000
            while remaining:
                remaining -= 1
                bind = {n: (t, v) for n, t, v in
                        zip(self.names, self.arg_types, cur)}
                try:
                    res = interp(self.body, bind, i)
                except _NonLocalRecur as nlr:
                    if nlr.loop_name != self.loop_name:
                        raise
                    cur = nlr.vals
                    continue
                if isinstance(res, _RecurSentinel):
                    cur = res.args
                    continue
                return res
            raise RuntimeError('loop: exceeded max iterations')

        out = [run_one(i) for i in range(total)]
        res = C.from_pylist(self.typ, out)
        return res.reshape(shape) if shape else res.reshape(())


def loop(f, typ, *args):
    """Tail-recursive loop (reference loop.py:11): `f(recur, *args)` where a
    call to `recur` in tail position continues the loop. Trace-time checks
    mirror the reference exactly: recur arity/argument types, declared vs
    inferred result type, and tail-position analysis."""
    from ..ir.nodes import If, Coalesce, Ref
    typ = ht.dtype(typ) if isinstance(typ, str) else typ
    _loop_uid[0] += 1
    loop_name = f'__loop_{_loop_uid[0]}'
    arg_exprs = [to_expr(a) for a in args]
    names = [f'{loop_name}_arg{i}' for i in range(len(arg_exprs))]
    refs = [construct_expr(Ref(n, e.dtype), e._indices)
            for n, e in zip(names, arg_exprs)]

    def recur(*new_args):
        nexprs = [to_expr(a) for a in new_args]
        if len(nexprs) != len(arg_exprs):
            raise TypeError('Recursive call in loop has wrong number of arguments')
        err = None
        for i, (rexpr, expr) in enumerate(zip(nexprs, arg_exprs)):
            if rexpr.dtype != expr.dtype:
                if err is None:
                    err = 'Type error in recursive call,'
                err += (f'\n  at argument index {i}, loop arg type: '
                        f'{expr.dtype}, recur arg type: {rexpr.dtype}')
        if err is not None:
            raise TypeError(err)
        e = Expression.__new__(Expression)
        e._ir = _RecurIR(loop_name, [x._ir for x in nexprs], typ)
        e._indices = arg_exprs[0]._indices if arg_exprs else refs[0]._indices
        e._dtype = typ
        return e

    body_expr = to_expr(f(recur, *refs))
    if body_expr.dtype != typ:
        raise TypeError(f'requested type {typ} does not match inferred type '
                        f'{body_expr.dtype}')

    def contains_recursive_call(ir_):
        if isinstance(ir_, _RecurIR) and ir_.loop_name == loop_name:
            return True
        return any(contains_recursive_call(c) for c in ir_.children)

    def check_tail_recursive(ir_):
        if isinstance(ir_, If):
            if contains_recursive_call(ir_.cond):
                raise TypeError("branch condition can't contain recursive call!")
            check_tail_recursive(ir_.cnsq)
            check_tail_recursive(ir_.altr)
        elif isinstance(ir_, Coalesce):
            for c in ir_.children:
                check_tail_recursive(c)
        elif isinstance(ir_, _TailLoopIR):
            if any(contains_recursive_call(a) for a in ir_.arg_irs):
                raise TypeError("parameters passed to inner loop can't "
                                "contain recursive call!")
        elif not isinstance(ir_, _RecurIR) and contains_recursive_call(ir_):
            raise TypeError('found recursive expression outside of tail position!')

    check_tail_recursive(body_expr._ir)
    from ..expr.expression import unify_all
    ind = unify_all(*arg_exprs, body_expr) if arg_exprs else body_expr._indices
    node = _TailLoopIR(loop_name, names, [e._ir for e in arg_exprs],
                       [e.dtype for e in arg_exprs], body_expr._ir, typ)
    return construct_expr(node, ind)


# ---------------------------------------------------------------------------
# statistics builtins (reference is/hail/experimental/package.scala)
# ---------------------------------------------------------------------------

def filtering_allele_frequency(ac, an, ci):
    """Whiffin et al. 2017 filtering allele frequency (reference
    `is/hail/experimental/package.scala:22` calcFilterAlleleFreq)."""
    def impl(ac_v, an_v, ci_v):
        from scipy.stats import poisson
        from scipy.optimize import brentq
        ac_v = int(ac_v)
        an_v = int(an_v)
        if ac_v <= 1 or an_v == 0:
            return 0.0
        qpois = lambda q, lam: int(poisson.ppf(q, lam))

        def g(af):
            return float(ac_v) - 1 - qpois(ci_v, an_v * af)
        lower, upper, tol, precision = 1e-10, 2.0, 1e-7, 1e-6
        try:
            root = brentq(g, lower, upper, xtol=tol)
        except ValueError:
            root = 0.0
        rounder = 1.0 / (precision / 100.0)
        max_af = round(root * rounder) / rounder

        def find_max_ac(af):
            return 0 if af == 0 else qpois(ci_v, an_v * af)
        while find_max_ac(max_af) < ac_v:
            max_af += precision
        return max_af - precision
    return F._apply('filtering_allele_frequency', ht.tfloat64,
                    F._obj_impl(ht.tfloat64, impl),
                    to_expr(ac), to_expr(an), to_expr(ci))


def haplotype_freq_em(gt_counts):
    """Excoffier-Slatkin EM haplotype counts for a pair of biallelic variants
    (reference `is/hail/experimental/package.scala:47` haplotypeFreqEM).
    Input [AABB, AABb, AAbb, AaBB, AaBb, Aabb, aaBB, aaBb, aabb]; output
    [AB, aB, Ab, ab] estimated haplotype counts."""
    def impl(v):
        g = np.asarray(v, dtype=np.float64)
        assert g.size == 9, 'haplotype_freq_em requires 9 genotype counts'
        n = g.sum()
        if g[0] >= n:
            return [float(g[0]), 0.0, 0.0, 0.0]
        n_hap = 2.0 * n
        const = np.array([
            2.0 * g[0] + g[1] + g[3],   # AB
            2.0 * g[6] + g[3] + g[7],   # aB
            2.0 * g[2] + g[1] + g[5],   # Ab
            2.0 * g[8] + g[5] + g[7],   # ab
        ])
        p_next = (const + g[4] / 2.0) / n_hap
        p_cur = p_next + 1.0
        while np.max(np.abs(p_next - p_cur)) > 1e-7:
            p_cur = p_next
            cross = p_cur[0] * p_cur[3] + p_cur[1] * p_cur[2]
            extra = np.array([p_cur[0] * p_cur[3], p_cur[1] * p_cur[2],
                              p_cur[1] * p_cur[2], p_cur[0] * p_cur[3]])
            p_next = (const + extra * (g[4] / cross)) / n_hap
        return [float(x) for x in p_next * n_hap]
    t = ht.tarray(ht.tfloat64)
    return F._apply('haplotype_freq_em', t, F._obj_impl(t, impl),
                    to_expr(gt_counts))


# ---------------------------------------------------------------------------
# trio-matrix utilities (reference experimental/phase_by_transmission.py)
# ---------------------------------------------------------------------------

def explode_trio_matrix(tm: MatrixTable, col_keys: List[str] = ['s'],
                        keep_trio_cols: bool = True,
                        keep_trio_entries: bool = False) -> MatrixTable:
    """Split a trio MatrixTable back into a per-sample MatrixTable: each trio
    column becomes three sample columns (reference
    phase_by_transmission.py:275)."""
    select = {'proband': 'proband_entry', 'father': 'father_entry',
              'mother': 'mother_entry'}
    st = tm._stage
    cols = st.cols
    n_trios = cols.length
    roles = ['proband', 'father', 'mother']
    col_t_inner = st.col_type['proband']
    ent_t_inner = st.entry_type['proband_entry']
    new_cols_rows = []
    cols_py = cols.to_pylist()
    for trio in cols_py:
        for role in roles:
            rec = dict(trio[role]) if trio[role] is not None else {}
            if keep_trio_cols:
                rec['source_trio'] = trio
            new_cols_rows.append(Struct(**rec))
    col_t = col_t_inner
    if keep_trio_cols:
        col_t = col_t._insert_field('source_trio', st.col_type)
    new_cols = Batch.from_pylist(col_t, new_cols_rows)

    ent_t = ent_t_inner
    if keep_trio_entries:
        ent_t = ent_t._insert_field('source_trio_entry', st.entry_type)

    def pf(mb: MatrixBatch, pi: int) -> MatrixBatch:
        R = mb.n_rows
        out_flat = []
        role_cols = [mb.entries[select[role]] for role in roles]
        role_py = [rc.to_pylist() for rc in role_cols]
        for r in range(R):
            for t_i in range(n_trios):
                for role_i in range(3):
                    out_flat.append(role_py[role_i][r][t_i])
        ec = C.from_pylist(ent_t_inner, out_flat).reshape((R, 3 * n_trios))
        if isinstance(ec, StructColumn):
            ents = dict(ec.fields)
            if ec.missing is not None:
                ents = {k: v.with_missing(v.missing_mask() | ec.missing)
                        for k, v in ents.items()}
        else:
            ents = {}
        return MatrixBatch(mb.rows, ents)

    st3 = st.map_partitions(pf, new_entry_type=ent_t_inner)
    return MatrixTable(MatrixStage(st3.globals, new_cols, st3.row_key, col_keys,
                                   st3.row_type, col_t, ent_t_inner,
                                   st3.contexts, st3.partition_fn))


def phase_trio_matrix_by_transmission(tm: MatrixTable, call_field: str = 'GT',
                                      phased_call_field: str = 'PBT_GT') -> MatrixTable:
    """Annotate each trio entry with transmission-phased calls (reference
    phase_by_transmission.py:209). Proband: father|mother allele; parents:
    transmitted|untransmitted."""
    from . import phase_by_transmission as _pbt
    pe = tm.proband_entry[call_field]
    fe = tm.father_entry[call_field]
    me = tm.mother_entry[call_field]
    calls = F.array([me, fe, pe])
    phased = _pbt(tm.locus, tm.alleles, calls)
    return tm.annotate_entries(
        proband_entry=tm.proband_entry.annotate(**{phased_call_field: phased[2]}),
        father_entry=tm.father_entry.annotate(**{phased_call_field: phased[1]}),
        mother_entry=tm.mother_entry.annotate(**{phased_call_field: phased[0]}),
    )


# ---------------------------------------------------------------------------
# sparse matrix-table ops (reference experimental/sparse_mt/)
# ---------------------------------------------------------------------------

def densify(sparse_mt: MatrixTable) -> MatrixTable:
    """Expand reference blocks (END fields) into dense per-position entries
    (reference sparse_mt/densify.py). Sequential forward-fill of the last
    reference-block entry per sample within each contig."""
    st = sparse_mt._stage
    if 'END' not in st.entry_type.fields:
        raise ValueError("densify requires an 'END' entry field of type int32")
    ent_names = [f for f in st.entry_type.fields]
    out_ent_t = st.entry_type._drop_fields(['END'])

    batches = []
    carry = None       # per-sample Struct-like dict of last ref-block entry
    carry_end = None   # per-sample END position
    carry_contig = None
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        R = mb.n_rows
        Cn = mb.n_cols
        if carry is None:
            carry = [None] * Cn
            carry_end = np.full(Cn, -1, dtype=np.int64)
            carry_contig = np.full(Cn, -1, dtype=np.int64)
        loci = mb.rows.columns['locus']
        contig = np.asarray(loci.contig_idx)
        pos = np.asarray(loci.position)
        g = StructColumn(st.entry_type, dict(mb.entries), None, (R, Cn))
        rows_py = g.to_pylist()  # list of R lists of C structs/None
        end_c = mb.entries['END']
        end_vals = np.asarray(end_c.values)
        end_miss = end_c.missing_mask()
        # an entry is missing when every field is missing (filter_entries
        # marks per-field masks, not a struct-level mask)
        g_miss = np.logical_and.reduce([c.missing_mask() for c in mb.entries.values()])
        out_rows = []
        for r in range(R):
            row_out = []
            for s in range(Cn):
                if not g_miss[r, s]:
                    e = rows_py[r][s]
                    if not end_miss[r, s]:
                        carry[s] = e
                        carry_end[s] = end_vals[r, s]
                        carry_contig[s] = contig[r]
                    row_out.append(e)
                elif (carry[s] is not None and carry_contig[s] == contig[r]
                        and carry_end[s] >= pos[r]):
                    row_out.append(carry[s])
                else:
                    row_out.append(None)
            out_rows.append(row_out)
        # rebuild entries struct column without END
        flat = [e if e is None else Struct(**{k: v for k, v in e.items() if k != 'END'})
                for row in out_rows for e in row]
        ec = C.from_pylist(out_ent_t, flat).reshape((R, Cn))
        ents = dict(ec.fields) if isinstance(ec, StructColumn) else {}
        new_ents = {k: v for k, v in ents.items()}
        if isinstance(ec, StructColumn) and ec.missing is not None:
            new_ents = {k: v.with_missing((v.missing_mask() | ec.missing))
                        for k, v in new_ents.items()}
        batches.append(MatrixBatch(mb.rows, new_ents))

    def pf(ctx):
        return batches[int(ctx)]
    contexts = list(range(len(batches)))
    return MatrixTable(MatrixStage(st.globals, st.cols, st.row_key, st.col_key,
                                   st.row_type, st.col_type, out_ent_t,
                                   contexts, pf))


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def _udgic(j: int):
    """Unphased diploid genotype index -> (a, b) allele pair, a <= b
    (reference Genotype.gtPair)."""
    b = int((math.sqrt(8 * j + 1) - 1) / 2)
    while _tri(b + 1) <= j:
        b += 1
    while _tri(b) > j:
        b -= 1
    return (j - _tri(b), b)


def _gq_from_pl_py(pl):
    m, m2 = 99, 99
    for x in pl:
        if x is None:
            continue
        if x < m:
            m2 = m
            m = x
        elif x < m2:
            m2 = x
    return m2 - m


def sparse_split_multi(sparse_mt: MatrixTable, *, filter_changed_loci: bool = False) -> MatrixTable:
    """Split sparse (gVCF-style) multiallelic variants (reference
    sparse_mt/sparse_split_multi.py): one output row per alt allele,
    min-repped; local entry fields LGT/LPGT/LAD/LPL are re-expressed against
    the split global alleles via the local-allele index (LA) and LA is
    dropped. Reference blocks (single-allele rows) pass through with the L-
    prefix stripped; hom-ref calls keep their LGT/LPGT unchanged; PL elements
    are minima over the local genotypes that downcode to each split genotype.

    The reference builds this as one large traced expression over localized
    entries; here it is a per-partition columnar transform (same semantics,
    host-side)."""
    from ..genetics.call import Call
    from ..expr.functions import _min_rep_py
    from ..utils.misc import FatalError

    st = sparse_mt._stage
    ent_t = st.entry_type
    fset = set(ent_t.fields)
    if 'LA' not in fset:
        raise ValueError("sparse_split_multi: entry field 'LA' is required")
    lfields = ('LGT', 'LPGT', 'LAD', 'LPL')
    kept = [(f, ent_t[f]) for f in ent_t.fields
            if f != 'LA' and f not in lfields]
    appended = []
    for lf, nf in (('LGT', 'GT'), ('LPGT', 'PGT'), ('LAD', 'AD'), ('LPL', 'PL')):
        if lf in fset:
            appended.append((nf, ent_t[lf]))
    new_ent_t = ht.tstruct(**dict(kept + appended))
    new_field_order = [f for f, _ in kept + appended]
    row_t = st.row_type._insert_field('a_index', ht.tint32)._insert_field(
        'was_split', ht.tbool)

    def transform(e, n_alleles, a_index):
        if e is None:
            return None
        d = {f: e[f] for f in ent_t.fields}
        if n_alleles == 1:
            # reference-block row: strip the L prefix, drop LA
            out = {f: d[f] for f in ent_t.fields
                   if f != 'LA' and f not in lfields}
            for lf, nf in (('LGT', 'GT'), ('LPGT', 'PGT'),
                           ('LAD', 'AD'), ('LPL', 'PL')):
                if lf in fset:
                    out[nf] = d[lf]
            return out
        la = d.get('LA')
        lgt = d.get('LGT')
        lai = None
        if la is not None:
            for j, v in enumerate(la):
                if v == a_index:
                    lai = j
        # PL: minimum LPL over local genotypes downcoding to each split one
        pl = None
        if 'LPL' in fset:
            lpl = d.get('LPL')
            if lpl is not None and lai is not None and lgt is not None:
                if lgt.ploidy == 2:
                    pl = []
                    for i in range(3):
                        target = _udgic(i)
                        best = None
                        for j in range(_tri(len(la))):
                            a, b = _udgic(j)
                            dc = tuple(sorted((1 if a == lai else 0,
                                               1 if b == lai else 0)))
                            if dc == target:
                                v = lpl[j] if j < len(lpl) else None
                                if v is not None and (best is None or v < best):
                                    best = v
                        pl.append(best)
                else:
                    pl = []
                    for i in range(2):
                        best = None
                        for j in range(len(la)):
                            if int(j == lai) == i:
                                v = lpl[j] if j < len(lpl) else None
                                if v is not None and (best is None or v < best):
                                    best = v
                        pl.append(best)

        def dc_call(c):
            if c is None:
                return None
            if not any(a != 0 for a in c.alleles):   # not non-ref
                return c
            idx = lai if lai is not None else (len(la) if la is not None else None)
            if idx is None:
                return None
            dc = [1 if a == idx else 0 for a in c.alleles]
            if not c.phased:
                dc.sort()   # unphased calls are normalized j <= k
            return Call(dc, phased=c.phased)

        new_exprs = {}
        if 'LGT' in fset:
            new_exprs['GT'] = dc_call(lgt)
        if 'LPGT' in fset:
            new_exprs['PGT'] = dc_call(d.get('LPGT'))
        if 'LAD' in fset:
            lad = d.get('LAD')
            if lad is None:
                new_exprs['AD'] = None
            else:
                nra = lad[lai] if (lai is not None and lai < len(lad)) else None
                nra = 0 if nra is None else nra
                s = sum(x for x in lad if x is not None)
                new_exprs['AD'] = [s - nra, nra]
        if 'LPL' in fset:
            new_exprs['PL'] = pl
            if 'GQ' in fset:
                gq = _gq_from_pl_py(pl) if pl is not None else None
                new_exprs['GQ'] = gq if gq is not None else d.get('GQ')

        out = {f: d[f] for f in ent_t.fields
               if f != 'LA' and f not in lfields}
        hom_ref = (lgt is not None and len(lgt.alleles) > 0
                   and all(a == 0 for a in lgt.alleles))
        if hom_ref:
            # hom-ref calls keep LGT/LPGT verbatim
            if 'LGT' in fset:
                out['GT'] = lgt
            if 'LPGT' in fset:
                out['PGT'] = d.get('LPGT')
            for f, v in new_exprs.items():
                if f not in ('GT', 'PGT'):
                    out[f] = v
        else:
            out.update(new_exprs)
        return out

    batches = []
    for pi, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        rows_py = mb.rows.to_pylist()
        grid = StructColumn(ent_t, dict(mb.entries), None,
                            (mb.n_rows, mb.n_cols)).to_pylist() \
            if mb.n_rows else []
        new_rows = []
        new_ents = []
        for r, row in enumerate(rows_py):
            locus, alleles = row['locus'], row['alleles']
            n_all = len(alleles)
            if n_all < 3:
                splits = [(locus, list(alleles), 1, False)]
            else:
                splits = []
                for i in range(1, n_all):
                    mr = _min_rep_py(locus, [alleles[0], alleles[i]])
                    if mr.locus != locus:
                        if filter_changed_loci:
                            continue
                        raise FatalError(
                            'Found non-left-aligned variant in '
                            'sparse_split_multi\n'
                            f'old locus: {locus}\nold ref  : {alleles[0]}\n'
                            f'old alt  : {alleles[i]}\nmr locus : {mr.locus}\n'
                            f'mr ref   : {mr.alleles[0]}\nmr alt   : {mr.alleles[1]}')
                    splits.append((mr.locus, list(mr.alleles), i, True))
                splits.sort(key=lambda s: tuple(s[1]))
            ents_row = grid[r] if grid else [None] * mb.n_cols
            for (nl, na, ai, ws) in splits:
                nr = dict(row)
                nr['locus'] = nl
                nr['alleles'] = na
                nr['a_index'] = ai
                nr['was_split'] = ws
                new_rows.append(Struct(**nr))
                new_ents.append([transform(e, n_all, ai) for e in ents_row])
        rows_b = Batch.from_pylist(row_t, new_rows)
        Rp = len(new_rows)
        ents_cols = {}
        for f in new_field_order:
            flat = [None if e is None else e.get(f)
                    for rw in new_ents for e in rw]
            ents_cols[f] = C.from_pylist(new_ent_t[f], flat).reshape(
                (Rp, mb.n_cols))
        batches.append(MatrixBatch(rows_b, ents_cols))
    return MatrixTable(MatrixStage.from_batches(
        st.globals, st.cols, list(st.row_key), list(st.col_key), row_t,
        st.col_type, new_ent_t, batches))


# ---------------------------------------------------------------------------
# export / blocking helpers
# ---------------------------------------------------------------------------

def export_entries_by_col(mt: MatrixTable, path: str, batch_size: int = 256,
                          bgzip: bool = True, header_json_in_file: bool = True,
                          use_string_key_as_file_name: bool = False):
    """Write one TSV(.bgz) per column with row keys + that column's entries
    (reference experimental/export_entries_by_col.py)."""
    import gzip
    st = mt._stage
    os.makedirs(path, exist_ok=True)
    cols_py = st.cols.to_pylist()
    ckey = st.col_key[0] if st.col_key else None
    ent_fields = list(st.entry_type.fields)
    row_key = st.row_key
    mbs = [st.partition_fn(ctx) for ctx in st.contexts]
    for j in range(len(cols_py)):
        name = str(cols_py[j][ckey]) if (use_string_key_as_file_name and ckey) else f'{j:04d}'
        fp = os.path.join(path, name + ('.tsv.bgz' if bgzip else '.tsv'))
        op = gzip.open if bgzip else open
        with op(fp, 'wt') as f:
            if header_json_in_file:
                f.write('#' + json.dumps({'col': dict(cols_py[j])},
                                         cls=__import__('hail_tpu_torch.utils.misc', fromlist=['JSONEncoder']).JSONEncoder) + '\n')
            f.write('\t'.join(list(row_key) + ent_fields) + '\n')
            for mb in mbs:
                g = StructColumn(st.entry_type, dict(mb.entries), None,
                                 (mb.n_rows, mb.n_cols))
                col_entries = g.to_pylist()
                keys = {k: mb.rows.columns[k].to_pylist() for k in row_key}
                for r in range(mb.n_rows):
                    e = col_entries[r][j]
                    vals = [str(keys[k][r]) for k in row_key]
                    for fn2 in ent_fields:
                        v = None if e is None else e.get(fn2)
                        vals.append('NA' if v is None else str(v))
                    f.write('\t'.join(vals) + '\n')


def mt_to_table_of_ndarray(entry_expr, block_size: int = 16,
                           return_checkpointed_table_also: bool = False,
                           partition_size=None, window_size=None):
    """Blocks of the entry matrix as ndarray-typed table rows (reference
    experimental/table_ndarray_utils.py)."""
    from ..methods.statgen import _entry_expr_to_blocks
    e = to_expr(entry_expr)
    G, M = _entry_expr_to_blocks(e)
    G = np.where(M, 0.0, G.astype(np.float64)) if M is not None else G
    n = G.shape[0]
    rows = []
    for start in range(0, n, block_size):
        rows.append(Struct(idx=start // block_size,
                           ndarray=G[start:start + block_size]))
    t_row = ht.tstruct(idx=ht.tint64, ndarray=ht.tndarray(ht.tfloat64, 2))
    t = Table(TableStage.from_batches(Batch({}, 1), ['idx'], t_row,
                                      [Batch.from_pylist(t_row, rows)]))
    if window_size is not None:
        # reference returns (blocks, trailing_blocks_ht, checkpointed) in the
        # whitening path (table_ndarray_utils.py:85-110): each block row also
        # carries the `window_size` rows immediately preceding the block
        trows = []
        for start in range(0, n, block_size):
            lo = max(0, start - window_size)
            prev = np.zeros((0, G.shape[1])) if start == 0 else G[lo:start]
            trows.append(Struct(idx=start // block_size, prev_window=prev))
        tt_row = ht.tstruct(idx=ht.tint64,
                            prev_window=ht.tndarray(ht.tfloat64, 2))
        tt = Table(TableStage.from_batches(Batch({}, 1), ['idx'], tt_row,
                                           [Batch.from_pylist(tt_row, trows)]))
        return t, tt, t
    if return_checkpointed_table_also:
        return t, t
    return t


def block_matrices_tofiles(bms: List, prefix: str, overwrite: bool = False):
    """Write each BlockMatrix's data to `prefix<i>` as raw row-major float64
    (reference experimental/write_multiple.py block_matrices_tofiles)."""
    for i, bm in enumerate(bms):
        arr = np.asarray(bm.to_numpy(), dtype=np.float64)
        p = f'{prefix}{i}'
        if os.path.exists(p) and not overwrite:
            raise FileExistsError(p)
        arr.tofile(p)


def export_block_matrices(bms: List, prefix: str, overwrite: bool = False,
                          delimiter: str = '\t', header=None, add_index=False,
                          compression=None, custom_filenames=None):
    """Export BlockMatrices as delimited text (reference write_multiple.py)."""
    for i, bm in enumerate(bms):
        name = custom_filenames[i] if custom_filenames else f'{i}.tsv'
        p = os.path.join(prefix, name) if os.path.isdir(prefix) or prefix.endswith('/') \
            else f'{prefix}{name}'
        os.makedirs(os.path.dirname(p) or '.', exist_ok=True)
        arr = np.asarray(bm.to_numpy())
        with open(p, 'w') as f:
            if header:
                f.write(header + '\n')
            for r_i, row in enumerate(arr):
                pre = [str(r_i)] if add_index else []
                f.write(delimiter.join(pre + [repr(float(x)) for x in row]) + '\n')


def write_block_matrices(bms: List, prefix: str, overwrite: bool = False):
    """Write BlockMatrices in native format `prefix<i>.bm` (reference
    write_multiple.py)."""
    for i, bm in enumerate(bms):
        bm.write(f'{prefix}{i}.bm', overwrite=overwrite)


def write_matrix_tables(mts: List[MatrixTable], prefix: str,
                        overwrite: bool = False):
    """Write several MatrixTables under a shared prefix (reference
    write_multiple.py write_matrix_tables)."""
    paths = []
    for i, m in enumerate(mts):
        p = f'{prefix}{i}.mt'
        m.write(p, overwrite=overwrite)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# plots + datasets (reference experimental/plots.py, db.py)
# ---------------------------------------------------------------------------

def plot_roc_curve(ht_, scores, tp_label: str = 'tp', fp_label: str = 'fp',
                   colors=None, title: str = 'ROC Curve', hover_mode='mouse'):
    """ROC curves for score fields over a labeled table; returns
    (figure, aucs) (reference experimental/plots.py)."""
    import matplotlib.pyplot as plt
    if isinstance(scores, str):
        scores = [scores]
    rows = ht_.collect()
    fig, ax = plt.subplots()
    aucs = []
    for s in scores:
        pairs = [(r[s], bool(r[tp_label])) for r in rows if r[s] is not None]
        pairs.sort(key=lambda x: -x[0])
        n_pos = sum(1 for _, y in pairs if y)
        n_neg = len(pairs) - n_pos
        tps = fps = 0
        xs, ys = [0.0], [0.0]
        for _, y in pairs:
            if y:
                tps += 1
            else:
                fps += 1
            xs.append(fps / max(n_neg, 1))
            ys.append(tps / max(n_pos, 1))
        auc = float(np.trapezoid(ys, xs))
        aucs.append(auc)
        ax.plot(xs, ys, label=f'{s} (AUC={auc:.4f})')
    ax.plot([0, 1], [0, 1], 'k--', alpha=0.3)
    ax.set_xlabel('false positive rate')
    ax.set_ylabel('true positive rate')
    ax.set_title(title)
    ax.legend()
    return fig, aucs


def hail_metadata(t_path: str):
    """Plot per-partition row counts from a written table/matrix-table's
    metadata (reference experimental/plots.py hail_metadata)."""
    import matplotlib.pyplot as plt
    meta_p = os.path.join(t_path, 'metadata.json')
    if not os.path.exists(meta_p):
        raise FileNotFoundError(f'no metadata.json under {t_path}')
    with open(meta_p) as f:
        md = json.load(f)
    counts = md.get('partition_counts') or md.get('partition_rows') or []
    fig, ax = plt.subplots()
    ax.bar(range(len(counts)), counts)
    ax.set_xlabel('partition')
    ax.set_ylabel('rows')
    ax.set_title(os.path.basename(t_path))
    return fig


def get_gene_intervals(gene_symbols=None, gene_ids=None, transcript_ids=None,
                       verbose: bool = True, reference_genome=None,
                       gtf_file=None):
    """Intervals for the requested genes/transcripts from a GTF (reference
    experimental/import_gtf.py get_gene_intervals). `gtf_file` is required in
    this build (no egress to fetch Gencode)."""
    from . import import_gtf
    if gtf_file is None:
        raise ValueError('get_gene_intervals: gtf_file is required (no '
                         'network egress to download Gencode GTFs)')
    ht_ = import_gtf(gtf_file, reference_genome=reference_genome,
                     skip_invalid_contigs=True)
    rows = ht_.collect()
    out = []
    want_sym = set(gene_symbols or [])
    want_id = set(gene_ids or [])
    want_tx = set(transcript_ids or [])
    for r in rows:
        feat = r.get('feature') if hasattr(r, 'get') else r['feature']
        if feat == 'gene' and (r.get('gene_name') in want_sym or r.get('gene_id') in want_id):
            out.append(r.interval)
        elif feat == 'transcript' and r.get('transcript_id') in want_tx:
            out.append(r.interval)
    if verbose:
        print(f'get_gene_intervals: found {len(out)} intervals')
    return out
