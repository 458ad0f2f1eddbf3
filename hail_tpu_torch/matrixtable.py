"""MatrixTable: rows × cols × entries structured matrix.

Capability parity with reference `hail/python/hail/matrixtable.py:542` — but
entries are dense 2-D `(n_rows, n_cols)` columnar blocks per partition
(ARCHITECTURE.md decision 3), not per-row arrays as in the reference's
`LowerMatrixIR` lowering. Row fields broadcast as (R,1) and col fields as
(1,C) into entry context, so entry expressions and aggregations are pure
vectorized reductions — the TPU-friendly layout (device tier consumes these
same blocks).
"""

from __future__ import annotations

import builtins

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import types as ht
from .context import Env
from .ir import agg as aggmod
from .ir import columns as C
from .ir.columns import Batch, Column, PrimitiveColumn, StructColumn
from .ir.nodes import EvalEnv, GetField, Ref
from .expr.expression import (Expression, Indices, StructExpression,
                              construct_expr, to_expr)
from .table import Table, TableStage, _expr_field_name, _sort_indices
from .utils.structs import Struct
from .utils.structs import freeze as _structs_freeze


class MatrixBatch:
    """A materialized matrix partition: row fields (R,) + entry fields (R,C).

    `entry_missing` is an optional struct-level (R, C) mask marking FILTERED
    (absent) entries, distinct from per-field missing: a filtered cell has no
    entry at all (reference filtered-entries semantics), while a present
    entry may have individually missing fields. When None, an entry is
    treated as filtered iff every field is missing."""

    __slots__ = ('rows', 'entries', 'entry_missing', 'uids', '__weakref__')

    def __init__(self, rows: Batch, entries: Dict[str, Column],
                 entry_missing: 'Optional[np.ndarray]' = None,
                 uids: 'Optional[np.ndarray]' = None):
        self.rows = rows
        self.entries = dict(entries)
        self.entry_missing = entry_missing
        # optional explicit per-row UIDs (reference: readers assign stable
        # row uids that survive filtering/repartitioning — randomness.md);
        # None → the stage's positional uid_for fallback
        self.uids = uids

    def entry_filtered_mask(self) -> np.ndarray:
        """(R, C) bool mask of filtered/absent entries."""
        if self.entry_missing is not None:
            return self.entry_missing
        if not self.entries:
            return np.zeros((self.n_rows, self.n_cols), dtype=bool)
        return np.logical_and.reduce(
            [c.missing_mask() for c in self.entries.values()])

    @property
    def n_rows(self) -> int:
        return self.rows.length

    @property
    def n_cols(self) -> int:
        if self.entries:
            return next(iter(self.entries.values())).shape[1]
        return 0

    def filter_rows(self, keep: np.ndarray) -> 'MatrixBatch':
        return MatrixBatch(self.rows.compress(keep),
                           {k: c.compress(keep, axis=0) for k, c in self.entries.items()},
                           self.entry_missing[keep] if self.entry_missing is not None else None,
                           uids=self.uids[keep] if self.uids is not None else None)

    def gather_rows(self, idx: np.ndarray) -> 'MatrixBatch':
        return MatrixBatch(self.rows.gather(idx),
                           {k: c.gather(idx, axis=0) for k, c in self.entries.items()},
                           self.entry_missing[idx] if self.entry_missing is not None else None,
                           uids=self.uids[idx] if self.uids is not None else None)

    def filter_cols(self, keep: np.ndarray) -> 'MatrixBatch':
        return MatrixBatch(self.rows, {k: c.compress(keep, axis=1) for k, c in self.entries.items()},
                           self.entry_missing[:, keep] if self.entry_missing is not None else None,
                           uids=self.uids)

    def gather_cols(self, idx: np.ndarray) -> 'MatrixBatch':
        return MatrixBatch(self.rows, {k: c.gather(idx, axis=1) for k, c in self.entries.items()},
                           self.entry_missing[:, idx] if self.entry_missing is not None else None,
                           uids=self.uids)


class MatrixStage:
    """Lazy matrix plan: cols/globals on the driver, row+entry partitions
    distributed (mirrors TableStage with entries; reference keeps cols in
    globals after LowerMatrixToTable)."""

    def __init__(self, globals: Batch, cols: Batch, row_key: List[str], col_key: List[str],
                 row_type: ht.tstruct, col_type: ht.tstruct, entry_type: ht.tstruct,
                 contexts: List[Any], partition_fn: Callable[[Any], MatrixBatch],
                 partition_bounds: Optional[List] = None,
                 uid_bases: Optional[List[int]] = None):
        self.globals = globals
        self.cols = cols
        self.row_key = list(row_key)
        self.col_key = list(col_key)
        self.row_type = row_type
        self.col_type = col_type
        self.entry_type = entry_type
        self.contexts = list(contexts)
        self.partition_fn = partition_fn
        self.partition_bounds = partition_bounds
        # stable per-row UID base offsets (see TableStage.uid_bases)
        self.uid_bases = list(uid_bases) if uid_bases is not None else None

    def uid_for(self, part_idx: int, n: int) -> np.ndarray:
        if self.uid_bases is not None and part_idx < len(self.uid_bases):
            return np.int64(self.uid_bases[part_idx]) + np.arange(n, dtype=np.int64)
        return (np.int64(part_idx) << np.int64(32)) + np.arange(n, dtype=np.int64)

    @property
    def n_cols(self) -> int:
        return self.cols.length

    @property
    def globals_type(self) -> ht.tstruct:
        return self.globals.row_type

    def materialize_partition(self, i: int) -> MatrixBatch:
        """Partition i through the in-memory memo (ir/memcache.py): repeated
        actions over a shared chain prefix evaluate it once."""
        from .ir import memcache
        return memcache.memoized(self, i,
                                 lambda: self.partition_fn(self.contexts[i]))

    def map_partitions(self, f: Callable[[MatrixBatch, int], MatrixBatch],
                       new_row_type=None, new_entry_type=None) -> 'MatrixStage':
        parent = self
        def new_fn(ctx):
            i, _inner = ctx
            return f(parent.materialize_partition(i), i)
        ctxs = [(i, c) for i, c in enumerate(self.contexts)]
        # explicit None checks: an empty tstruct is falsy but is a real
        # new type (select_entries() with no fields)
        return MatrixStage(self.globals, self.cols, self.row_key, self.col_key,
                           self.row_type if new_row_type is None else new_row_type,
                           self.col_type,
                           self.entry_type if new_entry_type is None else new_entry_type,
                           ctxs, new_fn, uid_bases=self.uid_bases)

    def collect_batches(self) -> List[MatrixBatch]:
        from .ir import memcache
        n = len(self.contexts)
        results = [memcache.peek(self, i) for i in range(n)]
        todo = [i for i, b in enumerate(results) if b is None]
        if todo:
            fresh = Env.backend().map_collect([self.contexts[i] for i in todo],
                                              self.partition_fn)
            for i, b in zip(todo, fresh):
                results[i] = b
                memcache.store(self, i, b)
        return results

    @staticmethod
    def from_batches(globals, cols, row_key, col_key, row_type, col_type, entry_type,
                     batches: List[MatrixBatch],
                     partition_bounds=None) -> 'MatrixStage':
        bases = list(np.cumsum([0] + [b.n_rows for b in batches[:-1]]).astype(int))
        return MatrixStage(globals, cols, row_key, col_key, row_type, col_type,
                           entry_type, list(range(len(batches))), lambda i: batches[i],
                           partition_bounds, uid_bases=bases)


class MatrixTable:
    def __init__(self, stage):
        if not isinstance(stage, MatrixStage):
            # reference-style construction from a relational IR:
            # hl.MatrixTable(ir.MatrixRead(ir.MatrixVCFReader(...)))
            from .ir import relational_ir as _rir
            node = stage
            if isinstance(node, _rir.MatrixRead) and node.children and \
                    hasattr(node.children[0], 'resolve'):
                self._stage = node.children[0].resolve()._stage
                return
            if hasattr(node, 'resolve'):
                self._stage = node.resolve()._stage
                return
            raise TypeError(f'cannot build MatrixTable from {type(stage).__name__}')
        self._stage = stage

    # -- schema / field expressions ---------------------------------------
    @property
    def row(self) -> StructExpression:
        # cached so `expr is mt.row` identity checks work (reference caches
        # the field-struct expressions on the source object)
        if '_row_expr' not in self.__dict__:
            self.__dict__['_row_expr'] = construct_expr(
                Ref('va', self._stage.row_type), Indices(self, frozenset({'row'})))
        return self.__dict__['_row_expr']

    @property
    def col(self) -> StructExpression:
        if '_col_expr' not in self.__dict__:
            self.__dict__['_col_expr'] = construct_expr(
                Ref('sa', self._stage.col_type), Indices(self, frozenset({'column'})))
        return self.__dict__['_col_expr']

    @property
    def entry(self) -> StructExpression:
        if '_entry_expr' not in self.__dict__:
            self.__dict__['_entry_expr'] = construct_expr(
                Ref('g', self._stage.entry_type),
                Indices(self, frozenset({'row', 'column'})))
        return self.__dict__['_entry_expr']

    @property
    def globals(self) -> StructExpression:
        return construct_expr(Ref('global', self._stage.globals_type), Indices(self, frozenset()))

    @property
    def row_key(self) -> StructExpression:
        if '_row_key_expr' not in self.__dict__:
            self.__dict__['_row_key_expr'] = self.row.select(*self._stage.row_key)
        return self.__dict__['_row_key_expr']

    @property
    def col_key(self) -> StructExpression:
        if '_col_key_expr' not in self.__dict__:
            self.__dict__['_col_key_expr'] = self.col.select(*self._stage.col_key)
        return self.__dict__['_col_key_expr']

    @property
    def row_value(self):
        return self.row.drop(*self._stage.row_key)

    @property
    def col_value(self):
        return self.col.drop(*self._stage.col_key)

    def __getattr__(self, name):
        if name.startswith('__') and name.endswith('__'):
            raise AttributeError(name)
        if name == '_stage':
            raise AttributeError(name)
        st = self._stage
        if name in st.entry_type.fields:
            return self.entry[name]
        if name in st.row_type.fields:
            return self.row[name]
        if name in st.col_type.fields:
            return self.col[name]
        if name in st.globals_type.fields:
            return self.globals[name]
        raise AttributeError(f'MatrixTable has no field {name!r}')

    def __getitem__(self, item):
        if isinstance(item, str):
            return self.__getattr__(item)
        if isinstance(item, tuple) and len(item) == 2:
            # mt[row_key_exprs, col_key_exprs] → entry struct join (reference
            # MatrixTable.__getitem__ entry lookup)
            rpart, cpart = item
            st0 = self._stage

            def _expand(part, n):
                # a struct expression always explodes into its fields
                # (reference Table.index flexindex struct handling)
                from .expr.expression import StructExpression
                items = list(part) if isinstance(part, tuple) else [part]
                out = []
                for it in items:
                    if isinstance(it, StructExpression):
                        out.extend(it[k] for k in it.dtype.fields)
                    else:
                        out.append(it)
                return out
            rkeys = _expand(rpart, len(st0.row_key))
            ckeys = _expand(cpart, len(st0.col_key))
            st = self._stage
            ent = self.entries()
            keyed = ent.key_by(*(list(st.row_key) + list(st.col_key)))
            keyed = keyed.select(*st.entry_type.fields)
            return keyed[tuple(rkeys + ckeys)]
        raise TypeError(f'invalid MatrixTable index: {item!r}')


    def _eval_global_expr(self, expr):
        col = expr._ir.evaluate(self._globals_env())
        vals = col.to_pylist()
        return vals[0] if vals else None

    def _collect_expr(self, expr) -> list:
        axes = expr._indices.axes
        if axes == {'column'}:
            return self._eval_col_expr(expr).to_pylist()
        out = []
        for i, ctx in enumerate(self._stage.contexts):
            mb = self._stage.partition_fn(ctx)
            if axes == {'row'}:
                col = self._eval_row_expr(expr, mb, i)
            else:
                env = self._entry_env(mb, i)
                col = expr._ir.evaluate(env)
                if col.shape != env.shape:
                    col = col.broadcast_to(env.shape)
            out.extend(col.to_pylist() if len(col.shape) == 1 else
                       [v for row in col.to_pylist() for v in row])
        return out

    def _rebind(self, expr):
        """Re-root an expression from a schema-compatible ancestor MatrixTable
        onto this one (filters/annotates preserve the va/sa/g refs, so the IR
        evaluates unchanged; analogue of the reference's IR re-binding when
        methods pass field expressions through derived datasets)."""
        from .expr.expression import construct_expr, Indices
        return construct_expr(expr._ir, Indices(self, expr._indices.axes))

    def describe(self, handler=print, *, widget=False):
        """Print information about the fields in the matrix table (reference
        matrixtable.py describe — same layout, separators, pretty types)."""
        st = self._stage

        def fmt(fields):
            if not fields:
                return '\n    None'
            return ''.join(f"\n    '{f}': {t.pretty(indent=4).lstrip()} "
                           for f, t in fields.items())
        ck = '[' + ', '.join(f"'{f}'" for f in st.col_key) + ']'
        rk = '[' + ', '.join(f"'{f}'" for f in st.row_key) + ']'
        handler('----------------------------------------\n'
                f'Global fields:{fmt(st.globals_type.fields)}\n'
                '----------------------------------------\n'
                f'Column fields:{fmt(st.col_type.fields)}\n'
                '----------------------------------------\n'
                f'Row fields:{fmt(st.row_type.fields)}\n'
                '----------------------------------------\n'
                f'Entry fields:{fmt(st.entry_type.fields)}\n'
                '----------------------------------------\n'
                f'Column key: {ck}\n'
                f'Row key: {rk}\n'
                '----------------------------------------')

    def n_partitions(self) -> int:
        return len(self._stage.contexts)

    # -- envs --------------------------------------------------------------
    def _global_col(self):
        gt = self._stage.globals_type
        return StructColumn(gt, dict(self._stage.globals.columns), None, (1,))

    def _globals_env(self) -> EvalEnv:
        return EvalEnv({'global': self._global_col()}, (1,))

    @property
    def _fields(self):
        # reference MatrixTable._fields: every field name → its expression
        out = {}
        for f in self._stage.globals_type.fields:
            out[f] = self.globals[f]
        for f in self._stage.row_type.fields:
            out[f] = self.row[f]
        for f in self._stage.col_type.fields:
            out[f] = self.col[f]
        for f in self._stage.entry_type.fields:
            out[f] = self.entry[f]
        return out

    @property
    def _row_indices(self):
        return Indices(self, frozenset({'row'}))

    @property
    def _col_indices(self):
        return Indices(self, frozenset({'column'}))

    @property
    def _entry_indices(self):
        return Indices(self, frozenset({'row', 'column'}))

    @property
    def _global_indices(self):
        return Indices(self, frozenset())

    def _row_env(self, mb: MatrixBatch, part_idx: int) -> EvalEnv:
        n = mb.n_rows
        va = StructColumn(mb.rows.row_type, dict(mb.rows.columns), None, (n,))
        idx = mb.uids if mb.uids is not None else self._stage.uid_for(part_idx, n)
        return EvalEnv({'va': va, 'global': self._global_col(),
                        '__row_idx__': PrimitiveColumn(ht.tint64, idx)}, (n,))

    def _col_env(self) -> EvalEnv:
        cb = self._stage.cols
        n = cb.length
        sa = StructColumn(cb.row_type, dict(cb.columns), None, (n,))
        idx = np.arange(n, dtype=np.int64)
        return EvalEnv({'sa': sa, 'global': self._global_col(),
                        '__row_idx__': PrimitiveColumn(ht.tint64, idx)}, (n,))

    def _entry_env(self, mb: MatrixBatch, part_idx: int) -> EvalEnv:
        R, Cn = mb.n_rows, self._stage.n_cols
        va = StructColumn(mb.rows.row_type, dict(mb.rows.columns), None, (R,)).reshape((R, 1))
        cb = self._stage.cols
        sa = StructColumn(cb.row_type, dict(cb.columns), None, (Cn,)).reshape((1, Cn))
        # entry struct type derived from the batch (it may be a pruned read)
        g_t = ht.tstruct(**{k: c.typ for k, c in mb.entries.items()})
        g = StructColumn(g_t, dict(mb.entries), None, (R, Cn))
        gl = self._global_col().reshape((1, 1))
        # per-ENTRY uid: row_uid * n_cols + col index (reference: entry uid =
        # (row uid, col idx) pair fed to the PMAC message, `ir.py` RNGSplit
        # with entry_uid) — distinct rand values per entry, stable across
        # partitionings
        row_uid = mb.uids if mb.uids is not None \
            else self._stage.uid_for(part_idx, R)
        idx = row_uid.reshape(R, 1) * np.int64(max(Cn, 1)) \
            + np.arange(Cn, dtype=np.int64).reshape(1, Cn)
        # reference entry rng uid = (row uid, col idx) word pair (randomness.md)
        w0 = np.broadcast_to(row_uid.reshape(R, 1), (R, Cn))
        w1 = np.broadcast_to(np.arange(Cn, dtype=np.int64).reshape(1, Cn), (R, Cn))
        return EvalEnv({'va': va, 'sa': sa, 'g': g, 'global': gl,
                        '__row_idx__': PrimitiveColumn(ht.tint64, idx),
                        '__uid_w0__': PrimitiveColumn(ht.tint64, w0),
                        '__uid_w1__': PrimitiveColumn(ht.tint64, w1)}, (R, Cn))

    def _check_source(self, *exprs):
        from .expr.typefuncs import ExpressionException
        for e in exprs:
            src = e._indices.source
            if src is not None and src is not self:
                raise ExpressionException(
                    'source mismatch: expression is bound to another object; '
                    'use [] join syntax to combine datasets')

    # -- annotate ----------------------------------------------------------
    def annotate_rows(self, **named_exprs) -> 'MatrixTable':
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        self._check_source(*exprs.values())
        from .expr.scopes import analyze
        for e in exprs.values():
            analyze('MatrixTable.annotate_rows', e, {'row'}, {'column'})
        from .expr.scans import ScanOp
        new_t = self._stage.row_type
        has_scan = False
        for k, e in exprs.items():
            if any(isinstance(n_, ScanOp) for n_ in aggmod.collect_agg_nodes(e._ir)):
                has_scan = True
            new_t = new_t._insert_field(k, e.dtype)
        if has_scan:
            return self._annotate_rows_with_scans(exprs, new_t)
        def f(mb: MatrixBatch, i: int) -> MatrixBatch:
            cols = {}
            for k, e in exprs.items():
                cols[k] = self._eval_row_expr(e, mb, i)
            return MatrixBatch(mb.rows.annotate(**cols), mb.entries,
                               mb.entry_missing, uids=mb.uids)
        return MatrixTable(self._stage.map_partitions(f, new_row_type=new_t))

    def _annotate_rows_with_scans(self, exprs, new_t) -> 'MatrixTable':
        from .ir.nodes import substitute_aggs
        from .expr.scans import ScanOp
        scan_nodes = []
        agg_nodes = []
        for e in exprs.values():
            for n_ in aggmod.collect_agg_nodes(e._ir):
                (scan_nodes if isinstance(n_, ScanOp) else agg_nodes).append(n_)
        def totals(i_ctx):
            i, ctx = i_ctx
            mb = self._stage.partition_fn(ctx)
            return aggmod.partial_aggregate(scan_nodes, self._row_env(mb, i), (0,))
        partials = Env.backend().map_collect(
            list(enumerate(self._stage.contexts)), totals)
        carries = [None]
        acc = None
        for p in partials[:-1]:
            acc = aggmod.combine_optional(scan_nodes, acc, p)
            carries.append(acc)
        batches = []
        for i, ctx in enumerate(self._stage.contexts):
            mb = self._stage.partition_fn(ctx)
            env = self._row_env(mb, i)
            results = {}
            for n_ in scan_nodes:
                carry = carries[i][n_.uid] if carries[i] is not None else None
                col, _ = aggmod.scan_partition(n_, env, carry)
                results[n_.uid] = col.reshape(env.shape) if col.shape != env.shape else col
            if agg_nodes:
                # plain (non-scan) aggregators reduce over this row's entries
                ent_env = self._entry_env(mb, i)
                states = aggmod.partial_aggregate(
                    agg_nodes, ent_env, (1,),
                    extra_include=MatrixTable._unfiltered_mask(mb))
                for n_ in agg_nodes:
                    col = aggmod.finalize_single(n_, states[n_.uid]) if hasattr(aggmod, 'finalize_single') else None
                    if col is None:
                        col = n_.aggregator.result(states[n_.uid], n_.init_args)
                    results[n_.uid] = col.reshape(env.shape) if col.shape != env.shape else col
            cols = {}
            for k, e in exprs.items():
                col = substitute_aggs(e._ir, results).evaluate(env)
                if col.shape != (mb.n_rows,):
                    col = col.broadcast_to((mb.n_rows,))
                cols[k] = col
            batches.append(MatrixBatch(mb.rows.annotate(**cols), mb.entries,
                                       mb.entry_missing, uids=mb.uids))
        st = self._stage
        return MatrixTable(MatrixStage.from_batches(
            st.globals, st.cols, st.row_key, st.col_key, new_t, st.col_type,
            st.entry_type, batches))

    @staticmethod
    def _unfiltered_mask(mb):
        """(R, C) include mask excluding FILTERED entries, or None."""
        return None if mb.entry_missing is None else ~mb.entry_missing

    def _eval_row_expr(self, e: Expression, mb: MatrixBatch, part_idx: int) -> Column:
        R = mb.n_rows
        agg_nodes = aggmod.collect_agg_nodes(e._ir)
        if agg_nodes:
            env = self._entry_env(mb, part_idx)
            states = aggmod.partial_aggregate(agg_nodes, env, (1,),
                                              extra_include=MatrixTable._unfiltered_mask(mb))
            col = aggmod.finalize_aggregate(e._ir, agg_nodes, states,
                                            self._row_env(mb, part_idx))
        else:
            col = e._ir.evaluate(self._row_env(mb, part_idx))
        if col.shape != (R,):
            col = col.broadcast_to((R,)) if int(np.prod(col.shape)) in (1,) else col.reshape((R,))
        return col

    def annotate_cols(self, **named_exprs) -> 'MatrixTable':
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        self._check_source(*exprs.values())
        from .expr.scopes import analyze
        for e in exprs.values():
            analyze('MatrixTable.annotate_cols', e, {'column'}, {'row'})
        new_cols = dict(self._stage.cols.columns)
        for k, e in exprs.items():
            new_cols[k] = self._eval_col_expr(e)
        cb = Batch(new_cols, self._stage.n_cols)
        st = self._stage
        return MatrixTable(MatrixStage(st.globals, cb, st.row_key, st.col_key,
                                       st.row_type, cb.row_type, st.entry_type,
                                       st.contexts, st.partition_fn))

    def _eval_col_expr(self, e: Expression) -> Column:
        Cn = self._stage.n_cols
        agg_nodes = aggmod.collect_agg_nodes(e._ir)
        from .expr.scans import ScanOp
        scan_nodes = [n_ for n_ in agg_nodes if isinstance(n_, ScanOp)]
        if scan_nodes and len(scan_nodes) == len(agg_nodes):
            # column-axis scans: exclusive prefix over the ordered columns
            from .ir.nodes import substitute_aggs
            env = self._col_env()
            results = {}
            for n_ in scan_nodes:
                col, _ = aggmod.scan_partition(n_, env, None)
                results[n_.uid] = col.reshape(env.shape) if col.shape != env.shape else col
            col = substitute_aggs(e._ir, results).evaluate(env)
            if col.shape != (Cn,):
                col = col.broadcast_to((Cn,)) if int(np.prod(col.shape)) == 1 else col.reshape((Cn,))
            return col
        if agg_nodes:
            def part(i_ctx):
                i, ctx = i_ctx
                mb = self._stage.partition_fn(ctx)
                env = self._entry_env(mb, i)
                return aggmod.partial_aggregate(agg_nodes, env, (0,),
                                                extra_include=MatrixTable._unfiltered_mask(mb))
            partials = Env.backend().map_collect(
                list(enumerate(self._stage.contexts)), part)
            if not partials:
                raise ValueError('aggregation over an empty matrix')
            from .table import _tree_combine
            state = _tree_combine(agg_nodes, partials)
            col = aggmod.finalize_aggregate(e._ir, agg_nodes, state, self._col_env())
        else:
            col = e._ir.evaluate(self._col_env())
        if col.shape != (Cn,):
            col = col.broadcast_to((Cn,)) if int(np.prod(col.shape)) == 1 else col.reshape((Cn,))
        return col

    def annotate_entries(self, **named_exprs) -> 'MatrixTable':
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        self._check_source(*exprs.values())
        from .expr.scopes import analyze
        for e in exprs.values():
            analyze('MatrixTable.annotate_entries', e, {'row', 'column'})
        new_t = self._stage.entry_type
        for k, e in exprs.items():
            new_t = new_t._insert_field(k, e.dtype)
        def f(mb, i):
            env = self._entry_env(mb, i)
            ents = dict(mb.entries)
            for k, e in exprs.items():
                col = e._ir.evaluate(env)
                if col.shape != env.shape:
                    col = col.broadcast_to(env.shape)
                ents[k] = col
            return MatrixBatch(mb.rows, ents, mb.entry_missing, uids=mb.uids)
        return MatrixTable(self._stage.map_partitions(f, new_entry_type=new_t))

    def _filter_partitions(self, parts, keep: bool = True) -> 'MatrixTable':
        """Keep (or drop) partitions by index (reference
        MatrixTable._filter_partitions / MatrixToMatrixApply)."""
        st = self._stage
        sel = [i for i in range(len(st.contexts))
               if (i in parts) == keep]
        return MatrixTable(MatrixStage(
            st.globals, st.cols, st.row_key, st.col_key, st.row_type,
            st.col_type, st.entry_type, [st.contexts[i] for i in sel],
            st.partition_fn,
            ([st.partition_bounds[i] for i in sel]
             if st.partition_bounds is not None else None),
            uid_bases=([st.uid_bases[i] for i in sel]
                       if st.uid_bases is not None else None)))

    def annotate_globals(self, **named_exprs) -> 'MatrixTable':
        env = self._globals_env().bind(
            '__row_idx__', PrimitiveColumn(ht.tint64, np.asarray([-1], dtype=np.int64)))
        g = dict(self._stage.globals.columns)
        for k, v in named_exprs.items():
            col = to_expr(v)._ir.evaluate(env)
            g[k] = col.reshape((1,)) if col.shape != (1,) else col
        st = self._stage
        return MatrixTable(MatrixStage(Batch(g, 1), st.cols, st.row_key, st.col_key,
                                       st.row_type, st.col_type, st.entry_type,
                                       st.contexts, st.partition_fn))

    # -- select / drop -----------------------------------------------------
    @staticmethod
    def _positional_select(fields, roots, what):
        """Positional select args may be names, top-level field expressions,
        or nested field expressions which select under the leaf name
        (reference expr/matrix_type get_select_exprs). Returns
        (ordered names, {name: nested Expression})."""
        from .ir.nodes import GetField, Ref
        from .expr.typefuncs import ExpressionException
        pos_names, extra = [], {}
        for f in fields:
            if isinstance(f, str):
                pos_names.append(f)
                continue
            ir = f._ir
            name = ir.name if isinstance(ir, GetField) else None
            base = ir
            while isinstance(base, GetField):
                base = base.struct
            if name is None or not (isinstance(base, Ref)
                                    and base.name in roots):
                raise ExpressionException(
                    f'{what}: arguments must be fields or nested fields, '
                    f'not complex expressions')
            if isinstance(ir.struct, Ref):
                pos_names.append(name)     # top-level field: keep as-is
            else:
                extra.setdefault(name, f)
                pos_names.append(name)
        return pos_names, extra

    def select_rows(self, *fields, **named_exprs) -> 'MatrixTable':
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        pos_names, extra = self._positional_select(fields, ('va', 'row'),
                                                   'select_rows')
        for n, e in extra.items():
            exprs.setdefault(n, e)
        names = list(dict.fromkeys(self._stage.row_key + pos_names + list(exprs)))
        new_t = ht.tstruct.from_fields(
            [(n, exprs[n].dtype if n in exprs else self._stage.row_type[n]) for n in names])
        def f(mb, i):
            cols = {}
            for n in names:
                cols[n] = self._eval_row_expr(exprs[n], mb, i) if n in exprs else mb.rows.columns[n]
            return MatrixBatch(Batch(cols, mb.n_rows), mb.entries,
                               mb.entry_missing, uids=mb.uids)
        return MatrixTable(self._stage.map_partitions(f, new_row_type=new_t))

    def select_cols(self, *fields, **named_exprs) -> 'MatrixTable':
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        pos_names, extra = self._positional_select(fields, ('sa', 'col'),
                                                   'select_cols')
        for n, e in extra.items():
            exprs.setdefault(n, e)
        names = list(dict.fromkeys(self._stage.col_key + pos_names + list(exprs)))
        new_cols = {}
        for n in names:
            new_cols[n] = self._eval_col_expr(exprs[n]) if n in exprs else self._stage.cols.columns[n]
        cb = Batch(new_cols, self._stage.n_cols)
        st = self._stage
        return MatrixTable(MatrixStage(st.globals, cb, st.row_key, st.col_key,
                                       st.row_type, cb.row_type, st.entry_type,
                                       st.contexts, st.partition_fn))

    def select_entries(self, *fields, **named_exprs) -> 'MatrixTable':
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        from .ir.nodes import GetField, Ref
        pos_names = []
        for f in fields:
            if isinstance(f, str):
                pos_names.append(f)
                continue
            # nested positional selection: mt.select_entries(mt.a.b) keeps
            # field 'b' = the nested value (reference get_select_exprs)
            ir = f._ir
            name = ir.name if isinstance(ir, GetField) else None
            base = ir
            while isinstance(base, GetField):
                base = base.struct
            if name is None or not (isinstance(base, Ref) and base.name == 'g'):
                from .expr.typefuncs import ExpressionException
                raise ExpressionException(
                    'select_entries: arguments must be entry fields or '
                    'nested entry fields, not complex expressions')
            if isinstance(ir.struct, Ref):
                pos_names.append(name)     # top-level field: keep as-is
            else:
                exprs.setdefault(name, f)
                pos_names.append(name)
        names = list(dict.fromkeys(pos_names + list(exprs)))
        new_t = ht.tstruct.from_fields(
            [(n, exprs[n].dtype if n in exprs else self._stage.entry_type[n]) for n in names])
        def f(mb, i):
            env = self._entry_env(mb, i)
            ents = {}
            for n in names:
                if n in exprs:
                    col = exprs[n]._ir.evaluate(env)
                    if col.shape != env.shape:
                        col = col.broadcast_to(env.shape)
                    ents[n] = col
                else:
                    ents[n] = mb.entries[n]
            return MatrixBatch(mb.rows, ents, mb.entry_missing, uids=mb.uids)
        return MatrixTable(self._stage.map_partitions(f, new_entry_type=new_t))

    def select_globals(self, *fields, **named_exprs) -> 'MatrixTable':
        env = self._globals_env()
        pos_names, extra = self._positional_select(fields, ('global',),
                                                   'select_globals')
        named_exprs = {**extra, **named_exprs}
        g = {}
        for f_ in pos_names:
            if f_ in extra:
                continue
            g[f_] = self._stage.globals.columns[f_]
        for k, v in named_exprs.items():
            col = to_expr(v)._ir.evaluate(env)
            g[k] = col.reshape((1,)) if col.shape != (1,) else col
        st = self._stage
        return MatrixTable(MatrixStage(Batch(g, 1), st.cols, st.row_key, st.col_key,
                                       st.row_type, st.col_type, st.entry_type,
                                       st.contexts, st.partition_fn))

    def drop(self, *fields) -> 'MatrixTable':
        names = {f if isinstance(f, str) else _expr_field_name(f) for f in fields}
        st = self._stage
        row_drops = {n for n in names if n in st.row_type.fields and n not in st.row_key}
        col_drops = {n for n in names if n in st.col_type.fields and n not in st.col_key}
        entry_drops = {n for n in names if n in st.entry_type.fields}
        glob_drops = {n for n in names if n in st.globals_type.fields}
        out = self
        if row_drops or entry_drops:
            new_rt = st.row_type._drop_fields(row_drops)
            new_et = st.entry_type._drop_fields(entry_drops)
            def f(mb, i):
                return MatrixBatch(mb.rows.drop(*row_drops),
                                   {k: v for k, v in mb.entries.items() if k not in entry_drops},
                                   mb.entry_missing)
            out = MatrixTable(out._stage.map_partitions(f, new_row_type=new_rt, new_entry_type=new_et))
        if col_drops or glob_drops:
            st2 = out._stage
            cb = Batch({k: v for k, v in st2.cols.columns.items() if k not in col_drops},
                       st2.n_cols)
            g = Batch({k: v for k, v in st2.globals.columns.items() if k not in glob_drops}, 1)
            out = MatrixTable(MatrixStage(g, cb, st2.row_key, st2.col_key, st2.row_type,
                                          cb.row_type, st2.entry_type, st2.contexts,
                                          st2.partition_fn))
        return out

    # -- filter ------------------------------------------------------------
    def filter_rows(self, expr, keep: bool = True) -> 'MatrixTable':
        e = to_expr(expr)
        self._check_source(e)
        from .expr.scopes import analyze
        analyze('MatrixTable.filter_rows', e, {'row'}, {'column'})
        self = self._prune_by_predicate(e._ir, keep)
        agg_nodes = aggmod.collect_agg_nodes(e._ir)
        def f(mb, i):
            if agg_nodes:
                col = self._eval_row_expr(e, mb, i)
            else:
                col = e._ir.evaluate(self._row_env(mb, i))
                if col.shape != (mb.n_rows,):
                    col = col.broadcast_to((mb.n_rows,))
            mask = _bool_mask(col)
            if not keep:
                mask = ~mask & ~col.missing_mask()
            return mb.filter_rows(mask)
        return MatrixTable(self._stage.map_partitions(f))

    def _prune_by_predicate(self, pred_ir, keep: bool) -> 'MatrixTable':
        """Partition pruning from row-key comparisons in the filter predicate
        (reference `expr/ir/ExtractIntervalFilters.scala`)."""
        st = self._stage
        if not keep or not st.row_key:
            return self
        key0 = st.row_key[0]
        rg = getattr(st.row_type[key0], 'reference_genome', None)
        if rg is None:
            return self
        from .ir.interval_filters import extract_gp_ranges, prune_indices
        ranges = extract_gp_ranges(pred_ir, key0, rg)
        keep_idx = prune_indices(getattr(st, 'partition_bounds', None), ranges)
        if keep_idx is None or len(keep_idx) == len(st.contexts):
            return self
        return MatrixTable(MatrixStage(
            st.globals, st.cols, st.row_key, st.col_key,
            st.row_type, st.col_type, st.entry_type,
            [st.contexts[i] for i in keep_idx], st.partition_fn,
            [st.partition_bounds[i] for i in keep_idx],
            uid_bases=([st.uid_bases[i] for i in keep_idx]
                       if st.uid_bases is not None else None)))

    def filter_cols(self, expr, keep: bool = True) -> 'MatrixTable':
        e = to_expr(expr)
        self._check_source(e)
        from .expr.scopes import analyze
        analyze('MatrixTable.filter_cols', e, {'column'}, {'row'})
        col = self._eval_col_expr(e)
        mask = _bool_mask(col)
        if not keep:
            mask = ~mask & ~col.missing_mask()
        idx = np.where(mask)[0]
        return self._subset_cols(idx)

    def _subset_cols(self, idx: np.ndarray) -> 'MatrixTable':
        st = self._stage
        cb = st.cols.gather(idx)
        def f(mb, i):
            return mb.gather_cols(idx)
        st2 = st.map_partitions(f)
        return MatrixTable(MatrixStage(st2.globals, cb, st2.row_key, st2.col_key,
                                       st2.row_type, st2.col_type, st2.entry_type,
                                       st2.contexts, st2.partition_fn))

    def choose_cols(self, indices: List[int]) -> 'MatrixTable':
        return self._subset_cols(np.asarray(indices, dtype=np.int64))

    def filter_entries(self, expr, keep: bool = True) -> 'MatrixTable':
        e = to_expr(expr)
        self._check_source(e)
        from .expr.scopes import analyze
        analyze('MatrixTable.filter_entries', e, {'row', 'column'})
        def f(mb, i):
            env = self._entry_env(mb, i)
            col = e._ir.evaluate(env)
            if col.shape != env.shape:
                col = col.broadcast_to(env.shape)
            mask = _bool_mask(col)
            if not keep:
                mask = ~mask & ~col.missing_mask()
            drop = ~mask
            ents = {k: c.with_missing(drop.copy()) for k, c in mb.entries.items()}
            em = mb.entry_missing | drop if mb.entry_missing is not None else drop.copy()
            return MatrixBatch(mb.rows, ents, em, uids=mb.uids)
        return MatrixTable(self._stage.map_partitions(f))

    def unfilter_entries(self) -> 'MatrixTable':
        """Re-include FILTERED entries as present entries with all fields
        missing (reference matrixtable.py unfilter_entries)."""
        def f(mb, i):
            return MatrixBatch(mb.rows, mb.entries, None, uids=mb.uids)
        return MatrixTable(self._stage.map_partitions(f))

    # -- keys --------------------------------------------------------------
    def key_rows_by(self, *keys, **named_exprs) -> 'MatrixTable':
        mt = self.annotate_rows(**named_exprs) if named_exprs else self
        names = [k if isinstance(k, str) else _expr_field_name(k) for k in keys] + list(named_exprs)
        st = mt._stage
        out = MatrixTable(MatrixStage(st.globals, st.cols, names, st.col_key,
                                      st.row_type, st.col_type, st.entry_type,
                                      st.contexts, st.partition_fn))
        if names and names != st.row_key[:len(names)]:
            # matrix rows are row-key-sorted (reference MatrixKeyRowsBy
            # isSorted=False shuffle); re-keying by a non-prefix sorts
            out = out._sort_rows_by_key()
        return out

    def _sort_rows_by_key(self) -> 'MatrixTable':
        from .table import _sort_indices
        st = self._stage
        mb = _concat_matrix_batches(st.collect_batches(), st)
        order = _sort_indices(mb.rows, [(k, True) for k in st.row_key])
        if not np.array_equal(order, np.arange(mb.n_rows)):
            mb = mb.gather_rows(order)
        return MatrixTable(MatrixStage.from_batches(
            st.globals, st.cols, st.row_key, st.col_key, st.row_type,
            st.col_type, st.entry_type, [mb]))

    def key_cols_by(self, *keys, **named_exprs) -> 'MatrixTable':
        mt = self.annotate_cols(**named_exprs) if named_exprs else self
        names = [k if isinstance(k, str) else _expr_field_name(k) for k in keys] + list(named_exprs)
        st = mt._stage
        return MatrixTable(MatrixStage(st.globals, st.cols, st.row_key, names,
                                       st.row_type, st.col_type, st.entry_type,
                                       st.contexts, st.partition_fn))


    def _group_key_names(self, keys, named_exprs, axis):
        """Validate group keys, split into (names, extra annotations): a
        top-level field expression keys by its name; a nested field (mt.s.a)
        keys by the LEAF name and is annotated first; a named expression must
        introduce a FRESH name (reference GroupedMatrixTable key checks)."""
        from .expr.typefuncs import ExpressionException
        from .ir.nodes import GetField, Ref
        st = self._stage
        axis_fields = (st.row_type if axis == 'row' else st.col_type).fields
        all_fields = (set(st.row_type.fields) | set(st.col_type.fields)
                      | set(st.entry_type.fields) | set(st.globals_type.fields))

        def check_axes(e, name):
            # scalar (axis-free) key expressions are legal constants
            if e._indices.axes not in (frozenset({axis}), frozenset()):
                raise ExpressionException(
                    f"group key {name!r} has indices {sorted(e._indices.axes)};"
                    f" expected ['{axis}']")

        names = []
        ann = {}
        for k in keys:
            if isinstance(k, str):
                if k not in axis_fields:
                    raise ExpressionException(
                        f'{k!r} is not a {axis} field')
                names.append(k)
                continue
            ir = k._ir
            if not isinstance(ir, GetField):
                raise ExpressionException(
                    'positional group keys must be fields; '
                    'use a named expression (name=expr) otherwise')
            check_axes(k, ir.name)
            top_level = isinstance(ir.struct, Ref) and ir.name in axis_fields
            if not top_level:
                ann[ir.name] = k
            names.append(ir.name)
        renames = {}
        for name, e in named_exprs.items():
            e = to_expr(e)
            check_axes(e, name)
            if name in all_fields and name not in axis_fields:
                # shadowing is only legal for fields of the grouped axis
                # (old row fields die with the regroup); col/global/entry
                # collisions are errors (test_errors_caught_correctly)
                raise ExpressionException(
                    f'cannot assign group key {name!r}: '
                    f'field already exists outside the {axis} axis')
            if name in all_fields:
                # a named key may SHADOW a field of the grouped axis: the
                # key expr is evaluated against the old bindings, and the
                # field takes the key's name only in the result (reference
                # test_group_by_field_lifetimes)
                tmp = f'__group_key_{name}'
                renames[tmp] = name
                ann[tmp] = e
                names.append(tmp)
            else:
                ann[name] = e
                names.append(name)
        return names, ann, renames

    def group_rows_by(self, *keys, **named_exprs) -> 'GroupedMatrixTable':
        names, ann, renames = self._group_key_names(keys, named_exprs, 'row')
        mt = self.annotate_rows(**ann) if ann else self
        return GroupedMatrixTable(mt, row_keys=names, key_renames=renames)

    def group_cols_by(self, *keys, **named_exprs) -> 'GroupedMatrixTable':
        names, ann, renames = self._group_key_names(keys, named_exprs, 'column')
        mt = self.annotate_cols(**ann) if ann else self
        return GroupedMatrixTable(mt, col_keys=names, key_renames=renames)


    def summarize(self, *, rows: bool = True, entries: bool = True,
                  handler=print):
        handler(f'{self.count_rows()} rows x {self.count_cols()} cols, '
                f'{self.n_partitions()} partitions')
        if rows:
            handler('Rows:')
            self.rows().summarize(handler=handler)
        if entries:
            handler('Entry fields: ' + ', '.join(
                f'{k}: {t}' for k, t in self._stage.entry_type.items()))

    # -- aggregate ---------------------------------------------------------
    def aggregate_rows(self, expr, _localize: bool = True) -> Any:
        e = to_expr(expr)
        agg_nodes = aggmod.collect_agg_nodes(e._ir)
        def part(i_ctx):
            i, ctx = i_ctx
            mb = self._stage.partition_fn(ctx)
            return aggmod.partial_aggregate(agg_nodes, self._row_env(mb, i), (0,))
        partials = Env.backend().map_collect(
            list(enumerate(self._stage.contexts)), part)
        from .table import _tree_combine
        state = _tree_combine(agg_nodes, partials)
        col = aggmod.finalize_aggregate(e._ir, agg_nodes, state, self._globals_env())
        vals = col.to_pylist()
        out = vals[0] if vals else None
        if not _localize:
            from .expr.functions import literal, missing
            return literal(out, e.dtype) if out is not None else missing(e.dtype)
        from .utils.structs import thaw
        return thaw(out)

    def _try_device_entry_agg(self, e, agg_nodes, _localize):
        """Device tier for generic entry aggregations (ops/entry_agg.py):
        the whole seqOp fuses into one jitted jnp reduction per partition.
        Returns (result,) or None to fall back to the host evaluator.
        Disable with HAIL_TPU_NO_DEVICE_AGG=1."""
        import os
        if os.environ.get('HAIL_TPU_NO_DEVICE_AGG') == '1' or not agg_nodes:
            return None
        from .ops import entry_agg as ea
        planned = ea.plan_device_entry_agg(agg_nodes)
        if planned is None:
            return None
        leaves, plans = planned
        jitted = ea.cached_kernel(agg_nodes, plans, sorted(leaves.keys()))

        def part(i_ctx):
            i, ctx = i_ctx
            mb = self._stage.partition_fn(ctx)
            if mb.n_rows == 0 or self._stage.n_cols == 0:
                return aggmod.partial_aggregate(
                    agg_nodes, self._entry_env(mb, i), (0, 1),
                    extra_include=MatrixTable._unfiltered_mask(mb))
            st = ea.run_device_entry_agg(self, mb, i, leaves, plans, jitted)
            if st is None:
                return aggmod.partial_aggregate(
                    agg_nodes, self._entry_env(mb, i), (0, 1),
                    extra_include=MatrixTable._unfiltered_mask(mb))
            return st

        partials = Env.backend().map_collect(
            list(enumerate(self._stage.contexts)), part)
        from .table import _tree_combine
        state = _tree_combine(agg_nodes, partials)
        col = aggmod.finalize_aggregate(e._ir, agg_nodes, state,
                                        self._globals_env())
        vals = col.to_pylist()
        out = vals[0] if vals else None
        if not _localize:
            from .expr.functions import literal, missing
            return (literal(out, e.dtype) if out is not None
                    else missing(e.dtype),)
        return (out,)

    def aggregate_cols(self, expr, _localize: bool = True) -> Any:
        e = to_expr(expr)
        from .ir.nodes import Ref, walk_ir
        for n_ in walk_ir(e._ir):
            if isinstance(n_, Ref) and n_.name == 'g':
                from .expr.typefuncs import ExpressionException
                raise ExpressionException(
                    'scope violation: aggregate_cols aggregates over columns; '
                    'found an entry expression inside the aggregation')
        agg_nodes = aggmod.collect_agg_nodes(e._ir)
        env = self._col_env()
        if self._stage.col_key:
            # keyed column aggregations run in col-key order (reference: the
            # cols table is key-sorted; test_aggregate_cols_order)
            from .table import _sort_indices
            cb = self._stage.cols
            order = _sort_indices(cb, [(k, True) for k in self._stage.col_key])
            if not np.array_equal(order, np.arange(cb.length)):
                sb = cb.gather(order)
                from .ir.columns import StructColumn as _SC, PrimitiveColumn as _PC
                sa = _SC(sb.row_type, dict(sb.columns), None, (sb.length,))
                env = EvalEnv({'sa': sa, 'global': self._global_col(),
                               '__row_idx__': _PC(ht.tint64, np.asarray(order, np.int64))},
                              (sb.length,))
        states = aggmod.partial_aggregate(agg_nodes, env, (0,))
        col = aggmod.finalize_aggregate(e._ir, agg_nodes, states, self._globals_env())
        vals = col.to_pylist()
        out = vals[0] if vals else None
        if not _localize:
            from .expr.functions import literal, missing
            return literal(out, e.dtype) if out is not None else missing(e.dtype)
        from .utils.structs import thaw
        return thaw(out)

    def aggregate_entries(self, expr, _localize: bool = True) -> Any:
        e = to_expr(expr)
        agg_nodes = aggmod.collect_agg_nodes(e._ir)
        device = self._try_device_entry_agg(e, agg_nodes, _localize)
        if device is not None:
            return device[0]
        def part(i_ctx):
            i, ctx = i_ctx
            mb = self._stage.partition_fn(ctx)
            return aggmod.partial_aggregate(agg_nodes, self._entry_env(mb, i), (0, 1),
                                            extra_include=MatrixTable._unfiltered_mask(mb))
        partials = Env.backend().map_collect(
            list(enumerate(self._stage.contexts)), part)
        from .table import _tree_combine
        state = _tree_combine(agg_nodes, partials)
        col = aggmod.finalize_aggregate(e._ir, agg_nodes, state, self._globals_env())
        vals = col.to_pylist()
        out = vals[0] if vals else None
        if not _localize:
            from .expr.functions import literal, missing
            return literal(out, e.dtype) if out is not None else missing(e.dtype)
        from .utils.structs import thaw
        return thaw(out)

    # -- counts / shape ----------------------------------------------------
    def count_rows(self) -> int:
        ns = Env.backend().map_collect(self._stage.contexts,
                                       lambda c: self._stage.partition_fn(c).n_rows)
        return int(sum(ns))

    def count_cols(self) -> int:
        return self._stage.n_cols

    def count(self) -> Tuple[int, int]:
        return self.count_rows(), self.count_cols()

    # -- conversions -------------------------------------------------------
    def rows(self) -> Table:
        st = self._stage
        pf = st.partition_fn
        def f(ctx):
            return pf(ctx).rows
        return Table(TableStage(st.globals, st.row_key, st.row_type, st.contexts, f,
                                getattr(st, 'partition_bounds', None),
                                uid_bases=getattr(st, 'uid_bases', None)))

    def cols(self) -> Table:
        from .table import _sort_indices
        st = self._stage
        cb = st.cols
        if st.col_key:
            # the cols TABLE is col-key-sorted (reference MatrixColsTable);
            # the matrix itself keeps its column order
            order = _sort_indices(cb, [(k, True) for k in st.col_key])
            if not np.array_equal(order, np.arange(cb.length)):
                cb = cb.gather(order)
        return Table(TableStage.from_batches(st.globals, st.col_key, st.col_type, [cb]))

    def entries(self) -> Table:
        st = self._stage
        Cn = st.n_cols
        row_t = st.row_type
        col_t = st.col_type
        ent_t = st.entry_type
        # de-collide col/entry field names against row fields (suffix _1)
        rename_col: Dict[str, str] = {}
        used = set(row_t.fields)
        for k in col_t.fields:
            nk = k
            while nk in used:
                nk = nk + '_1'
            rename_col[k] = nk
            used.add(nk)
        rename_ent: Dict[str, str] = {}
        for k in ent_t.fields:
            nk = k
            while nk in used:
                nk = nk + '_1'
            rename_ent[k] = nk
            used.add(nk)
        fields = (list(row_t.items())
                  + [(rename_col[k], t) for k, t in col_t.items()]
                  + [(rename_ent[k], t) for k, t in ent_t.items()])
        new_t = ht.tstruct.from_fields(fields)
        cb = st.cols
        pf = st.partition_fn
        if st.col_key:
            # entries table is (row key, col key)-sorted (reference
            # MatrixEntriesTable): apply the col-key permutation per row
            from .table import _sort_indices
            perm = _sort_indices(cb, [(k, True) for k in st.col_key])
        else:
            perm = np.arange(Cn)
        def f(ctx):
            mb = pf(ctx)
            R = mb.n_rows
            cols: Dict[str, Column] = {}
            ridx = np.repeat(np.arange(R), Cn)
            cidx = np.tile(perm, R)
            for k, c in mb.rows.columns.items():
                cols[k] = c.gather(ridx)
            for k, c in cb.columns.items():
                cols[rename_col[k]] = c.gather(cidx)
            for k, c in mb.entries.items():
                cols[rename_ent[k]] = c.gather(perm, axis=1).reshape((R * Cn,))
            b = Batch(cols, R * Cn)
            if mb.entry_missing is not None:
                # FILTERED entries produce no rows (reference
                # MatrixTable.entries semantics)
                b = b.compress(~mb.entry_missing[:, perm].reshape((R * Cn,)))
            return b
        key = st.row_key + [rename_col[k] for k in st.col_key]
        t = Table(TableStage(st.globals, [], new_t, st.contexts, f))
        if key:
            # entries table is (row key, col key)-keyed AND key-sorted
            # (reference MatrixEntriesTable ordering)
            t = t.key_by(*key)
        return t

    def _localize_entries(self, entries_array_field_name=None,
                          columns_array_field_name=None):
        return self.localize_entries(entries_array_field_name,
                                     columns_array_field_name)

    def localize_entries(self, entries_array_field_name=None,
                         columns_array_field_name=None) -> Table:
        st = self._stage
        t = self.rows()
        if entries_array_field_name is not None:
            ent_struct_t = st.entry_type
            arr_t = ht.tarray(ent_struct_t)
            pf = st.partition_fn
            Cn = st.n_cols
            def f(ctx):
                mb = pf(ctx)
                R = mb.n_rows
                ent_objs = {k: np.asarray(C.to_object(c).values) for k, c in mb.entries.items()}
                filt = mb.entry_missing
                vals = np.empty(R, dtype=object)
                for i in range(R):
                    # FILTERED entries localize as missing array elements
                    vals[i] = [None if (filt is not None and filt[i, j]) else
                               Struct(**{k: ent_objs[k][i, j] for k in ent_objs})
                               for j in range(Cn)]
                b = mb.rows.annotate(**{entries_array_field_name: C.ObjectColumn(arr_t, vals)})
                return b
            new_t = st.row_type._insert_field(entries_array_field_name, arr_t)
            t = Table(TableStage(st.globals, st.row_key, new_t, st.contexts, f))
        if columns_array_field_name is not None:
            col_rows = st.cols.to_pylist()
            t = t.annotate_globals(**{columns_array_field_name: to_expr(
                col_rows, ht.tarray(st.col_type))})
        return t

    @property
    def _type(self):
        from .expr.typefuncs import tmatrix
        st = self._stage
        return tmatrix(st.globals_type, st.col_type, st.col_key,
                       st.row_type, st.row_key, st.entry_type)

    @property
    def _tir(self):
        from .ir import relational_ir as _rir
        tir = getattr(self._stage, 'tir', None)
        return tir if tir is not None else _rir.MatrixLiteral()

    def _force_count_rows(self) -> int:
        return self.count_rows()

    def _force_count_cols(self) -> int:
        return self.count_cols()

    def head(self, n_rows: Optional[int], n_cols: Optional[int] = None) -> 'MatrixTable':
        batches = self._stage.collect_batches()
        if n_rows is None:
            n_rows = sum(mb.n_rows for mb in batches)
        out = []
        remaining = n_rows
        for mb in batches:
            if remaining <= 0:
                break
            take = min(mb.n_rows, remaining)
            idx = np.arange(take)
            out.append(mb.gather_rows(idx))
            remaining -= take
        st = self._stage
        mt = MatrixTable(MatrixStage.from_batches(st.globals, st.cols, st.row_key,
                                                  st.col_key, st.row_type, st.col_type,
                                                  st.entry_type, out))
        if n_cols is not None:
            mt = mt.choose_cols(list(range(n_cols)))
        return mt

    def tail(self, n_rows: Optional[int], n_cols: Optional[int] = None, *,
             n: Optional[int] = None) -> 'MatrixTable':
        """Last `n_rows` rows (and optionally last `n_cols` columns)
        (reference matrixtable.py tail)."""
        if n_rows is None:
            n_rows = n
        batches = self._stage.collect_batches()
        total = sum(mb.n_rows for mb in batches)
        skip = max(0, total - (n_rows if n_rows is not None else total))
        out = []
        for mb in batches:
            if skip >= mb.n_rows:
                skip -= mb.n_rows
                continue
            idx = np.arange(skip, mb.n_rows)
            skip = 0
            out.append(mb.gather_rows(idx))
        st = self._stage
        mt = MatrixTable(MatrixStage.from_batches(st.globals, st.cols, st.row_key,
                                                  st.col_key, st.row_type, st.col_type,
                                                  st.entry_type, out))
        if n_cols is not None:
            total_c = st.cols.length
            mt = mt.choose_cols(list(range(max(0, total_c - n_cols), total_c)))
        return mt

    class _Show:
        """Wide matrix rendering: the localized table plus how many columns
        were displayed vs exist (reference MatrixTable._Show)."""

        def __init__(self, table, n_rows, actual_n_cols, displayed_n_cols,
                     width, truncate, types):
            self.table_show = table._show(n_rows, width, truncate, types)
            self.actual_n_cols = actual_n_cols
            self.displayed_n_cols = displayed_n_cols

        def __str__(self):
            s = str(self.table_show)
            if self.displayed_n_cols != self.actual_n_cols:
                s += (f'\nshowing the first {self.displayed_n_cols} '
                      f'of {self.actual_n_cols} columns')
            return s

        def __repr__(self):
            return self.__str__()

    def show(self, n_rows=None, n_cols=None,
             include_row_fields: bool = False, width=None,
             truncate=None, types: bool = True, handler=None):
        """Show the first rows as a wide table — one field per displayed
        matrix column (reference matrixtable.py show: localize_entries then
        select row key + per-column entry structs)."""
        import hail_tpu_torch as hl
        st = self._stage
        actual_n_cols = self.count_cols()
        if n_cols is None:
            n_cols = 8
        displayed = min(actual_n_cols, n_cols)

        t = self.localize_entries('entries', 'cols')
        col_headers = [f'<col {i}>' for i in range(displayed)]
        ckt = [st.col_type[k] for k in st.col_key]
        if len(st.col_key) == 1 and ckt[0] in (ht.tstr, ht.tint32, ht.tint64):
            cvals = st.cols.columns[st.col_key[0]].to_pylist()[:displayed]
            if len(set(cvals)) == len(cvals):
                col_headers = [repr(c) for c in cvals]
        entries = {col_headers[i]: t.entries[i] for i in range(displayed)}
        row_fields = list(st.row_key) + \
            ([f for f in st.row_type.fields if f not in st.row_key]
             if include_row_fields else [])
        t = t.select(**{f: t[f] for f in row_fields}, **entries)
        showobj = MatrixTable._Show(t, n_rows, actual_n_cols, displayed,
                                    width, truncate, types)
        if handler is None:
            print(str(showobj))
            return None
        return handler(showobj)

    def semi_join_rows(self, other: 'Table') -> 'MatrixTable':
        """Keep rows whose row key appears in `other` (reference
        matrixtable.py semi_join_rows)."""
        return self._row_key_join(other, keep_present=True)

    def anti_join_rows(self, other: 'Table') -> 'MatrixTable':
        return self._row_key_join(other, keep_present=False)

    def _row_key_join(self, other, keep_present: bool) -> 'MatrixTable':
        from .table import _key_tuples, _hashable_key
        st = self._stage
        what = 'semi_join_rows' if keep_present else 'anti_join_rows'
        nk = _check_key_prefix(what, [st.row_type[k] for k in st.row_key],
                               [other._stage.row_type[k] for k in other._stage.key])
        rb = other._stage.collect_single()
        rkeys = {_hashable_key(k) for k in _key_tuples(rb, other._stage.key)}

        def f(mb: 'MatrixBatch', i: int) -> 'MatrixBatch':
            keys = _key_tuples(mb.rows, st.row_key)
            keep = np.asarray([(_hashable_key(k[:nk]) in rkeys) == keep_present
                               for k in keys], dtype=bool)
            return mb.filter_rows(keep)
        return MatrixTable(st.map_partitions(f))

    def semi_join_cols(self, other: 'Table') -> 'MatrixTable':
        return self._col_key_join(other, keep_present=True)

    def anti_join_cols(self, other: 'Table') -> 'MatrixTable':
        return self._col_key_join(other, keep_present=False)

    def _col_key_join(self, other, keep_present: bool) -> 'MatrixTable':
        from .table import _key_tuples, _hashable_key
        st = self._stage
        what = 'semi_join_cols' if keep_present else 'anti_join_cols'
        nk = _check_key_prefix(what, [st.col_type[k] for k in st.col_key],
                               [other._stage.row_type[k] for k in other._stage.key])
        rb = other._stage.collect_single()
        rkeys = {_hashable_key(k) for k in _key_tuples(rb, other._stage.key)}
        keys = _key_tuples(st.cols, st.col_key)
        keep_idx = [i for i, k in enumerate(keys)
                    if (_hashable_key(k[:nk]) in rkeys) == keep_present]
        return self.choose_cols(keep_idx)

    def distinct_by_row(self) -> 'MatrixTable':
        """Keep the first row for each unique row key (reference
        matrixtable.py distinct_by_row)."""
        from .table import _key_tuples, _hashable_key
        st = self._stage
        seen = set()

        def f(mb: 'MatrixBatch', i: int) -> 'MatrixBatch':
            keys = _key_tuples(mb.rows, st.row_key)
            keep = np.zeros(mb.n_rows, dtype=bool)
            for j, k in enumerate(keys):
                hk = _hashable_key(k)
                if hk not in seen:
                    seen.add(hk)
                    keep[j] = True
            return mb.filter_rows(keep)
        batches = [f(st.partition_fn(c), i) for i, c in enumerate(st.contexts)]
        return MatrixTable(MatrixStage.from_batches(
            st.globals, st.cols, st.row_key, st.col_key, st.row_type,
            st.col_type, st.entry_type, batches))

    def distinct_by_col(self) -> 'MatrixTable':
        from .table import _key_tuples, _hashable_key
        st = self._stage
        keys = _key_tuples(st.cols, st.col_key)
        seen = set()
        keep_idx = []
        for i, k in enumerate(keys):
            hk = _hashable_key(k)
            if hk not in seen:
                seen.add(hk)
                keep_idx.append(i)
        return self.choose_cols(keep_idx)

    @staticmethod
    def _field_path(field_expr):
        from .ir.nodes import GetField, Ref
        path = []
        node = field_expr._ir
        while isinstance(node, GetField):
            path.append(node.name)
            node = node.struct
        if isinstance(node, Ref):
            return list(reversed(path))
        return None

    def explode_rows(self, field_expr) -> 'MatrixTable':
        """One output row per element of an array/set row field (reference
        matrixtable.py explode_rows); entries duplicate. Nested paths
        (mt.s.a) explode in place."""
        if not isinstance(field_expr, str):
            path = MatrixTable._field_path(field_expr)
            if path and len(path) > 1:
                return _explode_mt_path(self, path, 'row')
        name = field_expr if isinstance(field_expr, str) else \
            _mt_field_name(field_expr)
        st = self._stage
        if name in st.row_key:
            raise ValueError(f"method 'explode_rows' cannot explode a key field {name!r}")
        ft = st.row_type[name]
        new_row_t = ht.tstruct(**{k: (t.element_type if k == name else t)
                                  for k, t in st.row_type.items()})

        def f(mb: 'MatrixBatch', i: int) -> 'MatrixBatch':
            vals = mb.rows.columns[name].to_pylist()
            out_idx = []
            out_elem = []
            for r, v in enumerate(vals):
                if v is None:
                    continue
                for x in (sorted(v) if isinstance(v, (set, frozenset)) else v):
                    out_idx.append(r)
                    out_elem.append(x)
            idx = np.asarray(out_idx, dtype=np.int64)
            rows_cols = {}
            for k, c in mb.rows.columns.items():
                if k == name:
                    rows_cols[k] = C.from_pylist(ft.element_type, out_elem)
                else:
                    rows_cols[k] = c.gather(idx)
            ents = {k: c.gather(idx, axis=0) for k, c in mb.entries.items()}
            filt = mb.entry_missing[idx] if mb.entry_missing is not None else None
            return MatrixBatch(Batch(rows_cols, len(idx)), ents, filt)
        return MatrixTable(st.map_partitions(f, new_row_type=new_row_t))

    def explode_cols(self, field_expr) -> 'MatrixTable':
        """One output column per element of an array/set col field (reference
        matrixtable.py explode_cols). Nested paths explode in place."""
        if not isinstance(field_expr, str):
            path = MatrixTable._field_path(field_expr)
            if path and len(path) > 1:
                return _explode_mt_path(self, path, 'col')
        name = field_expr if isinstance(field_expr, str) else \
            _mt_field_name(field_expr)
        st = self._stage
        if name in st.col_key:
            raise ValueError(f"method 'explode_cols' cannot explode a key field {name!r}")
        ft = st.col_type[name]
        vals = st.cols.columns[name].to_pylist()
        out_idx = []
        out_elem = []
        for j, v in enumerate(vals):
            if v is None:
                continue
            for x in (sorted(v) if isinstance(v, (set, frozenset)) else v):
                out_idx.append(j)
                out_elem.append(x)
        mt = self.choose_cols(out_idx)
        st2 = mt._stage
        new_col_t = ht.tstruct(**{k: (t.element_type if k == name else t)
                                  for k, t in st2.col_type.items()})
        cols_cols = dict(st2.cols.columns)
        cols_cols[name] = C.from_pylist(ft.element_type, out_elem)
        new_cols = Batch(cols_cols, len(out_idx))
        return MatrixTable(MatrixStage(st2.globals, new_cols, st2.row_key,
                                       st2.col_key, st2.row_type, new_col_t,
                                       st2.entry_type, st2.contexts,
                                       st2.partition_fn))

    def collect_cols_by_key(self) -> 'MatrixTable':
        """Group columns by key: non-key col fields and entry fields become
        arrays (reference matrixtable.py collect_cols_by_key)."""
        from .table import _key_tuples, _hashable_key
        st = self._stage
        keys = _key_tuples(st.cols, st.col_key)
        groups = {}
        order = []
        for j, k in enumerate(keys):
            hk = _hashable_key(k)
            if hk not in groups:
                groups[hk] = []
                order.append(hk)
            groups[hk].append(j)
        cols_py = st.cols.to_pylist()
        val_fields = [f for f in st.col_type.fields if f not in st.col_key]
        new_col_t = ht.tstruct(**{f: st.col_type[f] for f in st.col_key},
                               **{f: ht.tarray(st.col_type[f]) for f in val_fields})
        new_cols_rows = []
        for hk in order:
            idxs = groups[hk]
            first = cols_py[idxs[0]]
            new_cols_rows.append(Struct(
                **{f: first[f] for f in st.col_key},
                **{f: [cols_py[j][f] for j in idxs] for f in val_fields}))
        new_cols = Batch.from_pylist(new_col_t, new_cols_rows)
        new_ent_t = ht.tstruct(**{f: ht.tarray(t) for f, t in st.entry_type.items()})
        group_lists = [groups[hk] for hk in order]

        def f(mb: 'MatrixBatch', i: int) -> 'MatrixBatch':
            R = mb.n_rows
            g = StructColumn(st.entry_type, dict(mb.entries), None,
                             (R, mb.n_cols))
            py = g.to_pylist()
            new_flat = {fn: [] for fn in st.entry_type.fields}
            for r in range(R):
                for idxs in group_lists:
                    for fn in st.entry_type.fields:
                        new_flat[fn].append([None if py[r][j] is None
                                             else py[r][j][fn] for j in idxs])
            ents = {fn: C.from_pylist(ht.tarray(st.entry_type[fn]), new_flat[fn])
                    .reshape((R, len(group_lists)))
                    for fn in st.entry_type.fields}
            return MatrixBatch(mb.rows, ents, mb.entry_missing, uids=mb.uids)
        st2 = st.map_partitions(f, new_entry_type=new_ent_t)
        return MatrixTable(MatrixStage(st2.globals, new_cols, st2.row_key,
                                       st2.col_key, st2.row_type, new_col_t,
                                       new_ent_t, st2.contexts,
                                       st2.partition_fn))

    def compute_entry_filter_stats(self, row_field: str = 'entry_stats_row',
                                   col_field: str = 'entry_stats_col') -> 'MatrixTable':
        """Annotate rows/cols with counts of filtered entries (reference
        matrixtable.py compute_entry_filter_stats)."""
        st = self._stage
        n_c = st.cols.length
        row_stats = []
        col_filt = np.zeros(n_c, dtype=np.int64)
        col_tot = np.zeros(n_c, dtype=np.int64)
        batches = []
        for i, ctx in enumerate(st.contexts):
            mb = st.partition_fn(ctx)
            batches.append(mb)
            if mb.entry_missing is not None:
                emiss = mb.entry_missing
            else:
                emiss = np.zeros((mb.n_rows, n_c), dtype=bool)
            row_stats.extend(
                Struct(n_filtered=int(x), n_remaining=int(n_c - x),
                       fraction_filtered=float(x / n_c) if n_c else 0.0)
                for x in emiss.sum(axis=1))
            col_filt += emiss.sum(axis=0).astype(np.int64)
            col_tot += mb.n_rows
        stat_t = ht.tstruct(n_filtered=ht.tint64, n_remaining=ht.tint64,
                            fraction_filtered=ht.tfloat32)
        col_stats = [Struct(n_filtered=int(f), n_remaining=int(t - f),
                            fraction_filtered=float(f / t) if t else 0.0)
                     for f, t in zip(col_filt, col_tot)]
        # rebuild with annotations
        new_row_t = st.row_type._insert_field(row_field, stat_t)
        new_col_t = st.col_type._insert_field(col_field, stat_t)
        out = []
        off = 0
        for mb in batches:
            rc = dict(mb.rows.columns)
            rc[row_field] = C.from_pylist(stat_t, row_stats[off:off + mb.n_rows])
            off += mb.n_rows
            out.append(MatrixBatch(Batch(rc, mb.n_rows), mb.entries,
                                   mb.entry_missing))
        cc = dict(st.cols.columns)
        cc[col_field] = C.from_pylist(stat_t, col_stats)
        new_cols = Batch(cc, n_c)
        return MatrixTable(MatrixStage.from_batches(
            st.globals, new_cols, st.row_key, st.col_key, new_row_t,
            new_col_t, st.entry_type, out))

    def naive_coalesce(self, max_partitions: int) -> 'MatrixTable':
        """Merge adjacent partitions down to at most `max_partitions`
        (reference matrixtable.py naive_coalesce)."""
        return self.repartition(max_partitions)

    def transmute_globals(self, **named_exprs) -> 'MatrixTable':
        refs = set()
        for e in named_exprs.values():
            refs |= _global_field_refs(to_expr(e)._ir, self._stage.globals_type)
        mt = self.annotate_globals(**named_exprs)
        drop = [f for f in refs if f not in named_exprs]
        return mt.drop(*drop) if drop else mt

    def globals_table(self) -> 'Table':
        """One-row table of the global fields (reference matrixtable.py
        globals_table)."""
        from .table import Table, TableStage
        st = self._stage
        return Table(TableStage.from_batches(Batch({}, 1), [],
                                             st.globals.row_type, [st.globals]))

    def index_globals(self):
        """The globals as a Python-evaluable struct expression (reference
        matrixtable.py index_globals)."""
        from .expr import functions as F
        g = self._stage.globals.to_pylist()
        return F.literal(g[0] if g else Struct(), self._stage.globals.row_type)

    def index_rows(self, *exprs, all_matches: bool = False):
        """Join this MatrixTable's row fields onto foreign key expressions
        (reference matrixtable.py index_rows)."""
        if not self._stage.row_key:
            from .expr.typefuncs import ExpressionException
            raise ExpressionException(
                'Cannot index an unkeyed axis\n'
                '  MatrixTable row key:   <<<empty key>>>')
        return self.rows()[tuple(exprs) if len(exprs) > 1 else exprs[0]]

    def index_cols(self, *exprs, all_matches: bool = False):
        if not self._stage.col_key:
            from .expr.typefuncs import ExpressionException
            raise ExpressionException(
                'Cannot index an unkeyed axis\n'
                '  MatrixTable col key:   <<<empty key>>>')
        return self.cols()[tuple(exprs) if len(exprs) > 1 else exprs[0]]

    def index_entries(self, row_exprs, col_exprs):
        """Join entries onto foreign (row, col) key expressions (reference
        matrixtable.py index_entries)."""
        et = self.entries().key_by(*(list(self._stage.row_key) + list(self._stage.col_key)))
        row_exprs = row_exprs if isinstance(row_exprs, tuple) else (row_exprs,)
        col_exprs = col_exprs if isinstance(col_exprs, tuple) else (col_exprs,)
        combined = tuple(row_exprs) + tuple(col_exprs)
        return et[combined]

    def make_table(self, separator: str = '.') -> 'Table':
        """One row per matrix row; entry fields become per-sample columns
        named `<sample><separator><field>` (reference matrixtable.py
        make_table)."""
        st = self._stage
        if len(st.col_key) != 1 or st.col_type[st.col_key[0]] != ht.tstr:
            raise ValueError('make_table requires a single string column key')
        skey = st.col_key[0]
        samples = [r[skey] for r in st.cols.to_pylist()]
        ent_fields = list(st.entry_type.fields)
        if builtins.any(smp is None for smp in samples):
            raise ValueError('make_table: column key contains a missing value')

        def _mk_name(smp, fn):
            # empty entry field name: separator omitted (reference
            # make_table docstring "If the entry field name is empty...")
            return smp if fn == '' else f'{smp}{separator}{fn}'
        from .table import Table, TableStage
        new_fields = dict(st.row_type.items())
        for s in samples:
            for fn in ent_fields:
                new_fields[_mk_name(s, fn)] = st.entry_type[fn]
        new_t = ht.tstruct(**new_fields)
        out_batches = []
        for i, ctx in enumerate(st.contexts):
            mb = st.partition_fn(ctx)
            cols = dict(mb.rows.columns)
            for j, s in enumerate(samples):
                for fn in ent_fields:
                    c = mb.entries[fn]
                    cols[_mk_name(s, fn)] = c.gather(np.asarray([j]), axis=1).reshape((mb.n_rows,))
            out_batches.append(Batch(cols, mb.n_rows))
        return Table(TableStage.from_batches(st.globals, st.row_key, new_t,
                                             out_batches))

    @classmethod
    def from_rows_table(cls, table: 'Table') -> 'MatrixTable':
        """A MatrixTable with no columns from a table's rows (reference
        matrixtable.py from_rows_table)."""
        st = table._stage
        col_t = ht.tstruct()
        cols = Batch({}, 0)
        batches = [MatrixBatch(b, {}) for b in st.collect_batches()]
        return MatrixTable(MatrixStage.from_batches(
            st.globals, cols, st.key, [], st.row_type, col_t,
            ht.tstruct(), batches))

    @staticmethod
    def from_parts(globals=None, rows=None, cols=None, entries=None) -> 'MatrixTable':
        """Build a MatrixTable from dicts of global/row/col/entry data
        (reference matrixtable.py from_parts). Row/col fields are parallel
        lists; entry fields are row-major lists of lists."""
        from .expr.expression import impute_type
        rows = rows or {}
        cols = cols or {}
        entries = entries or {}
        globals = globals or {}
        assert rows or entries, 'from_parts: need rows or entries'
        assert cols or entries, 'from_parts: need cols or entries'
        n_r = len(next(iter(rows.values()))) if rows else \
            len(next(iter(entries.values())))
        n_c = len(next(iter(cols.values()))) if cols else \
            len(next(iter(entries.values()))[0])
        for k, v in rows.items():
            if len(v) != n_r:
                raise ValueError(f'mismatched row property dimensions: '
                                 f'{k!r} has {len(v)} values, expected {n_r}')
        for k, v in cols.items():
            if len(v) != n_c:
                raise ValueError(f'mismatched col property dimensions: '
                                 f'{k!r} has {len(v)} values, expected {n_c}')
        for k, v in entries.items():
            if len(v) != n_r or any(len(r) != n_c for r in v):
                raise ValueError(f'mismatched entry property dimensions: '
                                 f'{k!r} is not {n_r} x {n_c}')
        mt = range_matrix_table(n_r, n_c)
        from .expr import functions as F
        if globals:
            mt = mt.annotate_globals(**{k: to_expr(v) for k, v in globals.items()})
        if rows:
            mt = mt.annotate_rows(**{k: F.literal(list(v))[mt.row_idx]
                                     for k, v in rows.items()})
        if cols:
            mt = mt.annotate_cols(**{k: F.literal(list(v))[mt.col_idx]
                                     for k, v in cols.items()})
        if entries:
            mt = mt.annotate_entries(**{k: F.literal([list(r) for r in v])[mt.row_idx][mt.col_idx]
                                        for k, v in entries.items()})
        return mt

    def sample_rows(self, p: float, seed=None) -> 'MatrixTable':
        from .expr import functions as F
        return self.filter_rows(F.rand_unif(0, 1, seed=seed) < p)

    def sample_cols(self, p: float, seed=None) -> 'MatrixTable':
        from .expr import functions as F
        return self.filter_cols(F.rand_unif(0, 1, seed=seed) < p)

    def repartition(self, n: int, shuffle: bool = True) -> 'MatrixTable':
        batches = self._stage.collect_batches()
        rows_total = sum(mb.n_rows for mb in batches)
        if not batches:
            return self
        # concatenate then re-split
        all_rows = Batch.concat([mb.rows for mb in batches])
        ents = {k: C.concat_columns([mb.entries[k] for mb in batches], axis=0)
                for k in self._stage.entry_type.fields}
        n = max(1, min(n, max(rows_total, 1)))
        bounds = np.linspace(0, rows_total, n + 1).astype(int)
        out = []
        for i in range(n):
            s, e = int(bounds[i]), int(bounds[i + 1])
            out.append(MatrixBatch(all_rows.slice(s, e),
                                   {k: c.slice(s, e, axis=0) for k, c in ents.items()}))
        st = self._stage
        return MatrixTable(MatrixStage.from_batches(st.globals, st.cols, st.row_key,
                                                    st.col_key, st.row_type, st.col_type,
                                                    st.entry_type, out))

    def persist(self, storage_level='MEMORY_AND_DISK') -> 'MatrixTable':
        batches = self._stage.collect_batches()
        st = self._stage
        return MatrixTable(MatrixStage.from_batches(st.globals, st.cols, st.row_key,
                                                    st.col_key, st.row_type, st.col_type,
                                                    st.entry_type, batches))

    cache = persist

    def unpersist(self):
        return self

    def checkpoint(self, path: str, overwrite: bool = False) -> 'MatrixTable':
        self.write(path, overwrite=overwrite)
        return read_matrix_table(path)

    def write(self, path: str, overwrite: bool = False,
              stage_locally: bool = False, _codec_spec=None,
              _partitions=None):
        from .io.native import write_matrix_table
        mt = self
        if _partitions is not None:
            mt = mt._repartition_by_intervals(list(_partitions))
        write_matrix_table(mt, path, overwrite)

    def _repartition_by_intervals(self, intervals) -> 'MatrixTable':
        """One partition per key interval, dropping rows outside their union
        (reference write(_partitions=...) partitioner coercion)."""
        from .table import _interval_contains_key, _key_tuples
        st = self._stage
        mb = _concat_matrix_batches(st.collect_batches(), st)
        kts = _key_tuples(mb.rows, st.row_key)
        batches = []
        for iv in intervals:
            keep = np.asarray([_interval_contains_key(iv, kt) for kt in kts],
                              dtype=bool) if kts else np.zeros(0, dtype=bool)
            batches.append(mb.filter_rows(keep))
        return MatrixTable(MatrixStage.from_batches(
            st.globals, st.cols, st.row_key, st.col_key, st.row_type,
            st.col_type, st.entry_type, batches))

    # -- unions ------------------------------------------------------------
    def union_rows(self, *others, _check_cols: bool = True) -> 'MatrixTable':
        from .table import _key_tuples
        st = self._stage
        my_cols = _key_tuples(st.cols, st.col_key)
        all_batches = list(self._stage.collect_batches())
        for o in others:
            if str(o._stage.entry_type) != str(st.entry_type):
                raise ValueError('union_rows: entry types differ')
            if _check_cols and _key_tuples(o._stage.cols, o._stage.col_key) != my_cols:
                raise ValueError(
                    'union_rows: datasets must have the same columns in the '
                    'same order; use union_rows(..., _check_cols=False) to '
                    'disable this check')
            all_batches.extend(o._stage.collect_batches())
        return MatrixTable(MatrixStage.from_batches(st.globals, st.cols, st.row_key,
                                                    st.col_key, st.row_type, st.col_type,
                                                    st.entry_type, all_batches))

    def union_cols(self, other: 'MatrixTable', row_join_type: str = 'inner',
                   drop_right_row_fields: bool = True) -> 'MatrixTable':
        """Union of columns; rows joined on row key (reference
        matrixtable.py union_cols / MatrixIR.scala MatrixUnionCols)."""
        if row_join_type not in ('inner', 'outer'):
            raise ValueError(f"row_join_type must be 'inner' or 'outer', "
                             f"got {row_join_type!r}")
        if self._stage.entry_type != other._stage.entry_type:
            raise ValueError(f'entry types differ:\n'
                             f'    left: {self._stage.entry_type}\n'
                             f'    right: {other._stage.entry_type}')
        if self._stage.col_type != other._stage.col_type:
            raise ValueError(f'column types differ:\n'
                             f'    left: {self._stage.col_type}\n'
                             f'    right: {other._stage.col_type}')
        if list(self._stage.col_key) != list(other._stage.col_key):
            raise ValueError(
                f'column key fields differ:\n'
                f"    left: {', '.join(self._stage.col_key)}\n"
                f"    right: {', '.join(other._stage.col_key)}")
        lkt = [self._stage.row_type[k] for k in self._stage.row_key]
        rkt = [other._stage.row_type[k] for k in other._stage.row_key]
        if lkt != rkt:
            raise ValueError(
                f'row key types differ:\n'
                f"    left: {', '.join(map(str, lkt))}\n"
                f"    right: {', '.join(map(str, rkt))}")
        if drop_right_row_fields:
            other = other.select_rows()
        else:
            left_fields = set(self._stage.row_type.fields) - set(self._stage.row_key)
            renames = {}
            for f in other._stage.row_type.fields:
                if f in other._stage.row_key:
                    continue
                nf = f
                while nf in left_fields or (nf != f and nf in renames.values()):
                    nf = nf + '_1'
                if nf != f:
                    renames[f] = nf
            if renames:
                other = other.rename(renames)

        st = self._stage
        ot = other._stage
        lmb = _concat_matrix_batches(st.collect_batches(), st)
        rmb = _concat_matrix_batches(ot.collect_batches(), ot)
        from .table import _key_tuples, _hashable_key, _sort_indices, _choose
        lmap, rmap = {}, {}
        l_null, r_null = [], []
        for i, k in enumerate(_key_tuples(lmb.rows, st.row_key)):
            if builtins.any(v is None for v in k):
                l_null.append(i)
            else:
                lmap.setdefault(_hashable_key(k), i)
        for j, k in enumerate(_key_tuples(rmb.rows, ot.row_key)):
            if builtins.any(v is None for v in k):
                r_null.append(j)
            else:
                rmap.setdefault(_hashable_key(k), j)
        l_idx, r_idx = [], []
        for k, i in lmap.items():
            j = rmap.get(k, -1)
            if j >= 0 or row_join_type == 'outer':
                l_idx.append(i)
                r_idx.append(j)
        if row_join_type == 'outer':
            # missing keys never match (SQL join semantics): null-keyed rows
            # from each side survive an outer join unmatched
            for k, j in rmap.items():
                if k not in lmap:
                    l_idx.append(-1)
                    r_idx.append(j)
            for i in l_null:
                l_idx.append(i)
                r_idx.append(-1)
            for j in r_null:
                l_idx.append(-1)
                r_idx.append(j)
        l_idx = np.asarray(l_idx, dtype=np.int64)
        r_idx = np.asarray(r_idx, dtype=np.int64)
        lmiss = l_idx < 0
        rmiss = r_idx < 0
        lg = np.maximum(l_idx, 0)
        rg = np.maximum(r_idx, 0)

        row_cols: Dict[str, C.Column] = {}
        for f, c in lmb.rows.columns.items():
            g = c.gather(lg)
            if f in st.row_key:
                rj = rmb.rows.columns[list(ot.row_key)[list(st.row_key).index(f)]].gather(rg)
                row_cols[f] = _choose(lmiss, rj, g)
            else:
                row_cols[f] = g.with_missing(lmiss if lmiss.any() else None)
        r_value_fields = [f for f in ot.row_type.fields if f not in ot.row_key]
        for f in r_value_fields:
            g = rmb.rows.columns[f].gather(rg)
            row_cols[f] = g.with_missing(rmiss if rmiss.any() else None)
        n_out = len(l_idx)
        rows = Batch(row_cols, n_out)
        order = _sort_indices(rows, [(k, True) for k in st.row_key])
        rows = rows.gather(order)
        lmiss = lmiss[order]
        rmiss = rmiss[order]
        lg = lg[order]
        rg = rg[order]

        n_lc, n_rc = st.n_cols, ot.n_cols
        ents: Dict[str, C.Column] = {}
        for f in st.entry_type.fields:
            le = lmb.entries[f].gather(lg, axis=0)
            re = rmb.entries[f].gather(rg, axis=0)
            if lmiss.any():
                le = le.with_missing(np.broadcast_to(lmiss[:, None], (n_out, n_lc)))
            if rmiss.any():
                re = re.with_missing(np.broadcast_to(rmiss[:, None], (n_out, n_rc)))
            ents[f] = C.concat_columns([le, re], axis=1)
        em = None
        lem = lmb.entry_missing
        rem = rmb.entry_missing
        if lem is not None or rem is not None:
            lem2 = lem[lg] if lem is not None else np.zeros((n_out, n_lc), dtype=bool)
            rem2 = rem[rg] if rem is not None else np.zeros((n_out, n_rc), dtype=bool)
            em = np.concatenate([lem2, rem2], axis=1)
        cols = Batch.concat([st.cols, ot.cols])
        new_rt = ht.tstruct(**{k: c.typ for k, c in rows.columns.items()})
        out_mb = MatrixBatch(rows, ents)
        if em is not None:
            out_mb.entry_missing = em
        return MatrixTable(MatrixStage.from_batches(
            st.globals, cols, st.row_key, st.col_key, new_rt, st.col_type,
            st.entry_type, [out_mb]))

    # -- misc --------------------------------------------------------------
    def rename(self, mapping: Dict[str, str]) -> 'MatrixTable':
        st = self._stage
        all_fields = (list(st.globals_type.fields) + list(st.row_type.fields)
                      + list(st.col_type.fields) + list(st.entry_type.fields))
        for old in mapping:
            if old not in all_fields:
                raise LookupError(f'cannot rename missing field {old!r}')
        seen = {}
        for old, new in mapping.items():
            if new in seen:
                raise ValueError(
                    f'cannot rename two fields to the same name: {new!r}')
            seen[new] = old
            if new in all_fields and new not in mapping:
                raise ValueError(
                    f'cannot rename {old!r} to {new!r}: field already exists')
        new_rt = ht.tstruct.from_fields([(mapping.get(k, k), v) for k, v in st.row_type.items()])
        new_et = ht.tstruct.from_fields([(mapping.get(k, k), v) for k, v in st.entry_type.items()])
        def f(mb, i):
            return MatrixBatch(
                Batch({mapping.get(k, k): c for k, c in mb.rows.columns.items()}, mb.n_rows),
                {mapping.get(k, k): c for k, c in mb.entries.items()})
        st2 = st.map_partitions(f, new_row_type=new_rt, new_entry_type=new_et)
        cb = Batch({mapping.get(k, k): c for k, c in st.cols.columns.items()}, st.n_cols)
        return MatrixTable(MatrixStage(
            st2.globals, cb, [mapping.get(k, k) for k in st.row_key],
            [mapping.get(k, k) for k in st.col_key], new_rt, cb.row_type, new_et,
            st2.contexts, st2.partition_fn))

    @staticmethod
    def _transmute_refs(exprs) -> set:
        # transmute drops the fields its expressions reference: collect both
        # struct-field accesses (row/col/entry bases) and bare field refs
        from .ir.nodes import GetField, Ref
        refs = set()
        def rec(node):
            if isinstance(node, GetField) and isinstance(node.struct, Ref):
                refs.add(node.name)
            elif isinstance(node, Ref):
                refs.add(node.name)
            for c in node.children:
                rec(c)
        for e in exprs.values():
            rec(e._ir)
        return refs

    def transmute_entries(self, **named_exprs):
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        refs = MatrixTable._transmute_refs(exprs)
        keep = [f for f in self._stage.entry_type.fields
                if f not in named_exprs and f not in refs]
        return self.select_entries(*keep, **named_exprs)

    def transmute_rows(self, **named_exprs):
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        refs = MatrixTable._transmute_refs(exprs)
        keep = [f for f in self._stage.row_type.fields
                if f not in named_exprs and f not in self._stage.row_key
                and f not in refs]
        return self.select_rows(*keep, **named_exprs)

    def transmute_cols(self, **named_exprs):
        exprs = {k: to_expr(v) for k, v in named_exprs.items()}
        refs = MatrixTable._transmute_refs(exprs)
        keep = [f for f in self._stage.col_type.fields
                if f not in named_exprs and f not in self._stage.col_key
                and f not in refs]
        return self.select_cols(*keep, **named_exprs)

    def add_row_index(self, name: str = 'row_idx') -> 'MatrixTable':
        batches = self._stage.collect_batches()
        out = []
        off = 0
        for mb in batches:
            col = PrimitiveColumn(ht.tint64, np.arange(off, off + mb.n_rows, dtype=np.int64))
            out.append(MatrixBatch(mb.rows.annotate(**{name: col}), mb.entries,
                                   mb.entry_missing))
            off += mb.n_rows
        st = self._stage
        return MatrixTable(MatrixStage.from_batches(
            st.globals, st.cols, st.row_key, st.col_key,
            st.row_type._insert_field(name, ht.tint64), st.col_type, st.entry_type, out))

    def add_col_index(self, name: str = 'col_idx') -> 'MatrixTable':
        st = self._stage
        col = PrimitiveColumn(ht.tint32, np.arange(st.n_cols, dtype=np.int32))
        cb = st.cols.annotate(**{name: col})
        return MatrixTable(MatrixStage(st.globals, cb, st.row_key, st.col_key,
                                       st.row_type, cb.row_type, st.entry_type,
                                       st.contexts, st.partition_fn))

    def entries_block(self, field: str, part_idx: int = None):
        """Internal: materialize an entry field as a dense numpy block list —
        the on-ramp to the jit tier (methods/)."""
        out = []
        for ctx in self._stage.contexts:
            mb = self._stage.partition_fn(ctx)
            out.append(mb.entries[field])
        return out


class GroupedMatrixTable:
    """Result of group_rows_by/group_cols_by (reference
    `hail/python/hail/matrixtable.py` GroupedMatrixTable →
    MatrixAggregateRowsByKey/MatrixAggregateColsByKey)."""

    def __init__(self, mt: 'MatrixTable', row_keys=None, col_keys=None,
                 entry_aggs=None, row_aggs=None, col_aggs=None,
                 key_renames=None):
        self._mt = mt
        self._row_keys = row_keys
        self._col_keys = col_keys
        self._entry_aggs = dict(entry_aggs or {})
        self._row_aggs = dict(row_aggs or {})
        self._col_aggs = dict(col_aggs or {})
        self._key_renames = dict(key_renames or {})

    def partition_hint(self, n: int) -> 'GroupedMatrixTable':
        return self

    def _copy(self, **updates) -> 'GroupedMatrixTable':
        d = dict(mt=self._mt, row_keys=self._row_keys, col_keys=self._col_keys,
                 entry_aggs=self._entry_aggs, row_aggs=self._row_aggs,
                 col_aggs=self._col_aggs, key_renames=self._key_renames)
        d.update(updates)
        return GroupedMatrixTable(d['mt'], d['row_keys'], d['col_keys'],
                                  d['entry_aggs'], d['row_aggs'], d['col_aggs'],
                                  d['key_renames'])

    def _check_field_names(self, exprs, allow_entry_collision=False):
        from .expr.typefuncs import ExpressionException
        st = self._mt._stage
        keys = set(self._row_keys or []) | set(self._col_keys or [])
        other = (set(st.col_type.fields) if self._row_keys is not None
                 else set(st.row_type.fields))
        staged = (set(self._entry_aggs) | set(self._row_aggs)
                  | set(self._col_aggs))
        forbidden = set(st.globals_type.fields) | keys | other | staged
        if not allow_entry_collision:
            forbidden |= set(st.entry_type.fields)
        for n in exprs:
            if n in forbidden:
                raise ExpressionException(
                    f'cannot assign aggregated field {n!r}: '
                    f'name collides with an existing field')

    def _check_scope(self, exprs, free_allowed, agg_allowed, what):
        from .expr.scopes import axis_usage
        from .expr.typefuncs import ExpressionException
        for n, e in exprs.items():
            free, agged = axis_usage(to_expr(e)._ir)
            if not free <= free_allowed:
                raise ExpressionException(
                    f'{what} {n!r}: non-aggregated indices '
                    f'{sorted(free - free_allowed)} are out of scope')
            if not agged <= agg_allowed:
                raise ExpressionException(
                    f'{what} {n!r}: aggregation scope is '
                    f'{sorted(agg_allowed)} only, found {sorted(agged)}')

    def aggregate_entries(self, **exprs) -> 'GroupedMatrixTable':
        """Stage per-group entry aggregations (reference
        GroupedMatrixTable.aggregate_entries)."""
        self._check_field_names(exprs, allow_entry_collision=True)
        other_axis = 'column' if self._row_keys is not None else 'row'
        self._check_scope(exprs, frozenset({other_axis}),
                          frozenset({'row', 'column'}), 'aggregate_entries')
        return self._copy(entry_aggs={**self._entry_aggs, **exprs})

    def aggregate_rows(self, **exprs) -> 'GroupedMatrixTable':
        """Stage per-group row-field aggregations (row grouping only)."""
        if self._row_keys is None:
            raise NotImplementedError(
                'aggregate_rows requires group_rows_by')
        self._check_field_names(exprs)
        self._check_scope(exprs, frozenset(), frozenset({'row'}),
                          'aggregate_rows')
        return self._copy(row_aggs={**self._row_aggs, **exprs})

    def aggregate_cols(self, **exprs) -> 'GroupedMatrixTable':
        """Stage per-group col-field aggregations (col grouping only)."""
        if self._col_keys is None:
            raise NotImplementedError(
                'aggregate_cols requires group_cols_by')
        self._check_field_names(exprs)
        self._check_scope(exprs, frozenset(), frozenset({'column'}),
                          'aggregate_cols')
        return self._copy(col_aggs={**self._col_aggs, **exprs})

    def result(self) -> 'MatrixTable':
        """Execute all staged aggregations (reference
        GroupedMatrixTable.result)."""
        return self._result(self._entry_aggs, self._row_aggs, self._col_aggs)

    def aggregate(self, **entry_exprs) -> 'MatrixTable':
        self._check_field_names(entry_exprs, allow_entry_collision=True)
        return self._result({**self._entry_aggs, **entry_exprs},
                            self._row_aggs, self._col_aggs)

    def _result(self, entry_exprs, row_agg_exprs, col_agg_exprs) -> 'MatrixTable':
        out = self._result_inner(entry_exprs, row_agg_exprs, col_agg_exprs)
        if self._key_renames:
            out = out.rename(dict(self._key_renames))
        return out

    def _result_inner(self, entry_exprs, row_agg_exprs, col_agg_exprs) -> 'MatrixTable':
        mt = self._mt
        st = mt._stage
        exprs = {k: to_expr(v) for k, v in entry_exprs.items()}
        new_entry_t = ht.tstruct(**{k: e.dtype for k, e in exprs.items()})
        all_nodes = {k: aggmod.collect_agg_nodes(e._ir) for k, e in exprs.items()}
        axis_exprs = {k: to_expr(v) for k, v in
                      (row_agg_exprs if self._row_keys is not None
                       else col_agg_exprs).items()}
        axis_nodes = {k: aggmod.collect_agg_nodes(e._ir)
                      for k, e in axis_exprs.items()}

        if self._row_keys is not None:
            key_names = list(self._row_keys)
            # phase 1: per-partition, per-group partial states — entry aggs
            # over (rows-in-group × cols), row aggs over rows-in-group
            def part(i_ctx):
                pi, ctx = i_ctx
                mb = st.partition_fn(ctx)
                renv = mt._row_env(mb, pi)
                key_cols = {kn: renv.bindings['va'].fields[kn] for kn in key_names}
                # freeze container-typed key values (array/set/dict keys are
                # legal group keys — reference doc examples group by alleles)
                keys = [tuple(_structs_freeze(v) for v in kt) for kt in zip(
                    *[C.obj_array(C._flatten(kc.to_pylist(), 1))
                      for kc in key_cols.values()])] \
                    if key_names else [() for _ in range(mb.n_rows)]
                env = mt._entry_env(mb, pi)
                groups = {}
                for i, kt in enumerate(keys):
                    groups.setdefault(kt, []).append(i)
                out = {}
                unfilt = MatrixTable._unfiltered_mask(mb)
                for kt, idxs in groups.items():
                    mask = np.zeros((mb.n_rows, 1), dtype=bool)
                    mask[idxs, 0] = True
                    emask = np.broadcast_to(mask, env.shape)
                    if unfilt is not None:
                        emask = emask & unfilt
                    states = {('e', name): aggmod.partial_aggregate(
                        nodes, env, (0,), extra_include=emask)
                        for name, nodes in all_nodes.items()}
                    rmask = mask[:, 0]
                    states.update({('r', name): aggmod.partial_aggregate(
                        nodes, renv, (0,), extra_include=rmask)
                        for name, nodes in axis_nodes.items()})
                    out[kt] = states
                return out
            partials = Env.backend().map_collect(
                list(enumerate(st.contexts)), part)
            node_of = {('e', n): all_nodes[n] for n in all_nodes}
            node_of.update({('r', n): axis_nodes[n] for n in axis_nodes})
            merged: Dict = {}
            for p in partials:
                for kt, states in p.items():
                    if kt in merged:
                        merged[kt] = {nk: aggmod.combine_states(node_of[nk], merged[kt][nk], states[nk])
                                      for nk in states}
                    else:
                        merged[kt] = states
            group_keys = sorted(merged.keys(), key=lambda t: tuple((x is None, x) for x in t))
            Cn = st.n_cols
            ents = {}
            from .ir.arrays import _mix_uid
            genv = mt._globals_env()
            for name, e in exprs.items():
                cols_per_group = []
                for gi, kt in enumerate(group_keys):
                    # distinct uids per (group, column) so body randomness in
                    # the aggregation result differs per output entry
                    cenv = mt._col_env().bind('__row_idx__', PrimitiveColumn(
                        ht.tint64, _mix_uid(np.full(Cn, gi, dtype=np.int64),
                                            np.arange(Cn, dtype=np.int64))))
                    col = aggmod.finalize_aggregate(e._ir, all_nodes[name], merged[kt][('e', name)], cenv)
                    if col.shape != (Cn,):
                        col = col.broadcast_to((Cn,)) if int(np.prod(col.shape)) == 1 else col.reshape((Cn,))
                    cols_per_group.append(col.reshape((1, Cn)))
                ents[name] = C.concat_columns(cols_per_group, axis=0) if cols_per_group else \
                    C.null_column(e.dtype, (0, Cn))
            key_types = {kn: st.row_type[kn] for kn in key_names}
            row_cols = {kn: C.from_pylist(key_types[kn], [kt[i] for kt in group_keys])
                        for i, kn in enumerate(key_names)}
            for name, e in axis_exprs.items():
                vals = []
                for gi, kt in enumerate(group_keys):
                    fenv = genv.bind('__row_idx__', PrimitiveColumn(
                        ht.tint64, np.asarray([gi], dtype=np.int64)))
                    col = aggmod.finalize_aggregate(e._ir, axis_nodes[name], merged[kt][('r', name)], fenv)
                    lst = col.to_pylist()
                    vals.append(lst[0] if lst else None)
                row_cols[name] = C.from_pylist(e.dtype, vals)
            row_t = ht.tstruct(**key_types,
                               **{n: e.dtype for n, e in axis_exprs.items()})
            rows = Batch(row_cols, len(group_keys))
            return MatrixTable(MatrixStage.from_batches(
                st.globals, st.cols, key_names, st.col_key,
                row_t, st.col_type, new_entry_t,
                [MatrixBatch(rows, ents)]))

        # group_cols_by
        key_names = list(self._col_keys)
        cenv = mt._col_env()
        key_cols = {kn: cenv.bindings['sa'].fields[kn] for kn in key_names}
        keys = [tuple(_structs_freeze(v) for v in kt) for kt in
                zip(*[C._flatten(kc.to_pylist(), 1) for kc in key_cols.values()])]
        groups: Dict = {}
        for j, kt in enumerate(keys):
            groups.setdefault(kt, []).append(j)
        group_keys = sorted(groups.keys(), key=lambda t: tuple((x is None, x) for x in t))
        batches = []
        from .ir.arrays import _mix_uid
        for pi, ctx in enumerate(st.contexts):
            mb = st.partition_fn(ctx)
            env = mt._entry_env(mb, pi)
            base_renv = mt._row_env(mb, pi)
            ents = {}
            for name, e in exprs.items():
                per_group = []
                unfilt = MatrixTable._unfiltered_mask(mb)
                for gi, kt in enumerate(group_keys):
                    mask = np.zeros((1, st.n_cols), dtype=bool)
                    mask[0, groups[kt]] = True
                    emask = np.broadcast_to(mask, env.shape)
                    if unfilt is not None:
                        emask = emask & unfilt
                    states = aggmod.partial_aggregate(all_nodes[name], env, (1,),
                                                      extra_include=emask)
                    renv = base_renv.bind('__row_idx__', PrimitiveColumn(
                        ht.tint64, _mix_uid(
                            np.asarray(base_renv.bindings['__row_idx__'].values),
                            np.full(mb.n_rows, gi, dtype=np.int64))))
                    col = aggmod.finalize_aggregate(e._ir, all_nodes[name], states, renv)
                    if col.shape != (mb.n_rows,):
                        col = (col.broadcast_to((mb.n_rows,))
                               if int(np.prod(col.shape)) == 1
                               else col.reshape((mb.n_rows,)))
                    per_group.append(col.reshape((mb.n_rows, 1)))
                ents[name] = C.concat_columns(per_group, axis=1) if per_group else \
                    C.null_column(e.dtype, (mb.n_rows, 0))
            batches.append(MatrixBatch(mb.rows, ents, uids=mb.uids))
        key_types = {kn: st.col_type[kn] for kn in key_names}
        col_cols = {kn: C.from_pylist(key_types[kn], [kt[i] for kt in group_keys])
                    for i, kn in enumerate(key_names)}
        genv = mt._globals_env()
        for name, e in axis_exprs.items():
            vals = []
            for gi, kt in enumerate(group_keys):
                cmask = np.zeros(st.n_cols, dtype=bool)
                cmask[groups[kt]] = True
                states = aggmod.partial_aggregate(axis_nodes[name], cenv, (0,),
                                                  extra_include=cmask)
                fenv = genv.bind('__row_idx__', PrimitiveColumn(
                    ht.tint64, np.asarray([gi], dtype=np.int64)))
                col = aggmod.finalize_aggregate(e._ir, axis_nodes[name], states, fenv)
                lst = col.to_pylist()
                vals.append(lst[0] if lst else None)
            col_cols[name] = C.from_pylist(e.dtype, vals)
        col_t = ht.tstruct(**key_types,
                           **{n: e.dtype for n, e in axis_exprs.items()})
        cols = Batch(col_cols, len(group_keys))
        return MatrixTable(MatrixStage.from_batches(
            st.globals, cols, st.row_key, key_names, st.row_type,
            col_t, new_entry_t, batches))


def _bool_mask(col: Column) -> np.ndarray:
    if isinstance(col, PrimitiveColumn):
        vals = np.asarray(col.values, dtype=bool)
    else:
        vals = np.frompyfunc(lambda v: v is True, 1, 1)(C.to_object(col).values).astype(bool)
    return vals & ~col.missing_mask()


def _concat_matrix_batches(batches: List[MatrixBatch], st: MatrixStage) -> MatrixBatch:
    if len(batches) == 1:
        return batches[0]
    rows = Batch.concat([mb.rows for mb in batches])
    ents = {k: C.concat_columns([mb.entries[k] for mb in batches], axis=0)
            for k in st.entry_type.fields}
    return MatrixBatch(rows, ents)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def range_matrix_table(n_rows: int, n_cols: int, n_partitions: Optional[int] = None) -> MatrixTable:
    if n_partitions is None:
        n_partitions = min(max(1, n_rows // 64000 + 1), 8)
    n_partitions = max(1, min(n_partitions, max(n_rows, 1)))
    bounds = np.linspace(0, n_rows, n_partitions + 1).astype(np.int64)
    contexts = [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_partitions)]
    row_t = ht.tstruct(row_idx=ht.tint32)
    col_t = ht.tstruct(col_idx=ht.tint32)
    entry_t = ht.tstruct()
    cols = Batch({'col_idx': PrimitiveColumn(ht.tint32, np.arange(n_cols, dtype=np.int32))}, n_cols)
    def pf(ctx):
        s, e = ctx
        rows = Batch({'row_idx': PrimitiveColumn(ht.tint32, np.arange(s, e, dtype=np.int32))}, e - s)
        return MatrixBatch(rows, {})
    g = Batch({}, 1)
    return MatrixTable(MatrixStage(g, cols, ['row_idx'], ['col_idx'],
                                   row_t, col_t, entry_t, contexts, pf))


def read_matrix_table(path: str, *, _intervals=None,
                      _filter_intervals: bool = False,
                      _n_partitions=None, _assert_type=None,
                      _load_refs: bool = True,
                      _create_row_uids: bool = False,
                      _create_col_uids: bool = False,
                      _drop_rows: bool = False,
                      _drop_cols: bool = False) -> MatrixTable:
    """Read a written MatrixTable (reference read_matrix_table); underscore
    options mirror read_table's indexed-read surface applied to row keys."""
    from .io.native import read_matrix_table as rmt
    mt = rmt(path)
    if _drop_rows:
        mt = mt.filter_rows(False)
    if _drop_cols:
        mt = mt.filter_cols(False)
    if _intervals is not None:
        mt = _restrict_mt_to_intervals(mt, list(_intervals), _filter_intervals)
    if _n_partitions is not None:
        mt = mt.repartition(_n_partitions)
    return mt


def _restrict_mt_to_intervals(mt: MatrixTable, intervals,
                              filter_intervals: bool) -> MatrixTable:
    """Indexed MT read (reference IndexedRVDSpec2 seeks): partition bounds
    restrict which source partitions are touched at PLAN time;
    filter_intervals=True keeps the overlapping source partitions'
    granularity, otherwise the result has ONE partition per interval."""
    from .table import _interval_contains_key, _interval_endpoint
    st = mt._stage
    key = list(st.row_key)

    def part_mask(mb, ivs):
        if not mb.n_rows:
            return np.zeros(0, dtype=bool)
        kvals = list(zip(*[mb.rows.columns[k].to_pylist() for k in key]))
        return np.asarray([any(_interval_contains_key(iv, kt) for iv in ivs)
                           for kt in kvals], dtype=bool)

    def overlaps_bounds(iv, b):
        if b is None:
            return True
        s = _interval_endpoint(iv.start, len(key))
        e = _interval_endpoint(iv.end, len(key))
        try:
            lo, hi = b
            sv, ev = s[0], e[0]
            if hasattr(sv, 'contig'):
                sv = sv.reference_genome.global_position(sv.contig, sv.position)
                ev = ev.reference_genome.global_position(ev.contig, ev.position)
            if ev < lo or (ev == lo and not iv.includes_end and len(e) >= len(key)):
                return False
            if sv > hi:
                return False
            return True
        except (TypeError, AttributeError):
            return True

    pf = st.partition_fn
    ctxs = list(st.contexts)
    bounds = st.partition_bounds or [None] * len(ctxs)
    if filter_intervals:
        kept = [i for i, b in enumerate(bounds)
                if any(overlaps_bounds(iv, b) for iv in intervals)]

        def new_pf(i):
            mb = pf(ctxs[i])
            return mb.filter_rows(part_mask(mb, intervals))
        return MatrixTable(MatrixStage(
            st.globals, st.cols, key, st.col_key, st.row_type, st.col_type,
            st.entry_type, kept, new_pf,
            [bounds[i] for i in kept] if st.partition_bounds else None))

    def iv_pf(j):
        iv = intervals[j]
        pieces = [pf(ctxs[i]) for i, b in enumerate(bounds)
                  if overlaps_bounds(iv, b)]
        out = [mb.filter_rows(part_mask(mb, [iv])) for mb in pieces]
        out = [mb for mb in out if mb.n_rows]
        if not out:
            from .ir.columns import Batch as _B
            return MatrixBatch(_B.empty(st.row_type), {
                k: C.null_column(t, (0, st.n_cols))
                for k, t in st.entry_type.items()})
        if len(out) == 1:
            return out[0]
        return _concat_matrix_batches(out, st)
    return MatrixTable(MatrixStage(
        st.globals, st.cols, key, st.col_key, st.row_type, st.col_type,
        st.entry_type, list(range(len(intervals))), iv_pf))



def _check_key_prefix(what: str, left_types: list, right_types: list) -> int:
    """semi/anti join key validation: the right key must be a non-empty
    type-compatible prefix of the left key (reference matrixtable.py
    semi_join_rows key checks). Returns the prefix length."""
    if not right_types or len(right_types) > len(left_types) or \
            builtins.any(lt != rt for lt, rt in zip(left_types, right_types)):
        raise ValueError(
            f'{what}: cannot join: the right-hand key must be a non-empty '
            f'prefix of the left key\n'
            f"    left key:  {', '.join(map(str, left_types))}\n"
            f"    right key: {', '.join(map(str, right_types))}")
    return len(right_types)

def _mt_field_name(e) -> str:
    return _expr_field_name(e)


def _global_field_refs(ir, globals_type) -> set:
    from .ir.nodes import GetField as _GF, Ref as _R
    out = set()

    def walk(n):
        if isinstance(n, _GF) and isinstance(n.struct, _R) and n.struct.name == 'global':
            if n.name in globals_type.fields:
                out.add(n.name)
        for c in n.children:
            walk(c)
    walk(ir)
    return out


def _mt_same(self, other, tolerance=1e-6, absolute=False, reorder_fields=False):
    """Row/col/entry equality within tolerance (reference MatrixTable._same)."""
    if not self.rows()._same(other.rows(), tolerance, absolute):
        return False
    if not self.cols()._same(other.cols(), tolerance, absolute):
        return False
    return self.entries()._same(other.entries(), tolerance, absolute)


MatrixTable._same = _mt_same


# ---------------------------------------------------------------------------
# relational lineage tags for table-producing ops (ir/relational_ir.py)
# ---------------------------------------------------------------------------

def _wrap_mt_table_tir():
    from .ir import relational_ir as _rir

    def wrap(name, node_cls):
        orig = getattr(MatrixTable, name)

        def wrapped(self, *a, **k):
            out = orig(self, *a, **k)
            try:
                out._stage.tir = node_cls(self._tir)
            except Exception:
                pass
            return out
        wrapped.__name__ = getattr(orig, '__name__', name)
        wrapped.__doc__ = orig.__doc__
        setattr(MatrixTable, name, wrapped)

    wrap('rows', _rir.MatrixRowsTable)
    wrap('cols', _rir.MatrixColsTable)
    wrap('entries', _rir.MatrixEntriesTable)
    wrap('localize_entries', _rir.CastMatrixToTable)


_wrap_mt_table_tir()


def _wrap_mt_lineage():
    from .ir import relational_ir as _rir

    MatrixTable._mir = MatrixTable._tir

    def wrap(name, node_cls, n_sources=1):
        if not hasattr(MatrixTable, name):
            return
        orig = getattr(MatrixTable, name)

        def wrapped(self, *a, **k):
            out = orig(self, *a, **k)
            if isinstance(out, MatrixTable):
                parents = [self._tir]
                if n_sources == 2 and a and isinstance(a[0], MatrixTable):
                    parents.append(a[0]._tir)
                try:
                    out._stage.tir = node_cls(*parents)
                except Exception:
                    pass
            return out
        wrapped.__name__ = getattr(orig, '__name__', name)
        wrapped.__doc__ = orig.__doc__
        setattr(MatrixTable, name, wrapped)

    def wrap_annotate(name, map_node, join_node):
        orig = getattr(MatrixTable, name)

        def wrapped(self, **named_exprs):
            out = orig(self, **named_exprs)
            if isinstance(out, MatrixTable):
                from .table import JoinLookup
                child = self._tir
                has_join = False

                def scan(ir_):
                    nonlocal has_join
                    if isinstance(ir_, JoinLookup):
                        has_join = True
                    for c in getattr(ir_, 'children', ()):
                        scan(c)
                for e in named_exprs.values():
                    if isinstance(e, Expression):
                        scan(e._ir)
                if has_join:
                    child = join_node(child)
                try:
                    out._stage.tir = map_node(child)
                except Exception:
                    pass
            return out
        wrapped.__name__ = name
        wrapped.__doc__ = orig.__doc__
        setattr(MatrixTable, name, wrapped)
    wrap_annotate('annotate_rows', _rir.MatrixMapRows, _rir.MatrixAnnotateRowsTable)
    wrap_annotate('annotate_cols', _rir.MatrixMapCols, _rir.MatrixAnnotateColsTable)
    wrap_annotate('annotate_entries', _rir.MatrixMapEntries, _rir.MatrixMapEntries)

    for nm, cls in [
        ('select_rows', _rir.MatrixMapRows),
        ('transmute_rows', _rir.MatrixMapRows),
        ('select_cols', _rir.MatrixMapCols),
        ('transmute_cols', _rir.MatrixMapCols),
        ('select_entries', _rir.MatrixMapEntries),
        ('transmute_entries', _rir.MatrixMapEntries),
        ('annotate_globals', _rir.MatrixMapGlobals),
        ('select_globals', _rir.MatrixMapGlobals),
        ('transmute_globals', _rir.MatrixMapGlobals),
        ('filter_rows', _rir.MatrixFilterRows),
        ('filter_cols', _rir.MatrixFilterCols),
        ('filter_entries', _rir.MatrixFilterEntries),
        ('key_rows_by', _rir.MatrixKeyRowsBy),
        ('_key_rows_by_assert_sorted', _rir.MatrixKeyRowsBy),
        ('key_cols_by', _rir.MatrixMapCols),
        ('explode_rows', _rir.MatrixExplodeRows),
        ('explode_cols', _rir.MatrixExplodeCols),
        ('choose_cols', _rir.MatrixChooseCols),
        ('collect_cols_by_key', _rir.MatrixCollectColsByKey),
        ('distinct_by_row', _rir.MatrixDistinctByRow),
        ('head', _rir.MatrixRowsHead),
        ('tail', _rir.MatrixRowsTail),
        ('rename', _rir.MatrixRename),
        ('repartition', _rir.MatrixRepartition),
        ('naive_coalesce', _rir.MatrixRepartition),
        ('drop', _rir.MatrixMapRows),
    ]:
        wrap(nm, cls)
    wrap('union_rows', _rir.MatrixUnionRows, n_sources=2)
    wrap('union_cols', _rir.MatrixUnionCols, n_sources=2)

    # head/tail with n_cols produce ColsHead/ColsTail lineage
    def wrap_ht(name, row_node, col_node):
        orig = getattr(MatrixTable, name)

        def wrapped(self, n_rows, n_cols=None, **k):
            out = orig(self, n_rows, n_cols, **k)
            if isinstance(out, MatrixTable):
                node = self._tir
                if n_rows is not None:
                    node = row_node(node)
                if n_cols is not None:
                    node = col_node(node)
                try:
                    out._stage.tir = node
                except Exception:
                    pass
            return out
        wrapped.__name__ = name
        setattr(MatrixTable, name, wrapped)
    wrap_ht('head', _rir.MatrixRowsHead, _rir.MatrixColsHead)
    wrap_ht('tail', _rir.MatrixRowsTail, _rir.MatrixColsTail)

    def wrap_apply(name):
        if not hasattr(MatrixTable, name):
            return
        orig = getattr(MatrixTable, name)

        def wrapped(self, *a, **k):
            out = orig(self, *a, **k)
            if isinstance(out, MatrixTable):
                try:
                    out._stage.tir = _rir.MatrixToMatrixApply(self._tir)
                except Exception:
                    pass
            return out
        wrapped.__name__ = name
        setattr(MatrixTable, name, wrapped)
    wrap_apply('_filter_partitions')


_wrap_mt_lineage()


def _wrap_mt_constructors_lineage():
    import sys
    from .ir import relational_ir as _rir
    mod = sys.modules[__name__]

    orig_range = range_matrix_table

    def range_matrix_table_(n_rows, n_cols, n_partitions=None):
        out = orig_range(n_rows, n_cols, n_partitions)
        try:
            out._stage.tir = _rir.MatrixRead()
        except Exception:
            pass
        return out
    range_matrix_table_.__doc__ = orig_range.__doc__
    mod.range_matrix_table = range_matrix_table_

    orig_read = read_matrix_table

    def read_matrix_table_(path, *a, **k):
        out = orig_read(path, *a, **k)
        try:
            out._stage.tir = _rir.MatrixRead()
        except Exception:
            pass
        return out
    read_matrix_table_.__doc__ = orig_read.__doc__
    mod.read_matrix_table = read_matrix_table_


_wrap_mt_constructors_lineage()


def _wrap_grouped_mt_lineage():
    from .ir import relational_ir as _rir
    def wrap_result(name):
        orig = getattr(GroupedMatrixTable, name)

        def wrapped(self, **named_exprs):
            out = orig(self, **named_exprs) if named_exprs or name == 'aggregate' \
                else orig(self)
            if isinstance(out, MatrixTable):
                node = _rir.MatrixAggregateRowsByKey if self._row_keys is not None \
                    else _rir.MatrixAggregateColsByKey
                try:
                    out._stage.tir = node(self._mt._tir)
                except Exception:
                    pass
            return out
        wrapped.__name__ = name
        setattr(GroupedMatrixTable, name, wrapped)
    wrap_result('aggregate')
    wrap_result('result')


_wrap_grouped_mt_lineage()


def _explode_mt_path(mt: MatrixTable, path, axis: str) -> MatrixTable:
    """Explode a NESTED array field along an axis (reference
    MatrixExplodeRows/Cols with a field path)."""
    from .utils.structs import Struct as _S
    st = mt._stage
    t = st.row_type if axis == 'row' else st.col_type
    sub_t = t
    for p in path:
        sub_t = sub_t[p]
    if not isinstance(sub_t, (ht.tarray, ht.tset)):
        raise ValueError(f"explode: field {'.'.join(path)!r} is not an array/set")
    elem_t = sub_t.element_type

    def rebuild_type(typ, i):
        if i == len(path):
            return elem_t
        return ht.tstruct(**{k: (rebuild_type(v, i + 1) if k == path[i] else v)
                             for k, v in typ.items()})
    new_t = rebuild_type(t, 0)

    def get_path(r):
        v = r
        for p in path:
            if v is None:
                return None
            v = v[p]
        return v

    def set_path(r, i, value):
        if i == len(path):
            return value
        d = dict(r)
        d[path[i]] = set_path(r[path[i]], i + 1, value)
        return _S(**d)

    if axis == 'row':
        def f(mb, i):
            rows_py = mb.rows.to_pylist()
            out_idx = []
            out_rows = []
            for r, row in enumerate(rows_py):
                arr = get_path(row)
                if arr is None:
                    continue
                elems = sorted(arr) if isinstance(arr, (set, frozenset)) else list(arr)
                for x in elems:
                    out_idx.append(r)
                    out_rows.append(dict(set_path(row, 0, x)))
            idx = np.asarray(out_idx, dtype=np.int64)
            rows_b = Batch.from_pylist(new_t, out_rows)
            ents = {k: c.gather(idx, axis=0) for k, c in mb.entries.items()}
            filt = mb.entry_missing[idx] if mb.entry_missing is not None else None
            return MatrixBatch(rows_b, ents, filt)
        out = MatrixTable(st.map_partitions(f, new_row_type=new_t))
        from .ir import relational_ir as _rir
        out._stage.tir = _rir.MatrixExplodeRows(mt._tir)
        return out

    # axis == 'col'
    cols_py = st.cols.to_pylist()
    out_idx = []
    out_cols = []
    for j, colrow in enumerate(cols_py):
        arr = get_path(colrow)
        if arr is None:
            continue
        elems = sorted(arr) if isinstance(arr, (set, frozenset)) else list(arr)
        for x in elems:
            out_idx.append(j)
            out_cols.append(dict(set_path(colrow, 0, x)))
    m2 = mt.choose_cols(out_idx)
    st2 = m2._stage
    cols_b = Batch.from_pylist(new_t, out_cols)
    out = MatrixTable(MatrixStage(st2.globals, cols_b, st2.row_key, st2.col_key,
                                  st2.row_type, new_t, st2.entry_type,
                                  st2.contexts, st2.partition_fn))
    from .ir import relational_ir as _rir
    out._stage.tir = _rir.MatrixExplodeCols(mt._tir)
    return out
