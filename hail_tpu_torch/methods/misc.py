"""Misc methods: filter_intervals, rename_duplicates, concordance,
compute_charr, segment_intervals.

Parity with reference `hail/python/hail/methods/misc.py` + `qc.py`
(concordance/compute_charr).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from .. import types as ht
from ..expr import functions as F
from ..expr.expression import to_expr
from ..genetics.call import calls_unphased_diploid_gt_index
from ..ir import columns as C
from ..ir.columns import Batch, LocusColumn, ObjectColumn, PrimitiveColumn
from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
from ..table import Table, TableStage
from ..utils.structs import Interval, Struct


def filter_intervals(ds, intervals, keep: bool = True):
    """Filter rows to (or excluding) a list of locus intervals — vectorized
    via global positions (the reference's interval-pushdown partition pruning,
    `ExtractIntervalFilters.scala`, becomes a mask here)."""
    from ..expr.expression import Expression
    if isinstance(intervals, Expression):
        intervals = F.eval_expr(intervals)
    ivs = []
    for iv in intervals:
        if isinstance(iv, Interval):
            ivs.append(iv)
        else:
            v = F.eval_expr(to_expr(iv))
            ivs.append(v)
    # locus-point intervals use the vectorized global-position mask; struct
    # points (compound keys) go through the generic key-prefix comparison
    _locus_points = all(hasattr(iv.start, 'global_position') for iv in ivs)

    def row_mask(locus_col: LocusColumn) -> np.ndarray:
        gp = locus_col.global_position()
        rg = locus_col.rg
        m = np.zeros(gp.shape, dtype=bool)
        for iv in ivs:
            s, e = iv.start, iv.end
            if hasattr(s, 'global_position'):
                gs, ge = s.global_position(), e.global_position()
            else:
                gs, ge = s, e
            lo = gp > gs if not iv.includes_start else gp >= gs
            hi = gp < ge if not iv.includes_end else gp <= ge
            m |= lo & hi
        return m if keep else ~m

    def gpos_ranges():
        out = []
        for iv in ivs:
            s_, e_ = iv.start, iv.end
            if hasattr(s_, 'global_position'):
                out.append((s_.global_position(), e_.global_position()))
        return out

    def prune_contexts(stage):
        """Skip partitions whose key bounds don't intersect any interval —
        the reference's interval-pushdown partition pruning
        (`ExtractIntervalFilters.scala` + partitioner rangeBounds)."""
        bounds = getattr(stage, 'partition_bounds', None)
        if not keep or bounds is None:
            return None
        ranges = gpos_ranges()
        if len(ranges) != len(ivs):
            return None
        keep_idx = []
        for i, b in enumerate(bounds):
            if b is None:
                keep_idx.append(i)
                continue
            lo, hi = b
            if any(not (hi < s_ or lo > e_) for (s_, e_) in ranges):
                keep_idx.append(i)
        return keep_idx

    if isinstance(ds, MatrixTable):
        st = ds._stage
        keep_idx = prune_contexts(st)
        if keep_idx is not None and len(keep_idx) < len(st.contexts):
            st = MatrixStage(st.globals, st.cols, st.row_key, st.col_key,
                             st.row_type, st.col_type, st.entry_type,
                             [st.contexts[i] for i in keep_idx], st.partition_fn,
                             [st.partition_bounds[i] for i in keep_idx],
                             uid_bases=([st.uid_bases[i] for i in keep_idx]
                                        if st.uid_bases is not None else None))
            ds = MatrixTable(st)
        def f(mb, i):
            key0 = ds._stage.row_key[0]
            col = mb.rows.columns[key0]
            if isinstance(col, LocusColumn) and _locus_points:
                mask = row_mask(col)
            else:
                mask = _generic_interval_mask(mb.rows, ds._stage.row_key, ivs, keep)
            return mb.filter_rows(mask)
        out = MatrixTable(ds._stage.map_partitions(f))
        from ..ir import relational_ir as _rir
        out._stage.tir = _rir.MatrixFilterIntervals(ds._tir)
        return out
    else:
        from ..table import TableStage
        st = ds._stage
        keep_idx = prune_contexts(st)
        if keep_idx is not None and len(keep_idx) < len(st.contexts):
            st = TableStage(st.globals, st.key, st.row_type,
                            [st.contexts[i] for i in keep_idx], st.partition_fn,
                            [st.partition_bounds[i] for i in keep_idx],
                            uid_bases=([st.uid_bases[i] for i in keep_idx]
                                       if st.uid_bases is not None else None))
            ds = Table(st)
        def f(batch, i):
            key0 = ds._stage.key[0]
            col = batch.columns[key0]
            if isinstance(col, LocusColumn) and _locus_points:
                mask = row_mask(col)
            else:
                mask = _generic_interval_mask(batch, ds._stage.key, ivs, keep)
            return batch.compress(mask)
        out = Table(ds._stage.map_partitions(f, ds._stage.row_type))
        from ..ir import relational_ir as _rir
        out._stage.tir = _rir.TableFilterIntervals(ds._tir)
        return out


def require_row_key_variant_w_struct_locus(dataset, method: str):
    """Reference methods/misc.py require_row_key_variant_w_struct_locus: key
    must be (locus, alleles) where locus is locus<any> OR
    struct{contig: str, position: int32}."""
    key = list(dataset._stage.row_key if isinstance(dataset, MatrixTable)
               else dataset._stage.key)
    row_t = dataset._stage.row_type
    loc_t = row_t.fields.get('locus')
    struct_ok = loc_t == ht.tstruct(contig=ht.tstr, position=ht.tint32)
    ok = (key == ['locus', 'alleles']
          and row_t.fields.get('alleles') == ht.tarray(ht.tstr)
          and (isinstance(loc_t, ht.tlocus) or struct_ok))
    if not ok:
        found = ''.join(f"\n    '{k}': {row_t.fields.get(k)}" for k in key)
        raise ValueError(
            f"Method '{method}' requires row key to be two fields 'locus' "
            "(type 'locus<any>' or 'struct{contig: str, position: int32}') "
            f"and 'alleles' (type 'array<str>')\n  Found:{found}")


def require_row_key_variant(dataset, method: str):
    """Reference methods/misc.py require_row_key_variant: row key must be
    (locus, alleles) with locus<rg> / array<str> types."""
    if isinstance(dataset, MatrixTable):
        key = list(dataset._stage.row_key)
        row_t = dataset._stage.row_type
    else:
        key = list(dataset._stage.key)
        row_t = dataset._stage.row_type
    ok = (key == ['locus', 'alleles']
          and isinstance(row_t.fields.get('locus'), ht.tlocus)
          and row_t.fields.get('alleles') == ht.tarray(ht.tstr))
    if not ok:
        raise ValueError(
            f"Method '{method}' requires row key to be two fields 'locus' "
            f"(type 'locus<any>') and 'alleles' (type 'array<str>')\n"
            f"  Found:{''.join(chr(10) + '    ' + k for k in key)}")


def require_biallelic(dataset: MatrixTable, method: str,
                      tolerate_generic_locus: bool = False) -> MatrixTable:
    """Reference methods/misc.py:261 require_biallelic: lazily errors (on
    realization) if any row is not biallelic."""
    from ..utils.misc import HailUserError
    if tolerate_generic_locus:
        require_row_key_variant_w_struct_locus(dataset, method)
    else:
        require_row_key_variant(dataset, method)

    def f(mb, i):
        alleles = mb.rows.columns['alleles'].to_pylist()
        for a in alleles:
            if a is not None and len(a) != 2:
                raise HailUserError(
                    f"'{method}' expects biallelic variants ('alleles' field "
                    f"of length 2), found {a}")
        return mb
    return MatrixTable(dataset._stage.map_partitions(f))


def rename_duplicates(dataset: MatrixTable, name: str = 'unique_id') -> MatrixTable:
    st = dataset._stage
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    # reference misc.rename_duplicates: a generated name must not collide
    # with any name already assigned (original or synthesized); the per-base
    # counter persists across occurrences.
    used = set()
    counts = {}
    uniq = []
    for s in samples:
        if s not in used:
            used.add(s)
            uniq.append(s)
            continue
        k = counts.get(s, 0) + 1
        while f'{s}_{k}' in used:
            k += 1
        counts[s] = k
        new = f'{s}_{k}'
        used.add(new)
        uniq.append(new)
    return _annotate_col_list(dataset, name, uniq)


def _annotate_col_list(mt: MatrixTable, name: str, values: List) -> MatrixTable:
    st = mt._stage
    col = C.from_pylist(ht.tstr, values)
    cb = st.cols.annotate(**{name: col})
    return MatrixTable(MatrixStage(st.globals, cb, st.row_key, st.col_key,
                                   st.row_type, cb.row_type, st.entry_type,
                                   st.contexts, st.partition_fn))


def segment_intervals(ht_table: Table, points) -> Table:
    """Segment an interval-keyed table at the given points (reference
    misc.segment_intervals)."""
    key0 = ht_table._stage.key[0]
    batch = ht_table._stage.collect_single()
    ivs = batch.columns[key0].to_pylist()
    others = {k: batch.columns[k].to_pylist() for k in batch.row_type.fields if k != key0}
    pts = sorted(points, key=lambda p: getattr(p, 'global_position', lambda: p)()
                 if hasattr(p, 'global_position') else p)
    out_rows = []
    for i, iv in enumerate(ivs):
        cuts = [p for p in pts if iv.contains(p)]
        bounds = [iv.start] + cuts + [iv.end]
        for j in range(len(bounds) - 1):
            seg = Interval(bounds[j], bounds[j + 1],
                           iv.includes_start if j == 0 else True,
                           iv.includes_end if j == len(bounds) - 2 else False)
            out_rows.append(Struct(**{key0: seg, **{k: v[i] for k, v in others.items()}}))
    row_t = batch.row_type
    return Table(TableStage.from_batches(ht_table._stage.globals, [key0], row_t,
                                         [Batch.from_pylist(row_t, out_rows)]))


def compute_charr(ds: MatrixTable, min_af: float = 0.05, max_af: float = 0.95,
                  min_dp: int = 10, max_dp: int = 100, min_gq: int = 20,
                  ref_AF=None) -> Table:
    """CHARR contamination estimate (reference qc.compute_charr): per sample,
    mean over high-quality hom-alt biallelic autosomal SNVs of
    (AD[0]/(AD[0]+AD[1])) / ref_AF."""
    from ..genetics.call import calls_is_hom_var, calls_n_alt_alleles
    from ..genetics.allele_type import is_snp as _is_snp
    st = ds._stage
    n = st.n_cols
    need = [f for f in ('AD', 'GT', 'GQ') if f not in st.entry_type.fields]
    if need:
        raise ValueError(
            f"'compute_charr': require a VDS or MatrixTable with fields "
            f"LAD/LGT/GQ/DP or AD/GT/GQ/DP, missing {need}")
    num = np.zeros(n)
    den = np.zeros(n, dtype=np.int64)
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        gt = mb.entries['GT']
        ad = mb.entries['AD']
        dp = mb.entries.get('DP')
        gq = mb.entries['GQ']
        packed = np.asarray(gt.values)
        ok = ~gt.missing_mask() & calls_is_hom_var(packed)
        adv = np.asarray(ad.values, dtype=np.float64)
        ad01 = adv[..., 0] + adv[..., 1]
        dpv = np.asarray(dp.values, np.float64) if dp is not None else ad01
        ok &= (dpv >= min_dp) & (dpv <= max_dp)
        if dp is not None:
            ok &= ~dp.missing_mask()
        ok &= (np.asarray(gq.values) >= min_gq) & ~gq.missing_mask()
        # row filters: autosomal biallelic SNV with ref_AF in (min, max)
        loci = mb.rows.columns.get(st.row_key[0] if st.row_key else 'locus')
        alleles = mb.rows.columns.get('alleles')
        row_ok = np.ones(mb.n_rows, dtype=bool)
        if loci is not None and isinstance(loci, LocusColumn) and loci.rg is not None:
            auto = set(loci.rg.contigs[:22]) if loci.rg.name in ('GRCh37', 'GRCh38') \
                else None
            contigs = [loci.rg.contigs[ci] for ci in np.asarray(loci.contig_idx)]
            if auto is not None:
                row_ok &= np.asarray([c in auto for c in contigs])
        if alleles is not None:
            al = alleles.to_pylist()
            row_ok &= np.asarray([
                a is not None and len(a) == 2 and len(a[0]) == 1
                and len(a[1]) == 1 and a[0] != a[1] for a in al])
        if ref_AF is not None:
            env = ds._row_env(mb, i)
            col = to_expr(ref_AF)._ir.evaluate(env)
            raf = np.broadcast_to(np.asarray(col.values, np.float64),
                                  (mb.n_rows,))
        else:
            if n < 10_000:
                raise ValueError(
                    "'compute_charr': with fewer than 10,000 samples, require "
                    "a reference AF in 'reference_data_source'.")
            called = ~gt.missing_mask()
            with np.errstate(all='ignore'):
                raf = 1 - calls_n_alt_alleles(packed).astype(np.float64).sum(
                    axis=1, where=called) / (2 * n)
        row_ok &= (raf > min_af) & (raf < max_af)
        ok &= row_ok[:, None]
        with np.errstate(all='ignore'):
            charr_per = (adv[..., 0] / np.maximum(ad01, 1)) / raf[:, None]
        num += np.where(ok, charr_per, 0.0).sum(axis=0)
        den += ok.sum(axis=0)
    with np.errstate(all='ignore'):
        charr = num / np.maximum(den, 1)
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    row_t = ht.tstruct(s=ht.tstr, charr=ht.tfloat64)
    rows = [Struct(s=s, charr=float(charr[i])) for i, s in enumerate(samples)]
    return Table(TableStage.from_batches(Batch({}, 1), ['s'], row_t,
                                         [Batch.from_pylist(row_t, rows)]))


def concordance(left: MatrixTable, right: MatrixTable,
                *, _localize_global_statistics: bool = True):
    """Genotype concordance between two datasets (reference qc.concordance):
    returns (global 5x5 matrix, per-sample table, per-variant table).
    Categories: [missing variant, missing GT, hom ref, het, hom var]."""
    from ..table import _key_tuples, _hashable_key
    lst, rst = left._stage, right._stage
    skey_l, skey_r = lst.col_key[0], rst.col_key[0]
    ls = [r[skey_l] for r in lst.cols.to_pylist()]
    rs = [r[skey_r] for r in rst.cols.to_pylist()]
    common = [s for s in ls if s in set(rs)]
    li = np.asarray([ls.index(s) for s in common])
    ri = np.asarray([rs.index(s) for s in common])

    from ..matrixtable import _concat_matrix_batches
    lmb = _concat_matrix_batches(lst.collect_batches(), lst)
    rmb = _concat_matrix_batches(rst.collect_batches(), rst)
    lkeys = [_hashable_key(k) for k in _key_tuples(lmb.rows, lst.row_key)]
    rkeys = [_hashable_key(k) for k in _key_tuples(rmb.rows, rst.row_key)]
    rmap = {k: i for i, k in enumerate(rkeys)}

    def gt_cat(packed, miss, filtered):
        from ..genetics.call import calls_n_alt_alleles
        # 0 = no entry (variant absent or entry filtered), 1 = no call,
        # 2/3/4 = hom ref / het / hom var (reference qc.concordance)
        cat = np.where(miss, 1, 2 + np.clip(calls_n_alt_alleles(packed), 0, 2))
        return np.where(filtered, 0, cat)

    n_common = len(common)
    glob = np.zeros((5, 5), dtype=np.int64)
    per_sample = np.zeros((n_common, 5, 5), dtype=np.int64)
    pv_rows = []
    lp = np.asarray(lmb.entries['GT'].values)[:, li]
    lm = lmb.entries['GT'].missing_mask()[:, li]
    lf = lmb.entry_filtered_mask()[:, li]
    rp = np.asarray(rmb.entries['GT'].values)[:, ri]
    rm = rmb.entries['GT'].missing_mask()[:, ri]
    rf = rmb.entry_filtered_mask()[:, ri]
    lcat_all = gt_cat(lp, lm, lf)
    rcat_all = gt_cat(rp, rm, rf)
    locus_l = lmb.rows.columns['locus'].to_pylist()
    alleles_l = lmb.rows.columns['alleles'].to_pylist()
    eye5 = np.arange(5)
    for i, k in enumerate(lkeys):
        j = rmap.get(k)
        lcat = lcat_all[i]
        rcat = rcat_all[j] if j is not None else np.zeros(n_common, dtype=np.int64)
        mat = np.zeros((5, 5), dtype=np.int64)
        np.add.at(mat, (lcat, rcat), 1)
        per_sample += (eye5[None, :, None] == lcat[:, None, None]) * \
                      (eye5[None, None, :] == rcat[:, None, None])
        glob += mat
        pv_rows.append(Struct(locus=locus_l[i], alleles=alleles_l[i],
                              concordance=[[int(x) for x in row] for row in mat],
                              n_discordant=int(_n_discordant(mat))))
    # right-only variants: left category is 0 for every sample
    lset = set(lkeys)
    for j, k in enumerate(rkeys):
        if k not in lset:
            rcat = rcat_all[j]
            mat = np.zeros((5, 5), dtype=np.int64)
            np.add.at(mat, (np.zeros(n_common, dtype=np.int64), rcat), 1)
            per_sample += (eye5[None, :, None] == 0) * \
                          (eye5[None, None, :] == rcat[:, None, None])
            glob += mat

    conc_t = ht.tarray(ht.tarray(ht.tint64))
    cols_rows = [Struct(s=s, concordance=[[int(x) for x in row] for row in per_sample[i]],
                        n_discordant=int(_n_discordant(per_sample[i])))
                 for i, s in enumerate(common)]
    cs_t = ht.tstruct(s=ht.tstr, concordance=conc_t, n_discordant=ht.tint64)
    cols_table = Table(TableStage.from_batches(Batch({}, 1), ['s'], cs_t,
                                               [Batch.from_pylist(cs_t, cols_rows)]))
    pv_t = ht.tstruct(locus=lst.row_type['locus'], alleles=lst.row_type['alleles'],
                      concordance=conc_t, n_discordant=ht.tint64)
    rows_table = Table(TableStage.from_batches(Batch({}, 1), ['locus', 'alleles'], pv_t,
                                               [Batch.from_pylist(pv_t, pv_rows)]))
    return [[int(x) for x in row] for row in glob], cols_table, rows_table


def _n_discordant(mat: np.ndarray) -> int:
    # discordant = both called (cats 2..4) and different
    sub = mat[2:, 2:]
    return int(sub.sum() - np.trace(sub))


def _generic_interval_mask(batch, key_fields, ivs, keep):
    """Row mask for interval filtering over arbitrary (non-locus) keys:
    prefix comparisons like the reference's key-ordering interval semantics."""
    from ..io.native import _cmp_key_prefix
    cols = [C.to_object(batch.columns[k]).values for k in key_fields]
    n = batch.length
    m = np.zeros(n, dtype=bool)
    endpoints = []
    for iv in ivs:
        def ep(v):
            if isinstance(v, Struct):
                return (list(v.values()), len(list(v.values())))
            return ([v], 1)
        endpoints.append((ep(iv.start), iv.includes_start,
                          ep(iv.end), iv.includes_end))
    for r in range(n):
        kv = tuple(c[r] for c in cols)
        for (s_ep, inc_s, e_ep, inc_e) in endpoints:
            cs = _cmp_key_prefix(kv, s_ep)
            if not (cs > 0 or (cs == 0 and inc_s)):
                continue
            ce = _cmp_key_prefix(kv, e_ep)
            if ce < 0 or (ce == 0 and inc_e):
                m[r] = True
                break
    return m if keep else ~m
