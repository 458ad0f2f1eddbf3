"""GVCF/VDS merge primitives (reference `hail/vds/combiner/combine.py`):
transform a single-sample GVCF into a VDS, parse allele-specific INFO
fields, and union samples across VDSes."""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from ... import types as ht
from ...ir import columns as C
from ...ir.columns import Batch
from ...matrixtable import (MatrixBatch, MatrixStage, MatrixTable,
                            _concat_matrix_batches)
from ...utils.structs import Struct
from .. import VariantDataset


def make_ref_entry_struct(e, entry_to_keep, save_filters, row):
    """Reference-block entry: localize GT/PGT/AD/PL, add LEN from END
    (reference `combine.py:84` make_ref_entry_struct)."""
    from ...expr import functions as F
    handled = {}
    handled_names = {'AD', 'GT', 'PGT', 'PL'}
    if 'GT' in entry_to_keep:
        handled['LGT'] = e['GT']
    if 'PGT' in entry_to_keep:
        handled['LPGT'] = e['PGT']
    if 'AD' in entry_to_keep:
        handled['LAD'] = e['AD'][:1]
    if 'PL' in entry_to_keep:
        handled['LPL'] = e['PL'][:1]
    passthrough = {k: v for k, v in e.items()
                   if k in entry_to_keep and k not in handled_names}
    filters = {'gvcf_filters': row.filters} if save_filters else {}
    return (
        F.case()
        .when(F.coalesce(e.GT.is_hom_ref(), True),
              F.struct(**passthrough, **handled,
                       LEN=row.info.END - row.locus.position + 1, **filters))
        .or_error('found reference block with non reference-genotype at '
                  + F.str_(row.locus))
    )


def defined_entry_fields(mt: MatrixTable, sample: Optional[int] = None) -> Set[str]:
    """Entry fields with at least one defined value (reference
    `combine.py:143` defined_entry_fields)."""
    from ...expr import aggregators as agg
    from ...expr import functions as F
    if sample is not None:
        mt = mt.head(sample)
    used = mt.aggregate_entries(F.struct(**{
        k: agg.any(F.is_defined(v)) for k, v in mt.entry.items()}))
    return {k for k in mt.entry if used[k]}


def _parse_as_scalar(conv, out_t):
    # host parse: ''/'.' are missing (the reference guards with a lazy
    # if_else; our columnar evaluation is strict, so parse directly)
    def parse(string, has_non_ref):
        from ...expr import functions as F

        def f(sv, nr):
            if sv is None:
                return None
            parts = sv.split('|')
            if nr:
                parts = parts[:-1]
            return [None if (len(x) == 0 or x == '.') else conv(x) for x in parts]
        return F._apply('parse_as', ht.tarray(out_t),
                        F._obj_impl_lenient(ht.tarray(out_t),
                                            lambda sv, nr: f(sv, nr)),
                        F.to_expr(string), F.to_expr(has_non_ref))
    return parse


parse_allele_specific_ints = _parse_as_scalar(int, ht.tint32)
parse_allele_specific_doubles = _parse_as_scalar(float, ht.tfloat64)


def parse_allele_specific_sb_table(string, has_non_ref):
    from ...expr import functions as F
    t = ht.tarray(ht.tarray(ht.tint32))

    def f(sv, nr):
        if sv is None:
            return None
        parts = sv.split('|')
        if nr:
            parts = parts[:-1]
        return [[None if x in ('', '.') else int(x) for x in p.split(',')]
                for p in parts]
    return F._apply('parse_as_sb', t, F._obj_impl_lenient(t, f),
                    F.to_expr(string), F.to_expr(has_non_ref))


def parse_allele_specific_ranksum(string, has_non_ref):
    from ...expr import functions as F
    typ = ht.ttuple(ht.tfloat64, ht.tint32)

    def f(sv, nr):
        if sv is None:
            return None
        parts = sv.split('|')
        if nr:
            parts = parts[:-1]
        out = []
        for s_ in parts:
            if len(s_) == 0 or s_ == '.':
                out.append(None)
                continue
            ss = s_.split(',')
            if len(ss) != 2:   # malformed (e.g. 'NaN') -> missing
                out.append(None)
            else:
                try:
                    out.append((float(ss[0]), int(ss[1])))
                except ValueError:
                    out.append(None)
        return out
    return F._apply('parse_as_ranksum', ht.tarray(typ),
                    F._obj_impl_lenient(ht.tarray(typ), f),
                    F.to_expr(string), F.to_expr(has_non_ref))


_allele_specific_field_parsers = {
    'AS_QUALapprox': parse_allele_specific_ints,
    'AS_RAW_MQ': parse_allele_specific_doubles,
    'AS_RAW_MQRankSum': parse_allele_specific_ranksum,
    'AS_RAW_ReadPosRankSum': parse_allele_specific_ranksum,
    'AS_SB_TABLE': parse_allele_specific_sb_table,
    'AS_VarDP': parse_allele_specific_ints,
}


def parse_allele_specific_fields(info, has_non_ref):
    """Parse pipe-delimited AS_* INFO strings into typed arrays, trimming the
    <NON_REF> slot (reference `combine.py:405`)."""
    from ...expr import functions as F

    def parse_field(field):
        parse = _allele_specific_field_parsers.get(field)
        if parse:
            return parse(info[field], has_non_ref)
        return info[field]

    return F.struct(**{f: parse_field(f) for f in info})


def get_lgt(gt, n_alleles, has_non_ref, row):
    """Local genotype for a variant row: drop calls that touch <NON_REF>
    (reference combine.py:24 get_lgt)."""
    from ...expr import functions as F
    index = gt.unphase().unphased_diploid_gt_index()
    n_no_nonref = n_alleles - F.int32(has_non_ref)
    triangle_without_nonref = F.triangle(n_no_nonref)
    return (
        F.case()
        .when(gt.is_haploid(), F.or_missing(gt[0] < n_no_nonref, gt))
        .when(index < triangle_without_nonref, gt)
        .when(index < F.triangle(n_alleles), F.missing('call'))
        .or_error('invalid call ' + F.str_(gt) + ' at site ' + F.str_(row.locus))
    )


def make_var_entry_struct(e, info_to_keep, alleles_len, has_non_ref,
                          save_filters, row):
    """Variant-row entry with localized alleles (reference combine.py:37)."""
    from ...expr import functions as F
    from ...utils.java import FatalError
    handled = {}
    handled_names = {'LA', 'gvcf_info', 'LAD', 'AD', 'LGT', 'GT', 'LPL', 'PL',
                     'LPGT', 'PGT'}
    if 'GT' not in e:
        raise FatalError(
            "the Hail VDS combiner expects input GVCFs to have a 'GT' field in FORMAT.")
    handled['LA'] = F.range_(0, alleles_len - F.if_else(has_non_ref, 1, 0))
    handled['LGT'] = get_lgt(e.GT, alleles_len, has_non_ref, row)
    if 'AD' in e:
        handled['LAD'] = F.if_else(has_non_ref, e.AD[:-1], e.AD)
    if 'PGT' in e:
        handled['LPGT'] = e.PGT if e.PGT.dtype != ht.tcall else \
            get_lgt(e.PGT, alleles_len, has_non_ref, row)
    if 'PL' in e:
        handled['LPL'] = F.if_else(
            has_non_ref,
            F.if_else(alleles_len > 2,
                      F.if_else(e.GT.is_haploid(), e.PL[:-1], e.PL[:-alleles_len]),
                      F.missing(e.PL.dtype)),
            F.if_else(alleles_len > 1, e.PL, F.missing(e.PL.dtype)))
        handled['RGQ'] = F.if_else(
            has_non_ref,
            F.if_else(e.GT.is_haploid(), e.PL[alleles_len - 1],
                      e.PL[F.call(0, alleles_len - 1).unphased_diploid_gt_index()]),
            F.missing(e.PL.dtype.element_type))
    handled['gvcf_info'] = (
        F.case()
        .when(F.is_missing(row.info.END),
              parse_allele_specific_fields(row.info.select(*info_to_keep), has_non_ref))
        .or_missing())
    passthrough = {k: v for k, v in e.items() if k not in handled_names}
    filters = {'gvcf_filters': row.filters} if save_filters else {}
    return F.struct(**handled, **passthrough, **filters)


def make_variants_matrix_table(mt: MatrixTable, info_to_keep=None,
                               save_filters: bool = False) -> MatrixTable:
    """Variant rows of a GVCF with localized entries (reference
    combine.py:111 make_variants_matrix_table)."""
    from ...expr import functions as F
    info_t = mt._stage.row_type['info']
    if not info_to_keep:
        info_to_keep = [n for n in info_t.fields if n not in ('END', 'LEN', 'DP')]
    mt = mt.filter_rows(F.is_missing(mt.info.END))
    alleles_len = F.len_(mt.alleles)
    has_non_ref = mt.alleles[-1] == '<NON_REF>'
    new_entry = make_var_entry_struct(mt.entry, info_to_keep, alleles_len,
                                      has_non_ref, save_filters, mt.row)
    mt = mt.annotate_entries(__new_entry=new_entry)
    mt = mt.select_entries('__new_entry')
    mt = mt.transmute_entries(**{f: mt.__new_entry[f]
                                 for f in mt._stage.entry_type['__new_entry'].fields})
    mt = mt.key_rows_by('locus')
    row_sel = {'alleles': F.if_else(mt.alleles[-1] == '<NON_REF>',
                                    mt.alleles[:-1], mt.alleles)}
    if 'rsid' in mt._stage.row_type.fields:
        row_sel['rsid'] = mt.rsid
    mt = mt.select_rows(**row_sel)
    return mt.key_rows_by('locus', 'alleles')


def make_reference_matrix_table(mt: MatrixTable, entry_to_keep,
                                save_filters: bool = False) -> MatrixTable:
    """Reference-block rows of a GVCF (reference combine.py:217)."""
    from ...expr import functions as F
    mt = mt.filter_rows(F.is_defined(mt.info.END))
    new_entry = make_ref_entry_struct(mt.entry, set(entry_to_keep),
                                      save_filters, mt.row)
    mt = mt.annotate_entries(__new_entry=new_entry)
    mt = mt.select_entries('__new_entry')
    mt = mt.transmute_entries(**{f: mt.__new_entry[f]
                                 for f in mt._stage.entry_type['__new_entry'].fields})
    mt = mt.key_rows_by('locus')
    return mt.select_rows()


def transform_gvcf(mt: MatrixTable, reference_entry_fields_to_keep=(),
                   info_to_keep=None, save_filters: bool = False) -> VariantDataset:
    """Split an imported GVCF into (reference_data, variant_data)
    (reference `vds/combiner/combine.py:238` transform_gvcf)."""
    from ...expr import functions as F
    if not reference_entry_fields_to_keep:
        ref_sample = mt.filter_rows(F.is_defined(mt.info.END))
        reference_entry_fields_to_keep = \
            defined_entry_fields(ref_sample, 10_000) - {'GT', 'PGT', 'PL'}
    ref_mt = make_reference_matrix_table(mt, reference_entry_fields_to_keep,
                                         save_filters)
    var_mt = make_variants_matrix_table(mt, info_to_keep, save_filters)
    return VariantDataset(ref_mt, var_mt)


def combine_references(mts: List[MatrixTable]) -> MatrixTable:
    """Union samples across reference-data MatrixTables; the
    ref_block_max_length global survives only if every input carries it
    (as the max), mirroring reference `combine.py:324`."""
    from ...expr import functions as F
    fd = VariantDataset.ref_block_max_length_field
    have = [mt for mt in mts if fd in mt.globals]
    if have and len(have) < len(mts):
        mts = [mt.drop(fd) if fd in mt.globals else mt for mt in mts]
        have = []
    mts = [mt.drop('ref_allele') if 'ref_allele' in mt.row else mt for mt in mts]
    out = _outer_union_cols(mts)
    if have:
        max_len = max(mt.globals[fd].collect()[0] if hasattr(mt.globals[fd], 'collect')
                      else F.eval_expr(mt.globals[fd]) for mt in mts)
        out = out.annotate_globals(**{fd: max_len})
    return out


def _merge_alleles_py(allele_lists):
    """Host merge of per-dataset allele lists at one locus (reference
    combine.py:428 merge_alleles): the longest ref wins; SNP/indel/MNP/complex
    alts are right-extended by the ref suffix; globl = [ref] + set of alts."""
    from ...genetics.allele_type import AlleleType, allele_type
    ref = ''
    for al in allele_lists:
        if al and al[0] and len(al[0]) > len(ref):
            ref = al[0]
    local = []
    for al in allele_lists:
        if not al:
            local.append(None)
            continue
        r = al[0]
        out = [ref]
        for a in al[1:]:
            at = allele_type(r, a)
            if at in (AlleleType.SNP, AlleleType.INSERTION, AlleleType.DELETION,
                      AlleleType.MNP, AlleleType.COMPLEX):
                out.append(a + ref[len(r):])
            else:
                out.append(a)
        local.append(out)
    seen = []
    sset = set()
    for lal in local:
        for a in (lal or []):
            if a != ref and a not in sset:
                sset.add(a)
                seen.append(a)
    globl = [ref] + sorted(seen)
    return globl, local


def combine_variant_datasets(vdses: List[VariantDataset]) -> VariantDataset:
    """Union samples across VDSes, merging variant rows at the same locus
    with allele renumbering (reference combine.py:340
    combine_variant_datasets / combine_variant_rows)."""
    from ...utils.structs import Struct
    from ...matrixtable import MatrixStage, MatrixTable as _MT
    refs = [v.reference_data for v in vdses]
    new_ref = combine_references(refs)

    vds_list = [v.variant_data for v in vdses]
    stages = [vd._stage for vd in vds_list]
    ent_t = stages[0].entry_type
    row_t = stages[0].row_type
    has_rsid = 'rsid' in row_t.fields
    n_cols = [st.n_cols for st in stages]

    # gather each dataset's rows keyed by locus (host merge; the combiner
    # operates on branch-factor-bounded groups)
    per_vds = []
    for vd in vds_list:
        st = vd._stage
        rows_by_locus = {}
        order = []
        for ctx in st.contexts:
            mb = st.partition_fn(ctx)
            loci = mb.rows.columns['locus'].to_pylist()
            alleles = mb.rows.columns['alleles'].to_pylist()
            rsid = mb.rows.columns['rsid'].to_pylist() if has_rsid else [None] * len(loci)
            ents = {k: C.to_object(c).values for k, c in mb.entries.items()}
            filt = mb.entry_missing
            for i, loc in enumerate(loci):
                key = (loc.contig, loc.position)
                ent_rows = []
                for j in range(st.n_cols):
                    if filt is not None and filt[i, j]:
                        ent_rows.append(None)
                    else:
                        ent_rows.append(Struct(**{k: ents[k][i, j] for k in ents}))
                rows_by_locus.setdefault(key, []).append(
                    (loc, list(alleles[i]), rsid[i], ent_rows))
        per_vds.append(rows_by_locus)

    all_keys = sorted({k for d in per_vds for k in d},
                      key=lambda k: per_vds[[i for i, d in enumerate(per_vds) if k in d][0]][k][0][0].global_position())
    out_rows = []
    for key in all_keys:
        groups = [d.get(key) for d in per_vds]
        # a dataset may legitimately have several rows at one locus; reference
        # zip-joins them by (locus) with each row contributing alleles
        max_rows = max(len(g) if g else 0 for g in groups)
        for ridx in range(max_rows):
            datas = [g[ridx] if g and ridx < len(g) else None for g in groups]
            globl, local = _merge_alleles_py(
                [d[1] if d is not None else None for d in datas])
            index_of = {a: gi for gi, a in enumerate(globl)}
            loc = next(d[0] for d in datas if d is not None)
            rsid_v = next((d[2] for d in datas if d is not None and d[2] is not None), None)
            entries = []
            for i, d in enumerate(datas):
                if d is None:
                    entries.extend([None] * n_cols[i])
                    continue
                old_to_new = [index_of[a] for a in local[i]]
                for e in d[3]:
                    if e is None:
                        entries.append(None)
                    elif e.get('LA') is not None:
                        entries.append(Struct(**{
                            **dict(e),
                            'LA': [old_to_new[la] for la in e['LA']]}))
                    else:
                        entries.append(e)
            row = {'locus': loc, 'alleles': globl}
            if has_rsid:
                row['rsid'] = rsid_v
            out_rows.append((row, entries))

    total_cols = sum(n_cols)
    from ...ir.columns import Batch
    rows_b = Batch.from_pylist(row_t, [r for r, _ in out_rows])
    ent_cols = {}
    import numpy as np
    filt = np.zeros((len(out_rows), total_cols), dtype=bool)
    ent_vals = {k: np.empty((len(out_rows), total_cols), dtype=object)
                for k in ent_t.fields}
    for i, (_, ents) in enumerate(out_rows):
        for j, e in enumerate(ents):
            if e is None:
                filt[i, j] = True
            else:
                for k in ent_t.fields:
                    ent_vals[k][i, j] = e.get(k)
    for k, ft in ent_t.fields.items():
        flat = C.from_pylist(ft, list(ent_vals[k].ravel()))
        ent_cols[k] = flat.reshape((len(out_rows), total_cols))

    cols_b = _outer_union_cols(vds_list).cols()._stage if False else None
    # column table: concatenation of the inputs' columns
    col_batches = [st.cols for st in stages]
    col_rows = []
    for cb in col_batches:
        col_rows.extend(cb.to_pylist())
    cols = Batch.from_pylist(stages[0].col_type, [dict(r) for r in col_rows])

    from ...matrixtable import MatrixBatch
    mb = MatrixBatch(rows_b, ent_cols, filt if filt.any() else None)
    new_var = _MT(MatrixStage.from_batches(
        stages[0].globals, cols, ['locus', 'alleles'], stages[0].col_key,
        row_t, stages[0].col_type, ent_t, [mb]))
    return VariantDataset(new_ref, new_var)


def _hashable(kt):
    return tuple(tuple(v) if isinstance(v, list) else v for v in kt)


def _outer_union_cols(mts: List[MatrixTable]) -> MatrixTable:
    """Full outer union of columns: rows = union of row keys; entries missing
    where a dataset lacks the row."""
    if len(mts) == 1:
        return mts[0]
    from ...table import _key_tuples
    st0 = mts[0]._stage
    mbs = [_concat_matrix_batches(mt._stage.collect_batches(), mt._stage) for mt in mts]
    key_fields = st0.row_key
    all_keys = {}
    for mb, mt in zip(mbs, mts):
        for i, kt in enumerate(_key_tuples(mb.rows, key_fields)):
            kt = _hashable(kt)
            if kt not in all_keys:
                all_keys[kt] = (mb, i)
    # sort union keys by locus global position where applicable
    def sort_key(kt):
        out = []
        for v in kt:
            if hasattr(v, 'global_position'):
                out.append(v.global_position())
            elif isinstance(v, list):
                out.append(tuple(str(x) for x in v))
            else:
                out.append(v)
        return tuple(out)
    union_keys = sorted(all_keys.keys(), key=sort_key)
    key_index = {kt: i for i, kt in enumerate(union_keys)}
    R = len(union_keys)
    # row fields taken from the first dataset containing the key
    row_vals = []
    for kt in union_keys:
        mb, i = all_keys[kt]
        row_vals.append(Struct(**{f: mb.rows.columns[f].to_pylist()[i]
                                  for f in st0.row_type.fields}))
    rows = Batch.from_pylist(st0.row_type, row_vals)
    # entries: per dataset gather into union rows. Cells where a dataset
    # lacks the row are FILTERED (absent), not all-field-missing — the
    # reference's union_cols produces no entry there, and round-tripping a
    # combine must reproduce the input's sparsity exactly.
    routing = []
    for mb in mbs:
        kts = [_hashable(k) for k in _key_tuples(mb.rows, key_fields)]
        src_idx = np.full(R, 0, dtype=np.int64)
        present = np.zeros(R, dtype=bool)
        for i, kt in enumerate(kts):
            j = key_index[kt]
            src_idx[j] = i
            present[j] = True
        routing.append((src_idx, present))
    ent_cols = {}
    for field, ftype in st0.entry_type.fields.items():
        pieces = []
        for mb, mt, (src_idx, present) in zip(mbs, mts, routing):
            col = mb.entries[field].gather(src_idx, axis=0)
            miss_rows = ~present
            if miss_rows.any():
                col = col.with_missing(np.broadcast_to(miss_rows[:, None],
                                                       (R, mt._stage.n_cols)).copy())
            pieces.append(col)
        ent_cols[field] = C.concat_columns(pieces, axis=1)
    filt_pieces = []
    for mb, mt, (src_idx, present) in zip(mbs, mts, routing):
        nc = mt._stage.n_cols
        src_filt = mb.entry_filtered_mask()
        block = src_filt[src_idx]
        block = np.where(present[:, None], block, True)
        filt_pieces.append(block)
    entry_missing = np.concatenate(filt_pieces, axis=1)
    if not entry_missing.any():
        entry_missing = None
    cols = Batch.concat([mt._stage.cols for mt in mts])
    return MatrixTable(MatrixStage.from_batches(
        st0.globals, cols, st0.row_key, st0.col_key, st0.row_type,
        st0.col_type, st0.entry_type,
        [MatrixBatch(rows, ent_cols, entry_missing)]))
