"""VDS: VariantDataset (reference+variant MatrixTable pair).

Capability parity with reference `hail/python/hail/vds/` — the sparse
reference-block representation. Round-1: core container + to_dense_mt /
to_merged_sparse_mt / filters; the scalable combiner lands in a later round
(`combiner/variant_dataset_combiner.py:67`).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .. import types as ht
from ..expr import functions as F
from ..expr import aggregators as agg
from ..ir import columns as C
from ..matrixtable import MatrixTable, read_matrix_table


class VariantDataset:
    """A pair of MatrixTables: `reference_data` (reference blocks: END field)
    and `variant_data` (variant sites) — reference
    `vds/variant_dataset.py`."""

    ref_block_max_length_field = 'ref_block_max_length'

    def __init__(self, reference_data: MatrixTable, variant_data: MatrixTable):
        self.reference_data = reference_data
        self.variant_data = variant_data

    @staticmethod
    def from_merged_representation(mt: MatrixTable, *,
                                   ref_block_indicator_field: str = 'END',
                                   ref_block_fields=(),
                                   infer_ref_block_fields: bool = True,
                                   is_split: bool = False) -> 'VariantDataset':
        """Split a merged sparse MatrixTable into (reference_data,
        variant_data) — reference variant_dataset.py:133. Reference blocks are
        the entries carrying the indicator (END or LEN); the kept reference
        entry fields are inferred from missingness in the first rows."""
        import hail_tpu_torch as hl
        ind = ref_block_indicator_field
        ents = mt._stage.entry_type.fields
        if ind not in ('END', 'LEN'):
            raise ValueError(
                f'Invalid `ref_block_indicator_field` `{ind}` one of `LEN` or `END` expected')
        if ind not in ents:
            raise ValueError(
                'VariantDataset.from_merged_representation: expect field '
                f'`{ind}` in matrix table entry')
        if 'LA' not in ents and not is_split:
            raise ValueError(
                'VariantDataset.from_merged_representation: expect field `LA` '
                'in matrix table entry.\n  If this dataset is already split '
                'into biallelics, use `is_split=True` to permit a conversion '
                'with no `LA` field.')
        if 'GT' not in ents and 'LGT' not in ents:
            raise ValueError(
                'VariantDataset.from_merged_representation: expect field '
                '`LGT` or `GT` in matrix table entry')

        used = set(ref_block_fields)
        used.add(ind)
        if infer_ref_block_fields:
            mt_head = mt.head(n_rows=100)
            present = mt_head.aggregate_entries(hl.agg.filter(
                hl.is_defined(mt_head[ind]),
                hl.tuple([hl.agg.any(hl.is_defined(mt_head[x]))
                          for x in ents])))
            for k, any_present in zip(list(ents), present):
                if any_present:
                    used.add(k)
        gt_field = 'LGT' if 'LGT' in ents else 'GT'
        used.discard('LA')

        rmt = mt.filter_entries(
            hl.case()
            .when(hl.is_missing(mt[ind]), False)
            .when(hl.is_defined(mt[ind]) & mt[gt_field].is_hom_ref(), True)
            .or_error(hl.str(
                'cannot create VDS from merged representation - found '
                f'{ind} field with non-reference genotype at ')
                + hl.str(mt.locus)))
        rmt = rmt.select_entries(*(x for x in ents if x in used))
        rmt = rmt.filter_rows(hl.agg.count() > 0)
        rmt = rmt.key_rows_by('locus').select_rows().select_cols()
        rmt = VariantDataset._add_len(rmt) if ind == 'END' else \
            VariantDataset._add_end(rmt)
        if is_split:
            rmt = rmt.distinct_by_row()

        vmt = mt.filter_entries(hl.is_missing(mt[ind])).drop(ind)
        vmt = vmt.filter_rows(hl.agg.count() > 0)
        return VariantDataset(rmt, vmt)

    @staticmethod
    def _add_len(rd: MatrixTable) -> MatrixTable:
        """Populate LEN from END (no-op if present) — reference
        variant_dataset.py:436."""
        ents = rd._stage.entry_type.fields
        if 'LEN' in ents:
            return rd
        if 'END' in ents:
            return rd.annotate_entries(LEN=rd.END - rd.locus.position + 1)
        raise ValueError('Need `END` to compute `LEN` in reference data')

    @staticmethod
    def _add_end(rd: MatrixTable) -> MatrixTable:
        ents = rd._stage.entry_type.fields
        if 'END' in ents:
            return rd
        if 'LEN' in ents:
            return rd.annotate_entries(END=rd.LEN + rd.locus.position - 1)
        raise ValueError('Need `LEN` to compute `END` in reference data')

    def validate(self, *, check_data: bool = True) -> 'VariantDataset':
        """Eagerly checks representational properties of the VDS (reference
        variant_dataset.py:271 validate)."""
        import hail_tpu_torch as hl

        def err(msg):
            return ValueError(f'VDS.validate: {msg}')

        rd, vd = self.reference_data, self.variant_data
        rd_row_key = rd.row_key.dtype
        if (len(rd_row_key) != 1 or list(rd_row_key)[0] != 'locus'
                or not isinstance(rd_row_key[0], ht.tlocus)):
            raise err("expect reference data to have a single row key 'locus' "
                      f"of type locus, found {rd_row_key}")
        vd_row_key = vd.row_key.dtype
        if (len(vd_row_key) != 2 or list(vd_row_key) != ['locus', 'alleles']
                or not isinstance(vd_row_key[0], ht.tlocus)
                or vd_row_key[1] != ht.tarray(ht.tstr)):
            raise err("expect variant data to have a row key "
                      f"{{'locus': locus<rg>, alleles: array<str>}}, found {vd_row_key}")
        if len(rd.col_key.dtype) != 1 or rd.col_key.dtype[0] != ht.tstr:
            raise err('expect reference data to have a single col key of type string')
        if len(vd.col_key.dtype) != 1 or vd.col_key.dtype[0] != ht.tstr:
            raise err('expect variant data to have a single col key of type string')

        field = 'gvcf_filters'
        ref_has = field in rd._stage.entry_type.fields
        var_has = field in vd._stage.entry_type.fields
        if ref_has and not var_has:
            raise err(f"reference data has '{field}' when variant data does not")
        if var_has and not ref_has:
            raise err(f"variant data has '{field}' when reference data does not")

        ents = rd._stage.entry_type.fields
        if 'END' not in ents and 'LEN' not in ents:
            raise err("expect at least one of 'END' or 'LEN' in entry of reference data")
        if 'END' in ents and ents['END'] != ht.tint32:
            raise err("'END' field in entry of reference data must have type tint32")
        if 'LEN' in ents and ents['LEN'] != ht.tint32:
            raise err("'LEN' field in entry of reference data must have type tint32")

        if not check_data:
            return self

        ref_cols = rd.col_key.collect()
        var_cols = vd.col_key.collect()
        if len(ref_cols) != len(var_cols):
            raise err('mismatch in number of columns between reference and variant data')
        if ref_cols != var_cols:
            raise err('mismatch in column keys between reference and variant data')

        n_rd_rows = rd.count_rows()
        n_distinct = rd.distinct_by_row().count_rows()
        if n_distinct != n_rd_rows:
            raise err(f'reference data loci are not distinct: found {n_rd_rows} '
                      f'rows, but {n_distinct} distinct loci')

        rdl = VariantDataset._add_len(rd)
        agg_exprs = {
            'missing_len': hl.agg.filter(hl.is_missing(rdl.LEN),
                                         hl.agg.take(rdl.locus, 5)),
            'negative_len': hl.agg.filter(rdl.LEN < 0, hl.agg.take(rdl.locus, 5)),
        }
        fd = VariantDataset.ref_block_max_length_field
        if fd in rdl._stage.globals_type.fields:
            rbml = rdl._stage.globals.columns[fd].to_pylist()[0]
            agg_exprs['blocks_too_long'] = hl.agg.filter(
                rdl.LEN > rbml, hl.agg.take(rdl.locus, 5))
        res = rdl.aggregate_entries(hl.struct(**agg_exprs))
        if res['missing_len']:
            raise err('found records in reference data with missing LEN field\n  '
                      + '\n  '.join(str(x) for x in res['missing_len']))
        if res['negative_len']:
            raise err('found records in reference data with negative LEN\n  '
                      + '\n  '.join(str(x) for x in res['negative_len']))
        if res.get('blocks_too_long'):
            raise err('found records in reference data with blocks larger than '
                      '`ref_block_max_length`\n  '
                      + '\n  '.join(str(x) for x in res['blocks_too_long']))
        return self

    def _same(self, other: 'VariantDataset') -> bool:
        return (self.reference_data._same(other.reference_data)
                and self.variant_data._same(other.variant_data))

    def write(self, path: str, overwrite: bool = False) -> None:
        self.reference_data.write(os.path.join(path, 'reference_data'), overwrite)
        self.variant_data.write(os.path.join(path, 'variant_data'), overwrite)

    def checkpoint(self, path: str, overwrite: bool = False) -> 'VariantDataset':
        self.write(path, overwrite)
        return read_vds(path)

    def n_samples(self) -> int:
        return self.variant_data.count_cols()

    def union_rows(*vdses) -> 'VariantDataset':
        """Combine VDSes with the same samples and disjoint variants;
        ref_block_max_length survives as the max when every input has it
        (reference VariantDataset.union_rows)."""
        fd = VariantDataset.ref_block_max_length_field
        mts = [v.reference_data for v in vdses]
        have = [mt for mt in mts
                if fd in mt._stage.globals_type.fields]
        if len(have) == len(mts) and mts:
            maxes = [mt._stage.globals.columns[fd].to_pylist()[0] for mt in mts]
            new_ref = mts[0].union_rows(*mts[1:]) if len(mts) > 1 else mts[0]
            new_ref = new_ref.annotate_globals(**{fd: max(maxes)})
        else:
            mts = [mt.drop(fd) if fd in mt._stage.globals_type.fields else mt
                   for mt in mts]
            new_ref = mts[0].union_rows(*mts[1:]) if len(mts) > 1 else mts[0]
        new_var = vdses[0].variant_data.union_rows(
            *(v.variant_data for v in vdses[1:]))
        return VariantDataset(new_ref, new_var)


def read_vds(path: str, *, intervals=None, n_partitions=None,
             _assert_reference_type=None, _assert_variant_type=None,
             _warn_no_ref_block_max_length=True) -> VariantDataset:
    import json as _json
    rd = read_matrix_table(os.path.join(path, 'reference_data'))
    vd = read_matrix_table(os.path.join(path, 'variant_data'))
    fd = VariantDataset.ref_block_max_length_field
    # the reference stores extra reference globals in a side file
    # (variant_dataset.py read_vds, extra_ref_globals_file)
    for meta_name in ('metadata.json', 'extra_reference_globals.json'):
        meta_p = os.path.join(path, meta_name)
        if os.path.exists(meta_p) and fd not in rd._stage.globals_type.fields:
            with open(meta_p) as f:
                meta = _json.load(f)
            rd = rd.annotate_globals(**{k: (int(v) if k == fd else v)
                                        for k, v in meta.items()})
    # LEN/END are interconvertible representations; surface both on read
    rd = VariantDataset._add_len(rd)
    rd = VariantDataset._add_end(rd)
    if intervals is not None:
        return filter_intervals(VariantDataset(rd, vd), intervals)
    return VariantDataset(rd, vd)


def to_dense_mt(vds: VariantDataset) -> MatrixTable:
    """Densify: at each variant site, a sample with no variant call takes the
    covering reference block's shared fields and a (hom-)ref call; uncovered
    sites stay FILTERED (reference vds/methods.py to_dense_mt coalesce_join
    semantics, incl. haploid reference LGT/GT passthrough)."""
    from ..genetics.call import pack_call
    from ..genetics.call import Call as _Call
    from ..ir.columns import Batch
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable, _concat_matrix_batches
    ref_mt, var_mt = vds.reference_data, vds.variant_data
    rst, vst = ref_mt._stage, var_mt._stage
    if rst.n_cols == 0 or not rst.contexts:
        return var_mt
    rmb = _concat_matrix_batches(rst.collect_batches(), rst)
    vmb = _concat_matrix_batches(vst.collect_batches(), vst)
    n = vst.n_cols
    if rmb.n_rows == 0 or vmb.n_rows == 0:
        return var_mt

    ref_loc = rmb.rows.columns['locus']
    ref_gpos = np.asarray(ref_loc.global_position())
    ref_pos = np.asarray(ref_loc.position, dtype=np.int64)
    if 'LEN' in rmb.entries:
        # LEN is authoritative (the reference to_dense computes _END_GLOBAL
        # from LEN, vds/methods.py:43); a user-annotated LEN may make a
        # stale END
        len_col = rmb.entries['LEN']
        lens = np.asarray(len_col.values, dtype=np.int64)
        block_def = ~rmb.entry_filtered_mask() & ~len_col.missing_mask()
        end_gpos = ref_gpos[:, None] + (lens - 1)
    elif 'END' in rmb.entries:
        ends_col = rmb.entries['END']
        ends = np.asarray(ends_col.values, dtype=np.int64)
        block_def = ~rmb.entry_filtered_mask() & ~ends_col.missing_mask()
        end_gpos = ref_gpos[:, None] + (ends - ref_pos[:, None])
    elif '__END' in rmb.rows.columns:
        ends = np.asarray(rmb.rows.columns['__END'].values, dtype=np.int64)
        end_gpos = np.broadcast_to(
            (ref_gpos + (ends - ref_pos))[:, None], (rmb.n_rows, n)).copy()
        block_def = ~rmb.entry_filtered_mask()
    else:
        return var_mt

    var_gpos = np.asarray(vmb.rows.columns['locus'].global_position())
    var_filtered = vmb.entry_filtered_mask()
    ent_t = vst.entry_type
    call_field = 'GT' if 'GT' in ent_t.fields else (
        'LGT' if 'LGT' in ent_t.fields else None)
    ref_fields = set(rst.entry_type.fields)
    ref_call_field = 'GT' if 'GT' in ref_fields else (
        'LGT' if 'LGT' in ref_fields else None)
    shared = [f for f in ent_t.fields
              if f in ref_fields and f not in ('END', 'LEN')]
    ref_objs = {f: C.to_object(rmb.entries[f]) for f in shared}
    ref_call = rmb.entries.get(ref_call_field) if ref_call_field else None
    hom_ref = _Call([0, 0])

    out_vals = {f: np.array(C.to_object(vmb.entries[f]).values, copy=True)
                for f in ent_t.fields}
    out_filtered = np.array(var_filtered, copy=True)
    for s in range(n):
        defined = block_def[:, s]
        if not defined.any():
            continue
        starts = ref_gpos[defined]
        ends_s = end_gpos[defined, s]
        block_rows = np.where(defined)[0]
        idx = np.searchsorted(starts, var_gpos, side='right') - 1
        valid = idx >= 0
        idxc = np.clip(idx, 0, len(starts) - 1)
        covered = valid & (ends_s[idxc] >= var_gpos)
        need = var_filtered[:, s] & covered
        if not need.any():
            continue
        src_rows = block_rows[idxc[need]]
        rows_need = np.where(need)[0]
        for f in ent_t.fields:
            if f == call_field:
                if ref_call is not None:
                    cv = C.to_object(ref_call).values
                    vals = [cv[r0, s] if cv[r0, s] is not None else hom_ref
                            for r0 in src_rows]
                else:
                    vals = [hom_ref] * len(src_rows)
                out_vals[f][rows_need, s] = vals
            elif f in shared:
                out_vals[f][rows_need, s] = ref_objs[f].values[src_rows, s]
            # var-only fields stay missing
        out_filtered[rows_need, s] = False

    ents = {}
    for f, t2 in ent_t.fields.items():
        flat = [out_vals[f][i, j] for i in range(vmb.n_rows) for j in range(n)]
        ents[f] = C.from_pylist(t2, flat).reshape((vmb.n_rows, n))
    return MatrixTable(MatrixStage.from_batches(
        vst.globals, vst.cols, vst.row_key, vst.col_key, vst.row_type,
        vst.col_type, ent_t,
        [MatrixBatch(vmb.rows, ents,
                     out_filtered if out_filtered.any() else None)]))

def to_merged_sparse_mt(vds: VariantDataset, *, ref_allele_function=None) -> MatrixTable:
    """Merge reference and variant data into one sparse MatrixTable
    (reference vds/methods.py:108): outer join on locus; reference entries
    are widened into the union entry schema with LA=[0] and a hom-ref call;
    reference-only rows take alleles=[ref_allele]."""
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable as _MT, _concat_matrix_batches
    from ..utils.structs import Struct
    rst = vds.reference_data._stage
    vst = vds.variant_data._stage

    merged_schema = dict(rst.entry_type.fields)
    for e, t in vst.entry_type.fields.items():
        if e in merged_schema:
            if merged_schema[e] != t:
                raise TypeError(
                    f"cannot unify field {e!r}: {merged_schema[e]}, {t}")
        else:
            merged_schema[e] = t
    ref_fields = set(rst.entry_type.fields)
    var_fields = set(vst.entry_type.fields)

    rmb = _concat_matrix_batches(rst.collect_batches(), rst)
    vmb = _concat_matrix_batches(vst.collect_batches(), vst)
    n = vst.n_cols

    def batch_rows(mb, fields):
        objs = {k: C.to_object(mb.rows.columns[k]).values for k in fields}
        return objs

    ref_loci = rmb.rows.columns['locus'].to_pylist() if rmb.n_rows else []
    ref_gpos = [l.global_position() for l in ref_loci]
    ref_by_gpos = {g: i for i, g in enumerate(ref_gpos)}
    ref_allele_col = rmb.rows.columns.get('ref_allele')
    ref_alleles = ref_allele_col.to_pylist() if ref_allele_col is not None else None

    var_row_fields = [k for k in vst.row_type.fields]
    var_objs = {k: C.to_object(vmb.rows.columns[k]).values for k in var_row_fields} \
        if vmb.n_rows else {k: [] for k in var_row_fields}
    var_loci = vmb.rows.columns['locus'].to_pylist() if vmb.n_rows else []
    var_gpos = [l.global_position() for l in var_loci]

    ent_objs_r = {k: C.to_object(c).values for k, c in rmb.entries.items()}
    ent_objs_v = {k: C.to_object(c).values for k, c in vmb.entries.items()}
    filt_r = rmb.entry_missing
    filt_v = vmb.entry_missing
    rg = rst.row_type['locus'].reference_genome

    if ref_allele_function is None and ref_alleles is None:
        if not getattr(rg, '_has_sequence', lambda: False)():
            ref_allele_function = lambda locus, i: None if False else (_ for _ in ()).throw(
                ValueError(
                    "to_merged_sparse_mt: in order to construct a ref allele for "
                    "reference-only sites, either pass a function to fill in "
                    "reference alleles (e.g. ref_allele_function=lambda locus: "
                    "hl.missing('str')) or add a sequence file with "
                    "'hl.get_reference(RG_NAME).add_sequence(FASTA_PATH)'."))

    def ref_allele_at(ri):
        if ref_alleles is not None:
            return ref_alleles[ri]
        if ref_allele_function is not None:
            return ref_allele_function(ref_loci[ri], ri)
        return rg.sequence_context(ref_loci[ri])

    def rewrite_ref(ri, j):
        if filt_r is not None and filt_r[ri, j]:
            return None
        vals = {}
        miss_all = True
        for k, t in merged_schema.items():
            if k == 'LA':
                vals[k] = [0]
            elif k in ('LGT', 'GT') and k not in ref_fields:
                from ..genetics.call import Call as _Call
                vals[k] = _Call([0, 0])
            elif k in ref_fields:
                v = ent_objs_r[k][ri, j]
                vals[k] = v
                if v is not None:
                    miss_all = False
            else:
                vals[k] = None
        if miss_all and all(ent_objs_r[k][ri, j] is None for k in ref_fields):
            return None
        return Struct(**vals)

    def rewrite_var(vi, j):
        if filt_v is not None and filt_v[vi, j]:
            return None
        if all(ent_objs_v[k][vi, j] is None for k in var_fields):
            # a fully-missing variant entry defers to the reference entry
            return None
        return Struct(**{k: (ent_objs_v[k][vi, j] if k in var_fields else None)
                         for k in merged_schema})

    out_rows = []
    out_entries = []
    used_ref = set()
    for vi in range(len(var_loci)):
        g = var_gpos[vi]
        ri = ref_by_gpos.get(g)
        if ri is not None:
            used_ref.add(ri)
        row = {k: var_objs[k][vi] for k in var_row_fields}
        ents = []
        for j in range(n):
            e = rewrite_var(vi, j)
            if e is None and ri is not None:
                e = rewrite_ref(ri, j)
            ents.append(e)
        out_rows.append((g, row, ents))
    for ri in range(len(ref_loci)):
        if ri in used_ref:
            continue
        row = {k: None for k in var_row_fields}
        row['locus'] = ref_loci[ri]
        row['alleles'] = [ref_allele_at(ri)]
        ents = [rewrite_ref(ri, j) for j in range(n)]
        out_rows.append((ref_gpos[ri], row, ents))
    out_rows.sort(key=lambda t: (t[0], tuple(t[1].get('alleles') or [])))

    R = len(out_rows)
    ent_t = ht.tstruct(**merged_schema)
    row_t = vst.row_type
    rows_b = C.Batch({}, R) if False else None
    from ..ir.columns import Batch
    rows_b = Batch.from_pylist(row_t, [r for _, r, _ in out_rows])
    filt = np.zeros((R, n), dtype=bool)
    vals = {k: np.empty((R, n), dtype=object) for k in merged_schema}
    for i, (_, _, ents) in enumerate(out_rows):
        for j, e in enumerate(ents):
            if e is None:
                filt[i, j] = True
            else:
                for k in merged_schema:
                    vals[k][i, j] = e.get(k)
    ent_cols = {k: C.from_pylist(t, list(vals[k].ravel())).reshape((R, n))
                for k, t in merged_schema.items()}
    mb = MatrixBatch(rows_b, ent_cols, filt if filt.any() else None)
    return _MT(MatrixStage.from_batches(
        vst.globals, vst.cols, ['locus', 'alleles'], vst.col_key,
        row_t, vst.col_type, ent_t, [mb]))


def _same_entries(vds) -> bool:
    return str(vds.reference_data._stage.entry_type) == str(vds.variant_data._stage.entry_type)


def filter_samples(vds: VariantDataset, samples, *, keep: bool = True,
                   remove_dead_alleles: bool = False) -> VariantDataset:
    if hasattr(samples, 'collect'):
        sset = {r.s for r in samples.collect()}
    else:
        sset = set(samples)
    lit = F.literal(sorted(sset), ht.tarray(ht.tstr))
    def filt(mt):
        return mt.filter_cols(lit.contains(mt.s), keep=keep)
    rd = filt(vds.reference_data)
    # reference vds/methods.py:220: rows where no kept sample has an entry
    # are dropped from the reference data (this also defines the row set
    # merge_reference_blocks' consecutive-row chains see)
    rd = rd.filter_rows(agg.count() > 0)
    return VariantDataset(rd, filt(vds.variant_data))


def filter_variants(vds: VariantDataset, variants_table, *, keep: bool = True) -> VariantDataset:
    # keys hold the alleles list: frozen to hash; a locus key matches a prefix
    from ..table import _hashable_key
    tkey = list(variants_table._stage.key)
    keyset = {_hashable_key(tuple(r[k] for k in tkey))
              for r in variants_table.collect()}
    vd = vds.variant_data
    keys = [_hashable_key(tuple(r[k] for k in vd._stage.row_key[:len(tkey)]))
            for r in vd.rows().collect()]
    mask = np.asarray([k in keyset for k in keys])
    if not keep:
        mask = ~mask
    batches = vd._stage.collect_batches()
    off = 0
    out = []
    for mb in batches:
        out.append(mb.filter_rows(mask[off:off + mb.n_rows]))
        off += mb.n_rows
    from ..matrixtable import MatrixStage
    st = vd._stage
    return VariantDataset(vds.reference_data, MatrixTable(MatrixStage.from_batches(
        st.globals, st.cols, st.row_key, st.col_key, st.row_type, st.col_type,
        st.entry_type, out)))


def filter_intervals(vds: VariantDataset, intervals, *, split_reference_blocks: bool = False,
                     keep: bool = True) -> VariantDataset:
    from ..methods.misc import filter_intervals as fi
    from ..table import Table as _T
    from ..expr.expression import Expression as _E, eval_scalar as _ev
    if isinstance(intervals, _T):
        # interval-keyed table form (reference vds.filter_intervals)
        key0 = intervals._stage.key[0]
        intervals = [r[key0] for r in intervals.collect()]
    elif isinstance(intervals, _E):
        intervals = _ev(intervals)
    intervals = [_ev(iv) if isinstance(iv, _E) else iv for iv in intervals]
    rd = vds.reference_data
    if split_reference_blocks:
        rd = segment_reference_blocks_to_intervals(rd, intervals)
    return VariantDataset(fi(rd, intervals, keep),
                          fi(vds.variant_data, intervals, keep))


def segment_reference_blocks_to_intervals(rd, intervals):
    """Clip per-sample reference blocks to interval boundaries so an
    interval filter keeps exact coverage (reference filter_intervals
    split_reference_blocks path → segment_reference_blocks,
    vds/methods.py:658): each block is cut into one segment per interval it
    overlaps, END/LEN adjusted, with one output row per distinct segment
    start; cells with no covering segment are FILTERED."""
    from ..ir.columns import Batch, LocusColumn, StructColumn
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable, _concat_matrix_batches
    from ..utils.structs import Struct as _S
    st = rd._stage
    if 'END' not in st.entry_type.fields:
        return rd
    mb = _concat_matrix_batches(st.collect_batches(), st)
    if mb.n_rows == 0:
        return rd
    loc = mb.rows.columns['locus']
    rg = loc.typ.reference_genome
    pos = np.asarray(loc.position, dtype=np.int64)
    cidx = np.asarray(loc.contig_idx)
    ivs = []
    for iv in intervals:
        sp = iv.start.position + (0 if iv.includes_start else 1)
        ep = iv.end.position - (0 if iv.includes_end else 1)
        ivs.append((rg.contig_index(iv.start.contig), sp, ep))
    ent_t = st.entry_type
    ends_col = mb.entries['END']
    ends = np.asarray(ends_col.values, dtype=np.int64)
    present = ~mb.entry_filtered_mask() & ~ends_col.missing_mask()
    n_s = mb.n_cols
    g = StructColumn(ent_t, dict(mb.entries), None, (mb.n_rows, n_s))
    ents_py = g.to_pylist()
    row_src = {}               # (ci, seg_start) -> source row (row fields)
    cells = {}                 # ((ci, seg_start), sample) -> (row, seg_end)
    for r in range(mb.n_rows):
        for (ci, sp, ep) in ivs:
            if ci != cidx[r] or pos[r] > ep:
                continue
            for s_ in range(n_s):
                if not present[r, s_]:
                    continue
                seg_start = max(int(pos[r]), sp)
                seg_end = min(int(ends[r, s_]), ep)
                if seg_start > seg_end:
                    continue
                key = (int(ci), seg_start)
                row_src.setdefault(key, r)
                cells[(key, s_)] = (r, seg_end)
    keys = sorted(row_src)
    R = len(keys)
    key_idx = {k: i for i, k in enumerate(keys)}
    flat = [None] * (R * n_s)
    entry_missing = np.ones((R, n_s), dtype=bool)
    for (key, s_), (r, seg_end) in cells.items():
        e = dict(ents_py[r][s_] or {})
        e['END'] = seg_end
        if 'LEN' in ent_t.fields:
            e['LEN'] = seg_end - key[1] + 1
        i = key_idx[key]
        flat[i * n_s + s_] = _S(**e)
        entry_missing[i, s_] = False
    ec = C.from_pylist(ent_t, flat).reshape((R, n_s))
    ents = dict(ec.fields)
    src_rows = np.asarray([row_src[k] for k in keys], dtype=np.int64)
    cols = {}
    for k, c2 in mb.rows.columns.items():
        if k == 'locus':
            cols[k] = LocusColumn(c2.typ,
                                  np.asarray([k2[0] for k2 in keys]),
                                  np.asarray([k2[1] for k2 in keys],
                                             dtype=np.int32))
        else:
            cols[k] = c2.gather(src_rows)
    rows = Batch(cols, R)
    return MatrixTable(MatrixStage.from_batches(
        st.globals, st.cols, st.row_key, st.col_key, st.row_type,
        st.col_type, ent_t,
        [MatrixBatch(rows, ents, entry_missing if entry_missing.any() else None)]))


def sample_qc(vds: VariantDataset, *, gq_bins=(0, 20, 60), dp_bins=(0, 1, 10, 20, 30),
              dp_field=None):
    """Per-sample QC over a VDS (reference vds/sample_qc.py sample_qc):
    variant metrics from the (global) GT of the variant data plus
    base-weighted GQ/DP coverage from reference blocks, combined per sample.
    Columnar host computation (the dense-matrix QC fast path lives in
    methods/qc.py)."""
    from ..genetics.allele_type import AlleleType, allele_type
    from ..genetics.call import J_MASK, J_SHIFT, K_MASK, K_SHIFT, PLOIDY_MASK
    from ..ir.columns import Batch, PrimitiveColumn
    from ..table import Table, TableStage

    vst = vds.variant_data._stage
    rst = vds.reference_data._stage
    n = vst.n_cols

    if dp_field is not None:
        ref_dp = dp_field
    elif 'DP' in rst.entry_type.fields:
        ref_dp = 'DP'
    elif 'MIN_DP' in rst.entry_type.fields:
        ref_dp = 'MIN_DP'
    else:
        ref_dp = None

    nG, nD = len(gq_bins), len(dp_bins)
    gq_counts = np.zeros((n, nG), dtype=np.int64)
    dp_counts = np.zeros((n, nD), dtype=np.int64)
    n_het = np.zeros(n, dtype=np.int64)
    n_hom_var = np.zeros(n, dtype=np.int64)
    n_singleton = np.zeros(n, dtype=np.int64)
    n_singleton_ti = np.zeros(n, dtype=np.int64)
    n_singleton_tv = np.zeros(n, dtype=np.int64)
    atype_counts = np.zeros((n, len(AlleleType)), dtype=np.int64)

    def unpack(col):
        packed = np.asarray(col.values, dtype=np.int64)
        miss = col.missing_mask()
        ploidy = (packed & PLOIDY_MASK).astype(np.int32)
        j = ((packed >> J_SHIFT) & J_MASK).astype(np.int32)
        k = ((packed >> K_SHIFT) & K_MASK).astype(np.int32)
        return ploidy, j, k, miss

    for ci, ctx in enumerate(vst.contexts):
        mb = vst.partition_fn(ctx)
        if mb.n_rows == 0:
            continue
        ent = mb.entries
        lgt = ent.get('GT') or ent.get('LGT')
        if lgt is None:
            raise ValueError('vds.sample_qc: variant data needs GT or LGT')
        ploidy, j, k, miss = unpack(lgt)
        if 'GT' not in ent and 'LA' in ent:
            # local → global allele translation (reference lgt_to_gt)
            la = C.to_object(ent['LA']).values
            for r in range(mb.n_rows):
                for s in range(n):
                    if miss[r, s]:
                        continue
                    m = la[r, s]
                    if m is None:
                        continue
                    if ploidy[r, s] >= 1 and j[r, s] < len(m):
                        j[r, s] = m[j[r, s]]
                    if ploidy[r, s] == 2 and k[r, s] < len(m):
                        k[r, s] = m[k[r, s]]
        alleles = C.to_object(mb.rows.columns['alleles']).values
        atypes = [[int(allele_type(a[0], alt, include_ti_tv=True))
                   for alt in a[1:]] if a is not None else []
                  for a in alleles]
        ok = ~miss
        dip = ok & (ploidy == 2)
        het = dip & (j != k)
        hom_var = dip & (j == k) & (j > 0)
        n_het += het.sum(axis=0)
        n_hom_var += hom_var.sum(axis=0)
        # allele counts per row (incl. ref) for singleton detection
        R = mb.n_rows
        n_all = np.asarray([len(a) if a is not None else 0 for a in alleles])
        for r in range(R):
            if not ok[r].any():
                continue
            ac = np.zeros(max(n_all[r], 1), dtype=np.int64)
            for s in range(n):
                if not ok[r, s]:
                    continue
                if ploidy[r, s] >= 1:
                    ac[j[r, s]] += 1
                if ploidy[r, s] == 2:
                    ac[k[r, s]] += 1
            at = atypes[r]
            for s in range(n):
                if not ok[r, s]:
                    continue
                carried = ([j[r, s]] if ploidy[r, s] >= 1 else []) + \
                    ([k[r, s]] if ploidy[r, s] == 2 else [])
                for g in carried:
                    if g == 0 or g - 1 >= len(at):
                        continue
                    t = at[g - 1]
                    atype_counts[s, t] += 1
                    if ac[g] == 1:
                        n_singleton[s] += 1
                        if t == int(AlleleType.TRANSITION):
                            n_singleton_ti[s] += 1
                        elif t == int(AlleleType.TRANSVERSION):
                            n_singleton_tv[s] += 1
        if 'GQ' in ent:
            gq = np.asarray(ent['GQ'].values, dtype=np.float64)
            gq_ok = ~ent['GQ'].missing_mask()
            for bi, b in enumerate(gq_bins):
                gq_counts[:, bi] += (gq_ok & (gq >= b)).sum(axis=0)
        if ref_dp is not None and 'DP' in ent:
            dpv = np.asarray(ent['DP'].values, dtype=np.float64)
            dp_ok = ~ent['DP'].missing_mask()
            for bi, b in enumerate(dp_bins):
                dp_counts[:, bi] += (dp_ok & (dpv >= b)).sum(axis=0)

    end_field = '__END' if '__END' in rst.row_type.fields else 'END'
    end_in_rows = end_field in rst.row_type.fields
    for ci, ctx in enumerate(rst.contexts):
        mb = rst.partition_fn(ctx)
        if mb.n_rows == 0:
            continue
        pos = np.asarray(mb.rows.columns['locus'].position, dtype=np.int64)
        if end_in_rows:
            endc = mb.rows.columns[end_field]
            ends = np.asarray(endc.values, dtype=np.int64)
            lens = (1 + ends - pos)[:, None]
        else:
            endc = mb.entries['END']
            ends = np.asarray(endc.values, dtype=np.int64)
            lens = 1 + ends - pos[:, None]
        gq = mb.entries.get('GQ')
        if gq is not None:
            gqv = np.asarray(gq.values, dtype=np.float64)
            gq_ok = ~gq.missing_mask()
            for bi, b in enumerate(gq_bins):
                sel = gq_ok & (gqv >= b)
                gq_counts[:, bi] += np.where(sel, np.broadcast_to(lens, sel.shape), 0).sum(axis=0)
        if ref_dp is not None and ref_dp in mb.entries:
            dpc = mb.entries[ref_dp]
            dpv = np.asarray(dpc.values, dtype=np.float64)
            dp_ok = ~dpc.missing_mask()
            for bi, b in enumerate(dp_bins):
                sel = dp_ok & (dpv >= b)
                dp_counts[:, bi] += np.where(sel, np.broadcast_to(lens, sel.shape), 0).sum(axis=0)

    def ratio(a, b):
        return [float(x) / y if y else None for x, y in zip(a, b)]

    n_ti = atype_counts[:, int(AlleleType.TRANSITION)]
    n_tv = atype_counts[:, int(AlleleType.TRANSVERSION)]
    cols = dict(vst.cols.columns)
    b = {kf: cols[kf] for kf in vst.col_key}
    gq_t = ht.ttuple(*([ht.tint64] * nG))
    b['bases_over_gq_threshold'] = C.from_pylist(
        gq_t, [tuple(int(x) for x in row) for row in gq_counts])
    fields_after = {}
    if ref_dp is not None:
        dp_t = ht.ttuple(*([ht.tint64] * nD))
        fields_after['bases_over_dp_threshold'] = C.from_pylist(
            dp_t, [tuple(int(x) for x in row) for row in dp_counts])
    ints = {
        'n_het': n_het, 'n_hom_var': n_hom_var,
        'n_non_ref': n_het + n_hom_var,
        'n_singleton': n_singleton, 'n_singleton_ti': n_singleton_ti,
        'n_singleton_tv': n_singleton_tv,
        'n_snp': n_ti + n_tv,
        'n_insertion': atype_counts[:, int(AlleleType.INSERTION)],
        'n_deletion': atype_counts[:, int(AlleleType.DELETION)],
        'n_transition': n_ti, 'n_transversion': n_tv,
        'n_star': atype_counts[:, int(AlleleType.STAR)],
    }
    for k2, v in fields_after.items():
        b[k2] = v
    for k2, v in ints.items():
        b[k2] = PrimitiveColumn(ht.tint64, v.astype(np.int64))
    ratios = {
        'r_ti_tv': ratio(n_ti, n_tv),
        'r_ti_tv_singleton': ratio(n_singleton_ti, n_singleton_tv),
        'r_het_hom_var': ratio(n_het, n_hom_var),
        'r_insertion_deletion': ratio(ints['n_insertion'], ints['n_deletion']),
    }
    for k2, v in ratios.items():
        b[k2] = C.from_pylist(ht.tfloat64, v)
    batch = Batch(b, n)
    g = {'gq_bins': C.from_pylist(ht.ttuple(*([ht.tint32] * nG)), [tuple(gq_bins)])}
    if ref_dp is not None:
        g['dp_bins'] = C.from_pylist(ht.ttuple(*([ht.tint32] * nD)), [tuple(dp_bins)])
    return Table(TableStage.from_batches(Batch(g, 1), list(vst.col_key),
                                         batch.row_type, [batch]))


def split_multi(vds: VariantDataset, *, filter_changed_loci: bool = False) -> VariantDataset:
    """Split multiallelics in the variant data; the reference data's LGT
    (a hom-ref call) becomes GT unless GT already exists (reference
    vds/methods.py:630 split_multi)."""
    import hail_tpu_torch as hl
    from ..experimental import sparse_split_multi
    variant_data = sparse_split_multi(vds.variant_data,
                                      filter_changed_loci=filter_changed_loci)
    reference_data = vds.reference_data
    ents = reference_data._stage.entry_type.fields
    if 'LGT' in ents:
        if 'GT' in ents:
            reference_data = reference_data.drop('LGT')
        else:
            reference_data = reference_data.transmute_entries(
                GT=reference_data.LGT)
    return VariantDataset(reference_data=reference_data,
                          variant_data=variant_data)


def _ref_block_arrays(vds):
    """(starts_gpos (R,), per-entry ends_gpos (R,C), per-entry defined mask,
    dp column|None, concatenated matrix batch). Reference blocks carry END
    (or LEN) per ENTRY: each sample's block at a row has its own extent."""
    from ..matrixtable import _concat_matrix_batches
    rd = VariantDataset._add_end(vds.reference_data)
    rst = rd._stage
    rmb = _concat_matrix_batches(rst.collect_batches(), rst)
    loc = rmb.rows.columns['locus']
    gp = np.asarray(loc.global_position())
    pos = np.asarray(loc.position, dtype=np.int64)
    endc = rmb.entries['END']
    ends = np.asarray(endc.values, dtype=np.int64)
    defined = ~endc.missing_mask()
    if rmb.entry_missing is not None:
        defined = defined & ~rmb.entry_missing
    end_gp = gp[:, None] + (ends - pos[:, None])
    dp = rmb.entries.get('DP')
    if dp is None:
        dp = rmb.entries.get('MIN_DP')
    return gp, end_gp, defined, dp, rmb


def interval_coverage(vds: VariantDataset, intervals, gq_thresholds=(0, 10, 20),
                      dp_thresholds=(0, 1, 10, 20, 30), dp_field=None):
    """Base-coverage statistics by interval (reference vds/methods.py:761
    interval_coverage): rows keyed by `interval` with `interval_size`;
    entries hold base-weighted GQ/DP threshold counts and fractions computed
    from reference blocks clipped to each interval."""
    from ..ir.columns import Batch, PrimitiveColumn
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
    gp, end_gp, defined, dp_col, rmb = _ref_block_arrays(vds)
    rst = vds.reference_data._stage
    n = rst.n_cols
    dpv = np.asarray(dp_col.values, dtype=np.float64) if dp_col is not None else None
    dpm = dp_col.missing_mask() if dp_col is not None else None
    gq_col = rmb.entries.get('GQ')
    gqv = np.asarray(gq_col.values, dtype=np.float64) if gq_col is not None else None
    gqm = gq_col.missing_mask() if gq_col is not None else None

    ivs = []
    if hasattr(intervals, 'collect'):
        key0 = intervals._stage.key[0]
        ivs = [r[key0] for r in intervals.collect()]
    else:
        ivs = list(intervals)
    m = len(ivs)
    has_dp = dpv is not None

    bases_gq = np.zeros((m, n, len(gq_thresholds)), dtype=np.int64)
    bases_dp = np.zeros((m, n, len(dp_thresholds)), dtype=np.int64)
    sum_dp = np.zeros((m, n), dtype=np.int64)
    sizes = np.zeros(m, dtype=np.int64)
    for ii, iv in enumerate(ivs):
        s_gp = iv.start.global_position() + (0 if iv.includes_start else 1)
        e_gp = iv.end.global_position() - (0 if iv.includes_end else 1)
        sizes[ii] = e_gp - s_gp + 1
        # per-entry overlap of each sample block with the interval, in bases
        ov = np.maximum(
            0, np.minimum(end_gp, e_gp) - np.maximum(gp[:, None], s_gp) + 1)
        ov = np.where(defined, ov, 0)
        if not ov.any():
            continue
        for ti, t in enumerate(gq_thresholds):
            okt = (gqv >= t) & ~(gqm if gqm is not None else False) \
                if gqv is not None else np.zeros_like(defined)
            bases_gq[ii, :, ti] = np.where(okt, ov, 0).sum(axis=0)
        if has_dp:
            dvals = np.where(dpm, 0, dpv) if dpm is not None else dpv
            sum_dp[ii] = (ov * np.where(dpm, 0, dpv) if dpm is not None
                          else ov * dpv).sum(axis=0).astype(np.int64)
            for ti, t in enumerate(dp_thresholds):
                okt = (dvals >= t) & ~(dpm if dpm is not None else False)
                bases_dp[ii, :, ti] = np.where(okt, ov, 0).sum(axis=0)

    loc_t = rst.row_type['locus']
    rows_b = Batch({
        'interval': C.from_pylist(ht.tinterval(loc_t), ivs),
        'interval_size': PrimitiveColumn(ht.tint32, sizes.astype(np.int32)),
    }, m)
    gq_tt = ht.ttuple(*[ht.tint64] * len(gq_thresholds))
    dp_tt = ht.ttuple(*[ht.tint64] * len(dp_thresholds))
    gq_ft = ht.ttuple(*[ht.tfloat64] * len(gq_thresholds))
    dp_ft = ht.ttuple(*[ht.tfloat64] * len(dp_thresholds))
    ents = {}
    ents['bases_over_gq_threshold'] = C.from_pylist(
        gq_tt, [tuple(int(x) for x in bases_gq[i, j])
                for i in range(m) for j in range(n)]).reshape((m, n))
    if has_dp:
        ents['sum_dp'] = PrimitiveColumn(ht.tint64, sum_dp)
        ents['bases_over_dp_threshold'] = C.from_pylist(
            dp_tt, [tuple(int(x) for x in bases_dp[i, j])
                    for i in range(m) for j in range(n)]).reshape((m, n))
    with np.errstate(all='ignore'):
        ents['fraction_over_gq_threshold'] = C.from_pylist(
            gq_ft, [tuple(float(x) / sizes[i] for x in bases_gq[i, j])
                    for i in range(m) for j in range(n)]).reshape((m, n))
        if has_dp:
            ents['fraction_over_dp_threshold'] = C.from_pylist(
                dp_ft, [tuple(float(x) / sizes[i] for x in bases_dp[i, j])
                        for i in range(m) for j in range(n)]).reshape((m, n))
            ents['mean_dp'] = PrimitiveColumn(
                ht.tfloat64, sum_dp / np.maximum(sizes[:, None], 1))
    entry_t = ht.tstruct(**{k: c.typ if hasattr(c, 'typ') else c.row_type
                            for k, c in ents.items()})
    from ..expr.expression import to_expr as _te
    gq_glob = Batch({'gq_thresholds': C.from_pylist(
        ht.ttuple(*[ht.tint32] * len(gq_thresholds)),
        [tuple(gq_thresholds)])}, 1)
    return MatrixTable(MatrixStage.from_batches(
        gq_glob, rst.cols, ['interval'], rst.col_key,
        ht.tstruct(interval=ht.tinterval(loc_t), interval_size=ht.tint32),
        rst.col_type, entry_t, [MatrixBatch(rows_b, ents)]))



def impute_sex_chr_ploidy_from_interval_coverage(mt, normalization_contig: str):
    """Sex-chromosome ploidy from a precomputed interval-coverage MatrixTable
    (reference vds/methods.py:262): per-sample contig mean depth =
    sum(sum_dp)/sum(interval_size), ploidy = 2 * chr_dp / autosomal_dp."""
    import hail_tpu_torch as hl
    rg = mt._stage.row_type['interval'].point_type.reference_genome
    if len(rg.x_contigs) != 1:
        raise NotImplementedError(
            f"reference genome {rg.name!r} has multiple X contigs, this is not "
            f"supported in 'impute_sex_chr_ploidy_from_interval_coverage'")
    chr_x = rg.x_contigs[0]
    if len(rg.y_contigs) != 1:
        raise NotImplementedError(
            f"reference genome {rg.name!r} has multiple Y contigs, this is not "
            f"supported in 'impute_sex_chr_ploidy_from_interval_coverage'")
    chr_y = rg.y_contigs[0]

    mt = mt.annotate_rows(contig=mt.interval.start.contig)
    mt = mt.annotate_cols(__mean_dp=hl.agg.group_by(
        mt.contig, hl.agg.sum(mt.sum_dp) / hl.agg.sum(mt.interval_size)))
    mean_dp_dict = mt.__mean_dp
    auto_dp = mean_dp_dict.get(normalization_contig, 0.0)
    x_dp = mean_dp_dict.get(chr_x, 0.0)
    y_dp = mean_dp_dict.get(chr_y, 0.0)
    per_sample = mt.transmute_cols(
        autosomal_mean_dp=auto_dp,
        x_mean_dp=x_dp,
        x_ploidy=2 * x_dp / auto_dp,
        y_mean_dp=y_dp,
        y_ploidy=2 * y_dp / auto_dp,
    )
    return per_sample.cols()


def impute_sex_chromosome_ploidy(vds, calling_intervals, normalization_contig: str,
                                 use_variant_dataset: bool = False):
    """X/Y ploidy estimates from interval depth vs an autosomal normalization
    contig (reference vds/methods.py:337 impute_sex_chromosome_ploidy):
    calling intervals are segmented at PAR boundaries and PAR-overlapping
    segments dropped; coverage comes from reference blocks (or variant DP
    with use_variant_dataset)."""
    import hail_tpu_torch as hl
    from ..utils.structs import Interval, Struct
    rst = vds.reference_data._stage
    rg = rst.row_type['locus'].reference_genome

    if calling_intervals is None:
        # convenience: whole contigs carrying reference data
        from ..genetics.locus import Locus as _Locus
        seen = []
        for ctx in rst.contexts:
            lc = rst.partition_fn(ctx).rows.columns['locus']
            for ci in np.unique(np.asarray(lc.contig_idx)):
                c = rg.contigs[int(ci)]
                if c not in seen:
                    seen.append(c)
        ivs = [Interval(_Locus(c, 1, rg), _Locus(c, rg.contig_length(c), rg),
                        True, False) for c in seen]
    elif hasattr(calling_intervals, 'collect'):
        k0 = calling_intervals._stage.key[0]
        ivs = [r[k0] for r in calling_intervals.collect()]
    else:
        ivs = [F.eval_expr(to_expr(iv)) if not isinstance(iv, Interval) else iv
               for iv in calling_intervals]

    def gpos(p):
        return p.global_position()

    # segment at PAR boundaries, then drop PAR-overlapping segments
    par = list(rg.par)
    boundaries = []
    for piv in par:
        boundaries.extend([piv.start, piv.end])
    segments = []
    for iv in ivs:
        if iv.start.contig != iv.end.contig:
            raise ValueError(
                "'impute_sex_chromosome_ploidy' does not support calling "
                "intervals that span chromosome boundaries")
        cuts = sorted((b for b in boundaries
                       if b.contig == iv.start.contig
                       and gpos(iv.start) < gpos(b) < gpos(iv.end)),
                      key=gpos)
        bounds = [iv.start] + cuts + [iv.end]
        for j in range(len(bounds) - 1):
            seg = Interval(bounds[j], bounds[j + 1],
                           iv.includes_start if j == 0 else True,
                           iv.includes_end if j == len(bounds) - 2 else False)
            overlaps_par = any(
                piv.start.contig == seg.start.contig
                and gpos(seg.start) < gpos(piv.end)
                and gpos(piv.start) < gpos(seg.end)
                for piv in par)
            if not overlaps_par:
                segments.append(seg)

    if use_variant_dataset:
        mt = vds.variant_data
        loc_t = rst.row_type['locus']
        iv_t = ht.tinterval(loc_t)
        civ = hl.Table.parallelize(
            [Struct(interval=s, interval_dup=s) for s in segments],
            schema=ht.tstruct(interval=iv_t, interval_dup=iv_t), key='interval')
        mt = mt.annotate_rows(interval=civ[mt.locus].interval_dup)
        mt = mt.filter_rows(hl.is_defined(mt.interval))
        coverage = mt.select_entries(sum_dp=mt.DP,
                                     interval_size=hl.is_defined(mt.DP))
    else:
        coverage = interval_coverage(vds, segments, gq_thresholds=())
    return impute_sex_chr_ploidy_from_interval_coverage(coverage, normalization_contig)

def truncate_reference_blocks(ds, *, max_ref_block_base_pairs=None,
                              ref_block_winsorize_fraction=None):
    """Split reference blocks longer than a maximum and record
    `ref_block_max_length` on the reference data's globals (reference
    vds/methods.py truncate_reference_blocks). Handles per-ENTRY END (each
    sample's block split independently)."""
    from ..ir.columns import Batch, LocusColumn, PrimitiveColumn
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable, _concat_matrix_batches
    is_vds = isinstance(ds, VariantDataset)
    rd = ds.reference_data if is_vds else ds
    if int(ref_block_winsorize_fraction is None) + int(max_ref_block_base_pairs is None) != 1:
        raise ValueError(
            'truncate_reference_blocks: require exactly one of '
            '"max_ref_block_base_pairs", "ref_block_winsorize_fraction"')
    rd = VariantDataset._add_end(rd)
    st = rd._stage
    mb = _concat_matrix_batches(st.collect_batches(), st)
    loc = mb.rows.columns['locus']
    pos = np.asarray(loc.position, dtype=np.int64)
    cidx = np.asarray(loc.contig_idx)
    end_entry = 'END' in st.entry_type.fields
    if end_entry:
        endc = mb.entries['END']
        ends = np.asarray(endc.values, dtype=np.int64)
        emiss = endc.missing_mask()
    else:
        endf = mb.rows.columns.get('__END')
        if endf is None:
            return ds
        ends = np.broadcast_to(np.asarray(endf.values, dtype=np.int64)[:, None],
                               (mb.n_rows, mb.n_cols))
        emiss = np.zeros((mb.n_rows, mb.n_cols), dtype=bool)
    lens = ends - pos[:, None] + 1
    if ref_block_winsorize_fraction is not None:
        assert 0 < ref_block_winsorize_fraction < 1
        defined = lens[~emiss]
        max_ref_block_base_pairs = int(np.quantile(
            defined, 1.0 - ref_block_winsorize_fraction)) if defined.size else 1
    maxlen = int(max_ref_block_base_pairs)
    assert maxlen > 0

    # per (row, sample): pieces starting at pos + k*maxlen. New row set =
    # union of piece start positions per source row.
    n_s = mb.n_cols
    piece_map = {}
    for r in range(mb.n_rows):
        for s in range(n_s):
            if emiss[r, s]:
                continue
            start = pos[r]
            while start <= ends[r, s]:
                piece_end = min(ends[r, s], start + maxlen - 1)
                piece_map.setdefault((int(cidx[r]), int(start)), []).append(
                    (r, s, int(piece_end)))
                start = piece_end + 1
    keys = sorted(piece_map)
    R2 = len(keys)
    new_cidx = np.asarray([k[0] for k in keys], dtype=np.int32)
    new_pos = np.asarray([k[1] for k in keys], dtype=np.int32)
    # source row for row-level fields: first contributing piece
    src_row = np.asarray([piece_map[k][0][0] for k in keys], dtype=np.int64)
    cols = {}
    for k2, c2 in mb.rows.columns.items():
        if k2 == 'locus':
            cols[k2] = LocusColumn(c2.typ, new_cidx, new_pos)
        elif k2 == '__END':
            continue
        else:
            cols[k2] = c2.gather(src_row)
    ents = {}
    ent_objs = {k2: C.to_object(c2) for k2, c2 in mb.entries.items()}
    for k2, c2 in mb.entries.items():
        t2 = c2.typ if hasattr(c2, 'typ') else st.entry_type[k2]
        vals = np.empty((R2, n_s), dtype=object)
        for ri, key in enumerate(keys):
            for (r, s, piece_end) in piece_map[key]:
                if k2 == 'END':
                    vals[ri, s] = piece_end
                elif k2 == 'LEN':
                    # keep LEN consistent with the piece's new extent
                    vals[ri, s] = piece_end - key[1] + 1
                else:
                    v2 = ent_objs[k2].values[r, s]
                    vals[ri, s] = v2
        flat = [vals[i, j] for i in range(R2) for j in range(n_s)]
        ents[k2] = C.from_pylist(st.entry_type[k2], flat).reshape((R2, n_s))
    if not end_entry:
        # internal row-__END layout: every sample shares the row end, so the
        # split is row-level
        cols['__END'] = PrimitiveColumn(ht.tint32, np.asarray(
            [max((pe for (_, _, pe) in piece_map[k]), default=0) for k in keys],
            dtype=np.int32))
    g = dict(st.globals.columns)
    g[VariantDataset.ref_block_max_length_field] = C.from_pylist(ht.tint32, [maxlen])
    rows = Batch(cols, R2)
    new_row_t = rows.row_type
    new_ref = MatrixTable(MatrixStage.from_batches(
        Batch(g, 1), st.cols, st.row_key, st.col_key, new_row_t,
        st.col_type, st.entry_type, [MatrixBatch(rows, ents)]))
    if is_vds:
        return VariantDataset(new_ref, ds.variant_data)
    return new_ref


def new_combiner(**kwargs):
    from .combiner import new_combiner as nc
    return nc(**kwargs)


def load_combiner(path: str):
    from .combiner import load_combiner as lc
    return lc(path)


# ---------------------------------------------------------------------------
# round-2 parity batch (reference vds/methods.py, impex.py, functions.py)
# ---------------------------------------------------------------------------

from .functions import lgt_to_gt, local_to_global  # noqa: E402
from . import combiner  # noqa: E402
from ..expr.expression import to_expr  # noqa: E402
from ..utils.structs import Struct  # noqa: E402


def write_variant_datasets(vdss, paths, *, overwrite: bool = False,
                           stage_locally: bool = False, codec_spec=None):
    """Write many VDSes (reference vds/methods.py:12)."""
    for v, p in zip(vdss, paths):
        v.write(p, overwrite=overwrite)


def read_dense_mt(path: str) -> MatrixTable:
    """Read a VDS path directly as a dense MatrixTable (reference
    vds/impex.py:43)."""
    return to_dense_mt(read_vds(path))


def import_vcf(path, *, is_split=False, ref_block_fields=(),
               infer_ref_block_fields=True, header_file=None,
               call_fields=(), **kwargs) -> 'VariantDataset':
    """Import an SVCR-VCF as a VariantDataset (reference vds/impex.py:349):
    LEN is the reference-block indicator; LAA converts back to LA; entries
    filtered to those with a defined GT/LGT; ##ref_block_max_length parsed
    from the header."""
    import hail_tpu_torch as hl
    from ..methods.impex import import_vcf as _ivcf, _open
    if isinstance(call_fields, str):
        call_fields = tuple({'LGT', call_fields})
    else:
        call_fields = tuple({'LGT', *call_fields})
    hdr = header_file or (path if isinstance(path, str) else path[0])
    ref_block_max_length = None
    with _open(hdr) as f:
        for _line in f:
            line = _line.strip()
            if not line:
                continue
            if not line.startswith('##'):
                break
            if line.startswith('##ref_block_max_length='):
                try:
                    ref_block_max_length = int(line.split('=', 1)[1])
                    if ref_block_max_length <= 0:
                        raise ValueError
                except ValueError:
                    ref_block_max_length = None
    vcf = _ivcf(path, call_fields=call_fields, **kwargs)
    ents = vcf._stage.entry_type.fields
    if 'LEN' not in ents or ents['LEN'] != ht.tint32:
        raise ValueError(
            'Invalid SVCR-VCF: expected `LEN` of type `int32` in FORMAT fields')
    gt_fields = [f for f in ('GT', 'LGT') if f in ents and ents[f] == ht.tcall]
    if not gt_fields:
        raise ValueError(
            'Invalid SVCR-VCF: expected at least one field of type `call` '
            'named `GT` or `LGT`')
    if not is_split:
        has_la = 'LA' in ents
        has_laa = 'LAA' in ents
        if not (has_la or has_laa):
            raise ValueError(
                'Invalid SVCR-VCF: expected one of `LA` or `LAA` in FORMAT fields')
        if has_laa:
            if has_la:
                vcf = vcf.drop('LAA')
            else:
                vcf = vcf.transmute_entries(LA=hl.array([0]).extend(vcf.LAA))
    import functools
    vcf = vcf.filter_entries(functools.reduce(
        lambda p, q: p | q, (hl.is_defined(vcf[g]) for g in gt_fields)))
    vds = VariantDataset.from_merged_representation(
        vcf, ref_block_indicator_field='LEN', ref_block_fields=ref_block_fields,
        infer_ref_block_fields=infer_ref_block_fields, is_split=is_split)
    if ref_block_max_length is not None:
        vds.reference_data = vds.reference_data.annotate_globals(
            **{VariantDataset.ref_block_max_length_field: ref_block_max_length})
    return vds


def export_vcf(vds: 'VariantDataset', path: str, *, append_to_header=None,
               parallel=None, metadata=None, tabix: bool = False) -> None:
    """Export a VariantDataset as an SVCR-VCF (reference vds/impex.py:210):
    LGT/LPGT become GT/PGT via lgt_to_gt, LA becomes LAA, gvcf_info is
    dropped, END is dropped in favor of LEN, and ref_block_max_length is
    recorded as a header line."""
    import tempfile
    import hail_tpu_torch as hl
    from ..methods.impex import export_vcf as _evcf
    from .functions import lgt_to_gt
    ref, var = vds.reference_data, vds.variant_data
    if 'END' in ref._stage.entry_type.fields:
        ref = ref.drop('END')
    vents = var._stage.entry_type.fields
    if 'gvcf_info' in vents and isinstance(vents['gvcf_info'], ht.tstruct):
        var = var.drop('gvcf_info')
    vents = var._stage.entry_type.fields
    if 'LGT' in vents:
        if 'GT' not in vents:
            var = var.annotate_entries(GT=lgt_to_gt(var.LGT, var.LA))
        var = var.drop('LGT')
    vents = var._stage.entry_type.fields
    if 'LPGT' in vents:
        if 'PGT' not in vents:
            var = var.annotate_entries(PGT=lgt_to_gt(var.LPGT, var.LA))
        var = var.drop('LPGT')
    if 'LA' in var._stage.entry_type.fields:
        var = var.transmute_entries(LAA=var.LA[1:])

    extra_header = (
        '##SVCR="This is a VCF that implements hail\'s Scalable Variant Call '
        'Representation. See https://doi.org/10.1101/2024.01.09.574205 for '
        'more information."\n')
    fd = VariantDataset.ref_block_max_length_field
    if fd in ref._stage.globals_type.fields:
        rbml = ref._stage.globals.columns[fd].to_pylist()[0]
        extra_header += f'##ref_block_max_length={rbml}\n'
    if append_to_header:
        with open(append_to_header) as f:
            extra_header += f.read()
    hdr_path = tempfile.mktemp(suffix='.txt')
    with open(hdr_path, 'w') as f:
        f.write(extra_header)
    vcf = to_merged_sparse_mt(VariantDataset(reference_data=ref, variant_data=var))
    _evcf(vcf, path, append_to_header=hdr_path, metadata=metadata, tabix=tabix)


def filter_chromosomes(vds: 'VariantDataset', *, keep=None, remove=None,
                       keep_autosomes: bool = False) -> 'VariantDataset':
    """Filter VDS contigs by keep/remove list or autosomes-only (reference
    vds/methods.py:527)."""
    n_args = (keep is not None) + (remove is not None) + bool(keep_autosomes)
    if n_args != 1:
        raise ValueError("filter_chromosomes: pass exactly one of 'keep', "
                         "'remove', or 'keep_autosomes'")
    rd = vds.reference_data
    rg = rd.rows().collect()[0].locus.reference_genome if rd.count_rows() else None
    if rg is None:
        rg = vds.variant_data.rows().collect()[0].locus.reference_genome

    if keep is not None:
        to_keep = keep if isinstance(keep, list) else [keep]
    elif remove is not None:
        rem = set(remove if isinstance(remove, list) else [remove])
        to_keep = [c for c in rg.contigs if c not in rem]
    else:
        special = set(list(rg.x_contigs) + list(rg.y_contigs) + list(rg.mt_contigs))
        to_keep = [c for c in rg.contigs if c not in special]
    keep_set = F.literal(set(to_keep))

    def filt(mt):
        return mt.filter_rows(keep_set.contains(mt.locus.contig))
    return VariantDataset(filt(vds.reference_data), filt(vds.variant_data))


def merge_reference_blocks(ds, equivalence_function, merge_functions=None):
    """Merge adjacent per-sample reference blocks when the user equivalence
    holds (reference vds/methods.py:996). Host-tier sequential pass.

    Semantics matched to the reference: the folded block is placed at the
    chain-start row (keeping the first block's un-merged fields), absorbed
    rows get missing entries, and ``ref_block_max_length`` is dropped since
    merging can lengthen blocks. Crucially, the reference's scan fold
    (vds/methods.py:1075-1092 ``keep_last``) RESETS a sample's chain at any
    row where that sample's entry is missing — two blocks merge only when
    they sit in consecutive table rows, are positionally adjacent
    (END + 1 == start), and satisfy the equivalence; a block in a later row
    never folds across an intervening row. This row-consecutiveness is what
    keeps ``to_dense_mt`` fills stable under field-changing
    ``merge_functions`` in the reference's own test.
    """
    from ..utils.structs import Struct as _S
    is_vds = isinstance(ds, VariantDataset)
    rd = ds.reference_data if is_vds else ds
    st = rd._stage
    ent_t = st.entry_type
    samples = st.cols.to_pylist()
    n_s = len(samples)

    def equivalent(b1, b2):
        r = equivalence_function(F.literal(b1, ent_t), F.literal(b2, ent_t))
        return bool(F.eval_expr(to_expr(r)))

    def do_merge(b1, b2):
        new = dict(b2)
        out = dict(b1)
        out['END'] = new['END']
        if merge_functions:
            for k, f in merge_functions.items():
                if isinstance(f, str):
                    a2, c2 = b1.get(k), b2.get(k)
                    fl = f.lower()
                    if a2 is None or c2 is None:
                        out[k] = a2 if c2 is None else c2
                    elif fl == 'min':
                        out[k] = min(a2, c2)
                    elif fl == 'max':
                        out[k] = max(a2, c2)
                    elif fl == 'sum':
                        out[k] = a2 + c2
                    else:
                        raise ValueError(f'unknown merge function {f!r}')
                else:
                    out[k] = F.eval_expr(to_expr(
                        f(F.literal(b1, ent_t), F.literal(b2, ent_t))))
        return _S(**out)

    # collect per-sample block lists with GLOBAL row indices: the reference
    # chain breaks whenever a row's entry is missing for the sample, so a
    # merge requires row_idx == prev_row_idx + 1
    per_sample = [[] for _ in range(n_s)]
    from ..matrixtable import MatrixBatch as _MB
    from ..ir.columns import StructColumn as _SC
    row_base = 0
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        g = _SC(ent_t, dict(mb.entries), None, (mb.n_rows, mb.n_cols))
        ents = g.to_pylist()
        emiss = np.logical_and.reduce([c.missing_mask() for c in mb.entries.values()])
        loci = mb.rows.columns['locus'].to_pylist()
        for r in range(mb.n_rows):
            for s in range(mb.n_cols):
                e = ents[r][s]
                if e is not None and not emiss[r, s] and \
                        e.get('END') is not None:
                    per_sample[s].append((row_base + r, loci[r], e))
        row_base += mb.n_rows
    merged = [[] for _ in range(n_s)]
    last_row = [None] * n_s
    for s in range(n_s):
        for ridx, loc, block in per_sample[s]:
            if merged[s] and last_row[s] == ridx - 1:
                ploc, pblock = merged[s][-1]
                if (ploc.contig == loc.contig
                        and pblock['END'] + 1 == loc.position
                        and equivalent(pblock, block)):
                    merged[s][-1] = (ploc, do_merge(pblock, block))
                    last_row[s] = ridx
                    continue
            merged[s].append((loc, block))
            last_row[s] = ridx
    # rebuild: rows = distinct start loci
    keyfn = lambda l: (l._rg.contig_index(l.contig), l.position)
    all_loci = sorted({(keyfn(l), l) for s in range(n_s) for l, _ in merged[s]},
                      key=lambda x: x[0])
    loci_sorted = [l for _, l in all_loci]
    pos_of = {k: i for i, (k, _) in enumerate(all_loci)}
    R = len(loci_sorted)
    flat = [None] * (R * n_s)
    for s in range(n_s):
        for l, b in merged[s]:
            flat[pos_of[keyfn(l)] * n_s + s] = b
    ec = C.from_pylist(ent_t, flat).reshape((R, n_s))
    from ..ir.columns import Batch as _B
    lt = st.row_type['locus']
    alleles_list = [['N', '<NON_REF>']] * R
    rows_cols = {'locus': C.from_pylist(lt, loci_sorted)}
    if 'alleles' in st.row_type.fields:
        rows_cols['alleles'] = C.from_pylist(ht.tarray(ht.tstr), alleles_list)
    rows = _B(rows_cols, R)
    ents = dict(ec.fields)
    if ec.missing is not None:
        ents = {k: v.with_missing(v.missing_mask() | ec.missing)
                for k, v in ents.items()}
    row_t = ht.tstruct(**{k: rows_cols[k].typ if hasattr(rows_cols[k], 'typ') else st.row_type[k]
                          for k in rows_cols})
    from ..matrixtable import MatrixStage as _MS, MatrixTable as _MT
    batches = [_MB(rows, ents)]
    new_rd = _MT(_MS(st.globals, st.cols, st.row_key, st.col_key,
                     st.row_type, st.col_type, ent_t,
                     [0], lambda ctx: batches[int(ctx)]))
    if is_vds:
        return VariantDataset(new_rd, ds.variant_data)
    return new_rd


def segment_reference_blocks(ref: MatrixTable, intervals) -> MatrixTable:
    """Segment reference blocks at interval boundaries; loci outside the
    intervals are dropped (reference vds/methods.py:658). Host-tier."""
    from ..ir.columns import StructColumn as _SC, Batch as _B
    from ..matrixtable import MatrixBatch as _MB, MatrixStage as _MS, MatrixTable as _MT
    key_names = list(intervals._stage.key) if hasattr(intervals._stage, 'key') else []
    iv_field = key_names[0] if key_names else list(intervals.row)[0]
    ivs = [r[iv_field] for r in intervals.collect()]
    st = ref._stage
    ent_t = st.entry_type
    n_s = st.cols.length
    out = {}   # (contig_idx, pos) -> locus
    cells = {}  # (row_key, sample) -> block
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        g = _SC(ent_t, dict(mb.entries), None, (mb.n_rows, mb.n_cols))
        ents = g.to_pylist()
        emiss = np.logical_and.reduce([c.missing_mask() for c in mb.entries.values()])
        loci = mb.rows.columns['locus'].to_pylist()
        for r in range(mb.n_rows):
            loc = loci[r]
            for iv in ivs:
                if iv.start.contig != loc.contig:
                    continue
                iv_start = iv.start.position
                iv_end = iv.end.position + (0 if iv.includes_end else -1)
                for s in range(mb.n_cols):
                    e = ents[r][s]
                    if e is None or emiss[r, s]:
                        continue
                    b_start = loc.position
                    b_end = e['END']
                    seg_start = max(b_start, iv_start)
                    seg_end = min(b_end, iv_end)
                    if seg_start > seg_end:
                        continue
                    new_loc = type(loc)(loc.contig, seg_start, loc._rg) \
                        if b_start != seg_start else loc
                    nb = dict(e)
                    nb['END'] = seg_end
                    k = (loc._rg.contig_index(new_loc.contig), new_loc.position)
                    out[k] = (new_loc, iv)
                    cells[(k, s)] = Struct(**nb)
    keys = sorted(out)
    R = len(keys)
    flat = [cells.get((k, s)) for k in keys for s in range(n_s)]
    ec = C.from_pylist(ent_t, flat).reshape((R, n_s))
    lt = st.row_type['locus']
    # the covering interval is carried as a row field (reference
    # segment_reference_blocks interval annotation)
    rows_cols = {'interval': C.from_pylist(ht.tinterval(lt),
                                           [out[k][1] for k in keys]),
                 'locus': C.from_pylist(lt, [out[k][0] for k in keys])}
    for kf in st.row_type.fields:
        if kf not in rows_cols and kf == 'alleles':
            rows_cols[kf] = C.from_pylist(ht.tarray(ht.tstr),
                                          [['N', '<NON_REF>']] * R)
    rows = _B(rows_cols, R)
    ents = dict(ec.fields)
    if ec.missing is not None:
        ents = {k: v.with_missing(v.missing_mask() | ec.missing)
                for k, v in ents.items()}
    batches = [_MB(rows, ents)]
    new_row_t = rows.row_type
    return _MT(_MS(st.globals, st.cols, st.row_key, st.col_key,
                   new_row_t, st.col_type, ent_t,
                   [0], lambda ctx: batches[int(ctx)]))


def store_ref_block_max_length(vds_path: str) -> None:
    """Compute and store the maximum reference-block length in the VDS
    metadata to speed up interval filters (reference
    vds/variant_dataset.py:71)."""
    import json as _json
    v = read_vds(vds_path)
    rd = v.reference_data
    st = rd._stage
    max_len = 0
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        import numpy as _np
        end_c = mb.entries['END']
        ends = _np.asarray(end_c.values, dtype=_np.int64)
        miss = end_c.missing_mask()
        pos = _np.asarray(mb.rows.columns['locus'].position)[:, None]
        lens = _np.where(miss, 0, ends - pos + 1)
        if lens.size:
            max_len = max(max_len, int(lens.max()))
    meta_p = os.path.join(vds_path, 'metadata.json')
    meta = {}
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = _json.load(f)
    meta['ref_block_max_length'] = max_len
    with open(meta_p, 'w') as f:
        _json.dump(meta, f)


def _vds_reference_genome(self):
    """Reference genome of the dataset (reference VariantDataset
    .reference_genome)."""
    rows = self.variant_data.rows().collect() or self.reference_data.rows().collect()
    return rows[0].locus.reference_genome if rows else None


def _vds_union_rows(self, *others):
    """Union variants/reference blocks across VDSes with the same samples
    (reference VariantDataset.union_rows)."""
    rd = self.reference_data.union_rows(*[o.reference_data for o in others])
    vd = self.variant_data.union_rows(*[o.variant_data for o in others])
    return VariantDataset(rd, vd)


VariantDataset.reference_genome = property(_vds_reference_genome)
