"""variant_qc / sample_qc.

Capability parity with reference `hail/python/hail/methods/qc.py`
(`variant_qc`, `sample_qc`). variant_qc composes the vectorized aggregator
tier; sample_qc runs a dedicated numpy kernel per partition (per-sample
allele-type counting needs row-allele metadata crossed with entries, which is
a take_along_axis lookup here instead of the reference's per-genotype
virtual-function loop).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import types as ht
from ..context import Env
from ..expr import aggregators as agg
from ..expr import functions as F
from importlib import import_module as _imp
at = _imp("hail_tpu_torch.genetics.allele_type")
from ..genetics.call import (PLOIDY_MASK, calls_allele_j, calls_allele_k,
                             calls_is_het, calls_is_hom_ref, calls_is_hom_var)
from ..ir import columns as C
from ..ir.columns import Batch, PrimitiveColumn, StructColumn
from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable


def variant_qc(mt: MatrixTable, name: str = 'variant_qc') -> MatrixTable:
    """Compute per-variant QC metrics (reference `methods/qc.py` variant_qc).

    Runs the fused device kernel (`ops/qc.py variant_qc_block`) per partition
    — one XLA pass over the (R, C) call block computes every counter (the
    reference's generated seqOp loops become a single fused jit)."""
    from ..ops.qc import run_variant_qc_block
    from ..stats.hwe import hwe_test_vec
    from ..ir.columns import DenseArrayColumn
    if 'GT' not in mt._stage.entry_type.fields:
        raise ValueError("Method 'variant_qc' requires an entry field 'GT' "
                         "(type 'call')")
    if 'alleles' not in mt._stage.row_type.fields \
            or mt._stage.row_type['alleles'] != ht.tarray(ht.tstr):
        raise ValueError("Method 'variant_qc' requires a field 'alleles' "
                         "(type 'array<str>') in the row schema")
    st = mt._stage
    n_cols = st.n_cols
    has_dp = 'DP' in st.entry_type.fields
    has_gq = 'GQ' in st.entry_type.fields

    stats_t = ht.tstruct(mean=ht.tfloat64, stdev=ht.tfloat64,
                         min=ht.tfloat64, max=ht.tfloat64)
    fields = []
    if has_dp:
        fields.append(('dp_stats', stats_t))
    if has_gq:
        fields.append(('gq_stats', stats_t))
    fields += [
        ('AC', ht.tarray(ht.tint32)), ('AF', ht.tarray(ht.tfloat64)),
        ('AN', ht.tint32), ('homozygote_count', ht.tarray(ht.tint32)),
        ('call_rate', ht.tfloat64), ('n_called', ht.tint64),
        ('n_not_called', ht.tint64), ('n_filtered', ht.tint64),
        ('n_het', ht.tint64), ('n_non_ref', ht.tint64),
        ('het_freq_hwe', ht.tfloat64), ('p_value_hwe', ht.tfloat64),
        ('p_value_excess_het', ht.tfloat64),
    ]
    qc_t = ht.tstruct.from_fields(fields)

    def f(mb: MatrixBatch, i: int) -> MatrixBatch:
        R = mb.n_rows
        gt = mb.entries['GT']
        alleles_l = mb.rows.columns['alleles'].to_pylist()
        n_alleles = np.asarray([len(a) if a else 2 for a in alleles_l], dtype=np.int32)
        max_a = max(int(n_alleles.max()) if R else 2, 2)
        dp = mb.entries.get('DP') if has_dp else None
        gq = mb.entries.get('GQ') if has_gq else None
        res = run_variant_qc_block(
            np.asarray(gt.values), gt.missing_mask(),
            None if dp is None else np.asarray(dp.values),
            None if dp is None else dp.missing_mask(),
            None if gq is None else np.asarray(gq.values),
            None if gq is None else gq.missing_mask(),
            max_alleles=max_a)
        an = res['AN'].astype(np.int32)
        ac = res['AC'].astype(np.int32)
        hom = res['homozygote_count'].astype(np.int32)
        with np.errstate(all='ignore'):
            af = np.where(an[:, None] > 0, ac / np.maximum(an[:, None], 1), 0.0)
        n_called = res['n_called'].astype(np.int64)
        het_freq, p_hwe, p_xhet = hwe_test_vec(res['n_hom_ref_diploid'], res['n_het'],
                                               res['n_hom_var_diploid'],
                                               with_one_sided=True)
        # reference semantics: HWE stats are missing for non-biallelic rows
        multi = n_alleles != 2
        cols = {}
        def stat_struct(prefix):
            n = res[f'{prefix}_n']
            with np.errstate(all='ignore'):
                mean = res[f'{prefix}_sum'] / n
                var = res[f'{prefix}_sumsq'] / n - mean * mean
            miss = n == 0
            m = miss if miss.any() else None
            return StructColumn(stats_t, {
                'mean': PrimitiveColumn(ht.tfloat64, np.where(miss, 0, mean), m),
                'stdev': PrimitiveColumn(ht.tfloat64,
                                         np.where(miss, 0, np.sqrt(np.maximum(var, 0))), m),
                'min': PrimitiveColumn(ht.tfloat64, np.where(miss, 0, res[f'{prefix}_min']), m),
                'max': PrimitiveColumn(ht.tfloat64, np.where(miss, 0, res[f'{prefix}_max']), m),
            }, None, (R,))
        if has_dp:
            cols['dp_stats'] = stat_struct('dp')
        if has_gq:
            cols['gq_stats'] = stat_struct('gq')
        an_zero = an == 0
        cols.update({
            'AC': DenseArrayColumn(ht.tarray(ht.tint32), ac, n_alleles),
            'AF': DenseArrayColumn(ht.tarray(ht.tfloat64), af, n_alleles, None,
                                   an_zero if an_zero.any() else None),
            'AN': PrimitiveColumn(ht.tint32, an),
            'homozygote_count': DenseArrayColumn(ht.tarray(ht.tint32), hom, n_alleles),
            'call_rate': PrimitiveColumn(ht.tfloat64,
                                         n_called / n_cols if n_cols else np.zeros(R)),
            'n_called': PrimitiveColumn(ht.tint64, n_called),
            'n_not_called': PrimitiveColumn(ht.tint64, n_cols - n_called),
            'n_filtered': PrimitiveColumn(ht.tint64, np.zeros(R, np.int64)),
            'n_het': PrimitiveColumn(ht.tint64, res['n_het'].astype(np.int64)),
            'n_non_ref': PrimitiveColumn(ht.tint64, res['n_non_ref'].astype(np.int64)),
            'het_freq_hwe': PrimitiveColumn(ht.tfloat64, np.where(multi, 0, het_freq),
                                            multi if multi.any() else None),
            'p_value_hwe': PrimitiveColumn(ht.tfloat64, np.where(multi, 0, p_hwe),
                                           multi if multi.any() else None),
            'p_value_excess_het': PrimitiveColumn(ht.tfloat64, np.where(multi, 0, p_xhet),
                                                  multi if multi.any() else None),
        })
        qc = StructColumn(qc_t, cols, None, (R,))
        return MatrixBatch(mb.rows.annotate(**{name: qc}), mb.entries)

    st2 = st.map_partitions(f, new_row_type=st.row_type._insert_field(name, qc_t))
    return MatrixTable(st2)


_SAMPLE_QC_T = ht.tstruct(
    dp_stats=ht.tstruct(mean=ht.tfloat64, stdev=ht.tfloat64, min=ht.tfloat64, max=ht.tfloat64),
    gq_stats=ht.tstruct(mean=ht.tfloat64, stdev=ht.tfloat64, min=ht.tfloat64, max=ht.tfloat64),
    call_rate=ht.tfloat64,
    n_called=ht.tint64, n_not_called=ht.tint64, n_filtered=ht.tint64,
    n_hom_ref=ht.tint64, n_het=ht.tint64, n_hom_var=ht.tint64, n_non_ref=ht.tint64,
    n_singleton=ht.tint64, n_snp=ht.tint64, n_insertion=ht.tint64,
    n_deletion=ht.tint64, n_transition=ht.tint64, n_transversion=ht.tint64,
    n_star=ht.tint64, r_ti_tv=ht.tfloat64, r_het_hom_var=ht.tfloat64,
    r_insertion_deletion=ht.tfloat64,
)

# allele-type codes used in the kernel
_AT_SNP, _AT_INS, _AT_DEL, _AT_STAR, _AT_TI, _AT_TV = 1, 2, 3, 4, 5, 6


def _row_allele_codes(alleles_list) -> np.ndarray:
    """(R, max_alleles) int8 codes; column 0 (ref) is 0."""
    R = len(alleles_list)
    A = max((len(a) for a in alleles_list if a is not None), default=1)
    codes = np.zeros((R, max(A, 1)), dtype=np.int8)
    ti_tv = np.zeros((R, max(A, 1)), dtype=np.int8)
    for i, als in enumerate(alleles_list):
        if als is None:
            continue
        ref = als[0]
        for a_i in range(1, len(als)):
            t = at.allele_type(ref, als[a_i])
            if t == at.AlleleType.SNP:
                codes[i, a_i] = _AT_SNP
                ti_tv[i, a_i] = _AT_TI if at.is_transition(ref, als[a_i]) else _AT_TV
            elif t == at.AlleleType.INSERTION:
                codes[i, a_i] = _AT_INS
            elif t == at.AlleleType.DELETION:
                codes[i, a_i] = _AT_DEL
            elif t == at.AlleleType.STAR:
                codes[i, a_i] = _AT_STAR
    return codes, ti_tv


def sample_qc(mt: MatrixTable, name: str = 'sample_qc') -> MatrixTable:
    """Compute per-sample QC metrics (reference `methods/qc.py` sample_qc)."""
    st = mt._stage
    if 'GT' not in st.entry_type.fields:
        raise ValueError('sample_qc requires a GT entry field')
    n_cols = st.n_cols
    has_dp = 'DP' in st.entry_type.fields
    has_gq = 'GQ' in st.entry_type.fields

    def part_stats(ctx):
        mb = st.partition_fn(ctx)
        gt_col = mb.entries['GT']
        packed = np.asarray(gt_col.values)
        miss = gt_col.missing_mask()
        called = ~miss
        R = mb.n_rows
        ploidy = packed & PLOIDY_MASK
        j = calls_allele_j(packed)
        k = calls_allele_k(packed)

        out = {}
        out['n_called'] = called.sum(axis=0).astype(np.int64)
        out['n_rows'] = np.int64(R)
        out['n_hom_ref'] = (called & calls_is_hom_ref(packed)).sum(axis=0).astype(np.int64)
        out['n_het'] = (called & calls_is_het(packed)).sum(axis=0).astype(np.int64)
        out['n_hom_var'] = (called & calls_is_hom_var(packed)).sum(axis=0).astype(np.int64)

        alleles_list = mb.rows.columns['alleles'].to_pylist()
        codes, ti_tv = _row_allele_codes(alleles_list)
        A = codes.shape[1]
        jc = np.clip(j, 0, A - 1)
        kc = np.clip(k, 0, A - 1)
        code_j = np.take_along_axis(codes, jc, axis=1)
        code_k = np.take_along_axis(codes, kc, axis=1)
        titv_j = np.take_along_axis(ti_tv, jc, axis=1)
        titv_k = np.take_along_axis(ti_tv, kc, axis=1)
        use_j = called & (ploidy >= 1) & (j > 0)
        use_k = called & (ploidy == 2) & (k > 0)
        for cname, code in [('n_snp', _AT_SNP), ('n_insertion', _AT_INS),
                            ('n_deletion', _AT_DEL), ('n_star', _AT_STAR)]:
            out[cname] = ((use_j & (code_j == code)).sum(axis=0)
                          + (use_k & (code_k == code)).sum(axis=0)).astype(np.int64)
        out['n_transition'] = ((use_j & (titv_j == _AT_TI)).sum(axis=0)
                               + (use_k & (titv_k == _AT_TI)).sum(axis=0)).astype(np.int64)
        out['n_transversion'] = ((use_j & (titv_j == _AT_TV)).sum(axis=0)
                                 + (use_k & (titv_k == _AT_TV)).sum(axis=0)).astype(np.int64)

        # singletons: allele (r, a>0) with total AC == 1, carried by this sample
        n_alleles_max = A
        ac = np.zeros((R, n_alleles_max), dtype=np.int64)
        rr = np.arange(R)[:, None]
        np.add.at(ac, (np.broadcast_to(rr, jc.shape)[use_j], jc[use_j]), 1)
        np.add.at(ac, (np.broadcast_to(rr, kc.shape)[use_k], kc[use_k]), 1)
        ac_j = np.take_along_axis(ac, jc, axis=1)
        ac_k = np.take_along_axis(ac, kc, axis=1)
        single_j = use_j & (ac_j == 1)
        single_k = use_k & (ac_k == 1)
        # a hom-var singleton would be AC==2, so no double count issue; but a
        # het carrying the same allele twice can't happen (j != k for het)
        out['n_singleton'] = (single_j.sum(axis=0) + single_k.sum(axis=0)).astype(np.int64)

        for fname, flag in [('dp', has_dp), ('gq', has_gq)]:
            if not flag:
                continue
            col = mb.entries[fname.upper()]
            v = np.asarray(col.values, dtype=np.float64)
            m = col.missing_mask()
            ok = ~m
            out[f'{fname}_sum'] = np.where(ok, v, 0).sum(axis=0)
            out[f'{fname}_sumsq'] = np.where(ok, v * v, 0).sum(axis=0)
            out[f'{fname}_n'] = ok.sum(axis=0).astype(np.int64)
            out[f'{fname}_min'] = np.where(ok, v, np.inf).min(axis=0) if R else np.full(v.shape[1], np.inf)
            out[f'{fname}_max'] = np.where(ok, v, -np.inf).max(axis=0) if R else np.full(v.shape[1], -np.inf)
        return out

    partials = Env.backend().map_collect(st.contexts, part_stats)
    total = partials[0]
    for p in partials[1:]:
        for key in p:
            if key.endswith('_min'):
                total[key] = np.minimum(total[key], p[key])
            elif key.endswith('_max'):
                total[key] = np.maximum(total[key], p[key])
            else:
                total[key] = total[key] + p[key]

    n_rows = int(total['n_rows'])
    with np.errstate(all='ignore'):
        def stat_struct(prefix):
            if f'{prefix}_n' not in total:
                return None
            n = total[f'{prefix}_n']
            mean = total[f'{prefix}_sum'] / n
            var = total[f'{prefix}_sumsq'] / n - mean * mean
            miss = n == 0
            t = _SAMPLE_QC_T[f'{prefix}_stats']
            m = miss if miss.any() else None
            return StructColumn(t, {
                'mean': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, mean), m),
                'stdev': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, np.sqrt(np.maximum(var, 0))), m),
                'min': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, total[f'{prefix}_min']), m),
                'max': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, total[f'{prefix}_max']), m),
            }, None, (n_cols,))

        call_rate = total['n_called'] / n_rows if n_rows else np.zeros(n_cols)
        ti, tv = total['n_transition'], total['n_transversion']
        het, homv = total['n_het'], total['n_hom_var']
        ins, dele = total['n_insertion'], total['n_deletion']

        def ratio(a, b):
            r = a / b
            miss = b == 0
            return PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, r), miss if miss.any() else None)

        fields = {}
        ds = stat_struct('dp')
        gs = stat_struct('gq')
        if ds is not None:
            fields['dp_stats'] = ds
        if gs is not None:
            fields['gq_stats'] = gs
        fields.update({
            'call_rate': PrimitiveColumn(ht.tfloat64, call_rate),
            'n_called': PrimitiveColumn(ht.tint64, total['n_called']),
            'n_not_called': PrimitiveColumn(ht.tint64, n_rows - total['n_called']),
            'n_filtered': PrimitiveColumn(ht.tint64, np.zeros(n_cols, np.int64)),
            'n_hom_ref': PrimitiveColumn(ht.tint64, total['n_hom_ref']),
            'n_het': PrimitiveColumn(ht.tint64, het),
            'n_hom_var': PrimitiveColumn(ht.tint64, homv),
            'n_non_ref': PrimitiveColumn(ht.tint64, het + homv),
            'n_singleton': PrimitiveColumn(ht.tint64, total['n_singleton']),
            'n_snp': PrimitiveColumn(ht.tint64, total['n_snp']),
            'n_insertion': PrimitiveColumn(ht.tint64, ins),
            'n_deletion': PrimitiveColumn(ht.tint64, dele),
            'n_transition': PrimitiveColumn(ht.tint64, ti),
            'n_transversion': PrimitiveColumn(ht.tint64, tv),
            'n_star': PrimitiveColumn(ht.tint64, total['n_star']),
            'r_ti_tv': ratio(ti, tv),
            'r_het_hom_var': ratio(het, homv),
            'r_insertion_deletion': ratio(ins, dele),
        })

    out_t = ht.tstruct(**{k: c.typ for k, c in fields.items()})
    qc_col = StructColumn(out_t, fields, None, (n_cols,))
    cb = st.cols.annotate(**{name: qc_col})
    return MatrixTable(MatrixStage(st.globals, cb, st.row_key, st.col_key,
                                   st.row_type, cb.row_type, st.entry_type,
                                   st.contexts, st.partition_fn))


def summarize_variants(mt, show: bool = True, *, handler=None):
    """Summarize variants: count, alleles-per-variant histogram, per-contig
    counts, allele-type distribution, ti/tv (reference methods/qc.py:1725
    summarize_variants)."""
    from collections import Counter
    import importlib
    _at = importlib.import_module('hail_tpu_torch.genetics.allele_type')
    from ..matrixtable import MatrixTable as _MT
    from ..utils.structs import Struct
    ht_ = mt.rows() if isinstance(mt, _MT) else mt
    n_variants = 0
    contigs: Counter = Counter()
    allele_counts: Counter = Counter()
    allele_types: Counter = Counter()
    nti = ntv = 0
    for r in ht_.select().collect():
        n_variants += 1
        contigs[r.locus.contig] += 1
        als = r.alleles
        allele_counts[len(als)] += 1
        for alt in als[1:]:
            at = _at.allele_type(als[0], alt)
            allele_types[at.pretty_name] += 1
            if at == _at.AlleleType.SNP:
                if _at.is_transition(als[0], alt):
                    nti += 1
                else:
                    ntv += 1
    r_ti_tv = nti / ntv if ntv else None
    result = Struct(n_variants=n_variants,
                    allele_types=dict(allele_types),
                    contigs=dict(contigs),
                    allele_counts=dict(allele_counts),
                    r_ti_tv=r_ti_tv)
    if not show:
        return result
    lines = ['=' * 30, f'Number of variants: {n_variants}', '=' * 30,
             'Alleles per variant', '-' * 19]
    for n, c in sorted(allele_counts.items()):
        lines.append(f'  {n} alleles: {c} variants')
    lines += ['=' * 30, 'Variants per contig', '-' * 19]
    for ctg, c in contigs.items():
        lines.append(f'  {ctg}: {c} variants')
    lines += ['=' * 30, 'Allele type distribution', '-' * 24]
    for t, c in allele_types.most_common():
        lines.append(f'  {t:>12}: {c} alleles')
    lines.append('=' * 30)
    out = '\n'.join(lines)
    (handler or print)(out)
    return None


# The VEP JSON output schema (reference methods/qc.py:546 vep_json_typ) — the
# row annotation type produced by `hl.vep` when csq=False.
def _vep_consequence_fields():
    from .. import types as ht
    return dict(
        allele_num=ht.tint32, amino_acids=ht.tstr, appris=ht.tstr,
        biotype=ht.tstr, canonical=ht.tint32, ccds=ht.tstr, cdna_start=ht.tint32,
        cdna_end=ht.tint32, cds_end=ht.tint32, cds_start=ht.tint32,
        codons=ht.tstr, consequence_terms=ht.tarray(ht.tstr), distance=ht.tint32,
        domains=ht.tarray(ht.tstruct(db=ht.tstr, name=ht.tstr)),
        exon=ht.tstr, gene_id=ht.tstr, gene_pheno=ht.tint32,
        gene_symbol=ht.tstr, gene_symbol_source=ht.tstr, hgnc_id=ht.tstr,
        hgvsc=ht.tstr, hgvsp=ht.tstr, hgvs_offset=ht.tint32,
        impact=ht.tstr, intron=ht.tstr, lof=ht.tstr, lof_flags=ht.tstr,
        lof_filter=ht.tstr, lof_info=ht.tstr,
        polyphen_prediction=ht.tstr, polyphen_score=ht.tfloat64,
        protein_end=ht.tint32, protein_start=ht.tint32, protein_id=ht.tstr,
        sift_prediction=ht.tstr, sift_score=ht.tfloat64,
        strand=ht.tint32, transcript_id=ht.tstr, tsl=ht.tint32,
        uniparc=ht.tstr, variant_allele=ht.tstr,
    )


def _make_vep_json_typ():
    from .. import types as ht
    cons = _vep_consequence_fields()
    return ht.tstruct(
        assembly_name=ht.tstr,
        allele_string=ht.tstr,
        ancestral=ht.tstr,
        colocated_variants=ht.tarray(ht.tstruct(
            aa_allele=ht.tstr, aa_maf=ht.tfloat64, afr_allele=ht.tstr,
            afr_maf=ht.tfloat64, allele_string=ht.tstr, amr_allele=ht.tstr,
            amr_maf=ht.tfloat64, clin_sig=ht.tarray(ht.tstr), end=ht.tint32,
            eas_allele=ht.tstr, eas_maf=ht.tfloat64, ea_allele=ht.tstr,
            ea_maf=ht.tfloat64, eur_allele=ht.tstr, eur_maf=ht.tfloat64,
            exac_adj_allele=ht.tstr, exac_adj_maf=ht.tfloat64,
            exac_allele=ht.tstr, exac_afr_allele=ht.tstr,
            exac_afr_maf=ht.tfloat64, exac_amr_allele=ht.tstr,
            exac_amr_maf=ht.tfloat64, exac_eas_allele=ht.tstr,
            exac_eas_maf=ht.tfloat64, exac_fin_allele=ht.tstr,
            exac_fin_maf=ht.tfloat64, exac_maf=ht.tfloat64,
            exac_nfe_allele=ht.tstr, exac_nfe_maf=ht.tfloat64,
            exac_oth_allele=ht.tstr, exac_oth_maf=ht.tfloat64,
            exac_sas_allele=ht.tstr, exac_sas_maf=ht.tfloat64,
            id=ht.tstr, minor_allele=ht.tstr, minor_allele_freq=ht.tfloat64,
            phenotype_or_disease=ht.tint32, pubmed=ht.tarray(ht.tint32),
            sas_allele=ht.tstr, sas_maf=ht.tfloat64, somatic=ht.tint32,
            start=ht.tint32, strand=ht.tint32)),
        context=ht.tstr,
        end=ht.tint32,
        id=ht.tstr,
        input=ht.tstr,
        intergenic_consequences=ht.tarray(ht.tstruct(
            allele_num=ht.tint32, consequence_terms=ht.tarray(ht.tstr),
            impact=ht.tstr, variant_allele=ht.tstr)),
        most_severe_consequence=ht.tstr,
        motif_feature_consequences=ht.tarray(ht.tstruct(
            allele_num=ht.tint32, consequence_terms=ht.tarray(ht.tstr),
            high_inf_pos=ht.tstr, impact=ht.tstr, motif_feature_id=ht.tstr,
            motif_name=ht.tstr, motif_pos=ht.tint32,
            motif_score_change=ht.tfloat64, strand=ht.tint32,
            variant_allele=ht.tstr)),
        regulatory_feature_consequences=ht.tarray(ht.tstruct(
            allele_num=ht.tint32, biotype=ht.tstr,
            consequence_terms=ht.tarray(ht.tstr), impact=ht.tstr,
            regulatory_feature_id=ht.tstr, variant_allele=ht.tstr)),
        seq_region_name=ht.tstr,
        start=ht.tint32,
        strand=ht.tint32,
        transcript_consequences=ht.tarray(ht.tstruct(**_vep_consequence_fields())),
        variant_class=ht.tstr,
    )


vep_json_typ = _make_vep_json_typ()


class VEPConfig:
    """Base class for VEP configurations (reference methods/qc.py VEPConfig).
    Subclass and pass to `hl.vep(..., config=...)`; the zero-egress build has
    no VEP executable, so running requires a local installation."""

    def __init__(self, *, data_bucket=None, data_mount=None, image=None,
                 regions=None, cloud=None, batch_run_command=None,
                 batch_run_csq_header_command=None, env=None,
                 json_typ=None, **kwargs):
        self.data_bucket = data_bucket
        self.data_mount = data_mount
        self.image = image
        self.regions = regions
        self.cloud = cloud
        self.batch_run_command = batch_run_command
        self.batch_run_csq_header_command = batch_run_csq_header_command
        self.env = env or {}
        self.json_typ = json_typ or vep_json_typ


class VEPConfigGRCh37Version85(VEPConfig):
    """VEP 85 / GRCh37 configuration shape (reference qc.py)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.reference_genome = 'GRCh37'
        self.vep_version = 85


class VEPConfigGRCh38Version95(VEPConfig):
    """VEP 95 / GRCh38 configuration shape (reference qc.py)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.reference_genome = 'GRCh38'
        self.vep_version = 95
