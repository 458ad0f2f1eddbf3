"""Family-based methods: trio_matrix, mendel_errors, de_novo, TDT.

Capability parity with reference `hail/python/hail/methods/family_methods.py`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import types as ht
from ..expr import aggregators as agg
from ..expr import functions as F
from ..expr.expression import to_expr
from ..genetics.call import (calls_allele_j, calls_allele_k, calls_is_het,
                             calls_is_hom_ref, calls_is_hom_var, calls_n_alt_alleles)
from ..genetics.pedigree import Pedigree
from ..ir import columns as C
from ..ir.columns import Batch, ObjectColumn, PrimitiveColumn, StructColumn
from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
from ..table import Table, TableStage
from ..utils.structs import Struct


def trio_matrix(dataset: MatrixTable, pedigree: Pedigree,
                complete_trios: bool = False) -> MatrixTable:
    """MatrixTable with one column per trio, entries
    {proband_entry, father_entry, mother_entry} (reference trio_matrix)."""
    st = dataset._stage
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    s_idx = {s: i for i, s in enumerate(samples)}
    trios = pedigree.complete_trios() if complete_trios else pedigree.trios
    trios = [t for t in trios if t.s in s_idx
             and (t.pat_id is None or t.pat_id in s_idx)
             and (t.mat_id is None or t.mat_id in s_idx)]
    kid_idx = np.asarray([s_idx[t.s] for t in trios], dtype=np.int64)
    dad_idx = np.asarray([s_idx[t.pat_id] if t.pat_id else 0 for t in trios], dtype=np.int64)
    mom_idx = np.asarray([s_idx[t.mat_id] if t.mat_id else 0 for t in trios], dtype=np.int64)
    dad_defined = np.asarray([t.pat_id is not None for t in trios], dtype=bool)
    mom_defined = np.asarray([t.mat_id is not None for t in trios], dtype=bool)

    n_trios = len(trios)
    col_t = ht.tstruct(id=st.col_type[skey], proband=st.col_type,
                       father=st.col_type, mother=st.col_type,
                       is_female=ht.tbool, fam_id=ht.tstr)
    col_rows = st.cols.to_pylist()
    col_vals = []
    for i, t in enumerate(trios):
        col_vals.append(Struct(
            id=t.s, proband=col_rows[s_idx[t.s]],
            father=col_rows[s_idx[t.pat_id]] if t.pat_id else None,
            mother=col_rows[s_idx[t.mat_id]] if t.mat_id else None,
            is_female=t.is_female, fam_id=t.fam_id))
    cols = Batch.from_pylist(col_t, col_vals)

    entry_t = ht.tstruct(proband_entry=st.entry_type, father_entry=st.entry_type,
                         mother_entry=st.entry_type)

    def f(mb: MatrixBatch, i: int) -> MatrixBatch:
        R = mb.n_rows
        g = StructColumn(st.entry_type, dict(mb.entries), None,
                         (R, st.n_cols))
        ents = {
            'proband_entry': g.gather(kid_idx, axis=1),
            'father_entry': g.gather(dad_idx, axis=1).with_missing(
                np.broadcast_to(~dad_defined, (R, n_trios)).copy() if (~dad_defined).any() else None),
            'mother_entry': g.gather(mom_idx, axis=1).with_missing(
                np.broadcast_to(~mom_defined, (R, n_trios)).copy() if (~mom_defined).any() else None),
        }
        return MatrixBatch(mb.rows, ents)

    st2 = st.map_partitions(f, new_entry_type=entry_t)
    return MatrixTable(MatrixStage(st2.globals, cols, st2.row_key, ['id'],
                                   st2.row_type, col_t, entry_t,
                                   st2.contexts, st2.partition_fn))


# Mendel error codes follow PLINK/reference numbering exactly
# (reference `methods/family_methods.py` mendel_errors docstring table;
# `is/hail/methods/MendelErrors.scala`). `~HomRef` etc. includes NoCall.
def _mendel_codes(kid, dad, mom, in_x_nonpar, in_y_nonpar, kid_is_female):
    """Vectorized mendel error code per (variant, trio); 0 = no error.
    Arrays: packed calls + missing masks."""
    (kp, km), (dp, dm), (mp_, mm_) = kid, dad, mom
    k_het = calls_is_het(kp) & ~km
    k_hr = calls_is_hom_ref(kp) & ~km
    k_hv = calls_is_hom_var(kp) & ~km
    d_hr = calls_is_hom_ref(dp) & ~dm
    d_hv = calls_is_hom_var(dp) & ~dm
    m_hr = calls_is_hom_ref(mp_) & ~mm_
    m_hv = calls_is_hom_var(mp_) & ~mm_
    code = np.zeros(kp.shape, dtype=np.int32)
    # copy states: Auto = autosome/PAR or female child (anywhere);
    # HemiX/HemiY = male child in the non-PAR of X/Y
    auto = (~in_x_nonpar & ~in_y_nonpar) | kid_is_female
    hemi_x = in_x_nonpar & ~kid_is_female
    hemi_y = in_y_nonpar & ~kid_is_female
    code = np.where(auto & k_het & d_hv & m_hv, 1, code)
    code = np.where(auto & k_het & d_hr & m_hr, 2, code)
    code = np.where(auto & k_hv & d_hr & ~m_hr, 3, code)
    code = np.where(auto & k_hv & ~d_hr & m_hr, 4, code)
    code = np.where(auto & k_hv & d_hr & m_hr, 5, code)
    code = np.where(auto & k_hr & d_hv & ~m_hv, 6, code)
    code = np.where(auto & k_hr & ~d_hv & m_hv, 7, code)
    code = np.where(auto & k_hr & d_hv & m_hv, 8, code)
    code = np.where(hemi_x & k_hr & m_hv, 9, code)
    code = np.where(hemi_x & k_hv & m_hr, 10, code)
    code = np.where(hemi_y & k_hr & d_hv, 11, code)
    code = np.where(hemi_y & k_hv & d_hr, 12, code)
    return code


# per-code implicated members (docstring table): (dad, mom)
_MENDEL_IMPLICATES_DAD = {1, 2, 3, 6, 11, 12}
_MENDEL_IMPLICATES_MOM = {1, 2, 4, 7, 9, 10}


def mendel_errors(call, pedigree: Pedigree) -> Tuple[Table, Table, Table, Table]:
    """Mendelian-violation counting (reference mendel_errors); returns
    (all_errors, per_fam, per_sample, per_variant)."""
    e = to_expr(call)
    mt = e._indices.source
    st = mt._stage
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    s_idx = {s: i for i, s in enumerate(samples)}
    trios = [t for t in pedigree.complete_trios()
             if t.s in s_idx and t.pat_id in s_idx and t.mat_id in s_idx]
    kid_idx = np.asarray([s_idx[t.s] for t in trios], dtype=np.int64)
    dad_idx = np.asarray([s_idx[t.pat_id] for t in trios], dtype=np.int64)
    mom_idx = np.asarray([s_idx[t.mat_id] for t in trios], dtype=np.int64)
    kid_female = np.asarray([bool(t.is_female) for t in trios], dtype=bool)

    all_rows: List[Struct] = []
    per_variant_rows: List[Struct] = []
    # every complete trio's family / member appears even with zero errors
    fam_counts = {}
    fam_snp_counts = {}
    for t in trios:
        fam_counts.setdefault((t.fam_id, t.pat_id, t.mat_id), 0)
        fam_snp_counts.setdefault((t.fam_id, t.pat_id, t.mat_id), 0)
    trio_members = []
    seen_members = set()
    for t in trios:
        for s in (t.s, t.pat_id, t.mat_id):
            if s not in seen_members:
                seen_members.add(s)
                trio_members.append(s)
    indiv_counts = {s: 0 for s in trio_members}
    indiv_snp_counts = {s: 0 for s in trio_members}

    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        env = mt._entry_env(mb, i)
        col = e._ir.evaluate(env)
        packed = np.asarray(col.values)
        miss = col.missing_mask()
        loci = mb.rows.columns['locus']
        rg = loci.rg
        contig = np.asarray(loci.contig_idx)
        x_idx = [rg.contig_index(c) for c in rg.x_contigs]
        y_idx = [rg.contig_index(c) for c in rg.y_contigs]
        in_x = np.isin(contig, x_idx)
        in_y = np.isin(contig, y_idx)
        in_par = np.zeros(mb.n_rows, dtype=bool)
        for (c0, s0, c1, e0) in rg._par_tuples:
            ci = rg.contig_index(c0)
            in_par |= (contig == ci) & \
                      (np.asarray(loci.position) >= s0) & (np.asarray(loci.position) < e0)
        in_x_nonpar = (in_x & ~in_par)[:, None]
        in_y_nonpar = (in_y & ~in_par)[:, None]

        codes = _mendel_codes(
            (packed[:, kid_idx], miss[:, kid_idx]),
            (packed[:, dad_idx], miss[:, dad_idx]),
            (packed[:, mom_idx], miss[:, mom_idx]),
            in_x_nonpar, in_y_nonpar, kid_female[None, :])
        locus_l = loci.to_pylist()
        alleles_l = mb.rows.columns['alleles'].to_pylist()
        is_snp_l = [len(a) == 2 and len(a[0]) == 1 and len(a[1]) == 1 and a[0] != a[1]
                    for a in alleles_l]
        err_r, err_t = np.where(codes > 0)
        per_var = np.bincount(err_r, minlength=mb.n_rows)
        for r in range(mb.n_rows):
            per_variant_rows.append(Struct(locus=locus_l[r], alleles=alleles_l[r],
                                           errors=int(per_var[r])))
        for r, ti in zip(err_r, err_t):
            t = trios[ti]
            code = int(codes[r, ti])
            snp = is_snp_l[r]
            all_rows.append(Struct(locus=locus_l[r], alleles=alleles_l[r],
                                   s=t.s, fam_id=t.fam_id, mendel_code=code))
            fam_key = (t.fam_id, t.pat_id, t.mat_id)
            fam_counts[fam_key] += 1
            fam_snp_counts[fam_key] += snp
            # per-individual attribution follows the docs' Implicated column
            indiv_counts[t.s] += 1
            indiv_snp_counts[t.s] += snp
            if code in _MENDEL_IMPLICATES_DAD:
                indiv_counts[t.pat_id] += 1
                indiv_snp_counts[t.pat_id] += snp
            if code in _MENDEL_IMPLICATES_MOM:
                indiv_counts[t.mat_id] += 1
                indiv_snp_counts[t.mat_id] += snp

    lt = st.row_type['locus']
    at = st.row_type['alleles']
    t1_t = ht.tstruct(locus=lt, alleles=at, s=ht.tstr, fam_id=ht.tstr, mendel_code=ht.tint32)
    t1 = Table(TableStage.from_batches(Batch({}, 1), ['locus', 'alleles', 's'], t1_t,
                                       [Batch.from_pylist(t1_t, all_rows)]))
    t2_t = ht.tstruct(pat_id=ht.tstr, mat_id=ht.tstr, fam_id=ht.tstr,
                      children=ht.tint32, errors=ht.tint64, snp_errors=ht.tint64)
    fam_children = {}
    for t in trios:
        key = (t.fam_id, t.pat_id, t.mat_id)
        fam_children[key] = fam_children.get(key, 0) + 1
    t2_rows = [Struct(pat_id=k[1], mat_id=k[2], fam_id=k[0],
                      children=fam_children.get(k, 0), errors=v,
                      snp_errors=fam_snp_counts[k])
               for k, v in fam_counts.items()]
    t2 = Table(TableStage.from_batches(Batch({}, 1), ['pat_id', 'mat_id'], t2_t,
                                       [Batch.from_pylist(t2_t, t2_rows)]))
    t3_t = ht.tstruct(s=ht.tstr, fam_id=ht.tstr, errors=ht.tint64, snp_errors=ht.tint64)
    trio_fam = {}
    for t in trios:
        for s in (t.s, t.pat_id, t.mat_id):
            trio_fam.setdefault(s, t.fam_id)
    t3_rows = [Struct(s=s, fam_id=trio_fam.get(s), errors=c,
                      snp_errors=indiv_snp_counts[s])
               for s, c in indiv_counts.items()]
    t3 = Table(TableStage.from_batches(Batch({}, 1), ['s'], t3_t,
                                       [Batch.from_pylist(t3_t, t3_rows)]))
    t4_t = ht.tstruct(locus=lt, alleles=at, errors=ht.tint64)
    t4_rows = [Struct(locus=r.locus, alleles=r.alleles, errors=r.errors)
               for r in per_variant_rows]
    t4 = Table(TableStage.from_batches(Batch({}, 1), ['locus', 'alleles'], t4_t,
                                       [Batch.from_pylist(t4_t, t4_rows)]))
    return t1, t2, t3, t4


def transmission_disequilibrium_test(dataset: MatrixTable, pedigree: Pedigree) -> Table:
    """TDT (reference transmission_disequilibrium_test): counts transmitted/
    untransmitted alt alleles from het parents, chi² 1df."""
    import scipy.stats as sstats
    mt = dataset
    st = mt._stage
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    s_idx = {s: i for i, s in enumerate(samples)}
    trios = [t for t in pedigree.complete_trios()
             if t.s in s_idx and t.pat_id in s_idx and t.mat_id in s_idx]
    kid_idx = np.asarray([s_idx[t.s] for t in trios])
    dad_idx = np.asarray([s_idx[t.pat_id] for t in trios])
    mom_idx = np.asarray([s_idx[t.mat_id] for t in trios])

    kid_female = np.asarray([bool(t.is_female) for t in trios])

    # valid (kid, dad, mom, copy_state) -> (t, u); anything else contributes
    # nothing (reference family_methods.py transmission_disequilibrium_test
    # config_counts; copy state 2 = Auto, 1 = Hemi)
    _TDT_CONFIGS = [
        (0, 1, 1, 2, 0, 2), (0, 0, 1, 2, 0, 1), (0, 1, 0, 2, 0, 1),
        (1, 1, 1, 2, 1, 1), (1, 0, 1, 2, 1, 0), (1, 1, 0, 2, 1, 0),
        (1, 2, 1, 2, 0, 1), (1, 1, 2, 2, 0, 1), (2, 1, 1, 2, 2, 0),
        (2, 1, 2, 2, 1, 0), (2, 2, 1, 2, 1, 0),
        (0, 0, 1, 1, 0, 1), (0, 2, 1, 1, 0, 1),
        (2, 0, 1, 1, 1, 0), (2, 2, 1, 1, 1, 0),
    ]

    rows_out: List[Struct] = []
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        col = mb.entries['GT']
        packed = np.asarray(col.values)
        miss = col.missing_mask()
        kna = calls_n_alt_alleles(packed[:, kid_idx])
        dna = calls_n_alt_alleles(packed[:, dad_idx])
        mna = calls_n_alt_alleles(packed[:, mom_idx])
        ok = ~(miss[:, kid_idx] | miss[:, dad_idx] | miss[:, mom_idx])
        d_het = calls_is_het(packed[:, dad_idx]) & ~miss[:, dad_idx]
        m_het = calls_is_het(packed[:, mom_idx]) & ~miss[:, mom_idx]

        loci = mb.rows.columns['locus']
        rg = loci.rg
        contig = np.asarray(loci.contig_idx)
        sex_idx = [rg.contig_index(c) for c in
                   list(rg.x_contigs) + list(rg.y_contigs) + list(rg.mt_contigs)]
        x_idx = [rg.contig_index(c) for c in rg.x_contigs]
        in_autosome = ~np.isin(contig, sex_idx)
        in_x = np.isin(contig, x_idx)
        in_x_par = np.zeros(mb.n_rows, dtype=bool)
        for (c0, s0, c1, e0) in rg._par_tuples:
            ci = rg.contig_index(c0)
            if ci not in x_idx:
                continue
            in_x_par |= (contig == ci) & \
                        (np.asarray(loci.position) >= s0) & (np.asarray(loci.position) < e0)
        # only autosomes and X are considered (reference filters rows to
        # in_autosome | in_x_par | in_x_nonpar)
        row_keep = in_autosome | in_x
        auto_or_par = (in_autosome | in_x_par)[:, None]

        # het father on hemizygous X is a Mendel error -> trio excluded there
        valid = ok & ((d_het & auto_or_par) | (m_het & ~d_het))
        copy_state = np.where(auto_or_par | kid_female[None, :], 2, 1)

        t_count = np.zeros(kna.shape, dtype=np.int64)
        u_count = np.zeros(kna.shape, dtype=np.int64)
        for (ck, cd, cm, cs, tt, uu) in _TDT_CONFIGS:
            hit = valid & (kna == ck) & (dna == cd) & (mna == cm) & (copy_state == cs)
            if tt:
                t_count += hit * tt
            if uu:
                u_count += hit * uu
        t_sum = t_count.sum(axis=1)
        u_sum = u_count.sum(axis=1)
        with np.errstate(all='ignore'):
            chi2 = (t_sum - u_sum) ** 2 / (t_sum + u_sum).astype(np.float64)
        p = sstats.chi2.sf(chi2, 1)
        locus_l = mb.rows.columns['locus'].to_pylist()
        alleles_l = mb.rows.columns['alleles'].to_pylist()
        for r in range(mb.n_rows):
            if not row_keep[r]:
                continue
            rows_out.append(Struct(locus=locus_l[r], alleles=alleles_l[r],
                                   t=int(t_sum[r]), u=int(u_sum[r]),
                                   chi_sq=float(chi2[r]), p_value=float(p[r])))
    row_t = ht.tstruct(locus=st.row_type['locus'], alleles=st.row_type['alleles'],
                       t=ht.tint64, u=ht.tint64, chi_sq=ht.tfloat64, p_value=ht.tfloat64)
    return Table(TableStage.from_batches(Batch({}, 1), ['locus', 'alleles'], row_t,
                                         [Batch.from_pylist(row_t, rows_out)]))


def de_novo(mt: MatrixTable, pedigree: Pedigree, pop_frequency_prior,
            min_gq: int = 20, min_p: float = 0.05, max_parent_ab: float = 0.05,
            min_child_ab: float = 0.20, min_dp_ratio: float = 0.10,
            ignore_in_sample_allele_frequency: bool = False) -> Table:
    """Call putative de novo events (reference family_methods.py de_novo —
    the Samocha caller, bde3e40). Exact reference semantics: posterior
    P(dn) = P(x|dn)*P(dn) / (P(x|dn)*P(dn) + P(x|missed het)*P(het in
    parent)) from normalized PL likelihoods; copy-state-specific calls
    (autosomal / hemi X / hemi Y / female mito); SNP and indel confidence
    tiers; site frequency from in-sample AC unless
    ignore_in_sample_allele_frequency."""
    from ..expr import functions as F
    DE_NOVO_PRIOR = 1 / 30000000
    MIN_POP_PRIOR = 100 / 30000000

    required = {'GT', 'AD', 'DP', 'GQ', 'PL'}
    missing_f = required - set(mt._stage.entry_type.fields)
    if missing_f:
        raise ValueError(f"'de_novo': expected 'MatrixTable' to have at least "
                         f"{required}, missing {missing_f}")

    pfp = to_expr(pop_frequency_prior)
    mt = mt.annotate_rows(__prior=pfp)
    if ignore_in_sample_allele_frequency:
        mt = mt.annotate_rows(__alt_alleles=F.int64(1),
                              __site_freq=F.max(mt.__prior, MIN_POP_PRIOR))
    else:
        from ..expr import aggregators as agg
        mt = mt.annotate_rows(
            __alt_alleles=agg.sum(mt.GT.n_alt_alleles()),
            __total_alleles=2 * agg.sum(F.int32(F.is_defined(mt.GT))))
        # subtract 1 to correct for the observed genotype
        mt = mt.annotate_rows(__site_freq=F.max(
            (F.float64(mt.__alt_alleles) - 1) / F.float64(mt.__total_alleles),
            mt.__prior, MIN_POP_PRIOR))

    tm = trio_matrix(mt, pedigree, complete_trios=True)
    st = tm._stage
    trios_cols = st.cols.to_pylist()
    is_female_arr = np.asarray(
        [bool(c.get('is_female')) if c.get('is_female') is not None else False
         for c in trios_cols])

    rows_out: List[Struct] = []
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        R = mb.n_rows
        T = mb.n_cols
        if R == 0 or T == 0:
            continue
        loci = mb.rows.columns['locus']
        rg = loci.rg
        contig = np.asarray(loci.contig_idx)
        pos = np.asarray(loci.position)
        x_idx = [rg.contig_index(c) for c in rg.x_contigs]
        y_idx = [rg.contig_index(c) for c in rg.y_contigs]
        mt_idx = [rg.contig_index(c) for c in rg.mt_contigs]
        in_x = np.isin(contig, x_idx)
        in_y = np.isin(contig, y_idx)
        in_mt = np.isin(contig, mt_idx)
        in_par = np.zeros(R, dtype=bool)
        for (c0, s0, c1, e0) in rg._par_tuples:
            ci = rg.contig_index(c0)
            in_par |= (contig == ci) & (pos >= s0) & (pos < e0)
        in_autosome_or_par = (~in_x & ~in_y & ~in_mt) | in_par
        f = is_female_arr[None, :]
        autosomal = in_autosome_or_par[:, None] | ((in_x & ~in_par)[:, None] & f)
        hemi_x = (in_x & ~in_par)[:, None] & ~f
        hemi_y = (in_y & ~in_par)[:, None] & ~f
        hemi_mt = in_mt[:, None] & f

        alleles_l = mb.rows.columns['alleles'].to_pylist()
        is_snp_arr = np.asarray([len(a) == 2 and len(a[0]) == 1 and len(a[1]) == 1
                                 for a in alleles_l])[:, None]
        prior = np.asarray(mb.rows.columns['__site_freq'].values,
                           dtype=np.float64)[:, None]
        n_alt = np.asarray(mb.rows.columns['__alt_alleles'].values,
                           dtype=np.float64)[:, None]

        def fields(role):
            ent = mb.entries[role]
            gt = ent.fields['GT']
            pl = ent.fields['PL']
            ad = ent.fields['AD']
            dpv = ent.fields['DP']
            gq = ent.fields['GQ']
            return (np.asarray(gt.values), gt.missing_mask(),
                    pl.values.astype(np.float64), pl.missing_mask(),
                    ad.values.astype(np.float64), ad.missing_mask(),
                    np.asarray(dpv.values, dtype=np.float64), dpv.missing_mask(),
                    np.asarray(gq.values, dtype=np.float64), gq.missing_mask())

        kp, km, kpl, kplm, kad, kadm, kdp, kdpm, kgq, kgqm = fields('proband_entry')
        dp_, dm, dpl, dplm, dad_, dadm, ddp, ddpm, _, _ = fields('father_entry')
        mp_, mm, mpl, mplm, mad, madm, mdp, mdpm, _, _ = fields('mother_entry')

        defined = ~(km | dm | mm | kplm | dplm | mplm)
        het_hom_hom = calls_is_het(kp) & calls_is_hom_ref(dp_) & calls_is_hom_ref(mp_)

        with np.errstate(all='ignore'):
            kid_ad_sum = kad[..., 0] + kad[..., 1]
            kid_ad_ratio = kad[..., 1] / kid_ad_sum
            kid_ad_fail = kid_ad_ratio < min_child_ab

            def norm_pp(pl):
                lin = np.power(10.0, -pl / 10.0)
                return lin / np.maximum(lin.sum(axis=-1, keepdims=True), 1e-300)

            kid_pp = norm_pp(kpl)
            dad_pp = norm_pp(dpl)
            mom_pp = norm_pp(mpl)

            p_het_in_parent = 1 - (1 - prior) ** 4

            # autosomal posterior (reference call_auto)
            p_dn_auto_num = dad_pp[..., 0] * mom_pp[..., 0] * kid_pp[..., 1] * DE_NOVO_PRIOR
            p_missed_auto = (dad_pp[..., 1] * mom_pp[..., 0]
                             + dad_pp[..., 0] * mom_pp[..., 1]) * kid_pp[..., 1] * p_het_in_parent
            p_dn_auto = p_dn_auto_num / (p_dn_auto_num + p_missed_auto)

            def p_dn_hemi(parent_pp):
                num = parent_pp[..., 0] * kid_pp[..., 1] * DE_NOVO_PRIOR
                den = num + (parent_pp[..., 1] + parent_pp[..., 2]) * \
                    kid_pp[..., 2] * p_het_in_parent
                return num / den

            p_dn_x = p_dn_hemi(mom_pp)
            p_dn_y = p_dn_hemi(dad_pp)

            dp_ratio_auto = kdp / (ddp + mdp)
            dad_ab = dad_[..., 1] / (dad_[..., 0] + dad_[..., 1])
            mom_ab = mad[..., 1] / (mad[..., 0] + mad[..., 1])

        def classify(p_dn, dp_ratio, hemi):
            """confidence tiers (reference call_auto/call_hemi solve)"""
            conf = np.full(p_dn.shape, None, dtype=object)
            with np.errstate(all='ignore'):
                snp_high = ((p_dn > 0.99) & (kid_ad_ratio > 0.3) & (dp_ratio > 0.2)) | \
                           ((p_dn > 0.99) & (kid_ad_ratio > 0.3) & (n_alt == 1)) | \
                           ((p_dn > 0.5) & (kid_ad_ratio > 0.3) & (n_alt < 10) & (kdp > 10))
                snp_med = (p_dn > 0.5) & ((kid_ad_ratio > 0.3) | (n_alt == 1))
                snp_low = kid_ad_ratio > 0.2
                ind_high = (p_dn > 0.99) & (kid_ad_ratio > 0.3) & (n_alt == 1)
                ind_med = (p_dn > 0.5) & (kid_ad_ratio > 0.3) & (n_alt <= 5)
                ind_low = kid_ad_ratio > (0.3 if hemi else 0.2)
            is_snp_b = np.broadcast_to(is_snp_arr, p_dn.shape)
            conf = np.where(is_snp_b & snp_high, 'HIGH', conf)
            conf = np.where(is_snp_b & ~snp_high & snp_med, 'MEDIUM', conf)
            conf = np.where(is_snp_b & ~snp_high & ~snp_med & snp_low, 'LOW', conf)
            conf = np.where(~is_snp_b & ind_high, 'HIGH', conf)
            conf = np.where(~is_snp_b & ~ind_high & ind_med, 'MEDIUM', conf)
            conf = np.where(~is_snp_b & ~ind_high & ~ind_med & ind_low, 'LOW', conf)
            return conf

        with np.errstate(all='ignore'):
            base = defined & het_hom_hom & ~kid_ad_fail & ~np.isnan(kid_ad_ratio) \
                & ~kgqm & (kgq >= min_gq)
            auto_ok = base & autosomal & ~kdpm & ~ddpm & ~mdpm \
                & (dp_ratio_auto >= min_dp_ratio) & (kid_ad_ratio >= min_child_ab) \
                & ((dad_[..., 0] + dad_[..., 1]) > 0) & ((mad[..., 0] + mad[..., 1]) > 0) \
                & ~(mom_ab > max_parent_ab) & ~(dad_ab > max_parent_ab) \
                & (p_dn_auto >= min_p)
            x_ok = base & (hemi_x | hemi_mt) & ~kdpm & ~mdpm \
                & (kdp / mdp >= min_dp_ratio) & (kid_ad_ratio >= min_child_ab) \
                & ((mad[..., 0] + mad[..., 1]) > 0) & ~(mom_ab > max_parent_ab) \
                & (p_dn_x >= min_p)
            y_ok = base & hemi_y & ~kdpm & ~ddpm \
                & (kdp / ddp >= min_dp_ratio) & (kid_ad_ratio >= min_child_ab) \
                & ((dad_[..., 0] + dad_[..., 1]) > 0) & ~(dad_ab > max_parent_ab) \
                & (p_dn_y >= min_p)

        conf_auto = classify(p_dn_auto, dp_ratio_auto, hemi=False)
        with np.errstate(all='ignore'):
            conf_x = classify(p_dn_x, kdp / mdp, hemi=True)
            conf_y = classify(p_dn_y, kdp / ddp, hemi=True)

        locus_l = loci.to_pylist()
        ent_t = st.entry_type['proband_entry']
        role_py = {role: StructColumn(ent_t, dict(mb.entries[role].fields),
                                      mb.entries[role].missing,
                                      (R, T)).to_pylist()
                   for role in ('proband_entry', 'father_entry', 'mother_entry')}

        for ok, p_dn, conf in ((auto_ok, p_dn_auto, conf_auto),
                               (x_ok, p_dn_x, conf_x),
                               (y_ok, p_dn_y, conf_y)):
            rr, tt2 = np.where(ok & (conf != None))  # noqa: E711
            for r, t_i in zip(rr, tt2):
                trio = trios_cols[t_i]
                rows_out.append(Struct(
                    locus=locus_l[r], alleles=alleles_l[r], id=trio['id'],
                    prior=float(prior[r, 0]),
                    proband=trio['proband'], father=trio['father'],
                    mother=trio['mother'],
                    proband_entry=role_py['proband_entry'][r][t_i],
                    father_entry=role_py['father_entry'][r][t_i],
                    mother_entry=role_py['mother_entry'][r][t_i],
                    is_female=trio.get('is_female'),
                    p_de_novo=float(p_dn[r, t_i]),
                    confidence=str(conf[r, t_i])))

    col_t = st.col_type
    ent_t = st.entry_type['proband_entry']
    row_t = ht.tstruct(locus=st.row_type['locus'],
                       alleles=st.row_type['alleles'], id=ht.tstr,
                       prior=ht.tfloat64,
                       proband=col_t['proband'], father=col_t['father'],
                       mother=col_t['mother'],
                       proband_entry=ent_t, father_entry=ent_t,
                       mother_entry=ent_t, is_female=ht.tbool,
                       p_de_novo=ht.tfloat64, confidence=ht.tstr)
    return Table(TableStage.from_batches(Batch({}, 1), ['locus', 'alleles', 'id'],
                                         row_t, [Batch.from_pylist(row_t, rows_out)]))
