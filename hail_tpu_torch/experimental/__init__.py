"""hl.experimental (reference hail/python/hail/experimental/).

Round-1 subset: full_outer_join_mt, pc_project, strided helpers, and
write_multiple; ld_score_regression and the annotation DB land later.
"""

from __future__ import annotations

import numpy as np

from .. import types as ht
from ..expr import functions as F
from ..expr import aggregators as agg
from ..expr.expression import to_expr
from ..matrixtable import MatrixTable
from ..table import Table
from ..utils.structs import Struct


def full_outer_join_mt(left: MatrixTable, right: MatrixTable) -> MatrixTable:
    """Full outer join on both axes (reference
    experimental/full_outer_join_mt.py): rows/cols are joined by key with a
    CROSS PRODUCT on duplicate keys (the reference's key_indices flatmap);
    output schema is key fields + {left_row,right_row} / {left_col,right_col}
    structs and {left_entry,right_entry} entries."""
    from ..ir.columns import Batch, StructColumn
    from ..matrixtable import MatrixBatch, MatrixStage, _concat_matrix_batches
    from ..table import _hashable_key, _key_tuples
    from ..utils.structs import thaw
    lst, rst = left._stage, right._stage
    if [lst.row_type[f] for f in lst.row_key] != [rst.row_type[f] for f in rst.row_key]:
        raise ValueError(
            f'row key types do not match:\n'
            f'  left:  {[str(lst.row_type[f]) for f in lst.row_key]}\n'
            f'  right: {[str(rst.row_type[f]) for f in rst.row_key]}')
    if [lst.col_type[f] for f in lst.col_key] != [rst.col_type[f] for f in rst.col_key]:
        raise ValueError(
            f'column key types do not match:\n'
            f'  left:  {[str(lst.col_type[f]) for f in lst.col_key]}\n'
            f'  right: {[str(rst.col_type[f]) for f in rst.col_key]}')
    lmb = _concat_matrix_batches(lst.collect_batches(), lst)
    rmb = _concat_matrix_batches(rst.collect_batches(), rst)

    def _axis_pairs(lkeys, rkeys, sort_key=None):
        """(key, left_index|None, right_index|None) triples: cross product
        where both sides have the key (possibly duplicated), one-sided
        otherwise (reference key_indices flatmap semantics)."""
        lgroups, rgroups = {}, {}
        for i, k in enumerate(lkeys):
            lgroups.setdefault(k, []).append(i)
        for j, k in enumerate(rkeys):
            rgroups.setdefault(k, []).append(j)
        union = list(dict.fromkeys(list(lgroups) + [k for k in rgroups
                                                    if k not in lgroups]))
        if sort_key is not None:
            union = sorted(union, key=sort_key)
        pairs = []
        for k in union:
            li, ri = lgroups.get(k), rgroups.get(k)
            if li is not None and ri is not None:
                pairs.extend((k, i, j) for i in li for j in ri)
            elif li is not None:
                pairs.extend((k, i, None) for i in li)
            else:
                pairs.extend((k, None, j) for j in ri)
        return pairs

    def _skey(kt):
        out = []
        for v in kt:
            if hasattr(v, 'global_position'):
                out.append((0, v.global_position()))
            elif isinstance(v, tuple):
                out.append((1, tuple(str(x) for x in v)))
            else:
                out.append((2, str(v)))
        return tuple(out)

    lkeys = [_hashable_key(k) for k in _key_tuples(lmb.rows, lst.row_key)]
    rkeys = [_hashable_key(k) for k in _key_tuples(rmb.rows, rst.row_key)]
    row_pairs = _axis_pairs(lkeys, rkeys, sort_key=_skey)
    lckeys = [_hashable_key(k) for k in _key_tuples(lst.cols, lst.col_key)]
    rckeys = [_hashable_key(k) for k in _key_tuples(rst.cols, rst.col_key)]
    col_pairs = _axis_pairs(lckeys, rckeys)
    R, Cn = len(row_pairs), len(col_pairs)

    lrows = lmb.rows.to_pylist()
    rrows = rmb.rows.to_pylist()
    lcols_l = lst.cols.to_pylist()
    rcols_l = rst.cols.to_pylist()

    row_t = ht.tstruct(**{f: lst.row_type[f] for f in lst.row_key},
                       left_row=lst.row_type, right_row=rst.row_type)
    col_t = ht.tstruct(**{f: lst.col_type[f] for f in lst.col_key},
                       left_col=lst.col_type, right_col=rst.col_type)
    entry_t = ht.tstruct(left_entry=lst.entry_type, right_entry=rst.entry_type)

    row_vals = [Struct(**{f: thaw(kt[i]) for i, f in enumerate(lst.row_key)},
                       left_row=lrows[li] if li is not None else None,
                       right_row=rrows[ri] if ri is not None else None)
                for kt, li, ri in row_pairs]
    rows = Batch.from_pylist(row_t, row_vals)
    col_vals = [Struct(**{f: thaw(kt[i]) for i, f in enumerate(lst.col_key)},
                       left_col=lcols_l[li] if li is not None else None,
                       right_col=rcols_l[ri] if ri is not None else None)
                for kt, li, ri in col_pairs]
    cols = Batch.from_pylist(col_t, col_vals)

    def _side_entries(mb, st, li_list, ci_list):
        ridx = np.asarray([0 if i is None else i for i in li_list], np.int64)
        rmiss = np.asarray([i is None for i in li_list])
        cidx = np.asarray([0 if j is None else j for j in ci_list], np.int64)
        cmiss = np.asarray([j is None for j in ci_list])
        miss = rmiss[:, None] | cmiss[None, :]
        ents = {}
        for k2, c2 in mb.entries.items():
            if mb.rows.length == 0 or c2.shape[1] == 0:
                from ..ir import columns as C
                ents[k2] = C.null_column(st.entry_type[k2], (R, Cn))
                continue
            g = c2.gather(ridx, axis=0).gather(cidx, axis=1)
            ents[k2] = g.with_missing(
                (miss | g.missing_mask()).copy()) if miss.any() else g
        return StructColumn(st.entry_type, ents,
                            miss if miss.any() else None, (R, Cn))

    left_entry = _side_entries(lmb, lst, [li for _, li, _ in row_pairs],
                               [li for _, li, _ in col_pairs])
    right_entry = _side_entries(rmb, rst, [ri for _, _, ri in row_pairs],
                                [ri for _, _, ri in col_pairs])
    mb = MatrixBatch(rows, {'left_entry': left_entry,
                            'right_entry': right_entry})
    return MatrixTable(MatrixStage.from_batches(
        lst.globals, cols, list(lst.row_key), list(lst.col_key), row_t,
        col_t, entry_t, [mb]))



def pc_project(call_expr, loadings_expr, af_expr):
    """Project genotypes onto PCA loadings (reference
    experimental/pc_project.py)."""
    from ..methods.statgen import _entry_expr_to_blocks
    e = to_expr(call_expr)
    mt = e._indices.source
    ne = e.n_alt_alleles() if e.dtype == ht.tcall else e
    G, M = _entry_expr_to_blocks(ne)
    le = to_expr(loadings_expr)
    ae = to_expr(af_expr)
    src = le._indices.source
    loadings = []
    afs = []
    for i, ctx in enumerate(mt._stage.contexts):
        mb = mt._stage.partition_fn(ctx)
        env = mt._row_env(mb, i)
        lcol = le._ir.evaluate(env)
        acol = ae._ir.evaluate(env)
        loadings.extend(lcol.to_pylist())
        afs.extend(acol.to_pylist())
    keep = np.asarray([l is not None and a is not None for l, a in zip(loadings, afs)])
    L = np.asarray([l for l, k in zip(loadings, keep) if k], dtype=np.float64)
    af = np.asarray([a for a, k in zip(afs, keep) if k], dtype=np.float64)
    Gk = G[keep]
    Mk = M[keep]
    norm = np.sqrt(2 * af * (1 - af) * L.shape[0])
    Z = np.where(Mk, 0.0, (Gk - 2 * af[:, None]) / np.maximum(norm, 1e-300)[:, None])
    scores = Z.T @ L            # (n_samples, k)
    from ..ir.columns import Batch, DenseArrayColumn
    from ..table import TableStage
    st = mt._stage
    skey = st.col_key
    b = Batch({
        **{kf: st.cols.columns[kf] for kf in skey},
        'scores': DenseArrayColumn(ht.tarray(ht.tfloat64), scores,
                                   np.full(scores.shape[0], L.shape[1], np.int32)),
    }, st.n_cols)
    return Table(TableStage.from_batches(Batch({}, 1), skey, b.row_type, [b]))


def write_multiple(mts, prefix: str, overwrite: bool = False, stage_locally: bool = False):
    for i, mt in enumerate(mts):
        mt.write(f'{prefix}{i}.mt', overwrite=overwrite)


def import_gtf(path: str, reference_genome=None, skip_invalid_contigs: bool = False,
               min_partitions=None, force_bgz: bool = False, force: bool = False) -> Table:
    """Import a GTF as an interval-keyed table (reference
    experimental/import_gtf.py)."""
    from ..methods.impex import _open
    from ..genetics.locus import Locus
    from ..genetics.reference_genome import ReferenceGenome, default_reference
    from ..utils.structs import Interval, Struct
    from ..ir.columns import Batch
    from ..table import TableStage
    rg = None
    if reference_genome is not None:
        rg = ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome
    rows = []
    attr_keys = set()
    with _open(path) as f:
        for line in f:
            if line.startswith('#'):
                continue
            parts = line.rstrip('\n').split('\t')
            if len(parts) < 9:
                continue
            seqname, source, feature, start, end, score, strand, frame, attrs_s = parts[:9]
            if rg is not None and not rg.has_contig(seqname):
                if skip_invalid_contigs:
                    continue
                raise ValueError(f'invalid contig {seqname!r}')
            attrs = {}
            for item in attrs_s.rstrip(';').split(';'):
                item = item.strip()
                if ' ' in item:
                    k, v = item.split(' ', 1)
                    attrs[k] = v.strip('"')
            attr_keys |= set(attrs)
            rows.append((seqname, int(start), int(end), source, feature, score,
                         strand, frame, attrs))
    out = []
    for (seqname, start, end, source, feature, score, strand, frame, attrs) in rows:
        if rg is not None:
            iv = Interval(Locus(seqname, start, rg), Locus(seqname, end, rg), True, True)
        else:
            iv = Interval(Struct(contig=seqname, position=start),
                          Struct(contig=seqname, position=end), True, True)
        out.append(Struct(interval=iv, source=source, feature=feature,
                          score=None if score == '.' else float(score),
                          strand=strand, frame=None if frame == '.' else int(frame),
                          **{k: attrs.get(k) for k in sorted(attr_keys)}))
    pt = ht.tlocus(rg) if rg is not None else ht.tstruct(contig=ht.tstr, position=ht.tint32)
    row_t = ht.tstruct(interval=ht.tinterval(pt), source=ht.tstr, feature=ht.tstr,
                       score=ht.tfloat64, strand=ht.tstr, frame=ht.tint32,
                       **{k: ht.tstr for k in sorted(attr_keys)})
    return Table(TableStage.from_batches(Batch({}, 1), ['interval'], row_t,
                                         [Batch.from_pylist(row_t, out)]))


def ld_score(entry_expr, locus_expr, radius, coord_expr=None,
             annotation_exprs=None, block_size=None) -> Table:
    """Univariate LD scores: per variant, sum of r² with variants within
    `radius` bp (reference experimental/ld_score.py)."""
    from ..methods.statgen import _entry_expr_to_blocks
    from ..expr.expression import to_expr
    from ..ir.columns import Batch, PrimitiveColumn
    from ..table import TableStage
    e = to_expr(entry_expr)
    mt = e._indices.source
    G, M = _entry_expr_to_blocks(e)
    cnt = (~M).sum(axis=1)
    s_ = np.where(M, 0, G).sum(axis=1)
    mean = np.where(cnt > 0, s_ / np.maximum(cnt, 1), 0.0)
    G = np.where(M, mean[:, None], G)
    centered = G - G.mean(axis=1, keepdims=True)
    ss = np.sqrt((centered * centered).sum(axis=1, keepdims=True))
    Z = np.where(ss > 0, centered / np.where(ss > 0, ss, 1), 0.0)
    le = to_expr(locus_expr)
    gpos = []
    for i, ctx in enumerate(mt._stage.contexts):
        mb = mt._stage.partition_fn(ctx)
        env = mt._row_env(mb, i)
        col = le._ir.evaluate(env)
        gpos.append(np.asarray(col.global_position()))
    gp = np.concatenate(gpos)
    from ..ops.ldscore import ld_scores
    scores = ld_scores(Z, gp, G.shape[1], radius)
    rows_b = mt.rows()._stage.collect_single()
    key_fields = mt._stage.row_key
    cols = {k: rows_b.columns[k] for k in key_fields}
    cols['ld_score'] = PrimitiveColumn(ht.tfloat64, scores)
    row_t = ht.tstruct(**{k: c.typ for k, c in cols.items()})
    return Table(TableStage.from_batches(Batch({}, 1), key_fields, row_t,
                                         [Batch(cols, rows_b.length)]))


def _ldsc_one_pheno(y, n, x, w_init, M_, n_blocks, two_step_threshold):
    """The LDSC two-step IRWLS + block-jackknife estimator for one phenotype
    (reference experimental/ld_score_regression.py:320-520), as closed-form
    numpy over per-variant vectors. `y`/`n` use NaN for missing; rows are in
    row-key order (block boundaries follow the reference's scan)."""
    nb = n_blocks
    in2 = ~np.isnan(y)
    in1 = in2 & (y < two_step_threshold)
    m1 = int(in1.sum())
    # block assignment: separators at floor(j*m1/nb); a variant's step1 block
    # counts how many separators its exclusive in-step1 prefix count passes
    idx1 = np.concatenate([[0], np.cumsum(in1)[:-1]]).astype(np.int64)
    seps = np.floor(np.arange(nb + 1) * (m1 / nb)).astype(np.int64)
    block1 = np.searchsorted(seps, idx1, side='right') - 1
    is_sep = np.isin(idx1, seps)
    block2 = np.where(~in1 & is_sep, block1 - 1, block1)

    wif = np.maximum(w_init, 1.0)
    xf = np.maximum(x, 1.0)
    mean_n = float(np.nanmean(np.where(in2, n, np.nan)))
    mean_y = float(np.nanmean(np.where(in2, y, np.nan)))
    initial = np.array([1.0, (mean_y - 1.0) / float(x.mean())])

    def irwls_weight(b, mask):
        return np.where(mask, 1.0 / (wif * 2.0 * (b[0] + b[1] * xf) ** 2), 0.0)

    def wls2(wgt, mask, yv):
        wm = np.where(mask, wgt, 0.0)
        sww, swx = wm.sum(), (wm * x).sum()
        swxx = (wm * x * x).sum()
        ym = np.where(mask, yv, 0.0)
        swy, swxy = (wm * ym).sum(), (wm * x * ym).sum()
        return np.linalg.solve(np.array([[sww, swx], [swx, swxx]]),
                               np.array([swy, swxy]))

    y0 = np.where(in2, y, 0.0)
    # --- step 1: 3 rounds of IRWLS with h2 clipping between rounds
    b1 = initial.copy()
    wgt1 = None
    for _ in range(3):
        wgt1 = irwls_weight(b1, in1)
        raw = wls2(wgt1, in1, y0)
        h2 = min(max(raw[1] * M_ / mean_n, 0.0), 1.0)
        b1 = np.array([raw[0], h2 * mean_n / M_])
    # step 1 block jackknife (leave-one-block-out, weights from the last round)
    wm = np.where(in1, wgt1, 0.0)
    bl = np.where(in1, block1, 0)
    def blocksums(v):
        tot = v.sum()
        per = np.bincount(bl[in1], weights=v[in1], minlength=nb)
        return tot, per
    s_w = blocksums(wm); s_wx = blocksums(wm * x); s_wxx = blocksums(wm * x * x)
    s_wy = blocksums(wm * y0); s_wxy = blocksums(wm * x * y0)
    block_betas1 = np.empty((nb, 2))
    for i in range(nb):
        A = np.array([[s_w[0] - s_w[1][i], s_wx[0] - s_wx[1][i]],
                      [s_wx[0] - s_wx[1][i], s_wxx[0] - s_wxx[1][i]]])
        rhs = np.array([s_wy[0] - s_wy[1][i], s_wxy[0] - s_wxy[1][i]])
        block_betas1[i] = np.linalg.solve(A, rhs)
    bc1 = nb * b1[None, :] - (nb - 1) * block_betas1
    var1 = (np.sum(bc1 ** 2, axis=0) - np.sum(bc1, axis=0) ** 2 / nb) / (nb - 1) / nb

    # --- step 2: slope-only IRWLS on y - step1 intercept
    b2 = initial.copy()
    wgt2 = None
    for _ in range(3):
        wgt2 = irwls_weight(b2, in2)
        yc = np.where(in2, y0 - b1[0], 0.0)
        slope = float((wgt2 * x * yc).sum() / (wgt2 * x * x).sum())
        h2 = min(max(slope * M_ / mean_n, 0.0), 1.0)
        b2 = np.array([b1[0], h2 * mean_n / M_])
    wm2 = np.where(in2, wgt2, 0.0)
    yc = np.where(in2, y0 - b1[0], 0.0)
    valid2 = in2 & (block2 >= 0)
    def blocksums2(v):
        tot = v[in2].sum()
        per = np.bincount(block2[valid2], weights=v[valid2], minlength=nb)
        return tot, per
    s2_num = blocksums2(wm2 * x * yc)
    s2_den = blocksums2(wm2 * x * x)
    block_betas2 = np.array([(s2_num[0] - s2_num[1][i]) / (s2_den[0] - s2_den[1][i])
                             for i in range(nb)])

    # --- combine the jackknives (reference's __c correction)
    w2i = 1.0 / (wif * 2.0 * (initial[0] + initial[1] * xf) ** 2)
    c = float((w2i * x).sum() / (w2i * x * x).sum())
    final = np.array([b1[0], b2[1]])
    fbb = block_betas2 - c * (block_betas1[:, 0] - final[0])
    fbb_bc = nb * final[1] - (nb - 1) * fbb
    varf = (np.sum(fbb_bc ** 2) - np.sum(fbb_bc) ** 2 / nb) / (nb - 1) / nb
    scale = M_ / mean_n
    return Struct(
        mean_chi_sq=mean_y,
        intercept=Struct(estimate=float(final[0]),
                         standard_error=float(np.sqrt(var1[0]))),
        snp_heritability=Struct(estimate=float(scale * final[1]),
                                standard_error=float(np.sqrt(scale ** 2 * varf))))


def ld_score_regression(weight_expr, ld_score_expr, chi_sq_exprs,
                        n_samples_exprs, n_blocks: int = 200,
                        two_step_threshold: int = 30,
                        n_reference_panel_variants=None) -> Table:
    """LD score regression (reference experimental/ld_score_regression.py):
    SNP-heritability and confounding intercept from GWAS summary statistics
    via the Bulik-Sullivan two-step IRWLS estimator with leave-one-block-out
    jackknife standard errors."""
    from ..expr.expression import to_expr
    from ..ir.columns import Batch
    from ..table import TableStage
    chis = list(chi_sq_exprs) if isinstance(chi_sq_exprs, (list, tuple)) else [chi_sq_exprs]
    nss = list(n_samples_exprs) if isinstance(n_samples_exprs, (list, tuple)) else [n_samples_exprs]
    assert len(chis) == len(nss) or len(nss) == 1
    if len(nss) == 1 and len(chis) > 1:
        nss = nss * len(chis)
    src = to_expr(chis[0])._indices.source
    is_mt = isinstance(src, MatrixTable)

    def collect_row(expr):
        e2 = to_expr(expr)
        vals = src._collect_expr(e2)
        return np.asarray([np.nan if v is None else float(v) for v in vals])

    w = collect_row(weight_expr)
    x = collect_row(ld_score_expr)
    if is_mt:
        if len(chis) != 1:
            raise ValueError('Only one chi_sq_expr allowed if originating '
                             'from a matrix table.')
        from ..methods.statgen import _entry_expr_to_blocks
        Y, Ym = _entry_expr_to_blocks(to_expr(chis[0]))
        N, Nm = _entry_expr_to_blocks(to_expr(nss[0]))
        Y = np.where(Ym, np.nan, Y)
        N = np.where(Nm, np.nan, N)
        ckey = src._stage.col_key
        if len(ckey) != 1:
            raise ValueError('Matrix table must be keyed by a single '
                             'phenotype field.')
        labels = [c[ckey[0]] for c in src._stage.cols.to_pylist()]
        phen_t = src._stage.col_type[ckey[0]]
        ys = [Y[:, j] for j in range(Y.shape[1])]
        ns_v = [N[:, j] for j in range(N.shape[1])]
    else:
        ys = [collect_row(c) for c in chis]
        ns_v = [collect_row(n) for n in nss]
        labels = list(range(len(ys)))
        phen_t = ht.tint32

    ok = np.isfinite(w) & np.isfinite(x)
    w, x = w[ok], x[ok]
    ys = [y[ok] for y in ys]
    ns_v = [n[ok] for n in ns_v]
    M_ = n_reference_panel_variants if n_reference_panel_variants else len(x)

    out_rows = []
    for label, y, n in zip(labels, ys, ns_v):
        res = _ldsc_one_pheno(y, n, x, w, M_, n_blocks, two_step_threshold)
        out_rows.append(Struct(phenotype=label, **dict(res.items())))
    row_t = ht.tstruct(
        phenotype=phen_t, mean_chi_sq=ht.tfloat64,
        intercept=ht.tstruct(estimate=ht.tfloat64, standard_error=ht.tfloat64),
        snp_heritability=ht.tstruct(estimate=ht.tfloat64, standard_error=ht.tfloat64))
    return Table(TableStage.from_batches(
        Batch({}, 1), ['phenotype'], row_t, [Batch.from_pylist(row_t, out_rows)]))


def phase_by_transmission(locus, alleles, c, tm=None):
    """Phase trio genotypes by transmission (reference
    experimental/phase_by_transmission.py): returns an array
    [phased_mother, phased_father, phased_proband] where unambiguous."""
    from ..genetics.call import Call
    le = to_expr(locus)
    ae = to_expr(alleles)
    ce = to_expr(c)
    t = ht.tarray(ht.tcall)

    def phase(l, al, calls):
        if calls is None:
            return None
        mother, father, child = calls
        if mother is None or father is None or child is None:
            return None
        if not (mother.is_diploid() and father.is_diploid() and child.is_diploid()):
            return None
        ma, fa, ca = set(mother.alleles), set(father.alleles), child.alleles
        # determine which child allele came from which parent
        options = []
        for a1, a2 in [(ca[0], ca[1]), (ca[1], ca[0])]:
            if a1 in ma and a2 in fa:
                options.append((a1, a2))
        options = list(dict.fromkeys(options))
        if len(options) != 1:
            return None
        from_m, from_f = options[0]
        def phase_parent(p, transmitted):
            als = p.alleles
            if transmitted in als:
                other = als[1] if als[0] == transmitted else als[0]
                return Call([transmitted, other], phased=True)
            return None
        pm = phase_parent(mother, from_m)
        pf = phase_parent(father, from_f)
        pc = Call([from_m, from_f], phased=True)
        if pm is None or pf is None:
            return None
        return [pm, pf, pc]

    return F._apply('phase_by_transmission', t, F._obj_impl_lenient(
        t, lambda l, a, calls: phase(l, a, calls)), le, ae, ce)


from .datasets import load_dataset  # noqa: E402


def simulate_phenotypes(mt, genotype, h2, pi=1.0, rg=None, annot=None,
                        popstrat=None, popstrat_var=None, exact_h2=False):
    """Simulate phenotypes with target heritability (reference
    experimental/ldscsim.py simulate_phenotypes): beta ~ N(0, h2/M) on a
    `pi` fraction of causal variants, environmental noise to 1-h2."""
    from ..methods.statgen import _entry_expr_to_blocks
    from ..context import Env
    ge = to_expr(genotype)
    src = ge._indices.source
    G, M = _entry_expr_to_blocks(ge)
    Mv, n = G.shape
    rng = np.random.default_rng(Env.next_seed())
    cnt = (~M).sum(axis=1)
    s_ = np.where(M, 0, G).sum(axis=1)
    mean = np.where(cnt > 0, s_ / np.maximum(cnt, 1), 0.0)
    G = np.where(M, mean[:, None], G)
    sd = G.std(axis=1)
    ok = sd > 0
    Z = np.where(ok[:, None], (G - mean[:, None]) / np.where(ok, sd, 1)[:, None], 0.0)
    causal = rng.random(Mv) < pi
    m_causal = max(int(causal.sum()), 1)
    beta = np.where(causal, rng.normal(0, np.sqrt(h2 / m_causal), Mv), 0.0)
    g_comp = Z.T @ beta
    if exact_h2 and g_comp.std() > 0:
        g_comp = g_comp * np.sqrt(h2) / g_comp.std()
    e_comp = rng.normal(0, np.sqrt(max(1 - h2, 0)), n)
    y = g_comp + e_comp
    from ..ir.columns import PrimitiveColumn
    from ..matrixtable import MatrixStage
    st = src._stage
    cb = st.cols.annotate(y=PrimitiveColumn(ht.tfloat64, y))
    out = MatrixTable(MatrixStage(st.globals, cb, st.row_key, st.col_key,
                                  st.row_type, cb.row_type, st.entry_type,
                                  st.contexts, st.partition_fn))
    # per-row betas as a row annotation
    batches = []
    off = 0
    from ..matrixtable import MatrixBatch
    for ctx in st.contexts:
        mb = st.partition_fn(ctx)
        col = PrimitiveColumn(ht.tfloat64, beta[off:off + mb.n_rows])
        off += mb.n_rows
        batches.append(MatrixBatch(mb.rows.annotate(beta=col), mb.entries))
    return MatrixTable(MatrixStage.from_batches(
        st.globals, cb, st.row_key, st.col_key,
        st.row_type._insert_field('beta', ht.tfloat64), cb.row_type,
        st.entry_type, batches))


def cached(path: str, make, overwrite: bool = False):
    """Compute-or-load: the explicit form of the reference's fast-restart
    execution cache (`backend/ExecutionCache.scala`) — if `path` exists,
    read it; otherwise call `make()`, write, and read back."""
    import os
    from .. import read_matrix_table, read_table
    from ..matrixtable import MatrixTable as MT
    from ..table import Table as T
    if os.path.exists(path) and not overwrite:
        with __import__('builtins').open(os.path.join(path, 'metadata.json')) as f:
            import json as _json
            kind = _json.load(f).get('kind')
        return read_matrix_table(path) if kind == 'matrix_table' else read_table(path)
    obj = make()
    obj.write(path, overwrite=True)
    return read_matrix_table(path) if isinstance(obj, MT) else read_table(path)


from .extras import (gather, spread, separate, strftime, strptime,
                     write_expression, read_expression, define_function, loop,
                     filtering_allele_frequency, haplotype_freq_em,
                     explode_trio_matrix, phase_trio_matrix_by_transmission,
                     densify, sparse_split_multi, export_entries_by_col,
                     mt_to_table_of_ndarray, block_matrices_tofiles,
                     export_block_matrices, write_block_matrices,
                     write_matrix_tables, plot_roc_curve, hail_metadata,
                     get_gene_intervals, Function)
from .datasets import DB, get_datasets_metadata
from ..context import init  # reference experimental re-exports init
