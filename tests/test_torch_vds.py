"""`hl.vds` in the port against hail_tpu, on the CPU.

- The ten tests of tests/test_vds.py, run on the port (their gVCFs are
  written here).
- On a small VariantDataset made here from a seed with numpy (12 samples;
  sites on 20, X and Y outside the PARs; 15% tri-allelic; reference blocks
  of 1 to 6 sites carrying DP and GQ; uncovered entries), every method
  against the reference's result on the same VDS: `validate` (and its
  errors), `sample_qc`, `split_multi`, `to_dense_mt`, `to_merged_sparse_mt`
  and `from_merged_representation`, the four filters (`filter_variants`
  against the reference's `filter_rows`: the reference's own raises
  TypeError, a fault the port's copy repairs), `interval_coverage`,
  `impute_sex_chromosome_ploidy`, `truncate_reference_blocks`,
  `segment_reference_blocks`, `merge_reference_blocks`,
  `store_ref_block_max_length`, `union_rows`, `lgt_to_gt` and
  `local_to_global`, and the SVCR-VCF export and import.
- The combiner end to end on three gVCFs, in both packages, equal.
- A VDS written by each package and read by the other, equal; the port
  reads one the reference wrote in a process with jax and hail_tpu
  blocked.
- tests/test_vds_merge_semantics.py reads fixtures this tree lacks; its
  three checks run here on a VDS made in the test.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import hail_tpu as hr
import hail_tpu_torch as hlt
from hail_tpu_torch import vds as hvds
from test_torch_misc_methods import both, same


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


# ---------------------------------------------------------------------------
# tests/test_vds.py on the port
# ---------------------------------------------------------------------------

GVCF_HEADER = '''##fileformat=VCFv4.2
##FORMAT=<ID=GT,Number=1,Type=String,Description="">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="">
##INFO=<ID=END,Number=1,Type=Integer,Description="">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}
'''


def write_gvcf(path, sample, records):
    with open(path, 'w') as f:
        f.write(GVCF_HEADER.format(sample=sample))
        for rec in records:
            f.write(rec + '\n')


@pytest.fixture
def gvcfs(tmp_path):
    p1 = str(tmp_path / 's1.g.vcf')
    p2 = str(tmp_path / 's2.g.vcf')
    # S1: a block over 20:100-200, a variant at 300; S2: a variant at 150
    # (inside S1's block) and a block over 250-350 (covering S1's variant)
    write_gvcf(p1, 'S1', [
        '20\t100\t.\tA\t<NON_REF>\t.\t.\tEND=200\tGT:DP:GQ\t0/0:30:99',
        '20\t300\t.\tA\tT,<NON_REF>\t50\t.\t.\tGT:DP:GQ\t0/1:25:80',
    ])
    write_gvcf(p2, 'S2', [
        '20\t150\t.\tG\tC,<NON_REF>\t60\t.\t.\tGT:DP:GQ\t1/1:20:70',
        '20\t250\t.\tA\t<NON_REF>\t.\t.\tEND=350\tGT:DP:GQ\t0/0:28:95',
    ])
    return p1, p2


def test_transform_and_combine(gvcfs):
    p1, p2 = gvcfs
    from hail_tpu_torch.vds.combiner import (combine_variant_datasets,
                                             transform_gvcf)
    v1 = transform_gvcf(hlt.import_vcf(p1))
    assert v1.reference_data.count_rows() == 1
    assert v1.variant_data.count_rows() == 1
    assert v1.variant_data.rows().collect()[0].alleles == ['A', 'T']
    v2 = transform_gvcf(hlt.import_vcf(p2))
    merged = combine_variant_datasets([v1, v2])
    assert merged.variant_data.count_cols() == 2
    assert merged.variant_data.count_rows() == 2
    assert merged.reference_data.count_rows() == 2


def test_combiner_run_and_dense(gvcfs, tmp_path):
    p1, p2 = gvcfs
    out = str(tmp_path / 'out.vds')
    temp = str(tmp_path / 'tmp')
    os.makedirs(temp)
    c = hvds.new_combiner(output_path=out, temp_path=temp,
                          gvcf_paths=[p1, p2], reference_genome='GRCh37',
                          import_interval_size=1_000_000_000)
    c.run()
    assert c.finished
    final = hvds.read_vds(out)
    assert final.n_samples() == 2
    dense = hvds.to_dense_mt(final)
    assert dense.count_rows() == 2
    ents = {(str(e.locus), e.s): e for e in dense.entries().collect()}
    e = ents[('20:300', 'S2')]
    assert e.LGT is not None and e.LGT.is_hom_ref()
    assert e.DP == 28 and e.GQ == 95
    e2 = ents[('20:150', 'S1')]
    assert e2.LGT is not None and e2.LGT.is_hom_ref()
    assert e2.DP == 30
    assert ents[('20:300', 'S1')].LGT.is_het()
    assert ents[('20:150', 'S2')].LGT.is_hom_var()


def test_combiner_resumable(gvcfs, tmp_path):
    p1, p2 = gvcfs
    out = str(tmp_path / 'out2.vds')
    temp = str(tmp_path / 'tmp2')
    os.makedirs(temp)
    c = hvds.new_combiner(output_path=out, temp_path=temp, gvcf_paths=[p1, p2],
                          import_interval_size=1_000_000_000)
    c.save()
    c2 = hvds.load_combiner(c.save_path)
    assert c2.gvcf_paths == [p1, p2]
    c2.run()
    assert hvds.read_vds(out).n_samples() == 2


def test_vds_filters(gvcfs):
    p1, p2 = gvcfs
    from hail_tpu_torch.vds.combiner import (combine_variant_datasets,
                                             transform_gvcf)
    merged = combine_variant_datasets(
        [transform_gvcf(hlt.import_vcf(p)) for p in (p1, p2)])
    assert hvds.filter_samples(merged, ['S1']).variant_data.count_cols() == 1
    iv = hlt.eval(hlt.parse_locus_interval('20:100-200'))
    assert hvds.filter_intervals(merged, [iv]).variant_data.count_rows() == 1
    vds2 = hvds.split_multi(merged)
    assert vds2.variant_data.count_rows() >= merged.variant_data.count_rows()


def test_vds_write_read(gvcfs, tmp_path):
    p1, _ = gvcfs
    from hail_tpu_torch.vds.combiner import transform_gvcf
    v = transform_gvcf(hlt.import_vcf(p1))
    p = str(tmp_path / 'one.vds')
    v.write(p)
    assert hvds.read_vds(p).variant_data.count_rows() == 1
    assert v.checkpoint(str(tmp_path / 'cp.vds')).n_samples() == 1


def test_interval_coverage_and_ploidy(gvcfs):
    p1, p2 = gvcfs
    from hail_tpu_torch.vds.combiner import (combine_variant_datasets,
                                             transform_gvcf)
    merged = combine_variant_datasets(
        [transform_gvcf(hlt.import_vcf(p)) for p in (p1, p2)])
    iv = hlt.eval(hlt.parse_locus_interval('20:100-300'))
    cov = hvds.interval_coverage(merged, [iv])
    assert cov.count() == (1, 2)
    e = {x.s: x for x in cov.entries().collect()}
    assert e['S1'].bases_over_gq_threshold[0] == 101
    assert e['S1'].sum_dp == 101 * 30
    assert e['S2'].bases_over_dp_threshold[0] == 50
    civ = [hlt.eval(hlt.parse_locus_interval('20:100-201'))]
    rows = {r.s: r for r in
            hvds.impute_sex_chromosome_ploidy(merged, civ, '20').collect()}
    assert rows['S1'].autosomal_mean_dp == 30.0
    assert rows['S1'].x_ploidy == 0.0


def test_truncate_reference_blocks(gvcfs):
    p1, _ = gvcfs
    from hail_tpu_torch.vds.combiner import transform_gvcf
    v = transform_gvcf(hlt.import_vcf(p1))
    t = hvds.truncate_reference_blocks(v, max_ref_block_base_pairs=30)
    assert t.reference_data.count_rows() == 4
    ents = t.reference_data.entries().collect()
    assert ents[0].locus.position == 100 and ents[0].END == 129
    assert ents[-1].END == 200
    assert ents[-1].LEN == 200 - ents[-1].locus.position + 1


def test_lgt_to_gt_and_local_to_global():
    assert str(hlt.eval(hlt.vds.lgt_to_gt(hlt.call(0, 1),
                                          hlt.literal([0, 3])))) == '0/3'
    assert hlt.eval(hlt.vds.local_to_global(
        hlt.literal([9, 10]), hlt.literal([0, 2]), 3, 0, 'R')) == [9, 0, 10]
    assert hlt.eval(hlt.vds.local_to_global(
        hlt.literal([94, 0, 123]), hlt.literal([0, 2]), 3, 999, 'G')) == \
        [94, 999, 999, 0, 999, 123]
    assert hlt.eval(hlt.vds.local_to_global(
        hlt.literal([10]), hlt.literal([0, 2]), 3, 0, 'A')) == [0, 10]


def _ref_block_mt(pkg):
    mt = pkg.utils.range_matrix_table(3, 2)
    mt = mt.key_rows_by(locus=pkg.locus('1', 100 + mt.row_idx * 10),
                        alleles=pkg.literal(['N', '<NON_REF>']))
    mt = mt.annotate_entries(GT=pkg.call(0, 0),
                             END=pkg.or_missing(mt.row_idx == 0,
                                                pkg.int32(115 + mt.col_idx * 10)))
    return mt.filter_entries(mt.row_idx == 0)


def test_densify_fills_reference_blocks():
    d = hlt.experimental.densify(_ref_block_mt(hlt))
    ents = {(e.locus.position, e.col_idx): str(e.GT)
            for e in d.entries().collect() if e.GT is not None}
    assert ents.get((110, 0)) == '0/0' and (120, 0) not in ents
    assert ents.get((110, 1)) == '0/0' and ents.get((120, 1)) == '0/0'


def test_segment_and_merge_reference_blocks():
    def run(pkg):
        mt = _ref_block_mt(pkg)
        iv = pkg.Table.parallelize(
            [{'interval': pkg.Interval(pkg.Locus('1', 105), pkg.Locus('1', 118),
                                       True, False)}],
            pkg.dtype('struct{interval: interval<locus<GRCh37>>}')
        ).key_by('interval')
        seg = pkg.vds.segment_reference_blocks(mt, iv)
        rows = [(e.locus.position, e.col_idx, e.END)
                for e in seg.entries().collect() if e.END is not None]
        mt3 = pkg.utils.range_matrix_table(2, 1)
        mt3 = mt3.key_rows_by(locus=pkg.locus('1', 100 + mt3.row_idx * 10),
                              alleles=pkg.literal(['N', '<NON_REF>']))
        mt3 = mt3.annotate_entries(END=pkg.int32(109 + mt3.row_idx * 10), GQ=30)
        merged = pkg.vds.merge_reference_blocks(
            mt3, lambda b1, b2: b1.GQ == b2.GQ)
        out = [(e.locus.position, e.END) for e in merged.entries().collect()
               if e.END is not None]
        return rows, out
    ref, port = both(run)
    assert port == ref
    rows, out = port
    assert (105, 0, 115) in rows and (105, 1, 117) in rows
    assert out == [(100, 119)]


# ---------------------------------------------------------------------------
# a small VariantDataset made from numpy, in either package
# ---------------------------------------------------------------------------

N_SAMPLES = 12
SITES = (('20', 40), ('X', 24), ('Y', 12))
START = 3_000_000        # past the PARs of X and Y in GRCh37
MALES = np.arange(N_SAMPLES) < N_SAMPLES // 2


def vds_arrays(seed, n_samples=N_SAMPLES, sites=SITES, max_block=6,
               triallelic=0.15, uncovered_share=0.05):
    """The numpy arrays of a VDS with the combiner's schema: per site its
    contig, position and alleles; per entry the global calls (j <= k), a
    variant mask, LGT / LA / LAD / DP / GQ of the variant entries, and the
    reference blocks (start mask, END, DP, GQ) over the hom-ref entries,
    1 to `max_block` sites each, never across a contig. Females have no
    data on Y; males' reference DP on X is halved."""
    rng = np.random.default_rng(seed)
    contig = np.concatenate([[c] * n for c, n in sites])
    pos = np.concatenate([START + 10 * np.arange(n) for _, n in sites])
    V, N = contig.size, n_samples
    n_all = np.where(rng.random(V) < triallelic, 3, 2)
    af1 = rng.uniform(0.05, 0.4, V)
    af2 = np.where(n_all == 3, rng.uniform(0.05, 0.2, V), 0.0)
    al = []
    for _ in range(2):
        u = rng.random((V, N))
        al.append(np.where(u < af1[:, None], 1,
                           np.where(u < (af1 + af2)[:, None], 2, 0)))
    j, k = np.minimum(*al), np.maximum(*al)
    uncovered = rng.random((V, N)) < uncovered_share
    uncovered |= (contig == 'Y')[:, None] & ~MALES[None, :N]
    var = (k > 0) & ~uncovered
    homref = ~var & ~uncovered
    j[~var], k[~var] = 0, 0
    alleles = [['A', 'G', 'T'] if n == 3 else (['A', 'G'] if i % 3 else
                                               ['A', 'C'])
               for i, n in enumerate(n_all)]
    width = np.where((j > 0) & (j < k), 3, 2)
    la = np.stack([np.zeros_like(j), np.where(width == 3, j, k),
                   np.where(width == 3, k, 0)], axis=2)
    lgt = np.stack([(j > 0).astype(int), np.where(width == 3, 2, 1)], axis=2)
    lad = rng.integers(0, 30, (V, N, 3))
    v_dp = lad.sum(axis=2) + rng.integers(0, 5, (V, N))
    v_gq = rng.integers(0, 99, (V, N))
    start = np.zeros((V, N), bool)
    cover = np.full((V, N), -1)
    left = np.zeros(N, int)
    open_row = np.full(N, -1)
    for i in range(V):
        h = homref[i]
        same_contig = i > 0 and contig[i] == contig[i - 1]
        cont = h & (left > 0) & (open_row >= 0) & same_contig
        new = h & ~cont
        draw = rng.integers(1, max_block + 1, N)
        left = np.where(new, draw - 1, np.where(cont, left - 1, 0))
        open_row = np.where(h, np.where(new, i, open_row), -1)
        start[i] = new
        cover[i] = open_row
    nxt = np.vstack([cover[1:], np.full((1, N), -1)])
    last_r, last_s = np.nonzero((cover >= 0) & (nxt != cover))
    r_end = np.zeros((V, N), int)
    r_end[cover[last_r, last_s], last_s] = pos[last_r] + rng.integers(
        0, 10, last_r.size)
    r_dp = rng.integers(10, 60, (V, N))
    r_dp = np.where((contig == 'X')[:, None] & MALES[None, :N], r_dp // 2,
                    r_dp)
    r_gq = rng.integers(0, 99, (V, N))
    return dict(contig=contig, pos=pos, alleles=alleles, j=j, k=k, var=var,
                la=la, width=width, lgt=lgt, lad=lad, v_dp=v_dp, v_gq=v_gq,
                start=start, r_end=r_end, r_dp=r_dp, r_gq=r_gq,
                samples=[f'S{i:02d}' for i in range(N)])


def vds_of(pkg, a, n_parts=3):
    """The VariantDataset of `pkg` holding the arrays `a`, rows split into
    `n_parts` partitions of sites."""
    ht, C, M = pkg.types, pkg.ir.columns, pkg.matrixtable
    rg = pkg.get_reference('GRCh37')
    V, N = a['j'].shape
    cols = C.Batch.from_pylist(ht.tstruct(s=ht.tstr),
                               [pkg.Struct(s=s) for s in a['samples']])
    v_ent_t = ht.tstruct(LGT=ht.tcall, LA=ht.tarray(ht.tint32),
                         LAD=ht.tarray(ht.tint32), DP=ht.tint32, GQ=ht.tint32)
    r_ent_t = ht.tstruct(END=ht.tint32, DP=ht.tint32, GQ=ht.tint32)
    v_row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    r_row_t = ht.tstruct(locus=ht.tlocus(rg))
    bounds = np.linspace(0, V, n_parts + 1).astype(int)
    vmbs, rmbs = [], []
    for p in range(n_parts):
        sites = range(int(bounds[p]), int(bounds[p + 1]))
        rows = C.Batch.from_pylist(v_row_t, [pkg.Struct(
            locus=pkg.Locus(a['contig'][i], int(a['pos'][i]), rg),
            alleles=a['alleles'][i]) for i in sites])
        ents = {f: [] for f in v_ent_t.fields}
        for i in sites:
            for s in range(N):
                ok = a['var'][i, s]
                w = int(a['width'][i, s])
                ents['LGT'].append(pkg.Call(a['lgt'][i, s].tolist())
                                   if ok else None)
                ents['LA'].append(a['la'][i, s, :w].tolist() if ok else None)
                ents['LAD'].append(a['lad'][i, s, :w].tolist() if ok else None)
                ents['DP'].append(int(a['v_dp'][i, s]) if ok else None)
                ents['GQ'].append(int(a['v_gq'][i, s]) if ok else None)
        filt = ~a['var'][list(sites)]
        vmbs.append(M.MatrixBatch(rows, {
            f: C.from_pylist(v_ent_t[f], v).reshape((len(sites), N))
            for f, v in ents.items()}, filt))
        keep = [i for i in sites if a['start'][i].any()]
        rows = C.Batch.from_pylist(r_row_t, [pkg.Struct(
            locus=pkg.Locus(a['contig'][i], int(a['pos'][i]), rg))
            for i in keep])
        ents = {f: [] for f in r_ent_t.fields}
        for i in keep:
            for s in range(N):
                ok = a['start'][i, s]
                for f, key in (('END', 'r_end'), ('DP', 'r_dp'),
                               ('GQ', 'r_gq')):
                    ents[f].append(int(a[key][i, s]) if ok else None)
        rmbs.append(M.MatrixBatch(rows, {
            f: C.from_pylist(r_ent_t[f], v).reshape((len(keep), N))
            for f, v in ents.items()}, ~a['start'][keep]))
    vd = M.MatrixTable(M.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus', 'alleles'], ['s'], v_row_t,
        ht.tstruct(s=ht.tstr), v_ent_t, vmbs))
    rd = M.MatrixTable(M.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus'], ['s'], r_row_t,
        ht.tstruct(s=ht.tstr), r_ent_t, rmbs))
    return pkg.vds.VariantDataset(rd, vd)


@pytest.fixture(scope='module')
def arrays():
    return vds_arrays(11)


def mt_data(mt):
    """Rows, columns, globals and entries of a MatrixTable, collected."""
    return (mt.rows().collect(), mt.cols().collect(),
            mt.globals.collect()[0], mt.entries().collect())


def vds_data(v):
    return mt_data(v.reference_data), mt_data(v.variant_data)


def on_both(a, fn, n_parts=3):
    """fn(pkg, vds) for the reference and the port, each on its own VDS of
    the arrays `a`; equal results (floats at rtol 1e-12)."""
    ref, port = both(lambda pkg: fn(pkg, vds_of(pkg, a, n_parts)))
    assert same(ref, port)
    return port


def test_small_vds_is_valid(arrays):
    port = on_both(arrays, lambda pkg, v: vds_data(v.validate()))
    assert len(port[1][3]) == int(arrays['var'].sum())


def test_validate_errors(arrays):
    def errors(pkg, v):
        out = []
        bad = pkg.vds.VariantDataset(
            v.reference_data.annotate_entries(
                END=v.reference_data.END - 100),
            v.variant_data)
        for case in (bad, pkg.vds.VariantDataset(
                v.reference_data, v.variant_data.key_cols_by(
                    s=v.variant_data.s + '_x'))):
            with pytest.raises(ValueError) as e:
                case.validate()
            out.append(str(e.value))
        return out
    port = on_both(arrays, errors)
    assert 'negative LEN' in port[0] and 'column keys' in port[1]


@pytest.mark.parametrize('bins', [None, ((0, 10, 40), (0, 20))])
def test_sample_qc(arrays, bins):
    def run(pkg, v):
        kw = {} if bins is None else dict(gq_bins=bins[0], dp_bins=bins[1])
        t = pkg.vds.sample_qc(v, **kw)
        return t.collect(), t.globals.collect()
    port = on_both(arrays, run)
    a = arrays
    het = (a['var'] & (a['j'] != a['k'])).sum(axis=0)
    assert [r.n_het for r in port[0]] == het.tolist()


def test_split_multi(arrays):
    def run(pkg, v):
        s = pkg.vds.split_multi(v)
        return vds_data(s)
    port = on_both(arrays, run)
    n_split = sum(len(al) - 1 for al in arrays['alleles'])
    assert len(port[1][0]) == n_split
    assert all(len(r.alleles) == 2 for r in port[1][0])


@pytest.mark.parametrize('split', [False, True])
def test_to_dense_mt(arrays, split):
    def run(pkg, v):
        if split:
            v = pkg.vds.split_multi(v)
        return mt_data(pkg.vds.to_dense_mt(v))
    port = on_both(arrays, run)
    a = arrays
    ents = {(e.locus.contig, e.locus.position, e.s): e for e in port[3]}
    # an entry with no variant call and a covering block: a hom-ref call
    # and the block's DP and GQ; an uncovered one is filtered
    covered_ref = (~a['var']) & ~((a['contig'] == 'Y')[:, None]
                                  & ~MALES[None, :])
    seen = 0
    for i in range(len(a['pos'])):
        for s in range(N_SAMPLES):
            key = (a['contig'][i], int(a['pos'][i]), a['samples'][s])
            if a['var'][i, s]:
                assert key in ents
            elif key in ents and covered_ref[i, s]:
                e = ents[key]
                gt = e.GT if split else e.LGT
                assert gt.is_hom_ref()
                seen += 1
    assert seen > 100


def test_to_merged_sparse_mt_round_trip(arrays):
    def run(pkg, v):
        m = pkg.vds.to_merged_sparse_mt(
            v, ref_allele_function=lambda locus, i: 'N')
        back = pkg.vds.VariantDataset.from_merged_representation(m)
        return mt_data(m), vds_data(back)
    on_both(arrays, run)


def test_filters(arrays):
    def run(pkg, v):
        keep = ['S01', 'S04', 'S07']
        fs = pkg.vds.filter_samples(v, keep)
        fs_out = pkg.vds.filter_samples(v, keep, keep=False)
        ivs = [pkg.eval(pkg.parse_locus_interval('20:3000050-3000200')),
               pkg.eval(pkg.parse_locus_interval('X:3000000-3000101'))]
        fi = pkg.vds.filter_intervals(v, ivs)
        fi_split = pkg.vds.filter_intervals(v, ivs,
                                            split_reference_blocks=True)
        fi_out = pkg.vds.filter_intervals(v, ivs, keep=False)
        fc = [pkg.vds.filter_chromosomes(v, keep='X'),
              pkg.vds.filter_chromosomes(v, remove=['X', 'Y']),
              pkg.vds.filter_chromosomes(v, keep_autosomes=True)]
        return [vds_data(x) for x in [fs, fs_out, fi, fi_split, fi_out] + fc]
    port = on_both(arrays, run)
    assert len(port[0][1][1]) == 3 and len(port[1][1][1]) == N_SAMPLES - 3
    assert {r.locus.contig for r in port[5][1][0]} == {'X'}
    assert {r.locus.contig for r in port[7][1][0]} == {'20'}
    # split_reference_blocks clips every block to the intervals
    for e in port[3][0][3]:
        if e.END is not None:
            assert (e.locus.contig == '20' and e.END <= 3_000_200) or \
                (e.locus.contig == 'X' and e.END <= 3_000_101)


@pytest.mark.parametrize('key', [['locus', 'alleles'], ['locus']])
def test_filter_variants(arrays, key):
    """filter_variants keeps (or drops) the variant rows whose key, or key
    prefix, is in the table: equal to the reference's filter_rows on the
    same rows. The reference's own filter_variants raises TypeError here
    (it hashes the alleles list); the port's copy repairs that."""
    def table(pkg, v):
        rows = v.variant_data.rows()
        return rows.filter(rows.locus.position % 20 == 0).key_by(*key).select()

    def with_filter_rows(pkg, v):
        vd = v.variant_data
        sel = vd.locus.position % 20 == 0
        return [vds_data(pkg.vds.VariantDataset(v.reference_data,
                                                vd.filter_rows(sel, keep=k)))
                for k in (True, False)]
    want = with_filter_rows(hr, vds_of(hr, arrays))
    v = vds_of(hlt, arrays)
    got = [vds_data(hlt.vds.filter_variants(v, table(hlt, v), keep=k))
           for k in (True, False)]
    assert same(want, got)
    assert 0 < len(got[0][1][0]) < len(arrays['pos'])
    rv = vds_of(hr, arrays)
    with pytest.raises(TypeError, match='unhashable'):
        hr.vds.filter_variants(rv, table(hr, rv))


def test_interval_coverage(arrays):
    def run(pkg, v):
        ivs = [pkg.eval(pkg.parse_locus_interval(s)) for s in
               ('20:3000000-3000400', 'X:3000030-3000100', 'Y:3000000-3000120')]
        return mt_data(pkg.vds.interval_coverage(
            v, ivs, gq_thresholds=(0, 20, 50), dp_thresholds=(0, 15, 30)))
    port = on_both(arrays, run)
    assert len(port[0]) == 3 and len(port[3]) == 3 * N_SAMPLES


@pytest.mark.parametrize('use_variant_dataset', [False, True])
def test_impute_sex_chromosome_ploidy(arrays, use_variant_dataset):
    def run(pkg, v):
        ivs = [pkg.eval(pkg.parse_locus_interval(s)) for s in
               ('20:3000000-3000400', 'X:3000000-3000240',
                'Y:3000000-3000120')]
        return pkg.vds.impute_sex_chromosome_ploidy(
            v, ivs, '20', use_variant_dataset=use_variant_dataset).collect()
    port = on_both(arrays, run)
    # females have no data on Y
    assert [r.y_mean_dp == 0 for r in port] == (~MALES).tolist()


@pytest.mark.parametrize('how', ['bp', 'winsorize'])
def test_truncate_reference_blocks_parity(arrays, how):
    def run(pkg, v):
        kw = (dict(max_ref_block_base_pairs=25) if how == 'bp'
              else dict(ref_block_winsorize_fraction=0.1))
        t = pkg.vds.truncate_reference_blocks(v, **kw)
        return vds_data(t), pkg.vds.sample_qc(t).collect()
    port = on_both(arrays, run)
    rbml = port[0][0][2].ref_block_max_length
    assert all(e.END - e.locus.position + 1 <= rbml
               for e in port[0][0][3] if e.END is not None)


def test_segment_reference_blocks(arrays):
    def run(pkg, v):
        t = pkg.Table.parallelize(
            [{'interval': pkg.eval(pkg.parse_locus_interval(s))}
             for s in ('20:3000015-3000105', 'X:3000000-3000055')],
            pkg.dtype('struct{interval: interval<locus<GRCh37>>}')
        ).key_by('interval')
        return mt_data(pkg.vds.segment_reference_blocks(v.reference_data, t))
    port = on_both(arrays, run)
    assert all(r.locus.position >= 3_000_000 for r in port[0])


def test_merge_reference_blocks(arrays):
    def run(pkg, v):
        rd = v.reference_data
        v.reference_data = rd.annotate_entries(GQ=rd.GQ - rd.GQ % 50,
                                               N_BLOCKS=1)
        m = pkg.vds.merge_reference_blocks(
            v, equivalence_function=lambda b1, b2: b1.GQ == b2.GQ,
            merge_functions={'DP': 'min', 'N_BLOCKS': 'sum'})
        return vds_data(m), mt_data(pkg.vds.to_dense_mt(m))
    port = on_both(arrays, run)
    assert sum(e.N_BLOCKS for e in port[0][0][3] if e.N_BLOCKS is not None) \
        == int(arrays['start'].sum())


def test_store_ref_block_max_length_and_union_rows(arrays, tmp_path):
    def run(pkg, v):
        d = str(tmp_path / pkg.__name__)
        p = os.path.join(d, 'a.vds')
        v.write(p)
        pkg.vds.store_ref_block_max_length(p)
        r = pkg.vds.read_vds(p)
        x = pkg.vds.filter_chromosomes(r, keep='X')
        y = pkg.vds.filter_chromosomes(r, keep='Y')
        u = pkg.vds.VariantDataset.union_rows(x, y)
        pkg.vds.write_variant_datasets([x], [os.path.join(d, 'x.vds')])
        dense = pkg.vds.read_dense_mt(os.path.join(d, 'x.vds'))
        return vds_data(r), vds_data(u), mt_data(dense), \
            str(r.reference_genome)
    port = on_both(arrays, run)
    longest = int(np.max(np.where(arrays['start'], arrays['r_end']
                                  - arrays['pos'][:, None] + 1, 0)))
    assert port[0][0][2].ref_block_max_length == longest
    assert {r.locus.contig for r in port[1][1][0]} == {'X', 'Y'}


def test_lgt_to_gt_on_variant_data(arrays):
    a = arrays

    def run(pkg, v):
        vd = v.variant_data
        g = vd.annotate_entries(
            GT=pkg.vds.lgt_to_gt(vd.LGT, vd.LA),
            AD=pkg.vds.local_to_global(vd.LAD, vd.LA,
                                       pkg.len(vd.alleles), 0, 'R'))
        return g.entries().collect()
    port = on_both(a, run)
    site = {(c, int(p)): i for i, (c, p) in enumerate(zip(a['contig'],
                                                          a['pos']))}
    for e in port:
        i = site[e.locus.contig, e.locus.position]
        s = int(e.s[1:])
        assert sorted(e.GT.alleles) == [int(a['j'][i, s]), int(a['k'][i, s])]


def test_svcr_vcf_export_import(arrays, tmp_path):
    def run(pkg, v):
        p = str(tmp_path / f'{pkg.__name__}.vcf')
        v = pkg.vds.truncate_reference_blocks(v, max_ref_block_base_pairs=40)
        # read_vds gives the reference data LEN beside END
        v = v.checkpoint(str(tmp_path / f'{pkg.__name__}.vds'))
        pkg.vds.export_vcf(v, p)
        back = pkg.vds.import_vcf(p)
        return vds_data(back), open(p).read().count('\n')
    port = on_both(arrays, run)
    assert port[0][0][2].ref_block_max_length == 40


# ---------------------------------------------------------------------------
# the combiner end to end on three gVCFs
# ---------------------------------------------------------------------------

def _three_gvcfs(tmp_path):
    rng = np.random.default_rng(12)
    paths = []
    for n in range(3):
        recs, p = [], 10_000
        while p < 12_000:
            if rng.random() < 0.3:
                alt = ['T', 'C', 'G'][int(rng.integers(0, 3))]
                gt = ['0/1', '1/1'][int(rng.integers(0, 2))]
                recs.append(f'20\t{p}\t.\tA\t{alt},<NON_REF>\t50\t.\t.\t'
                            f'GT:DP:GQ\t{gt}:{int(rng.integers(5, 40))}:'
                            f'{int(rng.integers(10, 99))}')
                p += 1
            else:
                end = p + int(rng.integers(0, 120))
                recs.append(f'20\t{p}\t.\tA\t<NON_REF>\t.\t.\tEND={end}\t'
                            f'GT:DP:GQ\t0/0:{int(rng.integers(5, 40))}:'
                            f'{int(rng.integers(10, 99))}')
                p = end + 1
        path = str(tmp_path / f'g{n}.g.vcf')
        write_gvcf(path, f'G{n}', recs)
        paths.append(path)
    return paths


def test_combiner_end_to_end(tmp_path):
    paths = _three_gvcfs(tmp_path)

    def run(pkg):
        out = str(tmp_path / f'{pkg.__name__}.vds')
        temp = str(tmp_path / f'{pkg.__name__}_tmp')
        os.makedirs(temp)
        c = pkg.vds.new_combiner(output_path=out, temp_path=temp,
                                 gvcf_paths=paths, reference_genome='GRCh37',
                                 import_interval_size=1_000_000_000,
                                 gvcf_batch_size=2, branch_factor=2)
        c.run()
        v = pkg.vds.read_vds(out)
        v.validate()
        return vds_data(v), mt_data(pkg.vds.to_dense_mt(v)), \
            pkg.vds.sample_qc(v).collect()
    ref, port = both(run)
    assert same(ref, port)
    assert len(port[0][1][1]) == 3 and len(port[1][0]) > 10


# ---------------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('writer', ['reference', 'port'])
def test_vds_read_by_the_other_package(arrays, tmp_path, writer):
    w, r = (hr, hlt) if writer == 'reference' else (hlt, hr)
    p = str(tmp_path / 'cross.vds')
    split = w.vds.split_multi(vds_of(w, arrays))
    w.vds.truncate_reference_blocks(split, max_ref_block_base_pairs=30).write(p)
    w.vds.store_ref_block_max_length(p)
    assert same(vds_data(r.vds.read_vds(p)), vds_data(w.vds.read_vds(p)))
    assert same(vds_data(w.vds.read_vds(p)), vds_data(r.vds.read_vds(p)))
    assert same(mt_data(r.vds.read_dense_mt(p)),
                mt_data(w.vds.read_dense_mt(p)))


_DIGEST = r'''
import json, sys
sys.modules['jax'] = None
sys.modules['hail_tpu'] = None
import hail_tpu_torch as hl
hl.init(device='cpu', quiet=True)
v = hl.vds.read_vds(sys.argv[1])
v.validate()
out = {}
for name, mt in (('ref', v.reference_data), ('var', v.variant_data)):
    out[name] = [repr(sorted((k, repr(x)) for k, x in e.items()))
                 for e in mt.entries().collect()]
out['dense'] = [repr(sorted((k, repr(x)) for k, x in e.items()))
                for e in hl.vds.to_dense_mt(v).entries().collect()]
loaded = [m for m in sys.modules if m == 'hail_tpu' or m.startswith('hail_tpu.')
          or m == 'jax' or m.startswith('jax.')]
loaded = [m for m in loaded if sys.modules[m] is not None]
print(json.dumps({'digest': out, 'loaded': loaded}))
'''


def _digest(pkg, path):
    v = pkg.vds.read_vds(path)
    out = {}
    for name, mt in (('ref', v.reference_data), ('var', v.variant_data)):
        out[name] = [repr(sorted((k, repr(x)) for k, x in e.items()))
                     for e in mt.entries().collect()]
    out['dense'] = [repr(sorted((k, repr(x)) for k, x in e.items()))
                    for e in pkg.vds.to_dense_mt(v).entries().collect()]
    return out


def test_port_reads_reference_vds_without_the_reference(arrays, tmp_path):
    """A process with jax and hail_tpu blocked reads a VDS the reference
    wrote (its LA and LAD included) and sees what the port in this process
    sees."""
    p = str(tmp_path / 'ref.vds')
    vds_of(hr, arrays).write(p)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, '-c', _DIGEST, p], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got['loaded'] == []
    assert got['digest'] == _digest(hlt, p)
    assert len(got['digest']['var']) == int(arrays['var'].sum())


# ---------------------------------------------------------------------------
# tests/test_vds_merge_semantics.py on a VDS made here
# ---------------------------------------------------------------------------

def _chain_vds(pkg):
    """One contig, three samples. S0's blocks at 100-109 (GQ 20, MIN_DP 9),
    110-119 (GQ 21, MIN_DP 8) and 120-129 (GQ 30) sit in consecutive rows:
    the first two form a chain of equal GQ bins whose MIN_DP differ. S1's
    three blocks, 100-139, form one chain; S2 has blocks only in rows of
    its own (140-160). A variant at 105 is called in S2 only."""
    ht, C, M = pkg.types, pkg.ir.columns, pkg.matrixtable
    rg = pkg.get_reference('GRCh37')
    starts = [100, 110, 120, 140, 150]
    cells = {  # (row, sample): (END, GQ, MIN_DP, DP)
        (0, 0): (109, 20, 9, 12), (1, 0): (119, 21, 8, 10),
        (2, 0): (129, 30, 7, 9), (0, 1): (109, 40, 15, 18),
        (1, 1): (119, 42, 14, 17), (2, 1): (139, 45, 13, 16),
        (3, 2): (149, 10, 3, 4), (4, 2): (160, 12, 4, 5)}
    ent_t = ht.tstruct(END=ht.tint32, GQ=ht.tint32, MIN_DP=ht.tint32,
                       DP=ht.tint32)
    flat = {f: [] for f in ent_t.fields}
    filt = np.ones((5, 3), bool)
    for r in range(5):
        for s in range(3):
            v = cells.get((r, s))
            filt[r, s] = v is None
            for f, x in zip(ent_t.fields, v or (None,) * 4):
                flat[f].append(x)
    cols = C.Batch.from_pylist(ht.tstruct(s=ht.tstr),
                               [pkg.Struct(s=f'S{i}') for i in range(3)])
    rows = C.Batch.from_pylist(ht.tstruct(locus=ht.tlocus(rg)), [
        pkg.Struct(locus=pkg.Locus('22', p, rg)) for p in starts])
    rd = M.MatrixTable(M.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus'], ['s'],
        ht.tstruct(locus=ht.tlocus(rg)), ht.tstruct(s=ht.tstr), ent_t,
        [M.MatrixBatch(rows, {f: C.from_pylist(ent_t[f], v).reshape((5, 3))
                              for f, v in flat.items()}, filt)]))
    v_ent_t = ht.tstruct(LGT=ht.tcall, LA=ht.tarray(ht.tint32),
                         DP=ht.tint32, GQ=ht.tint32, MIN_DP=ht.tint32)
    vrows = C.Batch.from_pylist(
        ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr)),
        [pkg.Struct(locus=pkg.Locus('22', 105, rg), alleles=['A', 'G'])])
    vals = {'LGT': [None, None, pkg.Call([0, 1])], 'LA': [None, None, [0, 1]],
            'DP': [None, None, 11], 'GQ': [None, None, 50],
            'MIN_DP': [None, None, None]}
    vd = M.MatrixTable(M.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus', 'alleles'], ['s'],
        ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr)),
        ht.tstruct(s=ht.tstr), v_ent_t,
        [M.MatrixBatch(vrows, {f: C.from_pylist(v_ent_t[f], x).reshape((1, 3))
                               for f, x in vals.items()},
                       np.asarray([[True, True, False]]))]))
    return pkg.vds.VariantDataset(rd, vd)


def _merged_pair(pkg):
    vds = pkg.vds.filter_samples(_chain_vds(pkg), ['S0', 'S1'])
    rd = vds.reference_data
    vds.reference_data = rd.annotate_entries(GQ=rd.GQ - rd.GQ % 10)
    vds.reference_data = vds.reference_data.annotate_entries(
        LEN=vds.reference_data.END - vds.reference_data.locus.position + 1,
        N_BLOCKS=1)
    merged = pkg.vds.merge_reference_blocks(
        vds, equivalence_function=lambda b1, b2: b1.GQ == b2.GQ,
        merge_functions={'LEN': 'sum', 'MIN_DP': 'min', 'N_BLOCKS': 'sum'})
    return vds, merged


def test_filter_samples_drops_empty_rows():
    def run(pkg):
        v = _chain_vds(pkg)
        one = pkg.vds.filter_samples(v, ['S0', 'S1'])
        return v.reference_data.count_rows(), one.reference_data.count_rows()
    ref, port = both(run)
    assert port == ref
    assert port[1] < port[0]


def test_merge_invariants():
    def run(pkg):
        vds, merged = _merged_pair(pkg)
        s1 = pkg.vds.sample_qc(vds, gq_bins=(0, 10, 20, 30), dp_bins=()) \
            .select('bases_over_gq_threshold')
        s2 = pkg.vds.sample_qc(merged, gq_bins=(0, 10, 20, 30), dp_bins=()) \
            .select('bases_over_gq_threshold')
        mrd = merged.reference_data
        n_orig = vds.reference_data.entries().count()
        n_merged, sum_n = mrd.aggregate_entries(
            (pkg.agg.count(), pkg.agg.sum(mrd.N_BLOCKS)))
        lens_ok = mrd.aggregate_entries(
            pkg.agg.all(mrd.LEN == mrd.END - mrd.locus.position + 1))
        return s1._same(s2), n_orig, n_merged, sum_n, lens_ok
    ref, port = both(run)
    assert port == ref
    same_qc, n_orig, n_merged, sum_n, lens_ok = port
    assert same_qc and n_orig == sum_n and n_merged < n_orig and lens_ok


def test_merge_chain_min_dp_divergence_pinned():
    """The dense MIN_DP of S0 at the variant at 105 is the chain's min (8)
    after merging, not the covering block's 9 before it: the reference's
    merge-then-densify, pinned."""
    def run(pkg):
        vds, merged = _merged_pair(pkg)

        def dense_at(ds, pos, s):
            for r in pkg.vds.to_dense_mt(ds).entries().collect():
                if r.locus.position == pos and r.s == s:
                    return r
        return dense_at(vds, 105, 'S0'), dense_at(merged, 105, 'S0')
    ref, port = both(run)
    assert same(ref, port)
    a, b = port
    assert a.MIN_DP == 9 and b.MIN_DP == 8
