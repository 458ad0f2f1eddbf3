"""`hl.experimental` in the port against hail_tpu on the same inputs, on the
CPU.

The port's `experimental/` is the reference's with one change:
`ld_score`'s r = Z·Zᵀ, its r²
adjustment and its window sums run on the session's device
(`ops/ldscore.py`, torch f64, in row strips). So `ld_score` is held to the
reference at rtol 1e-10 (the row sums add in another order) and to a numpy
computation of the formula, and every other function gives the
reference's result exactly:
- `ld_score` at a ragged size: 257 variants on 3 contigs in 4 partitions,
  windows that cross partitions, 5% missing calls, global positions past
  2^24, an integer, a fractional, a zero and a whole-genome radius; and
  tests/test_methods.py's `test_ld_score` case;
- `pc_project`, `full_outer_join_mt` (duplicate keys on both axes),
  `ld_score_regression` (Table and MatrixTable sources),
  `simulate_phenotypes` (and `ldscsim`'s), `phase_by_transmission`,
  `phase_trio_matrix_by_transmission`, `explode_trio_matrix`,
  `import_gtf` and `get_gene_intervals` on a GTF written by the test,
  `write_multiple`, `write_matrix_tables`, `cached`, and the rest of
  `extras` (tidyr, time, expressions on disk, `define_function`, `loop`,
  `filtering_allele_frequency`, `haplotype_freq_em`, `densify`,
  `sparse_split_multi`, `export_entries_by_col`, `mt_to_table_of_ndarray`,
  the block-matrix writers, `plot_roc_curve`, `hail_metadata`);
- `load_dataset`: the registry lookup and its errors only (no network).
"""

import gzip
import importlib
import math
import os

import numpy as np
import pytest

import hail_tpu as hr
import hail_tpu_torch as hlt
from test_torch_sort import plain

PKGS = {'hail_tpu': hr, 'hail_tpu_torch': hlt}


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def rows(t):
    return [plain(r) for r in t.collect()]


# ---------------------------------------------------------------------------
# MatrixTables built the same way in both packages
# ---------------------------------------------------------------------------

def build_mt(pkg, nalt, miss, contig, pos, parts, cols=None):
    """A MatrixTable of GT calls (rows keyed by locus and alleles on GRCh37)
    in partitions of the given sizes; `cols` maps column field names to
    float arrays beside the key `s`."""
    ht = importlib.import_module(f'{pkg}.types')
    call = importlib.import_module(f'{pkg}.genetics.call')
    C = importlib.import_module(f'{pkg}.ir.columns')
    mtm = importlib.import_module(f'{pkg}.matrixtable')
    rgm = importlib.import_module(f'{pkg}.genetics.reference_genome')
    rg = rgm.default_reference()
    n = nalt.shape[1]
    mbs, start = [], 0
    for size in parts:
        sl = slice(start, start + size)
        start += size
        alleles = np.empty(size, dtype=object)
        alleles[:] = [['A', 'T']] * size
        rows_b = C.Batch({
            'locus': C.LocusColumn(ht.tlocus(rg), contig[sl].astype(np.int32),
                                   pos[sl].astype(np.int32)),
            'alleles': C.ObjectColumn(ht.tarray(ht.tstr), alleles)}, size)
        gt = call.pack_diploid((nalt[sl] == 2).astype(np.int32),
                               (nalt[sl] >= 1).astype(np.int32))
        mbs.append(mtm.MatrixBatch(rows_b, {'GT': C.PrimitiveColumn(
            ht.tcall, gt, miss[sl])}))
    fields = {'s': C.ObjectColumn(ht.tstr, np.asarray(
        [f's{i}' for i in range(n)], object))}
    col_t = {'s': ht.tstr}
    for name, v in (cols or {}).items():
        fields[name] = C.PrimitiveColumn(ht.tfloat64, np.asarray(v, float))
        col_t[name] = ht.tfloat64
    return mtm.MatrixTable(mtm.MatrixStage.from_batches(
        C.Batch({}, 1), C.Batch(fields, n), ['locus', 'alleles'], ['s'],
        ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr)),
        ht.tstruct(**col_t), ht.tstruct(GT=ht.tcall), mbs))


def ragged_data(seed=0, n=40):
    """257 variants on contigs 1, 2 and 3 (100, 100, 57) with positions past
    2^24, in partitions of 64, 70, 61 and 62 rows; allele frequencies drift
    along the genome so that neighbours are in LD; 5% missing."""
    rng = np.random.default_rng(seed)
    m = 257
    contig = np.repeat([0, 1, 2], [100, 100, 57])
    pos = np.concatenate([20_000_000 + np.cumsum(rng.integers(50, 400, 100)),
                          np.cumsum(rng.integers(50, 400, 100)),
                          30_000_000 + np.cumsum(rng.integers(50, 400, 57))])
    base = rng.integers(0, 3, (1, n))
    flips = rng.random((m, n)) < 0.15
    nalt = np.where(flips, rng.integers(0, 3, (m, n)), np.repeat(base, m, 0))
    nalt[rng.random(m) < 0.3] = rng.integers(0, 3, n)
    nalt[17] = 1                                    # a constant variant
    miss = rng.random((m, n)) < 0.05
    return nalt, miss, contig, pos, (64, 70, 61, 62)


def ld_score_oracle(nalt, miss, contig, pos, radius):
    """The reference's formula in numpy f64."""
    G = nalt.astype(np.float64)
    cnt = (~miss).sum(axis=1)
    mean = np.where(cnt > 0, np.where(miss, 0, G).sum(axis=1)
                    / np.maximum(cnt, 1), 0.0)
    G = np.where(miss, mean[:, None], G)
    c = G - G.mean(axis=1, keepdims=True)
    ss = np.sqrt((c * c).sum(axis=1, keepdims=True))
    Z = np.where(ss > 0, c / np.where(ss > 0, ss, 1), 0.0)
    from hail_tpu_torch.genetics.reference_genome import default_reference
    rg = default_reference()
    offsets = np.asarray([rg._global_offsets[c] for c in rg.contigs], np.int64)
    gp = offsets[contig] + pos.astype(np.int64) - 1
    r = Z @ Z.T
    r2 = r * r
    r2 = r2 - (1 - r2) / max(G.shape[1] - 2, 1)
    return (r2 * (np.abs(gp[:, None] - gp[None, :]) <= radius)).sum(axis=1)


@pytest.mark.parametrize('radius', [1000, 2500.7, 0, 3e9])
def test_ld_score_ragged_equals_reference(radius):
    data = ragged_data()
    got, want = (rows(PKGS[p].experimental.ld_score(
        mt.GT.n_alt_alleles(), mt.locus, radius=radius))
        for p, mt in ((p, build_mt(p, *data)) for p in PKGS))
    assert len(got) == 257
    assert [r[1][:-1] for r in got] == [r[1][:-1] for r in want]
    scores = np.asarray([dict(r[1])['ld_score'] for r in got])
    np.testing.assert_allclose(
        scores, [dict(r[1])['ld_score'] for r in want], rtol=1e-10)
    np.testing.assert_allclose(scores, ld_score_oracle(*data[:4], radius),
                               rtol=1e-10)
    if radius == 1000:
        # the windows hold several variants and cross partition boundaries
        gp = data[3] + data[2] * 10 ** 9
        near = np.abs(gp[:, None] - gp[None, :]) <= radius
        assert near.sum(axis=1).max() >= 5
        assert near[63, 64] and near[133, 134]


def test_int_radius():
    from hail_tpu_torch.ops.ldscore import int_radius
    assert [int_radius(r) for r in (0, 5, 5.9, -0.5, float('nan'),
                                    float('inf'), 2 ** 70)] == \
        [0, 5, 5, -1, -1, 2 ** 62, 2 ** 62]


def _bn(h):
    """tests/test_methods.py's `bn` MatrixTable on a rewound seed sequence."""
    h.reset_global_randomness()
    mt = h.balding_nichols_model(2, 60, 80)
    return mt.annotate_cols(pheno=h.rand_norm(seed=11),
                            cov1=h.rand_norm(seed=12))


def test_ld_score_bn_equals_reference():
    got, want = (rows(h.experimental.ld_score(
        mt.GT.n_alt_alleles(), mt.locus, radius=50))
        for h, mt in ((h, _bn(h)) for h in (hlt, hr)))
    assert len(got) == 80
    for g, w in zip(got, want):
        assert g[1][:-1] == w[1][:-1]
        assert math.isclose(dict(g[1])['ld_score'], dict(w[1])['ld_score'],
                            rel_tol=1e-10)
        assert dict(g[1])['ld_score'] > 0.5


# ---------------------------------------------------------------------------
# the rest of hl.experimental: every case gives the reference's result
# ---------------------------------------------------------------------------

def _pc_project(h, tmp):
    nalt, miss, contig, pos, parts = ragged_data(seed=1)
    mt = build_mt(h.__name__, nalt, miss, contig, pos, parts)
    rng = np.random.default_rng(2)
    L = rng.normal(size=(257, 3)).tolist()
    af = np.clip(nalt.mean(axis=1) / 2, 0.05, 0.95).tolist()
    mt = mt.add_row_index('i')
    mt = mt.annotate_rows(loadings=h.literal(L)[h.int32(mt.i)],
                          af=h.literal(af)[h.int32(mt.i)])
    mt = mt.annotate_rows(loadings=h.or_missing(mt.i != 5, mt.loadings))
    return rows(h.experimental.pc_project(mt.GT, mt.loadings, mt.af))


def _outer_pair(h):
    left = h.utils.range_matrix_table(5, 4, n_partitions=2)
    left = left.key_rows_by(k=left.row_idx % 4)
    left = left.key_cols_by(c=left.col_idx % 3)
    left = left.annotate_entries(x=left.row_idx * 10 + left.col_idx)
    right = h.utils.range_matrix_table(4, 3)
    right = right.key_rows_by(k=right.row_idx + 2)
    right = right.key_cols_by(c=right.col_idx + 1)
    right = right.annotate_rows(tag=h.str(right.row_idx))
    right = right.annotate_entries(y=h.float64(right.row_idx - right.col_idx))
    return left, right


def _full_outer_join(h, tmp):
    j = h.experimental.full_outer_join_mt(*_outer_pair(h))
    return (rows(j.rows()), rows(j.cols()), rows(j.entries()))


def _ldsc_table(h):
    rng = np.random.default_rng(3)
    m = 600
    ld = rng.gamma(2.0, 20.0, m)
    chi = 1.02 + 0.25 * ld / ld.mean() * rng.chisquare(1, m)
    chi[::97] = 45.0                                 # over the two-step cut
    rows_ = [h.Struct(i=i, w=float(ld[i] + 1.0), ld=float(ld[i]),
                      chi=None if i == 11 else float(chi[i]), n=5000.0)
             for i in range(m)]
    return h.Table.parallelize(rows_, h.tstruct(
        i=h.tint32, w=h.tfloat64, ld=h.tfloat64, chi=h.tfloat64,
        n=h.tfloat64), key='i')


def _ld_score_regression(h, tmp):
    t = _ldsc_table(h)
    a = h.experimental.ld_score_regression(t.w, t.ld, [t.chi, t.chi * 1.1],
                                           t.n, n_blocks=20)
    b = h.experimental.ld_score_regression(
        t.w, t.ld, t.chi, t.n, n_blocks=10, two_step_threshold=20,
        n_reference_panel_variants=1000)
    return rows(a), rows(b)


def _ld_score_regression_mt(h, tmp):
    t = _ldsc_table(h)
    mt = h.utils.range_matrix_table(600, 2)
    mt = mt.key_cols_by(pheno=h.str(mt.col_idx))
    mt = mt.annotate_rows(**t.select('w', 'ld', 'chi', 'n')[
        h.int32(mt.row_idx)])
    mt = mt.annotate_entries(c=mt.chi * (1.0 + mt.col_idx / 10), nn=mt.n)
    return rows(h.experimental.ld_score_regression(mt.w, mt.ld, mt.c, mt.nn,
                                                   n_blocks=15))


def _simulate_phenotypes(h, tmp):
    mt = _bn(h)
    out = []
    for kw in (dict(h2=0.4), dict(h2=0.6, pi=0.3, exact_h2=True)):
        h.reset_global_randomness()
        sim = h.experimental.simulate_phenotypes(mt, mt.GT.n_alt_alleles(),
                                                 **kw)
        out += [rows(sim.cols()), rows(sim.rows())]
    ldscsim = importlib.import_module(h.__name__ + '.experimental.ldscsim')
    h.reset_global_randomness()
    sim = ldscsim.simulate_phenotypes(mt, mt.GT.n_alt_alleles(), h2=0.5)
    norm = ldscsim.normalize_genotypes(mt.GT.n_alt_alleles())
    cov = ldscsim.get_cov_matrix([0.3, 0.5, 0.2], [0.4, -0.2, 0.9],
                                 psd_rg=True)
    return out + [rows(sim.cols()), rows(norm.entries().select('norm_gt')),
                  plain(cov[0]), plain(cov[1])]


def _trio_mt(h):
    """A trio MatrixTable (as trio_matrix lays one out) of 2 trios over 6
    variants, with a missing call and ambiguous and Mendel-violating
    trios."""
    calls = [  # (mother, father, child) per row and trio, as allele pairs
        [((0, 1), (0, 0), (0, 1)), ((1, 1), (0, 1), (0, 1))],
        [((0, 1), (0, 1), (0, 1)), ((0, 0), (1, 1), (0, 1))],
        [((0, 0), (0, 0), (1, 1)), ((0, 1), (1, 1), (1, 1))],
        [((1, 1), (0, 0), (0, 1)), (None, (0, 1), (0, 1))],
        [((0, 1), (1, 1), (0, 0)), ((0, 2), (1, 2), (0, 1))],
        [((0, 2), (0, 1), (1, 2)), ((2, 2), (0, 0), (0, 2))],
    ]
    tm = h.utils.range_matrix_table(6, 2)
    tm = tm.key_rows_by(locus=h.locus('1', 1000 + tm.row_idx),
                        alleles=h.literal(['A', 'C', 'G']))
    tm = tm.key_cols_by(id=h.str(tm.col_idx))
    tm = tm.annotate_cols(
        proband=h.struct(s=h.format('kid%d', tm.col_idx)),
        father=h.struct(s=h.format('dad%d', tm.col_idx)),
        mother=h.struct(s=h.format('mom%d', tm.col_idx)))
    lit = h.literal([[[None if c is None else list(c) for c in trio]
                      for trio in row] for row in calls])
    trio = lit[h.int32(tm.row_idx)][h.int32(tm.col_idx)]

    def entry(i):
        a = trio[i]
        return h.struct(GT=h.or_missing(h.is_defined(a), h.call(a[0], a[1])),
                        DP=h.int32(10 * tm.row_idx + i))
    return tm.annotate_entries(mother_entry=entry(0), father_entry=entry(1),
                               proband_entry=entry(2))


def _phase_by_transmission(h, tmp):
    tm = _trio_mt(h)
    ph = h.experimental.phase_trio_matrix_by_transmission(tm)
    direct = tm.annotate_entries(pbt=h.experimental.phase_by_transmission(
        tm.locus, tm.alleles, [tm.mother_entry.GT, tm.father_entry.GT,
                               tm.proband_entry.GT]))
    return rows(ph.entries()), rows(direct.entries().select('pbt'))


def _explode_trio_matrix(h, tmp):
    tm = _trio_mt(h)
    out = []
    for kw in ({}, dict(keep_trio_cols=False)):
        ex = h.experimental.explode_trio_matrix(tm, **kw)
        out += [rows(ex.cols()), rows(ex.entries())]
    return out


GTF = '\n'.join([
    '#!genome-build GRCh37',
    '1\tHAVANA\tgene\t11869\t14409\t.\t+\t.\tgene_id "G1"; gene_name "DDX11L1";',
    '1\tHAVANA\ttranscript\t11869\t14409\t.\t+\t.\tgene_id "G1"; '
    'transcript_id "T1"; gene_name "DDX11L1";',
    '1\tHAVANA\texon\t11869\t12227\t3.5\t+\t0\tgene_id "G1"; '
    'transcript_id "T1"; exon_number "1";',
    '2\tENSEMBL\tgene\t38814\t46870\t.\t-\t.\tgene_id "G2"; gene_name "FAM110C";',
    'chrUn\tENSEMBL\tgene\t1\t10\t.\t-\t.\tgene_id "G3"; gene_name "X";',
    'short\tline',
]) + '\n'


def _import_gtf(h, tmp):
    path = str(tmp / 'genes.gtf')
    with open(path, 'w') as f:
        f.write(GTF)
    out = [rows(h.experimental.import_gtf(path)),
           rows(h.experimental.import_gtf(path, reference_genome='GRCh37',
                                          skip_invalid_contigs=True)),
           plain(h.experimental.get_gene_intervals(
               gene_symbols=['FAM110C'], transcript_ids=['T1'],
               reference_genome='GRCh37', gtf_file=path, verbose=False))]
    for call in (lambda: h.experimental.import_gtf(
            path, reference_genome='GRCh37'),
            lambda: h.experimental.get_gene_intervals(gene_ids=['G1'])):
        with pytest.raises(ValueError) as info:
            call()
        out.append(str(info.value))
    return out


def _writers(h, tmp):
    mt = _bn(h)
    a, b = mt.head(7), mt.head(3)
    h.experimental.write_multiple([a, b], str(tmp / 'wm_'))
    paths = h.experimental.write_matrix_tables([b, a], str(tmp / 'wmt_'))
    out = [rows(h.read_matrix_table(str(tmp / f'wm_{i}.mt')).entries())
           for i in (0, 1)]
    out += [os.path.basename(p) for p in paths]
    out.append(rows(h.read_matrix_table(paths[1]).rows()))
    made = []
    for _ in range(2):   # made once, then read back
        c = h.experimental.cached(str(tmp / 'cached.ht'),
                                  lambda: made.append(1) or mt.rows())
        out.append(rows(c))
    cm = h.experimental.cached(str(tmp / 'cached.mt'), lambda: b)
    out += [len(made), rows(cm.entries())]
    return out


def _block_matrix_writers(h, tmp):
    BM = h.linalg.BlockMatrix
    bms = [BM.from_numpy(np.arange(6.0).reshape(2, 3) / 7),
           BM.from_numpy(np.eye(2) * -1.5)]
    h.experimental.block_matrices_tofiles(bms, str(tmp / 'raw_'))
    h.experimental.export_block_matrices(bms, str(tmp / 'txt_'),
                                         header='h', add_index=True)
    h.experimental.write_block_matrices(bms, str(tmp / 'bm_'))
    out = []
    for i in (0, 1):
        with open(tmp / f'raw_{i}', 'rb') as f:
            out.append(f.read())
        with open(tmp / f'txt_{i}.tsv') as f:
            out.append(f.read())
        out.append(plain(BM.read(str(tmp / f'bm_{i}.bm')).to_numpy()))
    with pytest.raises(FileExistsError):
        h.experimental.block_matrices_tofiles(bms, str(tmp / 'raw_'))
    return out


def _export_entries_by_col(h, tmp):
    mt = _trio_mt(h).select_entries('proband_entry')
    mt = mt.annotate_entries(**mt.proband_entry).drop('proband_entry')
    mt = mt.annotate_cols(n=h.int32(mt.col_idx)).drop('proband', 'father',
                                                      'mother')
    out = []
    for bgzip, by_key in ((True, False), (False, True)):
        d = tmp / f'ebc_{bgzip}'
        h.experimental.export_entries_by_col(
            mt, str(d), bgzip=bgzip, use_string_key_as_file_name=by_key)
        for name in sorted(os.listdir(d)):
            op = gzip.open if bgzip else open
            with op(d / name, 'rt') as f:
                out.append((name, f.read()))
    return out


def _tidyr_time_loop(h, tmp):
    """tests/test_methods.py's test_experimental_extras, and more of
    tidyr and time."""
    t = h.Table.parallelize(
        [{'s': 'a', 'x': 1, 'y': 2, 'z': 'p-q'},
         {'s': 'b', 'x': 3, 'y': None, 'z': 'r-s'}],
        h.dtype('struct{s:str,x:int32,y:int32,z:str}'))
    long = h.experimental.gather(t, 'key', 'val', 'x', 'y')
    out = [rows(long), rows(h.experimental.spread(long, 'key', 'val')),
           rows(h.experimental.separate(t, 'z', ['z1', 'z2'], '-'))]
    out += [h.eval(e) for e in (
        h.experimental.loop(
            lambda recur, x, acc: h.if_else(x == 0, acc, recur(x - 1, acc + x)),
            'int32', 5, 0),
        h.experimental.strftime('%Y.%m.%d', 1562569201, 'America/New_York'),
        h.experimental.strftime('%F %T %z', 1562569201, 'GMT+2'),
        importlib.import_module(h.__name__ + '.experimental.time').strftime(
            '%D', 0, 'UTC'),
        h.experimental.strptime('2019.07.08 03:00', '%Y.%m.%d %H:%M',
                                'America/New_York'),
        h.experimental.haplotype_freq_em([20, 10, 5, 10, 10, 5, 5, 5, 5]),
        h.experimental.haplotype_freq_em([9, 0, 0, 0, 0, 0, 0, 0, 0]),
        h.experimental.filtering_allele_frequency(25, 8000, 0.95),
        h.experimental.filtering_allele_frequency(1, 8000, 0.95))]
    f = h.experimental.define_function(lambda a, b: a * 2 + b, 'int32',
                                       h.tint32)
    out.append(h.eval(f(3, 4)))
    assert isinstance(f, h.experimental.Function)
    return out


def _expressions_on_disk(h, tmp):
    value = h.struct(a=h.literal([1, 2, None]), b=h.float64(0.25),
                     c=h.literal({'k': 1.5}))
    path = str(tmp / 'expr' / 'v.bin')
    h.experimental.write_expression(value, path)
    with pytest.raises(FileExistsError):
        h.experimental.write_expression(value, path)
    h.experimental.write_expression(value, path, overwrite=True)
    back = h.experimental.read_expression(path)
    with pytest.raises(TypeError):
        h.experimental.read_expression(path, _assert_type=h.tint32)
    return plain(h.eval(back)), str(back.dtype)


def _sparse_mt(h):
    """Rows of a gVCF-style sparse MatrixTable: a reference block, a
    biallelic and a triallelic site with local alleles."""
    mt = h.utils.range_matrix_table(3, 2)
    mt = mt.key_rows_by(
        locus=h.locus('1', 100 + 10 * mt.row_idx),
        alleles=h.literal([['A'], ['A', 'T'], ['A', 'T', 'C']])[
            h.int32(mt.row_idx)])
    la = h.literal([[[0], [0]], [[0, 1], [0]], [[0, 1, 2], [0, 2]]])
    lgt = h.literal([[[0, 0], [0, 0]], [[0, 1], [0, 0]], [[1, 2], [0, 1]]])
    lad = h.literal([[[9], [8]], [[4, 5], [7]], [[1, 4, 5], [6, 3]]])
    lpl = h.literal([[[0, 30, 60], [0, 20, 40]], [[50, 0, 40], [0, 30, 60]],
                     [[90, 40, 80, 30, 0, 20], [40, 0, 70]]])
    r, c = h.int32(mt.row_idx), h.int32(mt.col_idx)
    g = lgt[r][c]
    return mt.annotate_entries(
        LA=la[r][c], LGT=h.call(g[0], g[1]), LAD=lad[r][c], LPL=lpl[r][c],
        GQ=h.int32(20 + mt.row_idx),
        END=h.or_missing((mt.row_idx == 0) & (mt.col_idx == 0), 115))


def _densify_and_split(h, tmp):
    sparse = _sparse_mt(h)
    dense = h.experimental.densify(sparse)
    split = h.experimental.sparse_split_multi(sparse.drop('END'))
    with pytest.raises(ValueError):
        h.experimental.densify(sparse.drop('END'))
    return rows(dense.entries()), rows(split.rows()), rows(split.entries())


def _to_ndarray(h, tmp):
    nalt, miss, contig, pos, _ = ragged_data(seed=4)
    mt = build_mt(h.__name__, nalt[:50], miss[:50], contig[:50], pos[:50],
                  (20, 30))
    x = mt.GT.n_alt_alleles()
    t = h.experimental.mt_to_table_of_ndarray(x, block_size=16)
    _, trailing, _ = h.experimental.mt_to_table_of_ndarray(
        x, block_size=16, window_size=5)
    return rows(t), rows(trailing)


def _plots(h, tmp):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    t = h.Table.parallelize(
        [{'s1': float(i % 7), 's2': None if i == 3 else float(-i),
          'tp': i % 3 == 0, 'fp': i % 3 != 0} for i in range(30)],
        h.dtype('struct{s1:float64,s2:float64,tp:bool,fp:bool}'))
    fig, aucs = h.experimental.plot_roc_curve(t, ['s1', 's2'])
    curves = [plain(line.get_xydata()) for line in fig.axes[0].lines]
    plt.close(fig)
    path = str(tmp / 'meta.ht')
    t.write(path)
    fig = h.experimental.hail_metadata(path)
    bars = [p.get_height() for p in fig.axes[0].patches]
    plt.close(fig)
    with pytest.raises(FileNotFoundError):
        h.experimental.hail_metadata(str(tmp))
    return aucs, curves, bars


def _load_dataset_errors(h, tmp):
    out = [plain(h.experimental.get_datasets_metadata())]
    for args, kw in (
            (('nope', None, None), {}),
            (('1000_Genomes_autosomes', 'bad', 'GRCh38'), {}),
            (('1000_Genomes_autosomes', 'phase_3', 'GRCh99'), {}),
            (('1000_Genomes_autosomes', 'phase_3', 'GRCh38'),
             dict(region='mars')),
            (('1000_Genomes_autosomes', 'phase_3', 'GRCh38'),
             dict(cloud='azure')),
            (('1000_Genomes_autosomes', 'phase_3', 'GRCh38'),
             dict(region='us', cloud='gcp'))):
        with pytest.raises(ValueError) as info:
            h.experimental.load_dataset(*args, **kw)
        out.append(str(info.value))
    return out


CASES = [_pc_project, _full_outer_join, _ld_score_regression,
         _ld_score_regression_mt, _simulate_phenotypes,
         _phase_by_transmission, _explode_trio_matrix, _import_gtf, _writers,
         _block_matrix_writers, _export_entries_by_col, _tidyr_time_loop,
         _expressions_on_disk, _densify_and_split, _to_ndarray, _plots,
         _load_dataset_errors]


@pytest.mark.parametrize('case', CASES, ids=[c.__name__[1:] for c in CASES])
def test_equals_reference(case, tmp_path):
    out = {}
    for name, h in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = plain(case(h, d))
    assert out['hail_tpu_torch'] == out['hail_tpu']


def test_full_outer_join_key_type_errors():
    for h in (hr, hlt):
        left, right = _outer_pair(h)
        with pytest.raises(ValueError, match='row key types do not match'):
            h.experimental.full_outer_join_mt(
                left, right.key_rows_by(k=h.str(right.k)))
        with pytest.raises(ValueError, match='column key types do not match'):
            h.experimental.full_outer_join_mt(
                left, right.key_cols_by(c=h.float64(right.c)))


def test_load_dataset_reads_registry_path(tmp_path, monkeypatch):
    """A registry named by HAIL_TPU_DATASETS_CONFIG is what load_dataset
    looks names up in; a local url of an unknown kind is refused before
    anything is read."""
    import json
    reg = {'mine': {'description': 'd', 'url': 'u', 'versions': [
        {'version': '1', 'reference_genome': 'GRCh37',
         'url': str(tmp_path / 'data.txt')}]}}
    path = tmp_path / 'registry.json'
    path.write_text(json.dumps(reg))
    monkeypatch.setenv('HAIL_TPU_DATASETS_CONFIG', str(path))
    msgs = []
    for h in (hr, hlt):
        assert h.experimental.get_datasets_metadata() == reg
        with pytest.raises(ValueError) as info:
            h.experimental.load_dataset('mine', '1', 'GRCh37')
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and 'Invalid path' in msgs[0]


def test_public_names_and_init():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith('_')}
    assert public(hlt.experimental) == public(hr.experimental)
    assert hlt.experimental.init is hlt.init
    for name in ('datasets', 'extras', 'ldscsim', 'time'):
        mod = importlib.import_module(f'hail_tpu_torch.experimental.{name}')
        assert mod.__name__.startswith('hail_tpu_torch.')
