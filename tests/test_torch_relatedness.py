"""Relatedness in the port against hail_tpu on the same MatrixTable, on the
CPU: `king`, `pc_relate` (k and scores_expr, every `statistics` value,
`min_kinship`, `include_self_kinship`), `maximal_independent_set` (with
and without `tie_breaker`) and `identity_by_descent`'s pair table.

The MatrixTable has two populations, a duplicate pair and a few relatives
planted among 36 samples, 3% missing calls, over 240 variants in three
partitions. Tolerances:
- KING's φ within 1e-12 (its products are integer counts, exact in f64;
  the same f64 expression on them);
- PC-Relate's kin, ibd0, ibd1 and ibd2 within rtol 1e-9, atol 1e-12: the
  products are f64 sums of 240 terms in another order, and the regression's
  solve takes its right-hand side from a product in another order;
- IBD's Z0/Z1/Z2/PI_HAT within rtol 1e-12 (the same f64 expressions of
  equal counts), and everything else exactly.
PC-Relate branches on μ against `min_individual_maf`, 0 and 1, and on kin
against the cutoff 2^(-5/2): a value within roundoff of one of these takes
either branch. The tests assert that no μ and no kin lies within 1e-9 of
one, so that a difference is a fault and not roundoff.
"""

import importlib

import numpy as np
import pytest

import hail_tpu_torch as hlt
from test_torch_sort import plain

N_SAMPLES, ROWS, PARTS = 36, 80, 3
MAF = 0.05
K0_CUTOFF = 2.0 ** (-5.0 / 2.0)
STATS_FIELDS = {'kin': ['kin'], 'kin2': ['kin', 'ibd2'],
                'kin20': ['kin', 'ibd2', 'ibd0'],
                'all': ['kin', 'ibd2', 'ibd0', 'ibd1']}


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def genotypes(seed=0, n=N_SAMPLES, m=ROWS * PARTS):
    """(nalt (m, n) int, missing (m, n) bool, two principal-component-like
    sample scores (n, 2)): two populations of allele frequencies, sample 1
    a duplicate of sample 0, samples 3-5 each half of sample 2's genotypes."""
    rng = np.random.default_rng(seed)
    anc = rng.uniform(0.15, 0.85, m)
    pops = np.arange(n) % 2
    af = np.clip(anc[:, None] + np.where(pops == 0, 0.08, -0.08)[None, :]
                 * rng.normal(size=(m, 1)), 0.05, 0.95)
    nalt = rng.binomial(2, af)
    nalt[:, 1] = nalt[:, 0]
    for j in (3, 4, 5):
        half = rng.random(m) < 0.5
        nalt[half, j] = nalt[half, 2]
    miss = rng.random((m, n)) < 0.03
    miss[:, 1] = miss[:, 0]
    scores = np.stack([pops - 0.5, rng.normal(size=n) * 0.1], axis=1)
    return nalt, miss, scores


def build_mt(pkg, seed=0, int_key=False):
    ht = importlib.import_module(f'{pkg}.types')
    call = importlib.import_module(f'{pkg}.genetics.call')
    C = importlib.import_module(f'{pkg}.ir.columns')
    mtm = importlib.import_module(f'{pkg}.matrixtable')
    rg = importlib.import_module(f'{pkg}.genetics.reference_genome')
    ref = rg.default_reference()
    nalt, miss, scores = genotypes(seed)
    mbs = []
    for p in range(PARTS):
        sl = slice(p * ROWS, (p + 1) * ROWS)
        alleles = np.empty(ROWS, dtype=object)
        alleles[:] = [['A', 'T']] * ROWS
        rows = C.Batch({
            'locus': C.LocusColumn(ht.tlocus(ref), np.zeros(ROWS, np.int32),
                                   np.arange(sl.start, sl.stop, dtype=np.int32) + 100),
            'alleles': C.ObjectColumn(ht.tarray(ht.tstr), alleles)}, ROWS)
        gt = call.pack_diploid((nalt[sl] == 2).astype(np.int32),
                               (nalt[sl] >= 1).astype(np.int32))
        mbs.append(mtm.MatrixBatch(rows, {'GT': C.PrimitiveColumn(
            ht.tcall, gt, miss[sl])}))
    if int_key:
        key = C.PrimitiveColumn(ht.tint32, np.arange(N_SAMPLES, dtype=np.int32))
    else:
        key = C.ObjectColumn(ht.tstr, np.asarray(
            [f's{i}' for i in range(N_SAMPLES)], object))
    pcs = C.DenseArrayColumn(ht.tarray(ht.tfloat64), scores,
                             np.full(N_SAMPLES, 2, np.int32))
    cols = C.Batch({'s': key, 'pcs': pcs}, N_SAMPLES)
    col_t = ht.tstruct(s=ht.tint32 if int_key else ht.tstr,
                       pcs=ht.tarray(ht.tfloat64))
    return mtm.MatrixTable(mtm.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus', 'alleles'], ['s'],
        ht.tstruct(locus=ht.tlocus(ref), alleles=ht.tarray(ht.tstr)),
        col_t, ht.tstruct(GT=ht.tcall), mbs))


def _phi(kmt):
    st = kmt._stage
    return np.concatenate([st.partition_fn(c).entries['phi'].values
                           for c in st.contexts])


def test_king_matches_reference(hl):
    got = hlt.king(build_mt('hail_tpu_torch').GT)
    want = hl.king(build_mt('hail_tpu').GT)
    phi, phi_ref = _phi(got), _phi(want)
    assert phi.shape == (N_SAMPLES, N_SAMPLES)
    np.testing.assert_allclose(phi, phi_ref, rtol=0, atol=1e-12)
    # identical genotypes give exactly 1/2: the diagonal and the duplicate
    assert (np.diag(phi) == 0.5).all() and phi[0, 1] == phi[1, 0] == 0.5
    assert str(got.entry.dtype) == str(want.entry.dtype)
    assert plain(got.cols().collect()) == plain(want.cols().collect())
    assert plain(got.rows().collect()) == plain(want.rows().collect())


def _pc_relate(pkg, mt, how, **kw):
    if how == 'k':
        return pkg.pc_relate(mt.GT, MAF, k=2, **kw)
    return pkg.pc_relate(mt.GT, MAF, scores_expr=mt.pcs, **kw)


def _margins(hl, how):
    """For the reference's pc_relate by `how`: the least distance of any μ
    (as pc_relate computes it) from min_individual_maf,
    1 - min_individual_maf, 0 and 1, and of any kin from the k0 cutoff; and
    the share of μ outside (min_individual_maf, 1 - min_individual_maf)."""
    mt = build_mt('hail_tpu')
    G, M = hl.methods.statgen._entry_expr_to_blocks(mt.GT.n_alt_alleles())
    hl.reset_global_randomness()
    if how == 'k':
        _, st, _ = hl.hwe_normalized_pca(mt.GT, k=2)
        scores = np.array([r.scores for r in st.collect()])
    else:
        scores = genotypes()[2]
    X = np.concatenate([np.ones((N_SAMPLES, 1)), scores], axis=1)
    cnt = (~M).sum(axis=1)
    mean = np.where(M, 0.0, G).sum(axis=1) / np.maximum(cnt, 1)
    B = np.linalg.solve(X.T @ X, X.T @ np.where(M, mean[:, None], G).T).T
    mu = B @ X.T / 2.0
    mu_gap = min(np.abs(mu - t).min() for t in (MAF, 1 - MAF, 0.0, 1.0))
    hl.reset_global_randomness()
    rows = _pc_relate(hl, mt, how, statistics='kin',
                      include_self_kinship=True).collect()
    kin_gap = np.abs(np.array([r.kin for r in rows]) - K0_CUTOFF).min()
    return mu_gap, kin_gap, float(((mu <= MAF) | (mu >= 1 - MAF)).mean())


@pytest.mark.parametrize('how', ['k', 'scores_expr'])
def test_inputs_keep_clear_of_pc_relate_branches(hl, how):
    mu_gap, kin_gap, outside = _margins(hl, how)
    assert mu_gap > 1e-9 and kin_gap > 1e-9, (mu_gap, kin_gap)
    # some μ fall outside the bounds, so the mask's branch is taken too
    assert 0 < outside < 0.1, outside


def _assert_pairs_close(got, want, fields):
    assert [plain((r.i, r.j)) for r in got] == [plain((r.i, r.j)) for r in want]
    for f in fields:
        np.testing.assert_allclose([r[f] for r in got], [r[f] for r in want],
                                   rtol=1e-9, atol=1e-12, err_msg=f)


@pytest.mark.parametrize('statistics', sorted(STATS_FIELDS))
@pytest.mark.parametrize('how', ['k', 'scores_expr'])
def test_pc_relate_matches_reference(hl, how, statistics):
    hl.reset_global_randomness()
    hlt.reset_global_randomness()
    got_t = _pc_relate(hlt, build_mt('hail_tpu_torch'), how,
                       statistics=statistics)
    want_t = _pc_relate(hl, build_mt('hail_tpu'), how, statistics=statistics)
    assert str(got_t.row.dtype) == str(want_t.row.dtype)
    assert list(got_t.key) == list(want_t.key)
    got, want = got_t.collect(), want_t.collect()
    assert len(got) == N_SAMPLES * (N_SAMPLES - 1) // 2
    _assert_pairs_close(got, want, STATS_FIELDS[statistics])


@pytest.mark.parametrize('include_self', [False, True])
def test_pc_relate_min_kinship_and_self_pairs(hl, include_self):
    kw = dict(statistics='all', min_kinship=0.1,
              include_self_kinship=include_self)
    got = _pc_relate(hlt, build_mt('hail_tpu_torch', int_key=True),
                     'scores_expr', **kw).collect()
    want = _pc_relate(hl, build_mt('hail_tpu', int_key=True), 'scores_expr',
                      **kw).collect()
    _assert_pairs_close(got, want, STATS_FIELDS['all'])
    pairs = {(r.i.s, r.j.s) for r in got}
    # the duplicate and the three relatives of sample 2 are kept
    assert {(0, 1), (2, 3), (2, 4), (2, 5)} <= pairs
    assert all(r.kin >= 0.1 for r in got)
    assert ((0, 0) in pairs) == include_self


@pytest.mark.parametrize('tie_breaker', [False, True])
def test_maximal_independent_set_matches_reference(hl, tie_breaker):
    def mis(pkg):
        mt = build_mt(pkg.__name__)
        pairs = pkg.pc_relate(mt.GT, MAF, scores_expr=mt.pcs,
                              statistics='kin', min_kinship=0.1)
        tb = (lambda l, r: pkg.if_else(l.s < r.s, 1, -1)) if tie_breaker \
            else None
        return pkg.maximal_independent_set(pairs.i, pairs.j, keep=False,
                                           tie_breaker=tb).collect()

    got, want = mis(hlt), mis(hl)
    assert plain(got) == plain(want)
    removed = {r.node.s for r in got}
    # one of the duplicate pair, and sample 2 (three edges) go
    assert len(removed & {'s0', 's1'}) == 1 and 's2' in removed


def test_identity_by_descent_table_equals_reference(hl):
    kw = dict(min=0.05, max=0.9)
    got_t = hlt.identity_by_descent(build_mt('hail_tpu_torch'), **kw)
    want_t = hl.identity_by_descent(build_mt('hail_tpu'), **kw)
    assert str(got_t.row.dtype) == str(want_t.row.dtype)
    assert list(got_t.key) == list(want_t.key)
    got, want = got_t.collect(), want_t.collect()
    assert 0 < len(got) < N_SAMPLES * (N_SAMPLES - 1) // 2
    assert [(r.i, r.j, r.ibs0, r.ibs1, r.ibs2) for r in got] == \
        [(r.i, r.j, r.ibs0, r.ibs1, r.ibs2) for r in want]
    for f in ('Z0', 'Z1', 'Z2', 'PI_HAT'):
        np.testing.assert_allclose([r.ibd[f] for r in got],
                                   [r.ibd[f] for r in want], rtol=1e-12,
                                   atol=0, err_msg=f)
