"""QC in the port against hail_tpu on the same inputs, on the CPU.

- `variant_qc_block`: the port's plain version (what a CPU tensor runs;
  the card runs K5, held to this plain version in
  test_torch_kernels_cuda.py) against the reference's jitted
  `hail_tpu.ops.qc.variant_qc_block`, at 37 x 53 and 64 x 1,003 and with
  no rows: ploidy 0, 1 and 2, `max_alleles` 2 and 4 with alleles at and
  above it, arbitrary bits under missing calls, DP and GQ present or
  absent with -1 sentinels, and a row with no defined DP. Counts are
  equal; f64 sums, min and max are bit-equal (DP and GQ below 2^16 keep
  every partial sum exact).
- `variant_qc`, `sample_qc`, `summarize_variants`: every row and column
  collected from both packages is equal, on a MatrixTable with GT, DP and
  GQ in 3 partitions with triallelic rows and indels, and on the inline
  data of tests/test_golden_parity.py.
- `split_multi`, `split_multi_hts` (AD, PL, DP, GQ), `filter_alleles`,
  `filter_alleles_hts` (downcode and subset), `impute_sex` (loci on X),
  `lambda_gc` and the `_nd` regression aliases: equal to the reference's
  results, floats within rtol 1e-12.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import hail_tpu as hr
import hail_tpu_torch as hlt
from test_torch_sort import plain

N_COLS = 23
PARTS = (9, 12, 10)


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def _close(a, b, rtol=1e-12):
    """Recursive equality of plain values, floats within rtol."""
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-300)
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_close(x, y, rtol) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------------------
# variant_qc_block
# ---------------------------------------------------------------------------

def _pack(ploidy, j, k):
    return (ploidy | (j << 3) | (k << 17)).astype(np.int32)


def block_inputs(R, C, A, seed):
    """Packed calls of ploidy 0-2 with alleles up to A + 2 (some at or above
    A; haploid and ploidy-0 calls keep stray bits in the allele fields they
    do not use, which only the ploidy tests keep out of the counts),
    garbage under 6% missing, DP and GQ below 2^16 with 10% -1 and a row
    (row 0) with no defined DP."""
    rng = np.random.default_rng(seed)
    ploidy = rng.choice([0, 1, 2], (R, C), p=[0.05, 0.1, 0.85])
    j = rng.integers(0, A + 2, (R, C))
    k = rng.integers(0, A + 2, (R, C))
    j, k = np.minimum(j, k), np.maximum(j, k)
    packed = _pack(ploidy, j, k)
    missing = rng.random((R, C)) < 0.06
    packed = np.where(missing, rng.integers(-2**31, 2**31, (R, C)),
                      packed).astype(np.int32)
    dp = rng.integers(0, 1 << 16, (R, C)).astype(np.int32)
    dp[rng.random((R, C)) < 0.1] = -1
    gq = rng.integers(0, 100, (R, C)).astype(np.int32)
    gq[rng.random((R, C)) < 0.1] = -1
    if R:
        dp[0] = -1
    return packed, missing, dp, gq


BLOCK_CASES = [
    # R, C, A, has_dp, has_gq
    (37, 53, 2, True, True),
    (37, 53, 4, True, False),
    (37, 53, 4, False, True),
    (64, 1003, 2, False, False),
    (64, 1003, 4, True, True),
    (3, 7, 9, True, True),
    (0, 53, 2, True, True),
    (5, 0, 2, False, False),     # the reference's min of no DP raises
]


@pytest.mark.parametrize('R,C,A,has_dp,has_gq', BLOCK_CASES)
def test_variant_qc_block_plain_matches_reference(R, C, A, has_dp, has_gq):
    import jax.numpy as jnp
    from hail_tpu.ops import qc as rqc
    from hail_tpu_torch.ops import qc as pqc
    packed, missing, dp, gq = block_inputs(R, C, A, seed=R * 7 + C + A)
    dummy = np.zeros((1, 1), np.int32)
    want = rqc.variant_qc_block(
        jnp.asarray(packed), jnp.asarray(missing),
        jnp.asarray(dp if has_dp else dummy), jnp.asarray(gq if has_gq else dummy),
        A, has_dp, has_gq)
    got = pqc.variant_qc_block(
        torch.from_numpy(packed), torch.from_numpy(missing),
        torch.from_numpy(dp) if has_dp else None,
        torch.from_numpy(gq) if has_gq else None, A, has_dp, has_gq)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, key
        if key.endswith(('_sum', '_sumsq', '_min', '_max')):
            assert g.dtype == np.float64, key
            assert np.array_equal(g, w), key      # bit-equal, inf included
        else:
            assert g.dtype == np.int64, key
            assert np.array_equal(g, w.astype(np.int64)), key
    if R and C and has_dp:
        assert got['dp_min'][0] == math.inf and got['dp_max'][0] == -math.inf
        assert got['dp_n'][0] == 0


@pytest.mark.parametrize('with_fields', [True, False])
def test_run_variant_qc_block_matches_reference(with_fields):
    """The host wrappers: the same keys, types and values from numpy."""
    from hail_tpu.ops import qc as rqc
    from hail_tpu_torch.ops import qc as pqc
    packed, missing, dp, gq = block_inputs(37, 53, 3, seed=5)
    dp_m, gq_m = dp < 0, gq < 0
    kw = dict(dp=np.where(dp_m, 7, dp), dp_missing=dp_m, gq=gq,
              gq_missing=None, max_alleles=3) if with_fields else {}
    want = rqc.run_variant_qc_block(packed, missing, **kw)
    got = pqc.run_variant_qc_block(packed, missing, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# MatrixTables built alike in both packages
# ---------------------------------------------------------------------------

ALLELES = [['A', 'T'], ['C', 'G'], ['G', 'A'], ['C', 'CG'], ['AT', 'A'],
           ['A', 'G', 'C'], ['T', 'TA', 'C'], ['G', '*', 'GA']]


def build_mt(pkg, seed=0, parts=PARTS, x_from=None, hts=False):
    """GT (diploid, some haploid), DP and GQ (missing in places) over rows
    of the alleles above (about a third multiallelic); with `hts` also AD
    and PL; rows from partition `x_from` on lie on X outside the PARs."""
    ht = importlib.import_module(f'{pkg.__name__}.types')
    C = importlib.import_module(f'{pkg.__name__}.ir.columns')
    mtm = importlib.import_module(f'{pkg.__name__}.matrixtable')
    rgm = importlib.import_module(f'{pkg.__name__}.genetics.reference_genome')
    rg = rgm.default_reference()
    x_idx = rg.contigs.index('X')
    rng = np.random.default_rng(seed)
    mbs, start = [], 0
    for p, R in enumerate(parts):
        on_x = x_from is not None and p >= x_from
        als = [ALLELES[i] for i in rng.integers(0, len(ALLELES), R)]
        A = np.asarray([len(a) for a in als])
        ploidy = np.where(rng.random((R, N_COLS)) < 0.1, 1, 2)
        j = (rng.random((R, N_COLS)) * A[:, None]).astype(np.int64)
        k = (rng.random((R, N_COLS)) * A[:, None]).astype(np.int64)
        j, k = np.minimum(j, k), np.maximum(j, k)
        j = np.where(rng.random((R, N_COLS)) < 0.5, 0, j)
        k = np.where(ploidy < 2, 0, k)
        gt = _pack(ploidy, j, k)
        gt_m = rng.random((R, N_COLS)) < 0.08
        dp = rng.integers(0, 60, (R, N_COLS)).astype(np.int32)
        dp_m = rng.random((R, N_COLS)) < 0.1
        gq = rng.integers(0, 99, (R, N_COLS)).astype(np.int32)
        gq_m = rng.random((R, N_COLS)) < 0.1
        alleles = np.empty(R, dtype=object)
        alleles[:] = als
        pos = np.arange(start, start + R, dtype=np.int32) * 10 + (
            3_000_000 if on_x else 100)
        contig = np.full(R, x_idx if on_x else 0, np.int32)
        rows = C.Batch({
            'locus': C.LocusColumn(ht.tlocus(rg), contig, pos),
            'alleles': C.ObjectColumn(ht.tarray(ht.tstr), alleles),
        }, R)
        ents = {
            'GT': C.PrimitiveColumn(ht.tcall, gt, gt_m),
            'DP': C.PrimitiveColumn(ht.tint32, dp, dp_m),
            'GQ': C.PrimitiveColumn(ht.tint32, gq, gq_m),
        }
        if hts:
            W = int(A.max()) if R else 1
            ad = rng.integers(0, 30, (R, N_COLS, W)).astype(np.int32)
            ents['AD'] = C.DenseArrayColumn(
                ht.tarray(ht.tint32), ad,
                np.broadcast_to(A[:, None], (R, N_COLS)).copy(), None,
                rng.random((R, N_COLS)) < 0.05)
            G = A * (A + 1) // 2
            pl = rng.integers(0, 200, (R, N_COLS, int(G.max()) if R else 1))
            ents['PL'] = C.DenseArrayColumn(
                ht.tarray(ht.tint32), pl.astype(np.int32),
                np.broadcast_to(G[:, None], (R, N_COLS)).copy(), None,
                rng.random((R, N_COLS)) < 0.05)
        mbs.append(mtm.MatrixBatch(rows, ents))
        start += R
    cols = C.Batch({'s': C.ObjectColumn(
        ht.tstr, np.asarray([f's{i}' for i in range(N_COLS)], object))}, N_COLS)
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    ent_t = dict(GT=ht.tcall, DP=ht.tint32, GQ=ht.tint32)
    if hts:
        ent_t.update(AD=ht.tarray(ht.tint32), PL=ht.tarray(ht.tint32))
    return mtm.MatrixTable(mtm.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t,
        ht.tstruct(s=ht.tstr), ht.tstruct(**ent_t), mbs))


def _rows(mt):
    return [plain(r) for r in mt.rows().collect()]


def _cols(mt):
    return [plain(r) for r in mt.cols().collect()]


def _entries(mt):
    return [plain(r) for r in mt.entries().collect()]


def _both(f, **kw):
    return f(hr, build_mt(hr, **kw)), f(hlt, build_mt(hlt, **kw))


def test_variant_qc_matches_reference():
    ref, port = _both(lambda h, mt: _rows(h.variant_qc(mt, 'vqc')))
    assert len(port) == sum(PARTS)
    assert port == ref


def test_variant_qc_without_dp_gq_matches_reference():
    ref, port = _both(lambda h, mt: _rows(h.variant_qc(mt.drop('DP', 'GQ'))))
    assert port == ref


def test_variant_qc_runs_the_block_per_partition(monkeypatch):
    from hail_tpu_torch.ops import qc as pqc
    calls = []
    real = pqc.run_variant_qc_block

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(pqc, 'run_variant_qc_block', counted)
    hlt.variant_qc(build_mt(hlt)).rows().collect()
    assert calls == [(R, N_COLS) for R in PARTS]


def test_sample_qc_matches_reference():
    ref, port = _both(lambda h, mt: _cols(h.sample_qc(mt, 'sqc')))
    assert len(port) == N_COLS
    assert port == ref


def test_summarize_variants_matches_reference():
    ref, port = _both(lambda h, mt: plain(h.summarize_variants(mt, show=False)))
    assert port == ref
    lines = []
    hlt.summarize_variants(build_mt(hlt), handler=lines.append)
    assert 'Number of variants: 31' in lines[0]


SCHEMA = 'struct{v: str, s: str, GT: call, GQ: int, DP: int}'
GOLDEN_VARIANT = [
    ('1:1:A:T', '1', [0, 0], 10, 0), ('1:1:A:T', '2', [1, 1], 10, 5),
    ('1:1:A:T', '3', [0, 1], 11, 100), ('1:1:A:T', '4', None, None, 100),
    ('1:2:A:T,C', '1', [1, 2], 10, 5), ('1:2:A:T,C', '2', [2, 2], 10, 5),
    ('1:2:A:T,C', '3', [0, 1], 10, 5), ('1:2:A:T,C', '4', [1, 1], 10, 5),
]
GOLDEN_SAMPLE = [
    ('1:1:A:T', '1', [0, 0], 10, 0), ('1:2:A:T,C', '1', [1], 15, 5),
    ('1:3:A:G,C', '1', [2, 2], 10, 4), ('1:4:G:A', '1', [0, 1], None, 5),
    ('1:5:C:CG', '1', [1, 1], 20, 3), ('1:6:C:A', '1', None, 0, None),
]


def _golden_mt(h, data):
    rows = [{'v': v, 's': s, 'GT': None if gt is None else h.Call(gt),
             'GQ': gq, 'DP': dp} for v, s, gt, gq, dp in data]
    t = h.Table.parallelize(rows, h.dtype(SCHEMA))
    t = t.transmute(**h.parse_variant(t.v))
    return t.to_matrix_table(['locus', 'alleles'], ['s'])


@pytest.mark.parametrize('data', ['variant', 'sample'])
def test_golden_data_matches_reference(data):
    """The inline data of tests/test_golden_parity.py through both packages:
    variant_qc's rows and sample_qc's columns equal."""
    rows = GOLDEN_VARIANT if data == 'variant' else GOLDEN_SAMPLE
    out = []
    for h in (hr, hlt):
        mt = _golden_mt(h, rows)
        out.append((_rows(h.variant_qc(mt, 'vqc')),
                    _cols(h.sample_qc(mt, 'sqc'))))
    assert out[1] == out[0]
    if data == 'variant':
        q = dict(dict(out[1][0][0][1])['vqc'][1])
        assert q['AC'] == (3, 3) and q['AN'] == 6 and q['n_het'] == 1


@pytest.mark.parametrize('hts', [False, True])
@pytest.mark.parametrize('keep_star', [False, True])
def test_split_multi_matches_reference(hts, keep_star):
    def f(h, mt):
        split = (h.split_multi_hts if hts else h.split_multi)
        s = split(mt, keep_star=keep_star)
        return _rows(s), _entries(s)
    ref, port = _both(f, hts=True)
    assert len(port[0]) > sum(PARTS)
    assert port == ref


FILTERS = {
    'drop_second_alt': lambda allele, i: i != 2,
    'snps_only': lambda allele, i: allele.length() == 1,
}


@pytest.mark.parametrize('mode', ['plain', 'downcode', 'subset'])
@pytest.mark.parametrize('pred', sorted(FILTERS))
def test_filter_alleles_matches_reference(mode, pred):
    def f(h, mt):
        if mode == 'plain':
            out = h.filter_alleles(mt, FILTERS[pred])
        else:
            out = h.filter_alleles_hts(mt, FILTERS[pred],
                                       subset=(mode == 'subset'))
        return _rows(out), _entries(out)
    ref, port = _both(f, hts=True)
    assert port[0] and port == ref


def test_impute_sex_matches_reference():
    def f(h, mt):
        return [plain(r) for r in h.impute_sex(mt.GT).collect()]
    ref, port = _both(f, x_from=1, parts=(6, 40, 35))
    assert len(port) == N_COLS
    assert _close(tuple(port), tuple(ref))
    assert any(dict(r[1])['f_stat'] is not None for r in port)


def test_impute_sex_thresholds_match_reference():
    def f(h, mt):
        return [plain(r) for r in h.impute_sex(
            mt.GT, aaf_threshold=0.1, female_threshold=0.5,
            male_threshold=0.6, include_par=True).collect()]
    ref, port = _both(f, x_from=1, parts=(6, 40, 35))
    assert _close(tuple(port), tuple(ref))


def test_lambda_gc_matches_reference():
    out = []
    for h in (hr, hlt):
        t = h.variant_qc(build_mt(h)).rows()
        out.append(h.lambda_gc(t.variant_qc.p_value_hwe))
    assert math.isfinite(out[1])
    assert math.isclose(out[1], out[0], rel_tol=1e-12)


def test_nd_aliases_match_their_methods():
    h = hlt
    mt = h.balding_nichols_model(2, 30, 40, n_partitions=2)
    mt = mt.annotate_cols(y=h.rand_unif(0, 1, seed=3),
                          yb=h.rand_bool(0.5, seed=4))
    a = h._linear_regression_rows_nd(mt.y, mt.GT.n_alt_alleles(), [1.0])
    b = h.linear_regression_rows(mt.y, mt.GT.n_alt_alleles(), [1.0])
    assert [plain(r) for r in a.collect()] == [plain(r) for r in b.collect()]
    a = h._logistic_regression_rows_nd('wald', h.float64(mt.yb),
                                       mt.GT.n_alt_alleles(), [1.0],
                                       max_iterations=20)
    b = h.logistic_regression_rows('wald', h.float64(mt.yb),
                                   mt.GT.n_alt_alleles(), [1.0],
                                   max_iterations=20)
    assert [plain(r) for r in a.collect()] == [plain(r) for r in b.collect()]


EXPORTS = ['sample_qc', 'variant_qc', 'summarize_variants', 'vep_json_typ',
           'VEPConfig', 'VEPConfigGRCh37Version85', 'VEPConfigGRCh38Version95',
           'split_multi', 'split_multi_hts', 'filter_alleles',
           'filter_alleles_hts', 'impute_sex', 'lambda_gc']


def test_exports_match_reference():
    for name in EXPORTS:
        assert hasattr(hlt, name) and hasattr(hlt.methods, name), name
    assert str(hlt.vep_json_typ) == str(hr.vep_json_typ)
    cfg = hlt.VEPConfigGRCh38Version95(image='vep')
    assert (cfg.reference_genome, cfg.vep_version, cfg.image) == ('GRCh38', 95,
                                                                  'vep')
    assert str(cfg.json_typ) == str(hr.VEPConfig().json_typ)
