"""The port's public slice against hail_tpu on the same MatrixTable, on the
CPU: `linear_regression_rows` (GT path, integer x, float x, chained y),
`logistic_regression_rows` and `poisson_regression_rows` (every test; GT
x from the cached entry pair, float x, list y, the host route),
`identity_by_descent` and `balding_nichols_model`.

Tolerances: linreg outputs rtol 1e-10 (the exact int8 path and the f64 path
each against the reference's own; sums in another order); GLM numbers rtol
1e-9, atol 1e-12, with iteration counts and converged/exploded flags equal
(tests/test_glm_device.py's bars); IBS counts and `n` equal; IBD
Z0/Z1/Z2/PI_HAT rtol 1e-12 (the same float64 expressions of equal counts);
simulated GT calls equal.
"""

import importlib

import numpy as np
import pytest

import hail_tpu_torch as hlt

RTOL = 1e-10
N_SAMPLES, ROWS, PARTS = 300, 64, 3


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def build_mt(pkg: str, seed: int = 0, n_samples=N_SAMPLES, rows=ROWS,
             parts=PARTS):
    """bench.py's build_mt at a small size, in package `pkg`: packed GT calls
    with missing entries, an integer entry field X (missing where GT is),
    phenotypes (p2 with missing values) and covariates."""
    ht = importlib.import_module(f'{pkg}.types')
    call = importlib.import_module(f'{pkg}.genetics.call')
    cols_mod = importlib.import_module(f'{pkg}.ir.columns')
    mtm = importlib.import_module(f'{pkg}.matrixtable')
    rg = importlib.import_module(f'{pkg}.genetics.reference_genome')
    Batch, PC, OC = cols_mod.Batch, cols_mod.PrimitiveColumn, cols_mod.ObjectColumn
    ref = rg.default_reference()
    rng = np.random.default_rng(seed)
    mbs = []
    for p in range(parts):
        nalt = rng.integers(0, 3, (rows, n_samples)).astype(np.int32)
        miss = rng.random((rows, n_samples)) < 0.05
        gt = call.pack_diploid((nalt == 2).astype(np.int32),
                               (nalt >= 1).astype(np.int32))
        dose = rng.integers(0, 6, (rows, n_samples)).astype(np.int32)
        alleles = np.empty(rows, dtype=object)
        alleles[:] = [['A', 'T']] * rows
        row_b = Batch({
            'locus': cols_mod.LocusColumn(
                ht.tlocus(ref), np.zeros(rows, np.int32),
                np.arange(p * rows, (p + 1) * rows, dtype=np.int32) + 1000),
            'alleles': OC(ht.tarray(ht.tstr), alleles),
        }, rows)
        mbs.append(mtm.MatrixBatch(row_b, {
            'GT': PC(ht.tcall, gt, miss), 'X': PC(ht.tint32, dose, miss)}))
    cols = {'s': OC(ht.tstr, np.asarray([f's{i}' for i in range(n_samples)],
                                        object))}
    col_t = {'s': ht.tstr}
    for name in ('pheno', 'p2', 'c0', 'c1', 'w'):
        v = rng.normal(size=n_samples)
        m = None
        if name == 'p2':
            m = rng.random(n_samples) < 0.1
        if name == 'w':
            v = np.abs(v) + 0.1
        cols[name] = PC(ht.tfloat64, v, m)
        col_t[name] = ht.tfloat64
    # GLM phenotypes: binary (yb, and ybm with missing values) and counts
    cols['yb'] = PC(ht.tfloat64, (rng.random(n_samples) < 0.4).astype(float))
    cols['ybm'] = PC(ht.tfloat64,
                     (rng.random(n_samples) < 0.5).astype(float),
                     rng.random(n_samples) < 0.1)
    cols['yc'] = PC(ht.tfloat64, rng.poisson(1.5, n_samples).astype(float))
    col_t.update(yb=ht.tfloat64, ybm=ht.tfloat64, yc=ht.tfloat64)
    row_t = ht.tstruct(locus=ht.tlocus(ref), alleles=ht.tarray(ht.tstr))
    return mtm.MatrixTable(mtm.MatrixStage.from_batches(
        Batch({}, 1), Batch(cols, n_samples), ['locus', 'alleles'], ['s'],
        row_t, ht.tstruct(**col_t), ht.tstruct(GT=ht.tcall, X=ht.tint32), mbs))


def _regress(hl_mod, mt, case):
    covs = [1.0, mt.c0, mt.c1]
    if case == 'gt':
        return hl_mod.linear_regression_rows(
            y=mt.pheno, x=mt.GT.n_alt_alleles(), covariates=covs)
    if case == 'gt_missing_pheno':
        return hl_mod.linear_regression_rows(
            y=mt.p2, x=mt.GT.n_alt_alleles(), covariates=covs)
    if case == 'gt_multi_pheno':
        return hl_mod.linear_regression_rows(
            y=[mt.pheno, mt.c1], x=mt.GT.n_alt_alleles(), covariates=[1.0])
    if case == 'int_x':
        return hl_mod.linear_regression_rows(y=mt.pheno, x=mt.X,
                                             covariates=covs)
    if case == 'float_x':
        return hl_mod.linear_regression_rows(y=mt.pheno, x=mt.X * 0.5,
                                             covariates=covs)
    if case == 'weighted':
        return hl_mod.linear_regression_rows(y=mt.pheno, x=mt.X,
                                             covariates=covs, weights=mt.w)
    if case == 'chained':
        return hl_mod.linear_regression_rows(
            y=[[mt.pheno], [mt.p2, mt.w]], x=mt.X, covariates=covs)
    raise ValueError(case)


def _assert_close(a, b, path):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f'{path}[{i}]')
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a is None and b is None, path
        elif np.isnan(b):
            assert np.isnan(a), path
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=path)
    else:
        assert a == b, path


FIELDS = ('n', 'sum_x', 'y_transpose_x', 'beta', 'standard_error', 't_stat',
          'p_value')


@pytest.mark.parametrize('case', ['gt', 'gt_missing_pheno', 'gt_multi_pheno',
                                  'int_x', 'float_x', 'weighted', 'chained'])
def test_linear_regression_rows_matches_reference(hl, case, monkeypatch):
    from hail_tpu_torch.ops import devcache, linreg_i8, regression
    want = _regress(hl, build_mt('hail_tpu'), case).collect()
    mt = build_mt('hail_tpu_torch')
    devcache.clear()
    # the branch each case must take
    module, fn = {
        'gt': (linreg_i8, 'linreg_block_gz_exact_packed'),
        'gt_missing_pheno': (linreg_i8, 'linreg_block_gz_exact_packed'),
        'gt_multi_pheno': (linreg_i8, 'linreg_block_gz_exact_packed'),
        'int_x': (linreg_i8, '_linreg_block_i8_exact_packed'),
        'float_x': (regression, 'linreg_stats'),
        'weighted': (regression, 'linreg_stats'),
        'chained': (linreg_i8, 'linreg_stats_i8_exact'),
    }[case]
    calls = []
    real = getattr(module, fn)
    monkeypatch.setattr(module, fn,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _regress(hlt, mt, case).collect()
    assert calls, f'{case} did not run {fn}'
    assert len(got) == len(want) == PARTS * ROWS
    for r_got, r_want in zip(got, want):
        assert repr(r_got.locus) == repr(r_want.locus)
        for f in FIELDS:
            _assert_close(r_got[f], r_want[f], f'{r_want.locus}.{f}')
    if case in ('gt', 'gt_missing_pheno', 'int_x'):
        # the second call finds the entry pair resident on the device
        hits = devcache.stats()['hits']
        again = _regress(hlt, mt, case).collect()
        assert devcache.stats()['hits'] == hits + PARTS
        for r1, r2 in zip(again, got):
            assert r1.beta == r2.beta or np.isnan(r2.beta)


@pytest.mark.parametrize('case,groups', [('gt', 1), ('chained', 2),
                                         ('weighted', 1), ('float_x', 1)])
def test_every_route_makes_one_column_plane(hl, case, groups, monkeypatch):
    """The exact route of one group and of chained groups, the weighted
    route and the float-x route each make a group's column plane once, on
    the session's device (`statgen._column_plane_device`: one `linreg.qr`
    span a group, no numpy QR), and every field equals hail_tpu's at rtol
    1e-10."""
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.utils import timer
    want = _regress(hl, build_mt('hail_tpu'), case).collect()
    mt = build_mt('hail_tpu_torch')
    planes = []
    real = statgen._column_plane_device
    monkeypatch.setattr(statgen, '_column_plane_device',
                        lambda *a: planes.append(a[2]) or real(*a))

    def no_numpy_qr(*a, **k):
        raise AssertionError('numpy QR on the column plane')
    monkeypatch.setattr(np.linalg, 'qr', no_numpy_qr)
    timer.clear()
    with timer.recording():
        got = _regress(hlt, mt, case).collect()
    spans = timer.spans()
    timer.clear()
    assert planes == [hlt.current_device()] * groups
    qr = [s.attrs for s in spans if s.name == 'linreg.qr']
    assert len(qr) == groups and all(a['cols'] == 3 for a in qr)
    assert not [s for s in spans if s.name == 'consts.key']
    assert len(got) == len(want) == PARTS * ROWS
    for r_got, r_want in zip(got, want):
        for f in FIELDS:
            _assert_close(r_got[f], r_want[f], f'{r_want.locus}.{f}')


GLM_SHAPE = dict(n_samples=200, rows=40, parts=2)


def _glm(hl_mod, mt, method, test, case):
    covs = [1.0, mt.c0, mt.c1]
    x = mt.X * 0.5 if case == 'float_x' else mt.GT.n_alt_alleles()
    if method == 'poisson':
        return hl_mod.poisson_regression_rows(test, y=mt.yc, x=x,
                                              covariates=covs)
    y = [mt.yb, mt.ybm] if case == 'gt_list' else mt.yb
    return hl_mod.logistic_regression_rows(test, y=y, x=x, covariates=covs)


def _assert_glm_close(a, b, path):
    """GLM result values: structs and lists field by field, arrays and
    floats at rtol 1e-9, atol 1e-12, everything else equal."""
    from hail_tpu.utils.structs import Struct as RefStruct
    from hail_tpu_torch.utils.structs import Struct as PortStruct
    if isinstance(b, RefStruct):
        assert isinstance(a, PortStruct), path
        assert list(a) == list(b), path
        for f in b:
            _assert_glm_close(a[f], b[f], f'{path}.{f}')
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_glm_close(x, y, f'{path}[{i}]')
    elif isinstance(b, (float, np.ndarray)) and not isinstance(b, bool):
        assert a is not None, path
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                   equal_nan=True, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize('method,test,case', [
    (m, t, c)
    for m, tests, cases in (
        ('logistic', ('wald', 'lrt', 'score', 'firth'),
         ('gt', 'gt_list', 'float_x', 'host')),
        ('poisson', ('wald', 'lrt', 'score'), ('gt', 'float_x', 'host')))
    for t in tests for c in cases])
def test_glm_regression_rows_matches_reference(hl, method, test, case,
                                               monkeypatch):
    from hail_tpu_torch.ops import devcache, glm_device
    if case == 'host':
        # the host-faithful route, in both packages
        monkeypatch.setenv('HAIL_TPU_GLM_DEVICE', '0')
    want = _glm(hl, build_mt('hail_tpu', seed=5, **GLM_SHAPE), method, test,
                case).collect()
    mt = build_mt('hail_tpu_torch', seed=5, **GLM_SHAPE)
    devcache.clear()
    fn = f'{method}_rows_device'
    calls = []
    real = getattr(glm_device, fn)
    monkeypatch.setattr(glm_device, fn,
                        lambda *a, **k: calls.append(k.get('cached', False))
                        or real(*a, **k))
    got = _glm(hlt, mt, method, test, case).collect()
    # the route each case must take
    if case == 'host' or (method == 'poisson' and case == 'float_x'):
        assert not calls, f'{case} reached the device tier'
    else:
        assert calls and all(calls) == (case != 'float_x'), calls
    assert len(got) == len(want) == GLM_SHAPE['parts'] * GLM_SHAPE['rows']
    for r_got, r_want in zip(got, want):
        assert repr(r_got.locus) == repr(r_want.locus)
        assert list(r_got) == list(r_want)
        for f in r_want:
            if f not in ('locus', 'alleles'):
                _assert_glm_close(r_got[f], r_want[f], f'{r_want.locus}.{f}')


def test_glm_after_linreg_hits_devcache(monkeypatch):
    """A GLM call after a linreg call on the same MatrixTable reads the
    entry pair the linreg call cached: no decode (K4), no new entry."""
    from hail_tpu_torch.ops import devcache, linreg_i8
    mt = build_mt('hail_tpu_torch', seed=6, **GLM_SHAPE)
    devcache.clear()
    hlt.linear_regression_rows(y=mt.yb, x=mt.GT.n_alt_alleles(),
                               covariates=[1.0, mt.c0]).collect()
    before = devcache.stats()
    unpacks = []
    real = linreg_i8.unpack_gt_2bit
    monkeypatch.setattr(linreg_i8, 'unpack_gt_2bit',
                        lambda *a: unpacks.append(1) or real(*a))
    for res in (hlt.logistic_regression_rows('wald', y=mt.yb,
                                             x=mt.GT.n_alt_alleles(),
                                             covariates=[1.0, mt.c0]),
                hlt.poisson_regression_rows('score', y=mt.yc,
                                            x=mt.GT.n_alt_alleles(),
                                            covariates=[1.0, mt.c0])):
        assert len(res.collect()) == GLM_SHAPE['parts'] * GLM_SHAPE['rows']
    after = devcache.stats()
    assert after['hits'] == before['hits'] + 2 * GLM_SHAPE['parts']
    assert after['misses'] == before['misses'] and not unpacks


@pytest.mark.parametrize('method,test,field', [('logistic', 'firth', 'fit'),
                                               ('poisson', 'wald', 'test_fit')])
def test_collect_batches_defers_fit_structs(hl, method, test, field):
    """collect_batches memoizes each partition without building the
    deferred fit structs (an n-long mu per variant); read afterwards, they
    equal the reference's."""
    from hail_tpu_torch.ir.columns import DeferredObjectColumn
    mt = build_mt('hail_tpu_torch', seed=7, **GLM_SHAPE)
    batches = _glm(hlt, mt, method, test, 'gt')._stage.collect_batches()
    cols = [b.columns[field] for b in batches]
    assert all(isinstance(c, DeferredObjectColumn) and c._vals is None
               for c in cols)
    want = _glm(hl, build_mt('hail_tpu', seed=7, **GLM_SHAPE), method, test,
                'gt').collect()
    got = [s for c in cols for s in c.values]
    assert len(got) == len(want)
    for s, r in zip(got, want):
        _assert_glm_close(s, r[field], f'{r.locus}.{field}')


def test_force_count_then_collect(hl):
    mt = build_mt('hail_tpu_torch', seed=4)
    res = hlt.linear_regression_rows(y=mt.pheno, x=mt.GT.n_alt_alleles(),
                                     covariates=[1.0])
    assert res._force_count() == PARTS * ROWS
    mt_r = build_mt('hail_tpu', seed=4)
    want = hl.linear_regression_rows(y=mt_r.pheno, x=mt_r.GT.n_alt_alleles(),
                                     covariates=[1.0])
    got = res.collect()
    np.testing.assert_allclose([r.beta for r in got],
                               [r.beta for r in want.collect()], rtol=RTOL)


@pytest.mark.parametrize('use_pallas', [True, False])
def test_identity_by_descent_matches_reference(hl, use_pallas):
    want = hl.identity_by_descent(build_mt('hail_tpu', seed=1,
                                           n_samples=40)).collect()
    got = hlt.identity_by_descent(build_mt('hail_tpu_torch', seed=1,
                                           n_samples=40),
                                  _use_pallas=use_pallas).collect()
    assert len(got) == len(want) == 40 * 39 // 2
    for a, b in zip(got, want):
        assert (a.i, a.j) == (b.i, b.j)
        assert (a.ibs0, a.ibs1, a.ibs2) == (b.ibs0, b.ibs1, b.ibs2)
        for f in ('Z0', 'Z1', 'Z2', 'PI_HAT'):
            np.testing.assert_allclose(a.ibd[f], b.ibd[f], rtol=1e-12,
                                       atol=0, err_msg=f)


def test_identity_by_descent_bounds_and_maf(hl):
    kw = dict(min=0.0, max=0.9, bounded=False)
    mt_r = build_mt('hail_tpu', seed=2, n_samples=30)
    mt_p = build_mt('hail_tpu_torch', seed=2, n_samples=30)
    want = hl.identity_by_descent(mt_r, maf=mt_r.locus.position * 0 + 0.3,
                                  **kw).collect()
    got = hlt.identity_by_descent(mt_p, maf=mt_p.locus.position * 0 + 0.3,
                                  **kw).collect()
    assert [(a.i, a.j) for a in got] == [(b.i, b.j) for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.ibd.PI_HAT, b.ibd.PI_HAT, rtol=1e-12)


def test_balding_nichols_model_same_calls(hl):
    hl.reset_global_randomness()
    hlt.reset_global_randomness()
    mt_r = hl.balding_nichols_model(3, 50, 100)
    mt_p = hlt.balding_nichols_model(3, 50, 100)

    def calls(mt):
        st = mt._stage
        return np.concatenate([st.partition_fn(c).entries['GT'].values
                               for c in st.contexts])

    np.testing.assert_array_equal(calls(mt_p), calls(mt_r))
    assert [r.pop for r in mt_p.cols().collect()] == \
        [r.pop for r in mt_r.cols().collect()]
    np.testing.assert_array_equal(
        [r.ancestral_af for r in mt_p.rows().collect()],
        [r.ancestral_af for r in mt_r.rows().collect()])
