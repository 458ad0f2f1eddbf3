"""The port's device GLM tier (hail_tpu_torch/ops/glm_device.py) against
hail_tpu/ops/glm_device.py and against the host-faithful stats/glmfit.py,
on the same numpy inputs (tests/test_glm_device.py's data: N = 400
samples, R = 40 variants, 5% missing), on the CPU.

Tolerances: iteration counts and the converged/exploded status are equal;
numbers follow tests/test_glm_device.py's bars: against the reference's
device tier b, ll, score and fisher at rtol 1e-10 and se, z, chi² at
rtol 1e-9 (both are f64 batched fits; the sums are taken in another
order), always with atol 1e-12 for values near zero; against glmfit the
same bars as that file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hail_tpu.ops import glm_device as ref
from hail_tpu.stats import glmfit
from hail_tpu_torch.ops import glm_device as port

MAXIT, TOL = 25, 1e-8
RTOL = {'b': 1e-10, 'll': 1e-10, 'score': 1e-10, 'fisher': 1e-10,
        'null_b': 1e-9, 'full_b': 1e-9, 'null_ll': 1e-9, 'full_ll': 1e-9}
EXACT = ('n_iter', 'status', 'null_n_iter', 'null_status', 'full_n_iter',
         'full_status', 'valid', 'nan_input')


def _dataset(seed=0, N=400, R=40, k=3, missing_frac=0.05, binary=True):
    """tests/test_glm_device.py's generator."""
    rng = np.random.RandomState(seed)
    Cov = np.hstack([np.ones((N, 1)), rng.randn(N, k - 1)])
    beta_true = rng.randn(k) * 0.4
    G = rng.binomial(2, 0.3, size=(R, N)).astype(np.float64)
    M = rng.rand(R, N) < missing_frac
    eta = Cov @ beta_true + 0.15 * np.where(M, 0, G).mean(axis=0)
    if binary:
        y = (rng.rand(N) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    else:
        y = rng.poisson(np.exp(np.clip(eta, -3, 2))).astype(np.float64)
    return Cov, y, G, M


def _impute(G, M):
    with np.errstate(invalid='ignore', divide='ignore'):
        cnt = (~M).sum(axis=1)
        mean = np.where(M, 0.0, G).sum(axis=1) / cnt
    return np.where(M, mean[:, None], G)


def _poisson_null(Cov, y):
    N, k = Cov.shape
    b0 = np.concatenate([[float(np.log(y.sum() / N))], np.zeros(k - 1)])
    mu0 = np.exp(Cov @ b0)
    return glmfit.poisson_fit(Cov, y, b0, mu0, Cov.T @ (y - mu0),
                              (mu0 * Cov.T) @ Cov, MAXIT, TOL)


def _with_edge_rows(G, M, Cov):
    """Rows 3-5: x = 0 everywhere, x = 0 where present (imputes to 0), and
    all-missing x. Each makes the fisher exactly singular (or NaN), which
    `torch.linalg.cholesky` would raise on. (An x that equals a covariate,
    or any constant x ≠ 0, is singular only up to roundoff: the iteration
    at which the reference explodes on it depends on the sign of a pivot
    of O(eps), so it is held in its own test, not to iteration parity.)"""
    G, M = G.copy(), M.copy()
    G[3], M[3] = 0.0, False
    G[4] = 0.0
    M[5] = True
    return G, M


@pytest.fixture(scope='module')
def logistic_data():
    Cov, y, G, M = _dataset(seed=1)
    null = glmfit.logreg_fit(Cov, y, None, MAXIT, TOL)
    assert null['converged']
    return Cov, y, G, M, null


@pytest.fixture(scope='module')
def poisson_data():
    Cov, y, G, M = _dataset(seed=3, binary=False)
    null = _poisson_null(Cov, y)
    assert null['converged']
    return Cov, y, G, M, null


def _assert_same(got, want, keys=None):
    for key in keys or want:
        a = np.asarray(got[key], np.float64)
        b = np.asarray(want[key], np.float64)
        assert a.shape == b.shape, key
        if key in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        np.testing.assert_allclose(a, b, rtol=RTOL.get(key, 1e-9), atol=1e-12,
                                   equal_nan=True, err_msg=key)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _null_args(null):
    return [np.asarray(null[f], np.float64) for f in ('b', 'score', 'fisher')]


@pytest.mark.parametrize('link', ['logistic', 'poisson'])
def test_newton_batch_matches_reference(logistic_data, poisson_data, link):
    Cov, y, G, M, null = logistic_data if link == 'logistic' else poisson_data
    G, M = _with_edge_rows(G, M, Cov)
    args = [G, M, Cov, y] + _null_args(null)
    names = ('b', 'score', 'fisher', 'n_iter', 'll', 'status')
    want = dict(zip(names, ref.glm_newton_batch(*_j(*args), MAXIT, TOL, link)))
    got = dict(zip(names, port.glm_newton_batch(*_t(*args), MAXIT, TOL, link)))
    assert got['status'].dtype == torch.int32
    assert (got['status'][3:6] == 2).all(), 'singular rows explode'
    _assert_same({k: v.numpy() for k, v in got.items()}, want)


def test_wald_stats_batch_matches_reference(logistic_data):
    Cov, y, G, M, null = logistic_data
    args = [G, M, Cov, y] + _null_args(null)
    b, _, fi, _, _, _ = ref.glm_newton_batch(*_j(*args), MAXIT, TOL)
    se_r, z_r = ref.wald_stats_batch(b, fi)
    se, z = port.wald_stats_batch(*_t(b, fi))
    _assert_same({'se': se.numpy(), 'z': z.numpy()}, {'se': se_r, 'z': z_r})


@pytest.mark.parametrize('link', ['logistic', 'poisson'])
def test_score_batch_matches_reference(logistic_data, poisson_data, link):
    Cov, y, G, M, null = logistic_data if link == 'logistic' else poisson_data
    G, M = _with_edge_rows(G, M, Cov)
    args = [G, M, Cov, y] + _null_args(null)
    want = ref.glm_score_batch(*_j(*args), link)
    got = port.glm_score_batch(*_t(*args), link)
    assert np.isnan(got[3:6].numpy()).all()
    _assert_same({'chi2': got.numpy()}, {'chi2': np.asarray(want)})


@pytest.mark.parametrize('full', [False, True])
def test_firth_batch_matches_reference(logistic_data, full):
    Cov, y, G, M, null = logistic_data
    Gi = _impute(*_with_edge_rows(G, M, Cov))
    k = Cov.shape[1]
    b0 = np.broadcast_to(null['b'], (G.shape[0], k))
    if full:
        b0 = np.concatenate([b0, np.zeros((G.shape[0], 1))], axis=1)
    m0 = b0.shape[1]
    names = ('null_b', 'null_n_iter', 'null_ll', 'null_status')
    want = dict(zip(names, ref.firth_fit_batch(*_j(Gi, Cov, y, b0), m0,
                                               MAXIT, TOL)))
    got = dict(zip(names, port.firth_fit_batch(*_t(Gi, Cov, y, b0), m0,
                                               MAXIT, TOL)))
    assert (got['null_status'][3:6] == 2).all()
    _assert_same({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize('test', ['wald', 'lrt', 'score', 'firth'])
def test_logistic_rows_device_matches_reference(logistic_data, test):
    Cov, y, G, M, null = logistic_data
    G, M = _with_edge_rows(G, M, Cov)
    want = ref.logistic_rows_device(G, M, Cov, y, null, test, MAXIT, TOL)
    got = port.logistic_rows_device(G, M, Cov, y, null, test, MAXIT, TOL,
                                    device='cpu')
    assert sorted(got) == sorted(want)
    _assert_same(got, want)
    # the cached int8 entry pair gives the same result as host arrays
    gz8 = torch.from_numpy(np.where(M, 0, G).astype(np.int8))
    m8 = torch.from_numpy(M.astype(np.int8))
    _assert_same(port.logistic_rows_device(gz8, m8, Cov, y, null, test,
                                           MAXIT, TOL, cached=True),
                 port.logistic_rows_device(np.where(M, 0, G), M, Cov, y,
                                           null, test, MAXIT, TOL))


@pytest.mark.parametrize('test', ['wald', 'lrt', 'score'])
def test_poisson_rows_device_matches_reference(poisson_data, test):
    Cov, y, G, M, null = poisson_data
    G, M = _with_edge_rows(G, M, Cov)
    want = ref.poisson_rows_device(G, M, Cov, y, null, test, MAXIT, TOL)
    got = port.poisson_rows_device(G, M, Cov, y, null, test, MAXIT, TOL,
                                   block_rows=16)
    assert sorted(got) == sorted(want)
    _assert_same(got, want)


@pytest.mark.parametrize('test', ['wald', 'firth'])
def test_max_iterations_freeze_matches_reference(logistic_data, test):
    """With a cap of 3 iterations most rows stop at the cap (status 3):
    the cap applies at the same iteration in both packages."""
    Cov, y, G, M, null = logistic_data
    want = ref.logistic_rows_device(G, M, Cov, y, null, test, 3, TOL)
    got = port.logistic_rows_device(G, M, Cov, y, null, test, 3, TOL)
    status = got['status' if test == 'wald' else 'full_status']
    assert (status == 3).any()
    _assert_same(got, want)


# ---- against the host-faithful glmfit (tests/test_glm_device.py's checks)

def test_newton_matches_host_per_variant(logistic_data):
    Cov, y, G, M, null = logistic_data
    dev = port.logistic_rows_device(G, M, Cov, y, null, 'wald', MAXIT, TOL)
    Gi = _impute(G, M)
    for r in range(G.shape[0]):
        X = np.hstack([Cov, Gi[r][:, None]])
        hf = glmfit.logreg_fit(X, y, null, MAXIT, TOL)
        assert int(dev['n_iter'][r]) == hf['n_iterations'], f'row {r}'
        assert (dev['status'][r] == 1) == hf['converged'], f'row {r}'
        assert (dev['status'][r] == 2) == hf['exploded'], f'row {r}'
        if hf['converged']:
            np.testing.assert_allclose(dev['b'][r], hf['b'], rtol=1e-10,
                                       atol=1e-12)
            np.testing.assert_allclose(dev['ll'][r], hf['log_lkhd'],
                                       rtol=1e-10)
            w = glmfit.wald_test(X, hf)
            np.testing.assert_allclose(dev['se'][r], w['standard_error'],
                                       rtol=1e-9)
            np.testing.assert_allclose(dev['z'][r], w['z_stat'], rtol=1e-9)


def test_score_and_firth_match_host(logistic_data):
    Cov, y, G, M, null = logistic_data
    Gi = _impute(G, M)
    sc = port.logistic_rows_device(G, M, Cov, y, null, 'score', MAXIT, TOL)
    fi = port.logistic_rows_device(G, M, Cov, y, null, 'firth', MAXIT, TOL)
    for r in range(G.shape[0]):
        X = np.hstack([Cov, Gi[r][:, None]])
        h = glmfit.logistic_score_test(X, y, null)
        if h['chi_sq_stat'] is None:
            assert not sc['valid'][r]
        else:
            np.testing.assert_allclose(sc['chi_sq_stat'][r], h['chi_sq_stat'],
                                       rtol=1e-9, atol=1e-12)
        hn = glmfit.firth_fit(null['b'], X, y, MAXIT, TOL)
        assert int(fi['null_n_iter'][r]) == hn['n_iterations'], f'row {r}'
        assert (fi['null_status'][r] == 1) == hn['converged'], f'row {r}'
        if not hn['converged']:
            continue
        np.testing.assert_allclose(fi['null_b'][r], hn['b'], rtol=1e-9,
                                   atol=1e-11)
        hf = glmfit.firth_fit(np.concatenate([hn['b'], [0.0]]), X, y,
                              MAXIT, TOL)
        assert int(fi['full_n_iter'][r]) == hf['n_iterations'], f'row {r}'
        assert (fi['full_status'][r] == 1) == hf['converged'], f'row {r}'
        if hf['converged']:
            np.testing.assert_allclose(fi['full_b'][r], hf['b'], rtol=1e-9,
                                       atol=1e-11)
            np.testing.assert_allclose(fi['full_ll'][r], hf['log_lkhd'],
                                       rtol=1e-9)


def test_poisson_matches_host(poisson_data):
    Cov, y, G, M, null = poisson_data
    Gi = _impute(G, M)
    dev = port.poisson_rows_device(G, M, Cov, y, null, 'wald', MAXIT, TOL)
    for r in range(G.shape[0]):
        X = np.hstack([Cov, Gi[r][:, None]])
        b = np.concatenate([null['b'], [0.0]])
        with np.errstate(over='ignore'):
            mu = 1.0 / (1.0 + np.exp(-(X @ b)))   # the reference's quirk
        score = np.concatenate([null['score'], [Gi[r] @ (y - mu)]])
        f01 = ((Cov.T * mu) @ Gi[r]).reshape(-1, 1)
        fisher = np.block([[null['fisher'], f01],
                           [f01.T, np.array([[(mu * Gi[r]) @ Gi[r]]])]])
        hf = glmfit.poisson_fit(X, y, b, mu, score, fisher, MAXIT, TOL)
        assert int(dev['n_iter'][r]) == hf['n_iterations'], f'row {r}'
        assert (dev['status'][r] == 1) == hf['converged'], f'row {r}'
        if hf['converged']:
            np.testing.assert_allclose(dev['b'][r], hf['b'], rtol=1e-10,
                                       atol=1e-12)
            np.testing.assert_allclose(dev['ll'][r], hf['log_lkhd'],
                                       rtol=1e-10)


def test_all_missing_row_explodes(logistic_data):
    Cov, y, G, M, null = logistic_data
    M2 = M.copy()
    M2[5, :] = True          # all-missing → NaN imputation → exploded
    dev = port.logistic_rows_device(G, M2, Cov, y, null, 'wald', MAXIT, TOL)
    X = np.hstack([Cov, _impute(G, M2)[5][:, None]])
    hf = glmfit.logreg_fit(X, y, null, MAXIT, TOL)
    assert hf['exploded']
    assert dev['status'][5] == 2
    assert int(dev['n_iter'][5]) == hf['n_iterations']
    sc = port.logistic_rows_device(G, M2, Cov, y, null, 'score', MAXIT, TOL)
    assert sc['nan_input'][5] and np.isnan(sc['chi_sq_stat'][5])


def test_singular_fisher_explodes_without_raising(logistic_data):
    """x equal to a covariate: the fisher is singular. cholesky_ex reports
    it where torch.linalg.cholesky would raise for the whole block."""
    Cov, y, G, M, null = logistic_data
    G2, M2 = G.copy(), M.copy()
    G2[2], M2[2] = Cov[:, 2], False
    G2[7], M2[7] = 0.0, False
    # row 7's first fisher (x = 0: zero last row and column) is what
    # torch.linalg.cholesky raises on
    k = Cov.shape[1]
    fisher7 = port._fisher(torch.as_tensor(null['fisher'])[None],
                           torch.zeros((1, k), dtype=torch.float64),
                           torch.zeros(1, dtype=torch.float64))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(fisher7)
    assert torch.isnan(port._chol(fisher7)).all()
    for test in ('wald', 'lrt'):
        dev = port.logistic_rows_device(G2, M2, Cov, y, null, test, MAXIT,
                                        TOL)
        want = ref.logistic_rows_device(G2, M2, Cov, y, null, test, MAXIT,
                                        TOL)
        assert dev['status'][2] == dev['status'][7] == 2
        np.testing.assert_array_equal(dev['status'], want['status'])
        np.testing.assert_array_equal(dev['n_iter'], want['n_iter'])
