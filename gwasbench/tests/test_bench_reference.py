"""The reference against an independent least-squares solve, the input
generator, and the roofline counts."""

import numpy as np
import pytest
import scipy.stats
import torch

from gwasbench import data, roofline
from gwasbench.reference.ols import FIELDS, Covariates, ols_rows


def lstsq_rows(n_alt, missing, C, Y):
    """Each row's full regression y ~ [C | x] by np.linalg.lstsq."""
    n, k = C.shape
    out = {f: [] for f in FIELDS}
    for g, m in zip(n_alt, missing):
        x = g.astype(np.float64)
        x[m] = x[~m].mean()
        X = np.concatenate([C, x[:, None]], axis=1)
        coef, _, _, _ = np.linalg.lstsq(X, Y, rcond=None)
        resid = Y - X @ coef
        dof = n - k - 1
        se = np.sqrt((resid * resid).sum(axis=0) / dof
                     * np.linalg.inv(X.T @ X)[-1, -1])
        b = coef[-1]
        out['n'].append(n)
        out['sum_x'].append(x.sum())
        out['y_transpose_x'].append(Y.T @ x)
        out['beta'].append(b)
        out['standard_error'].append(se)
        out['t_stat'].append(b / se)
        out['p_value'].append(2 * scipy.stats.t.sf(np.abs(b / se), dof))
    return {f: np.asarray(v) for f, v in out.items()}


@pytest.mark.parametrize('P', [1, 3])
def test_reference_matches_lstsq_with_missing_calls(P):
    rng = np.random.default_rng(7)
    n, R = 300, 12
    C = np.stack([np.ones(n), rng.integers(40, 71, n).astype(float),
                  rng.normal(size=n)], axis=1)
    C = np.concatenate([C, (C[:, 1] * C[:, 1])[:, None]], axis=1)
    Y = rng.normal(size=(n, P)) + 0.01 * C[:, 1:2]
    g = rng.integers(0, 3, (R, n))
    miss = rng.random((R, n)) < 0.1
    got = ols_rows(g, miss, Covariates(C), Y)
    want = lstsq_rows(g, miss, C, Y)
    for f in FIELDS:
        np.testing.assert_allclose(np.reshape(got[f], want[f].shape),
                                   want[f], rtol=1e-9, atol=1e-12,
                                   err_msg=f)
    assert int(miss.sum()) > 0


def test_float32_reference_is_float32():
    rng = np.random.default_rng(3)
    C = np.stack([np.ones(200), rng.normal(size=200)], axis=1)
    got = ols_rows(rng.integers(0, 3, (4, 200)), np.zeros((4, 200), bool),
                   Covariates(C, np.float32), rng.normal(size=(200, 2)))
    assert got['beta'].dtype == np.float32


def test_calls_round_trip_and_follow_the_seed():
    dev = torch.device('cpu')
    a = data.make_calls(data.generator(2**31 + 9, dev), dev, 64, 1000,
                        0.05, 0.02)
    b = data.make_calls(data.generator(2**31 + 9, dev), dev, 64, 1000,
                        0.05, 0.02)
    c = data.make_calls(data.generator(2**31 + 10, dev), dev, 64, 1000,
                        0.05, 0.02)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    nalt = data.decode_n_alt(a[0])
    assert set(np.unique(nalt)) <= {0, 1, 2}
    assert 0.01 < a[1].mean() < 0.03
    # the program's own decoding of the same calls
    from hail_tpu_torch.ops.linreg_i8 import pack_gt_2bit
    codes = pack_gt_2bit(a[0], None)
    unpacked = np.stack([(codes >> s) & 3 for s in (0, 2, 4, 6)], axis=2)
    assert np.array_equal(unpacked.reshape(64, -1)[:, :1000], nalt)


def test_covariates_as_data_and_as_expressions_agree():
    terms = data.covariate_terms(['1', 'sex', 'age*age', 'sex*age*age'])
    assert terms == [[], ['sex'], ['age', 'age'], ['sex', 'age', 'age']]
    cols = {'sex': np.array([0., 1., 1.]), 'age': np.array([40., 50., 70.])}
    C = data.covariate_matrix(terms, cols, 3)
    np.testing.assert_array_equal(C[:, 3], [0., 2500., 4900.])
    np.testing.assert_array_equal(C[:, 0], 1.0)


def test_roofline_counts():
    # ukb.sweep: 4,096 variants x 361,194 samples, k 26, P 16
    R, N, k, P = 4096, 361_194, 26, 16
    assert roofline.call_bytes(R, N, P) == R * N / 4 + R * 65 * 8
    assert roofline.call_ops(R, N, k, P) == 2 * R * N * 42
    assert roofline.least_time_s(R, N, k, P) == pytest.approx(
        (369_862_656 + 2_129_920) / 3.35e12)
    # kg.scan: 262,144 x 2,504, k 5, P 1: bytes bound too
    R, N, k, P = 262_144, 2_504, 5, 1
    assert roofline.least_time_s(R, N, k, P) == pytest.approx(
        (R * N / 4 + R * 5 * 8) / 3.35e12)
    # a wide product turns the bound to operations
    assert roofline.least_time_s(8, 10**6, 10_000, 10_000) == pytest.approx(
        2 * 8 * 10**6 * 20_000 / 1979e12)
