"""The linear mixed model in the port against hail_tpu on the same inputs,
on the CPU.

- `LinearMixedModel`: every case of tests/test_lmm.py, run through both
  packages' classes on seeded numpy inputs. The fit (eigh or SVD, the REML
  optimization) is host numpy in both, so its parameters (h_sq, beta,
  sigma_sq, tau_sq, log_gamma) agree to rtol 1e-12. The batched test's
  contractions run on the port's device (ops/lmm.py, torch) and in jnp in
  the reference, so per-variant beta, sigma_sq and chi_sq are held at rtol
  1e-10 and p_value at rtol 1e-8, with NaN positions equal (a variant of
  zeros gives one).
- `ops/lmm.contractions` against the reference's jnp block
  (hail_tpu/stats/linear_mixed_model.py:196-206).
- `hl.linear_mixed_model` on the `k=` and `z_t=` routes, then
  `hl.linear_mixed_regression_rows`, on balding_nichols_model data as
  tests/test_methods.py:236 builds it.
"""

import math

import numpy as np
import pytest
import torch

import hail_tpu as hr
import hail_tpu_torch as hlt
from hail_tpu.stats.linear_mixed_model import LinearMixedModel as RefLMM
from hail_tpu_torch.stats.linear_mixed_model import LinearMixedModel as PortLMM

FIT_FIELDS = ('h_sq', 'beta', 'sigma_sq', 'tau_sq', 'log_gamma', 'gamma')


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def _simulate(n=300, m=180, h2=0.5, seed=0):
    """tests/test_lmm.py's simulation: (y, X, K, Z)."""
    rng = np.random.default_rng(seed)
    Z = rng.integers(0, 3, (n, m)).astype(np.float64)
    Z = (Z - Z.mean(0)) / np.maximum(Z.std(0), 1e-8)
    K = Z @ Z.T / m
    g = rng.multivariate_normal(np.zeros(n), K)
    e = rng.normal(size=n)
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = (X @ np.array([0.5, -0.2]) + math.sqrt(h2) * g / g.std()
         + math.sqrt(1 - h2) * e / e.std())
    return y, X, K, Z


def _fit_pair(route, y, X, K, Z):
    models = []
    for cls in (RefLMM, PortLMM):
        m = (cls.from_kinship(y, X, K) if route == 'kinship'
             else cls.from_random_effects(y, X, Z))
        m.fit()
        models.append(m)
    return models


def assert_same_fit(ref, port):
    assert port.fitted and ref.fitted
    for f in FIT_FIELDS:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=1e-12, err_msg=f)
    np.testing.assert_array_equal(port.s, ref.s)
    np.testing.assert_array_equal(port._u, ref._u)


def assert_same_alternatives(got, want):
    for f, rtol in (('beta', 1e-10), ('sigma_sq', 1e-10), ('chi_sq', 1e-10),
                    ('p_value', 1e-8)):
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert np.array_equal(np.isnan(g), np.isnan(w)), f
        np.testing.assert_allclose(g, w, rtol=rtol, err_msg=f)


@pytest.mark.parametrize('route,h2,seed,n,m', [
    ('kinship', 0.6, 1, 300, 180),
    ('random_effects', 0.6, 1, 300, 180),
    ('kinship', 0.5, 2, 120, 60),
    ('random_effects', 0.5, 2, 120, 60),
])
def test_fit_equals_reference(route, h2, seed, n, m):
    """test_h2_recovery_full_rank and test_low_rank_matches_full_rank, on
    both routes."""
    ref, port = _fit_pair(route, *_simulate(n=n, m=m, h2=h2, seed=seed))
    assert_same_fit(ref, port)
    if route == 'kinship' and seed == 1:
        assert 0.3 < port.h_sq < 0.9
        assert port.sigma_sq > 0 and port.tau_sq > 0


def test_low_rank_matches_full_rank():
    y, X, K, Z = _simulate(n=120, m=60, h2=0.5, seed=2)
    full = PortLMM.from_kinship(y, X, K)
    full.fit()
    low = PortLMM.from_random_effects(y, X, Z)
    low.fit()
    assert abs(full.h_sq - low.h_sq) < 0.02
    np.testing.assert_allclose(full.beta, low.beta, atol=1e-4)


def test_compute_neg_log_reml_equals_reference():
    ref, port = _fit_pair('kinship', *_simulate(seed=3))
    at_opt = port.compute_neg_log_reml(port.log_gamma)
    for dlg in (-0.5, 0.0, 0.5):
        lg = port.log_gamma + dlg
        assert port.compute_neg_log_reml(lg) == ref.compute_neg_log_reml(lg)
        assert port.compute_neg_log_reml(lg) >= at_opt - 1e-9
        got = port.compute_neg_log_reml(lg, return_parameters=True)
        want = ref.compute_neg_log_reml(lg, return_parameters=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_fixed_log_gamma_fit_equals_reference():
    ref, port = _fit_pair('kinship', *_simulate(seed=3))
    for m in (ref, port):
        m.fit(log_gamma=0.25)
    assert_same_fit(ref, port)


def test_h_sq_standard_error_and_lkhd_equal_reference():
    ref, port = _fit_pair('kinship', *_simulate(seed=4))
    assert port.h_sq_standard_error == ref.h_sq_standard_error
    se = port.h_sq_standard_error
    assert se is None or 0 < se < 1
    lk = port.h_sq_normalized_lkhd()
    np.testing.assert_array_equal(lk, ref.h_sq_normalized_lkhd())
    assert lk.shape == (101,) and abs(lk.sum() - 1) < 1e-12
    hs = np.linspace(0.01, 0.99, 101)
    assert abs(hs[np.argmax(lk)] - port.h_sq) < 0.15


@pytest.mark.parametrize('route', ['kinship', 'random_effects'])
def test_batched_equals_reference_and_scalar_loop(route):
    """test_batched_matches_scalar_loop, plus a variant of zeros (NaN)."""
    ref, port = _fit_pair(route, *_simulate(n=150, seed=5))
    rng = np.random.default_rng(6)
    G = rng.integers(0, 3, (150, 40)).astype(np.float64)
    G[:, 7] = 0.0
    pa = port._u.T @ G
    got = port.fit_alternatives_batched(pa)
    assert_same_alternatives(got, ref.fit_alternatives_batched(pa))
    assert np.isnan(got['beta'][7]) and np.isnan(got['chi_sq'][7])
    loop = port.fit_alternatives_numpy(np.delete(pa, 7, axis=1))
    ref_loop = ref.fit_alternatives_numpy(np.delete(pa, 7, axis=1))
    for f in loop:
        np.testing.assert_array_equal(loop[f], ref_loop[f])
    ok = np.delete(np.arange(40), 7)
    np.testing.assert_allclose(got['beta'][ok], loop['beta'], rtol=1e-8)
    np.testing.assert_allclose(got['chi_sq'][ok], loop['chi_sq'],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got['p_value'][ok], loop['p_value'],
                               rtol=1e-6, atol=1e-12)


def test_causal_variant_detected():
    rng = np.random.default_rng(7)
    n, m = 250, 120
    Z = rng.integers(0, 3, (n, m)).astype(np.float64)
    K = (Z - Z.mean(0)) / np.maximum(Z.std(0), 1e-8)
    K = K @ K.T / m
    causal = rng.integers(0, 3, n).astype(np.float64)
    y = 0.8 * causal + rng.normal(size=n)
    X = np.ones((n, 1))
    ref, port = _fit_pair('kinship', y, X, K, None)
    G = np.column_stack([causal] + [rng.integers(0, 3, n).astype(np.float64)
                                    for _ in range(20)])
    pa = port._u.T @ G
    res = port.fit_alternatives_batched(pa)
    assert_same_alternatives(res, ref.fit_alternatives_batched(pa))
    assert res['p_value'][0] < 1e-6
    assert np.median(res['p_value'][1:]) > 0.01


def test_contractions_equal_reference_block():
    import jax.numpy as jnp
    from hail_tpu_torch.ops.lmm import contractions
    rng = np.random.default_rng(8)
    n, m, k = 97, 33, 3
    pa = rng.normal(size=(n, m))
    wpx = rng.normal(size=(n, k))
    w = rng.random(n) + 0.5
    r0 = rng.normal(size=n)
    got = contractions(*(torch.from_numpy(a) for a in (pa, wpx, w, r0)))
    assert got.dtype == torch.float64 and got.shape == (k + 2, m)
    paj, wj = jnp.asarray(pa), jnp.asarray(w)
    want = np.concatenate([
        np.asarray(jnp.asarray(wpx).T @ paj),
        np.asarray(jnp.sum(paj * (wj[:, None] * paj), axis=0))[None],
        np.asarray((wj * r0) @ paj)[None]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)


def _bn(pkg_hl):
    """tests/test_methods.py's `bn` MatrixTable, from a rewound seed
    sequence, so both packages draw the same calls and phenotypes."""
    pkg_hl.reset_global_randomness()
    mt = pkg_hl.balding_nichols_model(2, 60, 80)
    return mt.annotate_cols(pheno=pkg_hl.rand_norm(seed=11),
                            cov1=pkg_hl.rand_norm(seed=12))


def _lmm_rows(pkg_hl, mt, route, K):
    x = mt.GT.n_alt_alleles()
    if route == 'k':
        model, Z = pkg_hl.linear_mixed_model(mt.pheno, [1.0, mt.cov1], k=K)
        assert Z is None
    else:
        model, Z = pkg_hl.linear_mixed_model(mt.pheno, [1.0], z_t=x)
        assert Z.shape == (60, 80)
    model.fit()
    rows = pkg_hl.linear_mixed_regression_rows(x, model).collect()
    return model, rows


@pytest.mark.parametrize('route', ['k', 'z_t'])
def test_linear_mixed_regression_rows_equals_reference(route):
    ref_mt = _bn(hr)
    K = hr.genetic_relatedness_matrix(ref_mt.GT).to_numpy() \
        if route == 'k' else None
    ref, ref_rows = _lmm_rows(hr, ref_mt, route, K)
    port, rows = _lmm_rows(hlt, _bn(hlt), route, K)
    assert_same_fit(ref, port)
    assert 0 <= port.h_sq <= 1
    assert len(rows) == 80
    assert [(r.locus.position, r.alleles) for r in rows] == \
        [(r.locus.position, r.alleles) for r in ref_rows]
    assert_same_alternatives(
        {f: [r[f] for r in rows] for f in ('beta', 'sigma_sq', 'chi_sq',
                                           'p_value')},
        {f: [r[f] for r in ref_rows] for f in ('beta', 'sigma_sq', 'chi_sq',
                                               'p_value')})
    assert all(0 <= r.p_value <= 1 for r in rows if not np.isnan(r.p_value))


def test_kinship_block_matrix_argument():
    """`k=` takes the port's BlockMatrix (GRM) as well as its numpy array."""
    mt = _bn(hlt)
    grm = hlt.genetic_relatedness_matrix(mt.GT)
    a, _ = hlt.linear_mixed_model(mt.pheno, [1.0, mt.cov1], k=grm)
    b, _ = hlt.linear_mixed_model(mt.pheno, [1.0, mt.cov1], k=grm.to_numpy())
    a.fit()
    b.fit()
    assert_same_fit(a, b)


def test_errors_equal_reference():
    for pkg_hl in (hr, hlt):
        mt = _bn(pkg_hl)
        with pytest.raises(ValueError, match='provide z_t'):
            pkg_hl.linear_mixed_model(mt.pheno, [1.0])
        model, _ = pkg_hl.linear_mixed_model(mt.pheno, [1.0],
                                             z_t=mt.GT.n_alt_alleles())
        model._u = None
        with pytest.raises(ValueError, match='lacks rotation matrix'):
            pkg_hl.linear_mixed_regression_rows(mt.GT.n_alt_alleles(), model)


def test_stats_exports_linear_mixed_model():
    assert hlt.stats.LinearMixedModel is PortLMM
    assert 'LinearMixedModel' in hlt.stats.__all__
