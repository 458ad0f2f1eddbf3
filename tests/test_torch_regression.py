"""The port's per-variant regressions (hail_tpu_torch/ops/regression.py)
against hail_tpu's on the same numpy inputs, on the CPU.

Tolerances: the fits (`logreg_null_fit`, `glm_per_variant_fit` with both
links, `glm_score_test`, `firth_fit`) at rtol 1e-9 in f64 (the same Newton
steps, their sums in another order), with `n_iter`, `converged` and the
call counts equal: both packages stop every row on the largest |delta| of
all rows, so `n_iter` is one number. `linreg_stats(precision='float32')`
against the reference's f32 route within the f32 bar of the repo (rtol
2e-4, atol 1e-6), and both within it of the f64 route. A Hessian that is
not positive definite gives NaN in both packages (`jnp.linalg.cholesky`
returns NaN; the port's `_chol` makes its factor NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hail_tpu.ops import regression as ref
from hail_tpu_torch.ops import regression as port

RTOL = 1e-9


def _data(R, N, k, seed, miss_rate=0.05):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (R, N)).astype(np.float64)
    miss = rng.random((R, N)) < miss_rate
    miss[0] = True                                  # an all-missing row
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, k - 1))],
                         axis=1)
    eta = cov @ (rng.normal(size=k) * 0.3) + 0.2 * G.mean(axis=0)
    yb = (rng.random(N) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    yc = rng.poisson(np.exp(np.clip(eta, -2, 2))).astype(np.float64)
    return G, miss, cov, yb, yc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want, what, atol=0.0):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind in 'biu':
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   equal_nan=True, err_msg=what)


def _null(cov, yb):
    return np.asarray(ref.logreg_null_fit(jnp.asarray(cov),
                                          jnp.asarray(yb))[0])


@pytest.mark.parametrize('k', [1, 3])
def test_logreg_null_fit(k):
    _, _, cov, yb, _ = _data(4, 400, k, seed=k)
    want = ref.logreg_null_fit(jnp.asarray(cov), jnp.asarray(yb))
    got = port.logreg_null_fit(_t(cov), _t(yb))
    for name, g, w in zip(('beta', 'mu', 'converged', 'll', 'n_iter'),
                          got, want):
        _same(g, w, name)
    assert bool(got[2]) and got[4] >= 1


@pytest.mark.parametrize('link', ['logistic', 'poisson'])
@pytest.mark.parametrize('R,N,k,max_iter', [(40, 300, 3, 25), (7, 120, 2, 3),
                                            (1, 64, 1, 25)])
def test_glm_per_variant_fit(link, R, N, k, max_iter):
    G, miss, cov, yb, yc = _data(R, N, k, seed=R + N)
    y = yb if link == 'logistic' else yc
    b0 = (_null(cov, yb) if link == 'logistic'
          else np.r_[np.log(yc.mean()), np.zeros(k - 1)])
    want = ref.glm_per_variant_fit(
        jnp.asarray(G), jnp.asarray(miss), jnp.asarray(cov), jnp.asarray(y),
        jnp.asarray(b0), max_iter=max_iter, link=link)
    got = port.glm_per_variant_fit(_t(G), _t(miss), _t(cov), _t(y), _t(b0),
                                   max_iter=max_iter, link=link)
    for name, g, w in zip(('beta', 'se_g', 'll', 'converged', 'n_iter',
                           'n_called'), got, want):
        _same(g, w, f'{link} {name}')
    assert got[4] == int(want[4]) and 1 <= got[4] <= max_iter


def test_glm_per_variant_fit_rejects_an_unknown_link():
    G, miss, cov, yb, _ = _data(2, 30, 2, seed=1)
    with pytest.raises(ValueError, match='link'):
        port.glm_per_variant_fit(_t(G), _t(miss), _t(cov), _t(yb),
                                 torch.zeros(2), link='probit')


@pytest.mark.parametrize('link', ['logistic', 'poisson'])
def test_glm_score_test(link):
    G, miss, cov, yb, yc = _data(30, 250, 3, seed=5)
    y = yb if link == 'logistic' else yc
    b0 = _null(cov, yb)
    want = ref.glm_score_test(jnp.asarray(G), jnp.asarray(miss),
                              jnp.asarray(cov), jnp.asarray(y),
                              jnp.asarray(b0), link=link)
    got = port.glm_score_test(_t(G), _t(miss), _t(cov), _t(y), _t(b0),
                              link=link)
    _same(got[0], want[0], 'chi2')
    _same(got[1], want[1], 'n_called')


@pytest.mark.parametrize('restricted', [True, False])
def test_firth_fit(restricted):
    G, miss, cov, yb, _ = _data(25, 200, 3, seed=11)
    k = cov.shape[1]
    bs = np.concatenate([np.broadcast_to(_null(cov, yb), (25, k)),
                         np.zeros((25, 1))], axis=1)
    m0 = k if restricted else k + 1
    want = ref.firth_fit(jnp.asarray(G), jnp.asarray(miss), jnp.asarray(cov),
                         jnp.asarray(yb), jnp.asarray(bs), m0)
    got = port.firth_fit(_t(G), _t(miss), _t(cov), _t(yb), _t(bs), m0)
    for name, g, w in zip(('beta', 'll_pen', 'converged', 'n_iter',
                           'n_called'), got, want):
        _same(g, w, f'firth m0={m0} {name}')
    if restricted:
        assert (got[0][:, k] == 0).all()


def test_non_spd_hessian_gives_nan_in_both():
    """A batch of one SPD and one indefinite Hessian: the indefinite one's
    Cholesky factor is NaN in both packages, and so are its solve, inverse
    and log-determinant; the SPD one's agree. In a fit: a poisson start
    whose fitted means overflow makes every Hessian non-finite, every
    coefficient NaN in both, and the NaN delta stops the loop after one
    step in both."""
    H = np.eye(3)[None].repeat(2, axis=0) * 2.0
    H[1] = [[1, 2, 0], [2, 1, 0], [0, 0, 1]]     # indefinite
    b = np.ones((2, 3))
    _same(port._psd_solve(_t(H), _t(b)),
          ref._psd_solve(jnp.asarray(H), jnp.asarray(b)), '_psd_solve')
    _same(port._psd_inv(_t(H)), ref._psd_inv(jnp.asarray(H)), '_psd_inv')
    _same(port._psd_logdet(_t(H)), ref._psd_logdet(jnp.asarray(H)),
          '_psd_logdet')
    x = port._psd_solve(_t(H), _t(b)).numpy()
    assert np.isnan(x[1]).all() and np.isfinite(x[0]).all()
    assert np.isnan(port._chol(_t(H))[1].numpy()).all()
    G, miss, cov, _, yc = _data(4, 50, 2, seed=3)
    b0 = np.array([800.0, 0.0])                   # exp(800) overflows
    want = ref.glm_per_variant_fit(jnp.asarray(G), jnp.asarray(miss),
                                   jnp.asarray(cov), jnp.asarray(yc),
                                   jnp.asarray(b0), max_iter=3,
                                   link='poisson')
    got = port.glm_per_variant_fit(_t(G), _t(miss), _t(cov), _t(yc), _t(b0),
                                   max_iter=3, link='poisson')
    for name, g, w in zip(('beta', 'se_g', 'll', 'converged', 'n_iter',
                           'n_called'), got, want):
        _same(g, w, name)
    assert np.isnan(got[0].numpy()).all() and got[4] == 1


def test_helpers():
    rng = np.random.default_rng(2)
    G = rng.normal(size=(5, 9))
    miss = rng.random((5, 9)) < 0.3
    miss[1] = True
    for g, w in zip(port._impute_mean(_t(G), _t(miss)),
                    ref._impute_mean(jnp.asarray(G), jnp.asarray(miss))):
        _same(g, w, '_impute_mean')
    # 0.5 (tanh(x / 2) + 1): near 0 it is a difference of two values near
    # 1, so the two libraries' tanh give values a few ulps of 1 apart there
    x = np.linspace(-40, 40, 101)
    _same(port._sigmoid(_t(x)), ref._sigmoid(jnp.asarray(x)), '_sigmoid',
          atol=1e-15)
    A = rng.normal(size=(3, 4, 4))
    H = A @ A.transpose(0, 2, 1) + np.eye(4)
    b = rng.normal(size=(3, 4))
    _same(port._psd_solve(_t(H), _t(b)),
          ref._psd_solve(jnp.asarray(H), jnp.asarray(b)), '_psd_solve')
    _same(port._psd_inv(_t(H)), ref._psd_inv(jnp.asarray(H)), '_psd_inv')
    _same(port._psd_logdet(_t(H)), ref._psd_logdet(jnp.asarray(H)),
          '_psd_logdet')


def _ols_inputs(R, N, k, P, seed):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (R, N)).astype(np.float64)
    miss = rng.random((R, N)) < 0.05
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, k - 1))],
                         axis=1)
    sw = np.sqrt(rng.uniform(0.5, 2.0, N))
    Q, _ = np.linalg.qr(cov * sw[:, None])
    Ys = rng.normal(size=(N, P)) * sw[:, None]
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(axis=0) - (Qty * Qty).sum(axis=0)
    return G, miss, sw, Q, Ys, Qty, yyp, N - k - 1


@pytest.fixture
def cpu_session():
    import hail_tpu_torch as hl
    hl.init(device='cpu', quiet=True)
    yield
    hl.stop()


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('R,N,k,P', [(30, 200, 3, 1), (9, 77, 1, 2)])
def test_linreg_stats_float32(R, N, k, P, weighted, cpu_session):
    G, miss, sw, Q, Ys, Qty, yyp, dof = _ols_inputs(R, N, k, P, R + N)
    sw = sw if weighted else None
    want = ref.linreg_stats(G, miss, sw, Q, Ys, Qty, yyp, dof,
                            precision='float32')
    got = port.linreg_stats(G, miss, sw, Q, Ys, Qty, yyp, dof,
                            precision='float32')
    f64 = port.linreg_stats(G, miss, sw, Q, Ys, Qty, yyp, dof)
    for name in ('sum_x', 'y_transpose_x', 'beta', 'standard_error',
                 't_stat', 'p_value'):
        assert got[name].dtype == np.float64
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[name], f64[name], rtol=2e-4,
                                   atol=1e-6, err_msg=f'{name} vs f64')
    assert not np.array_equal(got['beta'], f64['beta'])   # it is f32


@pytest.mark.parametrize('precision,rtol', [('float64', 1e-10),
                                            ('float32', 2e-4)])
def test_linreg_stats_takes_the_reference_arguments(precision, rtol,
                                                    cpu_session):
    """`linreg_stats` has the reference's signature: `precision` in the
    ninth place, the session's device; any other ninth argument (a device
    string) is refused, where the reference would take the f32 route."""
    G, miss, sw, Q, Ys, Qty, yyp, dof = _ols_inputs(12, 90, 2, 2, 5)
    want = ref.linreg_stats(G, miss, sw, Q, Ys, Qty, yyp, dof, precision)
    got = port.linreg_stats(G, miss, sw, Q, Ys, Qty, yyp, dof, precision)
    for name, v in want.items():
        assert got[name].dtype == np.float64
        np.testing.assert_allclose(got[name], v, rtol=rtol, atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match='precision'):
        port.linreg_stats(G, miss, sw, Q, Ys, Qty, yyp, dof, 'cpu')


def test_linreg_block_f32_is_true_f32():
    """The f32 route computes in f32 (not f64, not TF32) and leaves the
    global TF32 switch as it found it."""
    G, miss, sw, Q, Ys, Qty, yyp, dof = _ols_inputs(12, 90, 2, 1, 4)
    before = torch.backends.cuda.matmul.allow_tf32
    out = port.linreg_block_f32(_t(G), _t(miss), _t(sw), _t(Q), _t(Ys),
                                _t(Qty), _t(yyp), float(dof))
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert all(v.dtype == torch.float32 for v in out)
