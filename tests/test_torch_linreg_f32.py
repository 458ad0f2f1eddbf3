"""The port's f32 int8 linreg path (K1's wrapper `linreg_i8_sums`, the
f32 OLS epilogue, `linreg_block_i8`, `linreg_stats_i8`) against
hail_tpu/ops/linreg_i8.py on the same numpy inputs, on the CPU, where the
port's wrapper runs K1's plain torch version. The reference's K1 runs in
Pallas interpret mode, as tests/test_linreg_i8.py runs it.

Tolerances: the three row sums are integers, exact in f32, so they are
equal; GW and MW agree at rtol 1e-5, atol 1e-5 (f32 sums of the same
exact products, taken in another order). The OLS outputs are f32 in both
packages: beta, se and t agree at rtol 1e-4, atol 1e-5, the p-values at
rtol 5e-5, atol 1e-9. Each f32 path is itself that far from the exact
f64 results (at R = 100, N = 300 both packages' p-values lie within about
1.2e-5 relative of the exact path's, their t within about 9e-5 near zero),
so two f32 paths that sum in other orders differ by up to twice that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hail_tpu.ops import linreg_i8 as ref
from hail_tpu_torch.ops import linreg_i8 as port

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
OLS_TOL = dict(rtol=1e-4, atol=1e-5)


def _make(R, N, K=3, P=1, miss_rate=0.05, seed=0):
    """tests/test_linreg_i8.py's inputs: int8 G with -1 = missing and the
    OLS operands of covariates [1, normal...]."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (R, N)).astype(np.int8)
    miss = rng.random((R, N)) < miss_rate
    G8 = np.where(miss, -1, G).astype(np.int8)
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, K - 1))], axis=1)
    Q, _ = np.linalg.qr(cov)
    y = rng.normal(size=(N, P))
    Qty = Q.T @ y
    yyp = (y * y).sum(axis=0) - (Qty * Qty).sum(axis=0)
    return G8, miss, Q, y, Qty, yyp, N - K - 1


def _W(Q, Ys):
    return np.concatenate([Q, Ys], axis=1).astype(np.float32)


def _assert_sums(got, want_gw, want_mw, want_st):
    gw, mw, st = (a.numpy() for a in got)
    assert gw.dtype == mw.dtype == st.dtype == np.float32
    np.testing.assert_array_equal(st, want_st)
    np.testing.assert_allclose(gw, want_gw, **SUM_TOL)
    np.testing.assert_allclose(mw, want_mw, **SUM_TOL)


@pytest.mark.parametrize('R,N,K,P', [(64, 256, 2, 1), (77, 333, 3, 2),
                                     (5, 1030, 4, 1), (30, 100, 10, 5)])
def test_sums_ref_matches_reference_sums_ref(R, N, K, P):
    G8, _, Q, Ys, _, _, _ = _make(R, N, K, P, seed=R + N)
    W = _W(Q, Ys)
    want = [np.asarray(a) for a in ref._sums_ref(jnp.asarray(G8),
                                                 jnp.asarray(W))]
    got = port._sums_ref(torch.from_numpy(G8), torch.from_numpy(W))
    _assert_sums(got, *want)
    # the wrapper takes the plain version for CPU tensors
    _assert_sums(port.linreg_i8_sums(torch.from_numpy(G8), torch.from_numpy(W)),
                 *want)


@pytest.mark.parametrize('R,N,K,P', [(64, 256, 2, 1), (77, 333, 3, 2)])
def test_sums_match_reference_kernel_interpret(R, N, K, P):
    """Against K1 itself in interpret mode, on the reference's padded tiles:
    padded samples are missing (-1) and padded W rows zero."""
    G8, _, Q, Ys, _, _, _ = _make(R, N, K, P, seed=7 * R)
    W = _W(Q, Ys)
    Rp, Np = ref._ceil_to(R, ref.TILE_R), ref._ceil_to(N, ref.TILE_N)
    Gp = np.pad(G8, ((0, Rp - R), (0, Np - N)), constant_values=-1)
    Wp = np.pad(W, ((0, Np - N), (0, 0)))
    gw, mw, st = (np.asarray(a)[:R] for a in ref._linreg_i8_sums(
        jnp.asarray(Gp), jnp.asarray(Wp), True))
    st = st.copy()
    st[:, 0] -= Np - N
    _assert_sums(port.linreg_i8_sums(torch.from_numpy(G8), torch.from_numpy(W)),
                 gw, mw, st)


def _block(pkg_fn, G8, Q, Ys, Qty, yyp, dof, to, **kw):
    return [np.asarray(a) for a in pkg_fn(
        to(G8), to(_W(Q, Ys)), to(Qty), to(yyp), to(np.asarray(float(dof))),
        Q.shape[1], **kw)]


def _assert_ols(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == np.float32, i
        assert np.array_equal(np.isnan(a), np.isnan(b)), i
        np.testing.assert_allclose(a, b, equal_nan=True, err_msg=str(i),
                                   **OLS_TOL)


def test_block_i8_matches_reference_pallas_interpret():
    G8, _, Q, Ys, Qty, yyp, dof = _make(R=64, N=256, K=2, P=1, seed=1)
    want = _block(ref.linreg_block_i8, G8, Q, Ys, Qty, yyp, dof, jnp.asarray,
                  use_pallas=True, interpret=True)
    got = _block(port.linreg_block_i8, G8, Q, Ys, Qty, yyp, dof,
                 torch.from_numpy, use_pallas=True)
    _assert_ols(got, want)


@pytest.mark.parametrize('use_pallas', [True, False])
def test_block_i8_unpadded_shapes(use_pallas):
    # R, N not multiples of the reference's 256 x 1024 tiles
    G8, _, Q, Ys, Qty, yyp, dof = _make(R=77, N=333, K=2, P=1, seed=2)
    want = _block(ref.linreg_block_i8, G8, Q, Ys, Qty, yyp, dof, jnp.asarray,
                  use_pallas=False)
    got = _block(port.linreg_block_i8, G8, Q, Ys, Qty, yyp, dof,
                 torch.from_numpy, use_pallas=use_pallas)
    assert got[2].shape == (77, 1) and np.isfinite(got[2]).all()
    _assert_ols(got, want)


def test_all_missing_row_nan():
    # reference nd semantics: an all-missing row mean-imputes NaN → NaN stats
    G8, _, Q, Ys, Qty, yyp, dof = _make(R=8, N=64, K=2, P=1, seed=3)
    G8[0, :] = -1
    out = port.linreg_stats_i8(torch.from_numpy(G8), Q, Ys, Qty, yyp, dof)
    want = ref.linreg_stats_i8(G8, Q, Ys, Qty, yyp, dof)
    for f in ('beta', 'standard_error', 't_stat', 'p_value'):
        assert np.isnan(out[f][0]).all() and np.isnan(want[f][0]).all(), f
        assert np.isfinite(out[f][1:]).all(), f


@pytest.mark.parametrize('seed,P', [(4, 1), (5, 3)])
def test_stats_i8_pvalues_match_reference(seed, P):
    G8, miss, Q, Ys, Qty, yyp, dof = _make(R=100, N=300, P=P, seed=seed)
    want = ref.linreg_stats_i8(G8, Q, Ys, Qty, yyp, dof)
    got = port.linreg_stats_i8(torch.from_numpy(G8), Q, Ys, Qty, yyp, dof)
    for f in ('sum_x', 'y_transpose_x', 'beta', 'standard_error', 't_stat'):
        assert got[f].shape == want[f].shape, f
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **OLS_TOL)
    np.testing.assert_allclose(got['p_value'], want['p_value'], rtol=5e-5,
                               atol=1e-9)
    # and the f32 path stays near the port's exact path, by the
    # reference's own bar (tests/test_linreg_i8.py:87-90)
    exact = port.linreg_stats_i8_exact(torch.from_numpy(G8), Q, Ys, Qty, yyp,
                                       dof)
    np.testing.assert_allclose(got['beta'], exact['beta'], rtol=2e-4,
                               atol=1e-6)


def test_sums_reject_too_many_samples():
    # N above the f32 row-sum bound; R = 0 rows allocate nothing
    N = port._MAX_F32_N + 1
    with pytest.raises(ValueError, match='f32 row-sum bound'):
        port.linreg_i8_sums(torch.empty((0, N), dtype=torch.int8),
                            torch.empty((N, 2), dtype=torch.float32))


def test_true_f32_matmul_restores_setting():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for before in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = before
            with port._true_f32_matmul():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
