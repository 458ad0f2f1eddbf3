"""PCA and the decompositions in the port against hail_tpu, on the CPU:
`pca`, `hwe_normalized_pca` (with loadings), `_blanczos_pca` on its exact
branch (a small input: one host SVD) and its randomized branch (more than
4 << 20 entries), each with `transpose`, `_hwe_normalized_blanczos`,
`_make_tsm` with whitening, `_spectral_moments`, `_pca_and_moments`, the
randomized route of `_pca_core`, and ops/decomp's `chol_qr`,
`randomized_svd`, `gramian_svd` and `host_svd` (mirroring
tests/test_decomp.py, and against the reference on the same inputs).

Both packages draw Ω from `np.random.default_rng(seed)` with the seed of
`Env.next_seed()` after `reset_global_randomness()`. Tolerances:
- the exact branches run the same host LAPACK on the same matrix: equal
  to 1e-12 (relative for eigenvalues, of the largest score for scores);
- the randomized branches take their products in torch where the reference
  takes them in XLA, sums in another order: eigenvalues within rtol 1e-9,
  scores and loadings within 1e-8 of the largest. Signs must agree too: the
  l x l eigh runs in host LAPACK in both packages, on nearly equal input.
"""

import importlib

import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt
from hail_tpu_torch.ops import decomp

N_SAMPLES, ROWS, PARTS = 40, 60, 3
# the modules (`hl.methods.pca` is the function)
PORT_PCA = importlib.import_module('hail_tpu_torch.methods.pca')
REF_PCA = importlib.import_module('hail_tpu.methods.pca')


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


@pytest.fixture
def both(hl):
    hl.reset_global_randomness()
    hlt.reset_global_randomness()
    return hl


def build_mt(pkg, n=N_SAMPLES, rows=ROWS, parts=PARTS, seed=0, x=None):
    """GT calls from two populations with 4% missing, and the float entry
    field X (given as an (m, n) array `x`, or a noisy rank-3 matrix)."""
    ht = importlib.import_module(f'{pkg}.types')
    call = importlib.import_module(f'{pkg}.genetics.call')
    C = importlib.import_module(f'{pkg}.ir.columns')
    mtm = importlib.import_module(f'{pkg}.matrixtable')
    rg = importlib.import_module(f'{pkg}.genetics.reference_genome')
    ref = rg.default_reference()
    rng = np.random.default_rng(seed)
    m = rows * parts
    af = np.clip(rng.uniform(0.1, 0.9, m)[:, None]
                 + 0.15 * rng.normal(size=(m, 1)) * (np.arange(n) % 2 - 0.5),
                 0.02, 0.98)
    nalt = rng.binomial(2, af)
    nalt[:3] = 0                               # monomorphic: dropped by HWE
    miss = rng.random((m, n)) < 0.04
    if x is None:
        x = rng.normal(size=(m, 3)) @ rng.normal(size=(3, n)) * 3 \
            + rng.normal(size=(m, n))
    mbs = []
    for p in range(parts):
        sl = slice(p * rows, (p + 1) * rows)
        alleles = np.empty(rows, dtype=object)
        alleles[:] = [['A', 'C']] * rows
        rb = C.Batch({
            'locus': C.LocusColumn(ht.tlocus(ref), np.zeros(rows, np.int32),
                                   np.arange(sl.start, sl.stop, dtype=np.int32) + 1),
            'alleles': C.ObjectColumn(ht.tarray(ht.tstr), alleles)}, rows)
        gt = call.pack_diploid((nalt[sl] == 2).astype(np.int32),
                               (nalt[sl] >= 1).astype(np.int32))
        mbs.append(mtm.MatrixBatch(rb, {
            'GT': C.PrimitiveColumn(ht.tcall, gt, miss[sl]),
            'X': C.PrimitiveColumn(ht.tfloat64, np.ascontiguousarray(x[sl]))}))
    cols = C.Batch({'s': C.ObjectColumn(ht.tstr, np.asarray(
        [f's{i}' for i in range(n)], object))}, n)
    return mtm.MatrixTable(mtm.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus', 'alleles'], ['s'],
        ht.tstruct(locus=ht.tlocus(ref), alleles=ht.tarray(ht.tstr)),
        ht.tstruct(s=ht.tstr), ht.tstruct(GT=ht.tcall, X=ht.tfloat64), mbs))


def _arr(table, field):
    if table is None:
        return None
    return np.array([list(r[field]) for r in table.collect()])


def _keys(table):
    return [tuple(str(v) for v in r.values()) for r in
            table.select().collect()]


def assert_pca_close(got, want, exact):
    """(eigenvalues, scores table, loadings table) of the port against the
    reference's: keys equal, values at the module's tolerances."""
    ev_tol, vec_tol = (1e-12, 1e-12) if exact else (1e-9, 1e-8)
    np.testing.assert_allclose(got[0], want[0], rtol=ev_tol, atol=0)
    for g_t, w_t in zip(got[1:], want[1:]):
        assert (g_t is None) == (w_t is None)
        if g_t is None:
            continue
        field = [f for f in g_t.row if f not in g_t.key][0]
        assert _keys(g_t) == _keys(w_t)
        w = _arr(w_t, field)
        np.testing.assert_allclose(_arr(g_t, field), w, rtol=0,
                                   atol=vec_tol * np.abs(w).max(),
                                   err_msg=field)


def test_pca_matches_reference(both):
    got = hlt.pca(build_mt('hail_tpu_torch').X, k=4, compute_loadings=True)
    want = both.pca(build_mt('hail_tpu').X, k=4, compute_loadings=True)
    assert_pca_close(got, want, exact=True)


@pytest.mark.parametrize('loadings', [False, True])
def test_hwe_normalized_pca_matches_reference(both, loadings):
    got = hlt.hwe_normalized_pca(build_mt('hail_tpu_torch').GT, k=3,
                                 compute_loadings=loadings)
    want = both.hwe_normalized_pca(build_mt('hail_tpu').GT, k=3,
                                   compute_loadings=loadings)
    assert_pca_close(got, want, exact=True)
    if loadings:
        # the three monomorphic variants carry no loading
        assert got[2].count() == ROWS * PARTS - 3


def test_pca_core_randomized_route_matches_reference(both):
    """`_pca_core(exact=False)`: the randomized SVD (q = 2) with the
    matrix on the session's device."""
    A = np.random.default_rng(5).normal(size=(300, 90))
    got = PORT_PCA._pca_core(A, 5, True, exact=False)
    want = REF_PCA._pca_core(A, 5, True, exact=False)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-8 * np.abs(w).max())


@pytest.mark.parametrize('transpose', [False, True])
def test_blanczos_pca_exact_branch_matches_reference(both, transpose):
    kw = dict(k=3, compute_loadings=True, q_iterations=4, transpose=transpose)
    got = hlt._blanczos_pca(build_mt('hail_tpu_torch').X, **kw)
    want = both._blanczos_pca(build_mt('hail_tpu').X, **kw)
    assert_pca_close(got, want, exact=True)


@pytest.mark.parametrize('transpose', [False, True])
def test_blanczos_pca_randomized_branch_matches_reference(both, transpose):
    """2,052 x 2,050 entries, past the 4 << 20 of the exact branch."""
    x = np.random.default_rng(9).normal(size=(2052, 2050))
    x[:, :5] *= 6.0
    kw = dict(k=3, compute_loadings=True, q_iterations=2,
              oversampling_param=5, transpose=transpose)
    got = hlt._blanczos_pca(build_mt('hail_tpu_torch', n=2050, rows=684,
                                     x=x).X, **kw)
    want = both._blanczos_pca(build_mt('hail_tpu', n=2050, rows=684, x=x).X,
                              **kw)
    assert_pca_close(got, want, exact=False)


def test_hwe_normalized_blanczos_matches_reference(both):
    kw = dict(k=3, compute_loadings=True, q_iterations=3)
    got = hlt._hwe_normalized_blanczos(build_mt('hail_tpu_torch').GT, **kw)
    want = both._hwe_normalized_blanczos(build_mt('hail_tpu').GT, **kw)
    assert_pca_close(got, want, exact=False)


@pytest.mark.parametrize('normalize', [False, True])
def test_make_tsm_whitened_and_spectral_moments(both, normalize):
    kw = dict(whiten_window_size=6, normalize_after_whiten=normalize)
    got = PORT_PCA._make_tsm(build_mt('hail_tpu_torch').X, 32, **kw)
    want = REF_PCA._make_tsm(build_mt('hail_tpu').X, 32, **kw)
    np.testing.assert_array_equal(got._whitened, want._whitened)
    assert got.ncols == want.ncols and got.col_key == want.col_key
    assert got.block_table.count() == want.block_table.count()
    m_got = hlt._spectral_moments(got, 4)
    m_want = both._spectral_moments(want, 4)
    np.testing.assert_allclose(m_got[0], m_want[0], rtol=1e-12)
    assert m_got[1] == m_want[1]


def test_pca_and_moments_matches_reference(both):
    got = hlt._pca_and_moments(build_mt('hail_tpu_torch').X, k=3,
                               num_moments=3, compute_loadings=True)
    want = both._pca_and_moments(build_mt('hail_tpu').X, k=3,
                                 num_moments=3, compute_loadings=True)
    assert_pca_close(got[:3], want[:3], exact=True)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12)
    assert got[4] == want[4]


# -- ops/decomp (tests/test_decomp.py, on torch tensors) --------------------

def _t(a):
    return torch.from_numpy(a)


def test_chol_qr_orthonormal_and_rank_deficient(hl):
    from hail_tpu.ops import decomp as ref
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(500, 12))
    Q = decomp.chol_qr(_t(Y))
    assert isinstance(Q, torch.Tensor) and Q.dtype == torch.float64
    Qn = Q.numpy()
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(12), atol=1e-10)
    np.testing.assert_allclose(Qn @ (Qn.T @ Y), Y, atol=1e-8)
    np.testing.assert_allclose(Qn, np.asarray(ref.chol_qr(Y)), atol=1e-12)
    base = rng.normal(size=(200, 3))
    Yd = np.concatenate([base, base @ rng.normal(size=(3, 5))], axis=1)
    Qd = decomp.chol_qr(_t(Yd)).numpy()
    assert np.isfinite(Qd).all()
    w = np.linalg.eigvalsh(Qd.T @ Qd)
    assert np.all((np.abs(w) < 1e-6) | (np.abs(w - 1) < 1e-6))


@pytest.mark.parametrize('shape', [(300, 40), (40, 300)])
def test_randomized_svd_matches_lapack_and_reference(hl, shape):
    import jax.numpy as jnp
    from hail_tpu.ops import decomp as ref
    rng = np.random.default_rng(2)
    A = rng.normal(size=(shape[0], 10)) @ rng.normal(size=(10, shape[1]))
    A = A + 1e-6 * rng.normal(size=shape)
    U, s, Vt = decomp.randomized_svd(_t(A), k=8, q=3, seed=7)
    assert isinstance(U, torch.Tensor) and isinstance(Vt, torch.Tensor)
    s_true = np.linalg.svd(A, compute_uv=False)[:8]
    np.testing.assert_allclose(s, s_true, rtol=1e-6)
    U_t, s_t, Vt_t = np.linalg.svd(A, full_matrices=False)
    np.testing.assert_allclose(U.numpy() * s[None, :] @ Vt.numpy(),
                               U_t[:, :8] * s_t[:8][None, :] @ Vt_t[:8],
                               atol=1e-5)
    Ur, sr, Vtr = ref.randomized_svd(jnp.asarray(A), k=8, q=3, seed=7)
    np.testing.assert_allclose(s, sr, rtol=1e-9)
    # the numpy backend of the port's function is the reference's on numpy
    Un, sn, Vtn = decomp.randomized_svd(A, k=8, q=3, seed=7)
    Unr, snr, Vtnr = ref.randomized_svd(A, k=8, q=3, seed=7)
    np.testing.assert_array_equal(sn, snr)
    np.testing.assert_array_equal(Un, Unr)


@pytest.mark.parametrize('shape', [(120, 30), (30, 120)])
def test_gramian_svd(hl, shape):
    from hail_tpu.ops import decomp as ref
    A = np.random.default_rng(3).normal(size=shape)
    U, s, Vt = decomp.gramian_svd(_t(A))
    s_true = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(s, s_true, rtol=1e-8)
    np.testing.assert_allclose((U * s[None, :]) @ Vt, A, atol=1e-8)
    np.testing.assert_allclose(decomp.gramian_svd(_t(A), compute_uv=False),
                               s_true, rtol=1e-8)
    _, s_ref, _ = ref.gramian_svd(A)
    np.testing.assert_allclose(s, s_ref, rtol=1e-12)


def test_host_svd_tensor_input():
    A = np.random.default_rng(4).normal(size=(50, 20))
    U, s, Vt = decomp.host_svd(_t(A))
    np.testing.assert_allclose((U * s[None, :]) @ Vt, A, atol=1e-10)
