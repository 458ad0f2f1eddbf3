"""The port's GRM tier against hail_tpu on the same inputs, on the CPU:
`ops/grm.weight_planes`, the int32 products of `_grm_strip`, `ExactGrm`
against the f64 oracle of tests/test_grm_i8.py, and the methods
`genetic_relatedness_matrix` (both of the port's routes: the exact int8
strips the card takes, and the f64 product the CPU takes),
`realized_relationship_matrix`, `row_correlation` and `ld_matrix`.

Tolerances: digit planes, scales and int32 partials equal; ExactGrm within
1e-12 of the f64 oracle (the reference's bar: its weights are quantized to
about 2⁻⁴⁹); the f64 products at rtol 1e-12 with atol 1e-14, since the
two packages sum the same terms in other orders and an entry near zero
keeps only the absolute rounding of its partial sums (a few ulp of values
of order 1); the windowed zeros of ld_matrix equal.
"""

import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt

RTOL, ATOL = 1e-12, 1e-14


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def oracle(G, M):
    """tests/test_grm_i8.py's oracle: K = ZᵀZ/m from the hail-normalized
    genotype matrix, in f64 numpy."""
    cnt = (~M).sum(axis=1)
    s = np.where(M, 0, G).sum(axis=1)
    mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    Gi = np.where(M, mean[:, None], G).astype(np.float64)
    p = mean / 2
    denom = np.sqrt(2 * p * (1 - p))
    ok = (denom > 0) & (cnt > 0)
    Z = np.where(ok[:, None], (Gi - mean[:, None])
                 / np.where(ok, denom, 1)[:, None], 0.0)
    m = max(int(ok.sum()), 1)
    return (Z.T @ Z) / m, p, ok


def genotypes(m, n, miss_rate, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, (m, n)).astype(np.int64),
            rng.random((m, n)) < miss_rate)


@pytest.mark.parametrize('u', [
    np.array([0.3, -1.7, 2.5e-3, 0.0, 11.0]),
    np.random.default_rng(5).random(37) / 97.0,
    np.zeros(4),
    np.array([-1.0]),
])
def test_weight_planes_equal(u):
    from hail_tpu.ops.grm import weight_planes as ref
    from hail_tpu_torch.ops.grm import weight_planes as port
    (qp, sp), (qr, sr) = port(u), ref(u)
    assert qp.dtype == qr.dtype == np.int8
    np.testing.assert_array_equal(qp, qr)
    np.testing.assert_array_equal(sp, sr)


def test_plane_products_equal_reference():
    """The int32 partial Aᵀ (q_k ∘ B) of every plane, as the reference's
    `_grm_strip` forms it (dot_general over the variants, int32)."""
    import jax
    import jax.numpy as jnp
    from hail_tpu_torch.ops.grm import _plane_product, weight_planes
    rng = np.random.default_rng(1)
    m, n, B = 45, 30, 11
    A = (rng.random((m, n)) < 0.5).astype(np.int8)
    Bs = (rng.random((m, B)) < 0.6).astype(np.int8)
    q, _ = weight_planes(rng.normal(size=m))
    dn = (((0,), (0,)), ((), ()))
    for k in range(q.shape[0]):
        qb = (jnp.asarray(q[k])[:, None] * jnp.asarray(Bs)).astype(jnp.int8)
        want = np.asarray(jax.lax.dot_general(
            jnp.asarray(A), qb, dn, preferred_element_type=jnp.int32))
        got = _plane_product(torch.from_numpy(A.T.copy()),
                             torch.from_numpy(Bs.T.copy()),
                             torch.from_numpy(q[k]))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            want, A.T.astype(np.int64) @ (q[k][:, None] * Bs))


@pytest.mark.parametrize('m,n,miss,width,mono', [
    (64, 48, 0.05, 16, False),       # tests/test_grm_i8.py's first case
    (40, 16, 0.0, 7, True),          # its ragged strips, monomorphic rows
    (37, 10, 0.1, 3, False),         # fewer samples than _int_mm's 17 rows
    (61, 29, 0.2, 29, True),         # one strip, m not a multiple of 8
])
def test_exact_grm_matches_oracle_and_reference(m, n, miss, width, mono):
    from hail_tpu.ops.grm import ExactGrm as RefGrm
    from hail_tpu_torch.ops.grm import ExactGrm
    G, M = genotypes(m, n, miss, m + n)
    if mono:
        G[3] = 0
        G[17] = 2
        M[3] = M[17] = False
    K_ref, p, ok = oracle(G, M)
    gz8 = np.where(M, 0, G).astype(np.int8)
    g = ExactGrm(torch.from_numpy(gz8), torch.from_numpy(M.astype(np.int8)),
                 p, ok)
    K = g.to_numpy(width=width)
    assert np.max(np.abs(K - K_ref)) < 1e-12, np.max(np.abs(K - K_ref))
    strips = list(g.strips(width))
    assert [(lo, hi) for lo, hi, _ in strips] == [
        (lo, min(lo + width, n)) for lo in range(0, n, width)]
    assert all(s.dtype == torch.float64 and s.shape == (n, hi - lo)
               for lo, hi, s in strips)
    K_jax = RefGrm(gz8, M.astype(np.int8), p, ok).to_numpy(width=width)
    assert np.max(np.abs(K - K_jax)) < 1e-12


def test_exact_grm_refuses_int32_overflow():
    from hail_tpu_torch.ops.grm import ExactGrm
    m = 2 ** 31 // 127 + 1
    gz8 = torch.zeros((m, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match='overflow'):
        ExactGrm(gz8, gz8, np.full(m, 0.5), np.ones(m, bool))


def _mt(pkg_hl):
    """balding_nichols_model (equal calls in both packages from a rewound
    seed sequence) with calls made missing where (position + sample) % 7
    == 0."""
    pkg_hl.reset_global_randomness()
    mt = pkg_hl.balding_nichols_model(2, 36, 50, n_partitions=3)
    return mt.annotate_entries(GT=pkg_hl.or_missing(
        (mt.locus.position + mt.sample_idx) % 7 != 0, mt.GT))


def _method(pkg_hl, mt, name):
    x = mt.GT.n_alt_alleles()
    return {
        'grm': lambda: pkg_hl.genetic_relatedness_matrix(mt.GT),
        'rrm': lambda: pkg_hl.realized_relationship_matrix(mt.GT),
        'row_correlation': lambda: pkg_hl.row_correlation(x),
        'ld_matrix': lambda: pkg_hl.ld_matrix(x, mt.locus, radius=4),
        'ld_matrix_coord': lambda: pkg_hl.ld_matrix(
            x, mt.locus, radius=2.5, coord_expr=mt.locus.position / 2),
    }[name]()


@pytest.mark.parametrize('name', ['grm', 'rrm', 'row_correlation',
                                  'ld_matrix', 'ld_matrix_coord'])
def test_methods_match_reference(hl, name):
    want = np.asarray(_method(hl, _mt(hl), name).to_numpy())
    got_bm = _method(hlt, _mt(hlt), name)
    assert got_bm._data.dtype == torch.float64
    got = got_bm.to_numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got == 0, want == 0)
    if name.startswith('ld_matrix'):
        assert (got == 0).any() and (got != 0).any()


def test_exact_grm_route_matches_reference(hl):
    """The card's route of genetic_relatedness_matrix (the exact int8 strips
    written into one f64 tensor), run here on the CPU, against the
    reference's GRM and the oracle."""
    from hail_tpu.methods.statgen import _entry_expr_to_blocks
    from hail_tpu_torch.methods.statgen import _exact_grm
    mt_r = _mt(hl)
    K = _exact_grm(_mt(hlt).GT, torch.device('cpu'))
    assert K.dtype == torch.float64 and K.shape == (36, 36)
    want = np.asarray(hl.genetic_relatedness_matrix(mt_r.GT).to_numpy())
    assert np.max(np.abs(K.numpy() - want)) < 1e-12
    G, M = _entry_expr_to_blocks(mt_r.GT.n_alt_alleles())
    K_ref, _, _ = oracle(np.asarray(G), np.asarray(M, bool))
    assert np.max(np.abs(K.numpy() - K_ref)) < 1e-12
