"""The port's `hl.linalg` against hail_tpu's on the same inputs, on the CPU:
`BlockMatrix` (every case of tests/test_blockmatrix.py and the rest of its
public methods), the window helpers of `linalg.utils`, and
`hl._locus_windows_per_contig`, which raised ModuleNotFoundError in the
port while `linalg.utils` was missing.

Tolerances: elementwise results, slices, filters, masks, conversions and
files equal bit for bit (the same float64 operation on each entry; `log`
included, held here to the reference's own libm result); sums, products
and the SVD at rtol 1e-12 with atol 1e-14, since the two packages add the
same terms in other orders. `random` draws torch's numbers, not
jax.random's: it is held to its shape, its determinism under a seed and
its first two moments.
"""

import os

import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt
from hail_tpu.linalg import BlockMatrix as RefBM
from hail_tpu_torch.linalg import BlockMatrix as PortBM

RTOL, ATOL = 1e-12, 1e-14
_rng = np.random.default_rng(0)
A = _rng.normal(size=(6, 5))
B = _rng.normal(size=(6, 5))
C = _rng.normal(size=(5, 4))


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def _host(x):
    if isinstance(x, (RefBM, PortBM)):
        return np.asarray(x.to_numpy())
    return x


def _both(fn):
    got, want = fn(PortBM), fn(RefBM)
    if isinstance(got, PortBM):
        assert got._data.dtype == torch.float64
        assert got.is_sparse == want.is_sparse
        assert got.block_size == want.block_size
    return _host(got), _host(want)


@pytest.mark.parametrize('locus_coords,radius', [
    ([[1.0, 2.0, 5.0], [1.0, 3.0]], 1.0),
    ([[1.0, 1.5, 2.0, 9.0]], 0.5),
    ([[0.0], [3.0, 3.0, 4.0], []], 2.0),
])
def test_locus_windows_per_contig(hl, locus_coords, radius):
    got = hlt.eval(hlt._locus_windows_per_contig(locus_coords, radius))
    want = hl.eval(hl._locus_windows_per_contig(locus_coords, radius))
    assert got == want


def test_array_and_locus_windows(hl):
    from test_torch_ldprune import build_ld_mt
    from hail_tpu.linalg.utils import array_windows as ref_aw
    from hail_tpu.linalg.utils import locus_windows as ref_lw
    from hail_tpu_torch.linalg.utils import array_windows, locus_windows
    a = np.array([1, 2, 4, 4, 6, 8])
    for r in (0, 1, 2, 10):
        for x, y in zip(array_windows(a, r), ref_aw(a, r)):
            np.testing.assert_array_equal(x, y)
    mt_p, *_ = build_ld_mt('hail_tpu_torch')
    mt_r, *_ = build_ld_mt('hail_tpu')
    for radius, coord in ((0, None), (4, None), (10 ** 6, None),
                          (3.0, lambda mt: mt.locus.position * 0.5)):
        got = locus_windows(mt_p.locus, radius,
                            coord_expr=coord(mt_p) if coord else None)
        want = ref_lw(mt_r.locus, radius,
                      coord_expr=coord(mt_r) if coord else None)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    # windows stop at the contig boundary
    assert got[1].max() <= len(got[0])


EXACT = {
    # tests/test_blockmatrix.py test_construct_and_ops
    'add': lambda BM: BM.from_numpy(A) + 1,
    'radd': lambda BM: 2.5 + BM.from_numpy(A),
    'sub_self': lambda BM: BM.from_numpy(A) - BM.from_numpy(A),
    'sub_matrix': lambda BM: BM.from_numpy(A) - BM.from_numpy(B),
    'rsub': lambda BM: 3 - BM.from_numpy(A),
    'mul': lambda BM: BM.from_numpy(A) * 2,
    'mul_matrix': lambda BM: BM.from_numpy(A) * BM.from_numpy(B),
    'mul_ndarray': lambda BM: BM.from_numpy(A) * B,
    'rmul': lambda BM: 0.1 * BM.from_numpy(A),
    'div': lambda BM: BM.from_numpy(A) / 2,
    'div_matrix': lambda BM: BM.from_numpy(A) / BM.from_numpy(B),
    'rdiv': lambda BM: 1 / BM.from_numpy(A),
    'transpose': lambda BM: BM.from_numpy(A).T,
    'pow2': lambda BM: BM.from_numpy(A) ** 2,
    'pow3': lambda BM: BM.from_numpy(A) ** 3,
    'neg': lambda BM: -BM.from_numpy(A),
    'abs': lambda BM: BM.from_numpy(A).abs(),
    'sqrt': lambda BM: BM.from_numpy(A).abs().sqrt(),
    'log': lambda BM: BM.from_numpy(A).abs().log(),
    'ceil': lambda BM: BM.from_numpy(A * 3).ceil(),
    'floor': lambda BM: BM.from_numpy(A * 3).floor(),
    # test_reductions_slicing
    'diagonal': lambda BM: BM.from_numpy(A).diagonal(),
    'entry': lambda BM: BM.from_numpy(A)[1, -2],
    'slice': lambda BM: BM.from_numpy(A)[0:2, 1:3],
    'slice_step': lambda BM: BM.from_numpy(A)[1:6:2, :],
    'row': lambda BM: BM.from_numpy(A)[-1, :],
    'filter_rows': lambda BM: BM.from_numpy(A).filter_rows([1]),
    'filter_cols': lambda BM: BM.from_numpy(A).filter_cols([4, 0, 2]),
    'filter': lambda BM: BM.from_numpy(A).filter([5, 0], [3, 3]),
    # test_sparsify
    'band': lambda BM: BM.from_numpy(A).sparsify_band(-1, 1),
    'band_blocks': lambda BM: BM.from_numpy(A, block_size=2)
        .sparsify_band(-1, 2, blocks_only=True),
    'triangle': lambda BM: BM.from_numpy(A).sparsify_triangle(),
    'triangle_lower_blocks': lambda BM: BM.from_numpy(A, block_size=4)
        .sparsify_triangle(lower=True, blocks_only=True),
    'row_intervals': lambda BM: BM.from_numpy(np.ones((6, 6)))
        .sparsify_row_intervals([0, 1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6]),
    'row_intervals_blocks': lambda BM: BM.from_numpy(A, block_size=2)
        .sparsify_row_intervals([0, 3, 1, 0, 4, 2], [1, 4, 2, 1, 5, 5],
                                blocks_only=True),
    'rectangles': lambda BM: BM.from_numpy(np.ones((6, 6)), block_size=2)
        .sparsify_rectangles([[0, 2, 0, 2]]),
    'rectangles_ragged': lambda BM: BM.from_numpy(A, block_size=4)
        .sparsify_rectangles([[0, 1, 0, 1], [5, 6, 4, 5]]),
    'blocks': lambda BM: BM.from_numpy(A, block_size=4)._sparsify_blocks([1, 2]),
    # test_svd_random_fill, and the other constructors
    'fill': lambda BM: BM.fill(3, 3, 2.5),
    'create': lambda BM: BM._create(2, 3, [1, 2, 3, 4, 5, 6]),
    'from_ndarray': lambda BM: BM.from_ndarray(np.arange(6).reshape(2, 3)),
    'from_vector': lambda BM: BM.from_numpy(np.arange(4.0)),
    'pad': lambda BM: BM.from_numpy(A).pad(8, 7, value=-1.5),
    'map_dense': lambda BM: BM.from_numpy(A)._map_dense(lambda x: x * 2 + 1),
}


@pytest.mark.parametrize('case', sorted(EXACT))
def test_blockmatrix_exact(case):
    got, want = _both(EXACT[case])
    if isinstance(want, float):
        assert isinstance(got, float) and got == want
        return
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


PRODUCTS = {
    # tests/test_blockmatrix.py test_matmul, test_reductions_slicing
    'matmul': lambda BM: BM.from_numpy(A) @ BM.from_numpy(C),
    'matmul_ndarray': lambda BM: BM.from_numpy(A) @ C,
    'tree_matmul': lambda BM: BM.from_numpy(A).tree_matmul(BM.from_numpy(C)),
    'dot': lambda BM: BM.from_numpy(A).dot(BM.from_numpy(C)),
    'gram': lambda BM: BM.from_numpy(A).T @ BM.from_numpy(A),
    'sum': lambda BM: BM.from_numpy(A).sum(),
    'sum_rows': lambda BM: BM.from_numpy(A).sum(axis=0),
    'sum_cols': lambda BM: BM.from_numpy(A).sum(axis=1),
    'svd_values': lambda BM: BM.from_numpy(A).svd(compute_uv=False),
    'svd_gramian_values': lambda BM: BM.from_numpy(A).svd(
        compute_uv=False, complexity_bound=3),
}


@pytest.mark.parametrize('case', sorted(PRODUCTS))
def test_blockmatrix_products(case):
    got, want = _both(PRODUCTS[case])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('bound', [8192, 3])
@pytest.mark.parametrize('shape', [(6, 5), (4, 7)])
def test_blockmatrix_svd(bound, shape):
    """Local LAPACK below the complexity bound, the device gramian and a
    host eigendecomposition above it: both reconstruct the matrix, with
    the singular values of the reference."""
    a = np.random.default_rng(sum(shape)).normal(size=shape)
    u, s, vt = PortBM.from_numpy(a).svd(complexity_bound=bound)
    _, s_r, _ = RefBM.from_numpy(a).svd(complexity_bound=bound)
    np.testing.assert_allclose(s, s_r, rtol=RTOL, atol=ATOL)
    u, vt = _host(u), _host(vt)
    np.testing.assert_allclose(u @ np.diag(s) @ vt, a, atol=1e-12)


TABLES = {
    'entries': lambda BM: BM.from_numpy(np.arange(4.0).reshape(2, 2)).entries(),
    'table_row_major': lambda BM: BM.from_numpy(A).to_table_row_major(),
    'matrix_table_row_major':
        lambda BM: BM.from_numpy(A[:3, :2]).to_matrix_table_row_major().entries(),
}


def _plain(v):
    """A collected row as plain dicts and lists (each package has its own
    Struct class)."""
    if hasattr(v, 'items'):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize('case', sorted(TABLES))
def test_blockmatrix_tables(case):
    got, want = TABLES[case](PortBM).collect(), TABLES[case](RefBM).collect()
    assert len(got) > 1 and _plain(got) == _plain(want)
    if case == 'entries':
        assert got[3].i == 1 and got[3].j == 1 and got[3].entry == 3.0


def _bn(pkg_hl, missing):
    """balding_nichols_model from a rewound seed sequence: equal calls in
    both packages, whatever ran before in the process."""
    pkg_hl.reset_global_randomness()
    mt = pkg_hl.balding_nichols_model(1, 10, 15, n_partitions=3)
    if missing:
        mt = mt.annotate_entries(GT=pkg_hl.or_missing(
            (mt.locus.position + mt.sample_idx) % 5 != 0, mt.GT))
    return mt


@pytest.mark.parametrize('missing,kw', [
    (False, {}),
    (False, dict(center=True, normalize=True)),
    (True, dict(mean_impute=True)),
    (True, dict(mean_impute=True, center=True)),
    (True, dict(mean_impute=True, normalize=True)),
])
def test_from_entry_expr(hl, missing, kw):
    got = PortBM.from_entry_expr(_bn(hlt, missing).GT.n_alt_alleles(), **kw)
    want = RefBM.from_entry_expr(_bn(hl, missing).GT.n_alt_alleles(), **kw)
    assert got.shape == (15, 10) and got._data.dtype == torch.float64
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.to_numpy()))
    if not kw:
        assert set(np.unique(got.to_numpy())) <= {0.0, 1.0, 2.0}


def test_from_entry_expr_refuses_missing_without_impute():
    with pytest.raises(ValueError, match='missing values'):
        PortBM.from_entry_expr(_bn(hlt, True).GT.n_alt_alleles())


def _read_bytes(path):
    """Each file's bytes; a gzip file's header time (bytes 4-7, the moment
    it was written) zeroed, so that two writes a second apart compare."""
    out = {}
    for dirpath, _, names in os.walk(path):
        for n in names:
            with open(os.path.join(dirpath, n), 'rb') as f:
                data = f.read()
            if data[:2] == b'\x1f\x8b':
                data = data[:4] + bytes(4) + data[8:]
            out[os.path.relpath(os.path.join(dirpath, n), path)] = data
    return out


FILES = {
    'write': lambda bm, p: bm.write(p),
    'export': lambda bm, p: bm.export(p),
    'export_gz_options': lambda bm, p: bm.export(
        p + '.gz', delimiter=',', header='h', add_index=True,
        entries='strict_upper'),
    'export_lower': lambda bm, p: bm.export(p, entries='lower'),
    'export_rectangles': lambda bm, p: bm.export_rectangles(
        p, [[0, 3, 0, 1], [1, 2, 0, 2]]),
    'export_rectangles_binary': lambda bm, p: bm.export_rectangles(
        p, [[0, 6, 0, 5], [2, 4, 1, 3]], binary=True),
    'export_blocks': lambda bm, p: bm.export_blocks(p),
    'tofile': lambda bm, p: bm.tofile(p),
}


@pytest.mark.parametrize('case', sorted(FILES))
@pytest.mark.parametrize('transposed', [False, True])
def test_blockmatrix_files_byte_equal(tmp_path, case, transposed):
    """Each writer leaves the same bytes in both packages, also for a
    transposed matrix (whose host view is Fortran-ordered in the port)."""
    a = A.T if transposed else A
    for name, BM in (('port', PortBM), ('ref', RefBM)):
        os.makedirs(tmp_path / name)
        bm = BM.from_numpy(a, block_size=2)
        FILES[case](bm.T.T if transposed else bm, str(tmp_path / name / 'out'))
    got, want = (_read_bytes(tmp_path / n) for n in ('port', 'ref'))
    assert got and got == want


def test_written_matrices_cross_packages(tmp_path):
    a = np.random.default_rng(2).normal(size=(4, 5))
    PortBM.from_numpy(a, block_size=3).T.write(str(tmp_path / 'p'))
    RefBM.from_numpy(a, block_size=3).T.write(str(tmp_path / 'r'))
    for path in ('p', 'r'):
        for BM in (PortBM, RefBM):
            bm = BM.read(str(tmp_path / path))
            assert bm.block_size == 3
            np.testing.assert_array_equal(np.asarray(bm.to_numpy()), a.T)
    # checkpoint, fromfile and the static export read what was written
    bm = PortBM.from_numpy(a).checkpoint(str(tmp_path / 'c'))
    np.testing.assert_array_equal(bm.to_numpy(), a)
    PortBM.from_numpy(a).tofile(str(tmp_path / 'raw'))
    np.testing.assert_array_equal(
        PortBM.fromfile(str(tmp_path / 'raw'), 4, 5).to_numpy(), a)
    PortBM.export(str(tmp_path / 'r'), str(tmp_path / 'r.tsv'))
    RefBM.export(str(tmp_path / 'r'), str(tmp_path / 'r_ref.tsv'))
    assert open(tmp_path / 'r.tsv').read() == open(tmp_path / 'r_ref.tsv').read()


@pytest.mark.parametrize('binary', [False, True])
def test_rectangles_to_numpy(tmp_path, binary):
    nd = np.arange(12, dtype=np.float64).reshape(3, 4)
    PortBM.from_numpy(nd).export_rectangles(
        str(tmp_path), [[0, 3, 0, 1], [1, 2, 0, 2]], binary=binary)
    got = PortBM.rectangles_to_numpy(str(tmp_path), binary=binary)
    want = RefBM.rectangles_to_numpy(str(tmp_path), binary=binary)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0.0, 0.0], [4.0, 5.0], [8.0, 0.0]])


def test_host_arrays_are_copies():
    """A matrix shares no storage with the host arrays it came from or
    gave out, as the reference's device arrays do not."""
    a = A.copy()
    bm = PortBM.from_numpy(a)
    a[0, 0] = 99.0
    bm.to_numpy()[0, 1] = 99.0
    np.testing.assert_array_equal(bm.to_numpy(), A)


@pytest.mark.parametrize('gaussian', [True, False])
def test_random_determinism_and_moments(gaussian):
    n, m = 300, 200
    x = PortBM.random(n, m, seed=4, gaussian=gaussian)
    assert x.shape == (n, m) and x._data.dtype == torch.float64
    a = x.to_numpy()
    np.testing.assert_array_equal(
        a, PortBM.random(n, m, seed=4, gaussian=gaussian).to_numpy())
    assert not np.array_equal(
        a, PortBM.random(n, m, seed=5, gaussian=gaussian).to_numpy())
    # unseeded draws take the session's next seeds: two differ
    assert not np.array_equal(PortBM.random(3, 3, gaussian=gaussian).to_numpy(),
                              PortBM.random(3, 3, gaussian=gaussian).to_numpy())
    mean, var = (0.0, 1.0) if gaussian else (0.5, 1.0 / 12)
    # 60,000 draws: the mean within 5 standard errors, the variance within 3%
    assert abs(a.mean() - mean) < 5 * np.sqrt(var / a.size)
    assert abs(a.var() / var - 1) < 0.03
    if not gaussian:
        assert a.min() >= 0.0 and a.max() < 1.0
