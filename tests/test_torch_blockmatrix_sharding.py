"""The port's BlockMatrix sharded at rest, against hail_tpu's on the CPU:
the reference on its 8 virtual devices, the port on a mesh of
`[cpu] * 8` installed in the default mesh's cache. A counterpart of each
test of tests/test_blockmatrix_sharding.py and tests/test_scaling_grm.py,
and of the methods that read `_data` (`ld_matrix`).

Storage: the port's matrix is a `Sharded` value of 8 blocks, each on its
slot and no larger than total / 8 where the shape divides. Values:
constructors, elementwise results, transposes and masks equal the
port's one-device result bit for bit and the reference's at rtol 1e-12
(bit for bit but for XLA's c / x); products and the
GRM at rtol 1e-10 (the reference's own bar) with atol 1e-14, since the two
packages add the same terms in other orders and an entry near zero keeps
only the absolute rounding of its partial sums. `random` draws torch's
numbers, not jax.random's: it equals the port's one-device draw.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt
from hail_tpu.linalg import BlockMatrix as RefBM
from hail_tpu_torch.linalg import BlockMatrix as PortBM
from hail_tpu_torch.parallel import mesh as port_mesh
from hail_tpu_torch.parallel.mesh import Sharded

from test_torch_grm import _method, _mt

N_DEV = 8
RTOL, ATOL = 1e-10, 1e-14
CPU = torch.device('cpu')


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


@pytest.fixture(autouse=True)
def eight(monkeypatch):
    """The default mesh: 8 slots on the CPU."""
    mesh = port_mesh.get_mesh([CPU] * N_DEV)
    monkeypatch.setattr(port_mesh, '_mesh_cache', mesh)
    return mesh


def one_device(monkeypatch, fn):
    """`fn()` with the default mesh set to one CPU device."""
    mesh = port_mesh._mesh_cache
    monkeypatch.setattr(port_mesh, '_mesh_cache', port_mesh.get_mesh([CPU]))
    try:
        return fn()
    finally:
        monkeypatch.setattr(port_mesh, '_mesh_cache', mesh)


def assert_sharded(bm, divides=True):
    s = bm._store
    assert isinstance(s, Sharded) and len(s.shards) == N_DEV
    assert all(t.dtype == torch.float64 and t.device == CPU for t in s.shards)
    ptrs = [t.data_ptr() for t in s.shards if t.numel()]
    assert len(set(ptrs)) == len(ptrs)
    if divides:
        total = bm.shape[0] * bm.shape[1]
        assert max(t.numel() for t in s.shards) <= total // N_DEV


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


def test_random_is_sharded_at_rest(monkeypatch):
    bm = PortBM.random(512, 512, seed=0)
    assert_sharded(bm)
    assert tuple(bm._store.spec) == ('x', 'y')
    one = one_device(monkeypatch, lambda: PortBM.random(512, 512, seed=0))
    assert isinstance(one._store, torch.Tensor)
    np.testing.assert_array_equal(bm.to_numpy(), one.to_numpy())
    u = PortBM.random(64, 32, seed=4, gaussian=False)
    np.testing.assert_array_equal(u.to_numpy(), one_device(
        monkeypatch,
        lambda: PortBM.random(64, 32, seed=4, gaussian=False)).to_numpy())


@pytest.mark.parametrize('name', ['from_numpy', 'fill', '_create'])
def test_constructors_are_sharded(name):
    (A,) = _arrays(0, (64, 48))
    make = {'from_numpy': lambda bm: bm.from_numpy(A),
            'fill': lambda bm: bm.fill(64, 48, 2.5),
            '_create': lambda bm: bm._create(64, 48, A.ravel().tolist())}
    got = make[name](PortBM)
    assert_sharded(got)
    np.testing.assert_array_equal(got.to_numpy(), make[name](RefBM).to_numpy())


def test_elementwise_stays_sharded(monkeypatch):
    A, B = _arrays(1, (256, 512), (256, 512))

    def run(bm):
        a, b = bm.from_numpy(A), bm.from_numpy(B)
        return (a + b) * 2.0 - a
    c = run(PortBM)
    assert_sharded(c)
    np.testing.assert_array_equal(c.to_numpy(), np.asarray(run(RefBM).to_numpy()))
    np.testing.assert_array_equal(c.to_numpy(),
                                  one_device(monkeypatch, lambda: run(PortBM))
                                  .to_numpy())


@pytest.mark.parametrize('op', [
    'add', 'sub', 'rsub', 'mul', 'rmul', 'div', 'rdiv', 'neg', 'pow', 'abs',
    'sqrt', 'log', 'ceil', 'floor', 'add_T', 'mul_row', 'sub_col', 'add_np',
    'div_np_row', 'T', 'row_plus_matrix'])
def test_elementwise_ops_equal_reference(monkeypatch, op):
    """Bit for bit equal to the port's one-device result; equal to the
    reference's at rtol 1e-12 (XLA computes c / x as c times 1 / x, an ulp
    off the rounded quotient)."""
    A, B = _arrays(2, (48, 48), (48, 48))
    A = np.abs(A) + 0.5

    def run(bm):
        a, b = bm.from_numpy(A), bm.from_numpy(B)
        return {
            'add': lambda: a + b, 'sub': lambda: a - 3.0,
            'rsub': lambda: 1.0 - a, 'mul': lambda: a * b,
            'rmul': lambda: 2.0 * a, 'div': lambda: a / b,
            'rdiv': lambda: 3.0 / a, 'neg': lambda: -a,
            'pow': lambda: a ** 3, 'abs': lambda: b.abs(),
            'sqrt': lambda: a.sqrt(), 'log': lambda: a.log(),
            'ceil': lambda: b.ceil(), 'floor': lambda: b.floor(),
            'add_T': lambda: a + b.T,
            'mul_row': lambda: a * bm.from_numpy(B[:1]),
            'sub_col': lambda: a - bm.from_numpy(B[:, :1]),
            'add_np': lambda: a + B,
            'div_np_row': lambda: a / B[0],
            'T': lambda: b.T,
            'row_plus_matrix': lambda: bm.from_numpy(B[:1]) + a,
        }[op]()
    got = run(PortBM)
    assert_sharded(got)
    np.testing.assert_array_equal(
        got.to_numpy(), one_device(monkeypatch, lambda: run(PortBM)).to_numpy())
    np.testing.assert_allclose(got.to_numpy(), np.asarray(run(RefBM).to_numpy()),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize('case', [
    'triangle', 'lower_triangle', 'band', 'band_blocks', 'row_intervals',
    'row_intervals_blocks', 'rectangles', 'blocks'])
def test_sparsify_stays_sharded(case):
    (A,) = _arrays(3, (256, 256))
    starts = [max(0, i - 20) for i in range(256)]
    stops = [min(256, i + 37) for i in range(256)]

    def run(bm):
        a = bm.from_numpy(A)
        return {
            'triangle': lambda: a.sparsify_triangle(),
            'lower_triangle': lambda: a.sparsify_triangle(lower=True),
            'band': lambda: a.sparsify_band(-5, 17),
            'band_blocks': lambda: a.sparsify_band(-5, 17, blocks_only=True),
            'row_intervals': lambda: a.sparsify_row_intervals(starts, stops),
            'row_intervals_blocks': lambda: a.sparsify_row_intervals(
                starts, stops, blocks_only=True),
            'rectangles': lambda: a.sparsify_rectangles([[0, 10, 5, 70],
                                                         [130, 200, 0, 256]]),
            'blocks': lambda: bm(a._data if bm is RefBM else a._store, 64)
            ._sparsify_blocks([0, 5, 9, 15]),
        }[case]()
    got, want = run(PortBM), run(RefBM)
    assert_sharded(got)
    assert got.is_sparse == want.is_sparse
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.to_numpy()))
    if case == 'triangle':
        np.testing.assert_array_equal(got.to_numpy(), np.triu(A))


@pytest.mark.parametrize('shapes', [((256, 128), (128, 256)),
                                    ((64, 48), (48, 40)),
                                    ((30, 17), (17, 12))])
def test_matmul_sharded_output(shapes):
    A, B = _arrays(4, *shapes)
    got = PortBM.from_numpy(A) @ PortBM.from_numpy(B)
    want = np.asarray((RefBM.from_numpy(A) @ RefBM.from_numpy(B)).to_numpy())
    np.testing.assert_allclose(got.to_numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.to_numpy(), A @ B, rtol=RTOL, atol=ATOL)
    assert isinstance(got._store, Sharded)
    if shapes[0][0] % 8 == 0:
        assert_sharded(got)
    bt = PortBM.from_numpy(A).T @ PortBM.from_numpy(A)       # T on the left
    np.testing.assert_allclose(bt.to_numpy(), A.T @ A, rtol=RTOL, atol=ATOL)
    bn = PortBM.from_numpy(A) @ B                             # a host operand
    np.testing.assert_allclose(bn.to_numpy(), A @ B, rtol=RTOL, atol=ATOL)


def test_uneven_shapes_fall_back_gracefully():
    x = np.arange(21.0).reshape(3, 7)
    bm = PortBM.from_numpy(x)
    assert tuple(bm._store.spec) == ()           # replicated, as jax's
    assert_sharded(bm, divides=False)
    np.testing.assert_array_equal(bm.to_numpy(), x)
    c = bm @ bm.T
    np.testing.assert_array_equal(c.to_numpy(), x @ x.T)


def test_pick_2d_spec_prefers_grid(eight):
    mx, my = eight.devices.shape
    assert port_mesh.pick_2d_spec((mx * 4, my * 4), eight) == \
        port_mesh.P('x', 'y')
    assert port_mesh.pick_2d_spec((7, 11), eight) == port_mesh.P()


def test_methods_that_assemble_equal_reference():
    """The methods that are not shard-aware assemble one tensor and shard
    their result again: the same values as the reference's."""
    A, B = _arrays(5, (64, 48), (64, 48))
    for fn in (lambda bm: bm.from_numpy(A)[3:40, 5:30],
               lambda bm: bm.from_numpy(A).filter_rows([0, 9, 63, 2]),
               lambda bm: bm.from_numpy(A).filter_cols([47, 1, 3]),
               lambda bm: bm.from_numpy(A).diagonal(),
               lambda bm: bm.from_numpy(A).sum(axis=0),
               lambda bm: bm.from_numpy(A).pad(72, 56, 1.5)):
        np.testing.assert_allclose(fn(PortBM).to_numpy(),
                                   np.asarray(fn(RefBM).to_numpy()),
                                   rtol=1e-12, atol=ATOL)
    port, ref = PortBM.from_numpy(A), RefBM.from_numpy(A)
    assert port[5, 7] == float(ref[5, 7]) and port[-1, -1] == A[-1, -1]
    np.testing.assert_allclose(port.sum(), ref.sum(), rtol=1e-12)


def _synthetic(pkg, n_samples, n_variants, n_partitions):
    pkg.reset_global_randomness()
    return pkg.balding_nichols_model(2, n_samples, n_variants,
                                     n_partitions=n_partitions)


@pytest.mark.parametrize('kw', [dict(mean_impute=True),
                                dict(mean_impute=True, center=True),
                                dict(mean_impute=True, normalize=True)])
def test_from_entry_expr_sharded_no_host_concat(hl, monkeypatch, kw):
    def run(pkg, bm):
        mt = _mt(pkg)
        return bm.from_entry_expr(mt.GT.n_alt_alleles(), **kw)
    got = run(hlt, PortBM)
    assert got.shape == (50, 36)
    assert_sharded(got, divides=False)
    want = np.asarray(run(hl, RefBM).to_numpy())
    np.testing.assert_allclose(got.to_numpy(), want, rtol=1e-12, atol=ATOL)
    np.testing.assert_array_equal(
        got.to_numpy(), one_device(monkeypatch, lambda: run(hlt, PortBM))
        .to_numpy())


def test_from_entry_expr_streams_partitions():
    """Each partition's f64 block is released before the next partition is
    evaluated, and it goes straight into the slots' blocks."""
    from hail_tpu_torch.methods import statgen as sg
    mt = _synthetic(hlt, 64, 256, 8)
    live = []
    orig = sg._eval_entry_f64

    def tracking(mtx, expr, mb, i):
        G, M = orig(mtx, expr, mb, i)
        gc.collect()
        n_live = sum(1 for r in live if r() is not None)
        assert n_live <= 2, f'{n_live} partition blocks alive at partition {i}'
        live.append(weakref.ref(G))
        return G, M

    sg._eval_entry_f64 = tracking
    try:
        bm = PortBM.from_entry_expr(mt.GT.n_alt_alleles())
    finally:
        sg._eval_entry_f64 = orig
    assert bm.shape == (256, 64)
    assert_sharded(bm)
    assert len(live) >= 8


@pytest.mark.parametrize('name', ['grm', 'rrm', 'row_correlation',
                                  'ld_matrix', 'ld_matrix_coord'])
def test_methods_match_reference_sharded(hl, name):
    """The GRM's result stays sharded; ld_matrix reads `_data` twice."""
    want = np.asarray(_method(hl, _mt(hl), name).to_numpy())
    got_bm = _method(hlt, _mt(hlt), name)
    assert isinstance(got_bm._store, Sharded)
    got = got_bm.to_numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_exact_grm_route_writes_shards(hl):
    """The card's route of the GRM, run here: its strips go straight into
    the blocks of the 8 slots."""
    from hail_tpu_torch.methods.statgen import _exact_grm
    K = _exact_grm(_mt(hlt).GT, CPU)
    assert isinstance(K, Sharded) and len(K.shards) == N_DEV
    want = np.asarray(hl.genetic_relatedness_matrix(_mt(hl).GT).to_numpy())
    assert np.max(np.abs(K.to_numpy() - want)) < 1e-12


def test_grm_8k_sharded():
    """8192 x 8192 GRM over the 8-slot mesh: no slot holds more than an
    eighth, and a strided sample equals numpy's f64 product."""
    from hail_tpu_torch.methods.statgen import _normalized_genotype_matrix
    n, m = 8192, 512
    mt = _synthetic(hlt, n, m, 8)
    grm = hlt.genetic_relatedness_matrix(mt.GT)
    assert grm.shape == (n, n)
    assert_sharded(grm)
    Z, used = _normalized_genotype_matrix(mt.GT)
    idx = np.arange(0, n, 1024)
    want = Z[:, idx].T @ Z[:, idx] / used
    got = np.stack([[grm[int(i), int(j)] for j in idx] for i in idx])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    diag = got.diagonal()
    assert np.isfinite(diag).all() and 0.2 < float(np.mean(diag)) < 3.0


def test_grm_matches_numpy_dense_8dev():
    n, m = 100, 200
    mt = _synthetic(hlt, n, m, 4)
    g = PortBM.from_entry_expr(mt.GT.n_alt_alleles()).to_numpy().T
    col_means = np.mean(g, axis=0, keepdims=True)
    col_filter = np.logical_and(col_means > 0, col_means < 2)
    g2 = g[:, np.squeeze(col_filter)]
    cm = col_means[col_filter]
    sd = np.sqrt(cm * (1 - cm / 2))
    g_std = (g2 - cm) / sd
    k = (g_std @ g_std.T) / g_std.shape[1]
    grm = hlt.genetic_relatedness_matrix(mt.GT)
    assert isinstance(grm._store, Sharded)
    np.testing.assert_allclose(k, grm.to_numpy(), atol=1e-8)
