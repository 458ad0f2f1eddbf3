"""Each hand-written CUDA kernel of hail_tpu_torch against its plain torch
version, on the card. Without one every test skips. This file imports
neither jax nor hail_tpu, so on a machine without jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

K2, K3 and K4 are integer kernels: their results are bit-equal to the
plain versions (and to an int64 numpy oracle). K1 sums exact f32
products in f32: its row sums are integers, bit-equal; GW and MW are held
to the f64 product within |x - exact| <= 1e-5 |exact| + 1e-5 l2, with l2
the norm of the summed terms (the scale of random f32 rounding: an
absolute bar alone fails on sums near zero of large terms), and to the
plain version within 1e-4 |plain| + 2e-5 l2 (cuBLAS's long sequential f32
sums drift further). Shapes cross the kernels' edges: N not a
multiple of 4 (K4, K1), KP above K1's 8-column chunk, N above K1's
1,024-sample tile, R not a multiple of the 8 rows a K1 block owns. K3: R
below and not a multiple of its 64-row tile, N below the MMA depth of 32,
not a multiple of its 128-sample stage, not a multiple of 16 (the
register-staged load path, with 4-byte and with single-byte loads) and a
base pointer off 16 bytes, C of 7, 35, 40 (no spare column in its last
tile), 48, 70 and 84 (the 96-column variant, one and several chunks). K2:
n below and not a multiple of its 64-sample tile, m not a multiple of 32
nor of its 1,024-variant stage, shapes that are whole tiles and stages (no
padding), enough variants for several stages and slices, and samples with
every call missing. The GLM device tier has no kernel of its own; it is held to its
run on the CPU.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (torch.cuda.is_available() is False)')
    return torch.device('cuda', 0)


@pytest.mark.parametrize('R,N', [(1, 1), (3, 7), (64, 1003), (300, 10000)])
def test_unpack_matches_plain(dev, R, N):
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    gen = torch.Generator().manual_seed(R * N)
    u8 = torch.randint(0, 256, (R, -(-N // 4)), dtype=torch.uint8,
                       generator=gen).to(dev)
    before = _kernels.launches['hail_unpack_gt_2bit']
    gz8, m8 = li.unpack_gt_2bit(u8, N)
    assert _kernels.launches['hail_unpack_gt_2bit'] == before + 1
    gz8_p, m8_p = li._unpack_plain(u8, N)
    torch.cuda.synchronize()
    assert torch.equal(gz8, gz8_p) and torch.equal(m8, m8_p)


def test_unpack_rejects_bad_input(dev):
    from hail_tpu_torch.ops import linreg_i8 as li
    with pytest.raises(ValueError, match='cannot hold'):
        li.unpack_gt_2bit(torch.zeros((2, 3), dtype=torch.uint8, device=dev), 13)
    with pytest.raises(TypeError):
        li.unpack_gt_2bit(torch.zeros((2, 3), dtype=torch.int8, device=dev), 12)


@pytest.mark.parametrize('R,N,C,gmax', [(1, 1, 7, 2), (37, 1003, 35, 2),
                                        (100, 3000, 84, 2), (9, 513, 35, 127),
                                        (64, 1024, 35, 2), (5, 17, 7, 2),
                                        (16, 31, 35, 3), (130, 1000, 70, 2),
                                        (200, 4096, 70, 2), (70, 2048, 40, 2),
                                        (33, 10000, 35, 2), (65, 640, 48, 2),
                                        (300, 1030, 120, 2),
                                        (129, 2000, 35, 127)])
def test_exact_pass_matches_plain(dev, R, N, C, gmax):
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    rng = np.random.default_rng(R + N + C)
    g = rng.integers(0, gmax + 1, (R, N)).astype(np.int8)
    m = (rng.random((R, N)) < 0.1).astype(np.int8)
    g[m == 1] = 0
    W = rng.integers(-127, 128, (N, C)).astype(np.int8)
    gz8, m8, Wd = (torch.from_numpy(a).to(dev) for a in (g, m, W))
    before = _kernels.launches['hail_linreg_exact_pass']
    got = li.exact_pass(gz8, m8, li.exact_operand(Wd))
    assert _kernels.launches['hail_linreg_exact_pass'] == before + 1
    plain = li._exact_pass_plain(gz8, m8, Wd)
    torch.cuda.synchronize()
    g64, m64, w64 = (a.astype(np.int64) for a in (g, m, W))
    oracle = (g64 @ w64, m64 @ w64, m64.sum(1), g64.sum(1), (g64 * g64).sum(1))
    for a, b, o in zip(got, plain, oracle):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.cpu().numpy(), o)


@pytest.mark.parametrize('offset,N', [(4, 1024), (1, 1024), (16, 1024),
                                      (8, 1000)])
def test_exact_pass_off_aligned_base(dev, offset, N):
    """(gz8, m8) that start `offset` bytes into their allocations: rows
    that are not 16-byte aligned take the register-staged loads."""
    from hail_tpu_torch.ops import linreg_i8 as li
    rng = np.random.default_rng(offset + N)
    R, C = 70, 35
    g = rng.integers(0, 3, (R, N)).astype(np.int8)
    m = (rng.random((R, N)) < 0.1).astype(np.int8)
    g[m == 1] = 0
    W = torch.from_numpy(rng.integers(-127, 128, (N, C)).astype(np.int8)).to(dev)

    def shifted(a):
        buf = torch.zeros(offset + a.size, dtype=torch.int8, device=dev)
        buf[offset:] = torch.from_numpy(a).to(dev).reshape(-1)
        return buf[offset:].view(R, N)

    gz8, m8 = shifted(g), shifted(m)
    assert gz8.is_contiguous() and gz8.data_ptr() % 16 == offset % 16
    got = li.exact_pass(gz8, m8, li.exact_operand(W))
    plain = li._exact_pass_plain(gz8, m8, W)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_exact_pass_takes_the_group_constants(dev):
    """`exact_consts` hands `exact_pass` its operand ready-made, on the
    card: the same partials as from an operand made of a copy of Wdig."""
    from hail_tpu_torch.ops import linreg_i8 as li
    rng = np.random.default_rng(21)
    R, N, k, P = 90, 1500, 4, 1
    g = rng.integers(0, 3, (R, N)).astype(np.int8)
    m = (rng.random((R, N)) < 0.05).astype(np.int8)
    g[m == 1] = 0
    Q = np.linalg.qr(rng.normal(size=(N, k)))[0]
    Ys = rng.normal(size=(N, P))
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(0) - (Qty * Qty).sum(0)
    W = li.exact_consts(Q, Ys, Qty, yyp, N - k - 1, dev)[0]
    assert W.Wdig.device.type == W.WT.device.type == 'cuda'
    gz8, m8 = torch.from_numpy(g).to(dev), torch.from_numpy(m).to(dev)
    got = li.exact_pass(gz8, m8, W)
    bare = li.exact_pass(gz8, m8, li.exact_operand(W.Wdig.clone()))
    plain = li._exact_pass_plain(gz8, m8, W.Wdig)
    torch.cuda.synchronize()
    for a, b, c in zip(got, bare, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_exact_pass_rejects_bad_input(dev):
    from hail_tpu_torch.ops import linreg_i8 as li
    g = torch.zeros((4, 8), dtype=torch.int8, device=dev)

    def operand(N):
        return li.exact_operand(torch.zeros((N, 7), dtype=torch.int8,
                                            device=dev))
    with pytest.raises(ValueError, match='shape'):
        li.exact_pass(g, g, operand(9))
    with pytest.raises(ValueError, match='contiguous'):
        li.exact_pass(torch.zeros((8, 4), dtype=torch.int8, device=dev).T, g,
                      operand(8))
    with pytest.raises(ValueError, match='CUDA tensor'):
        li.exact_pass(g, g.cpu(), operand(8))
    # a layout that is not this Wdig's
    with pytest.raises(ValueError, match='exact_pass/WT'):
        li.exact_pass(g, g, li.ExactOperand(operand(8).Wdig, operand(40).WT))


@pytest.mark.parametrize('m,n', [(1, 1), (600, 130), (129, 65), (1000, 257),
                                 (128, 64), (31, 5), (4096, 200), (33, 63),
                                 (256, 192), (20000, 100), (700, 1000),
                                 (2048, 64), (1025, 130), (40000, 70)])
def test_ibs_matches_plain(dev, m, n):
    _ibs_against_plain(dev, m, n, all_missing=False)


@pytest.mark.parametrize('m,n', [(600, 130), (31, 5), (256, 192), (3000, 66)])
def test_ibs_with_all_missing_samples(dev, m, n):
    _ibs_against_plain(dev, m, n, all_missing=True)


def _ibs_against_plain(dev, m, n, all_missing):
    from hail_tpu_torch.ops import _kernels, ibs
    rng = np.random.default_rng(m * n)
    nalt = rng.integers(0, 3, (m, n))
    called = rng.random((m, n)) >= 0.1
    if all_missing:
        called[:, ::3] = False                   # every third sample
    het, hom_ref, hom_var = (called & (nalt == c) for c in (1, 0, 2))
    ind = [torch.from_numpy(a).to(dev) for a in (het, hom_ref, hom_var, called)]
    before = _kernels.launches['hail_ibs_counts']
    got = ibs.ibs_counts(*ind)
    assert _kernels.launches['hail_ibs_counts'] == before + 1
    plain = ibs._ibs_plain(*ind)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.dtype == torch.int32 and a.shape == (n, n)
        assert torch.equal(a, b)
    if all_missing:
        assert not any(a[0].any() or a[:, 0].any() for a in got)


def test_exact_core_on_the_card_matches_cpu(dev):
    """The f64 epilogue on the card against the same epilogue on the CPU."""
    from hail_tpu_torch.ops import linreg_i8 as li
    rng = np.random.default_rng(11)
    R, N, k, P = 50, 700, 3, 2
    g = rng.integers(0, 3, (R, N)).astype(np.int8)
    m = (rng.random((R, N)) < 0.05).astype(np.int8)
    g[m == 1] = 0
    m[7] = 1
    g[7] = 0                                     # all-missing row -> NaN
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, k - 1))], 1)
    Q, _ = np.linalg.qr(cov)
    Ys = rng.normal(size=(N, P))
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(0) - (Qty * Qty).sum(0)
    out = {}
    for d in (dev, torch.device('cpu')):
        consts = li.exact_consts(Q, Ys, Qty, yyp, N - k - 1, d)
        out[d.type] = li.linreg_block_gz_exact_packed(
            torch.from_numpy(g).to(d), torch.from_numpy(m).to(d), *consts,
            k).cpu().numpy()
    assert np.array_equal(np.isnan(out['cuda']), np.isnan(out['cpu']))
    np.testing.assert_allclose(out['cuda'], out['cpu'], rtol=1e-10,
                               equal_nan=True)


@pytest.mark.parametrize('R,N,KP', [(1, 1, 1), (37, 1003, 5), (100, 3001, 13),
                                    (9, 2048, 8), (300, 10000, 5)])
def test_linreg_i8_sums_matches_plain(dev, R, N, KP):
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    rng = np.random.default_rng(R + N + KP)
    g = rng.integers(0, 3, (R, N)).astype(np.int8)
    g[rng.random((R, N)) < 0.1] = -1
    W = rng.normal(size=(N, KP)).astype(np.float32)
    G8, Wd = (torch.from_numpy(a).to(dev) for a in (g, W))
    before = _kernels.launches['hail_linreg_i8_sums']
    got = li.linreg_i8_sums(G8, Wd)
    assert _kernels.launches['hail_linreg_i8_sums'] == before + 1
    plain = li._sums_ref(G8, Wd)
    torch.cuda.synchronize()
    gz = np.where(g < 0, 0, g).astype(np.float64)
    m = (g < 0).astype(np.float64)
    assert got[2].dtype == torch.float32 and torch.equal(got[2], plain[2])
    np.testing.assert_array_equal(
        got[2].cpu().numpy(), np.stack([m.sum(1), gz.sum(1), (gz * gz).sum(1)],
                                       axis=1))
    W64 = W.astype(np.float64)
    for a, b, A in zip(got[:2], plain[:2], (gz, m)):
        assert a.dtype == torch.float32 and a.shape == (R, KP)
        a, b = a.cpu().numpy(), b.cpu().numpy()
        exact, l2 = A @ W64, np.sqrt((A * A) @ (W64 * W64))
        assert (np.abs(a - exact) <= 1e-5 * np.abs(exact) + 1e-5 * l2).all()
        assert (np.abs(a - b) <= 1e-4 * np.abs(b) + 2e-5 * l2).all()


def test_linreg_i8_sums_rejects_bad_input(dev):
    from hail_tpu_torch.ops import linreg_i8 as li
    g = torch.zeros((4, 8), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match='shape'):
        li.linreg_i8_sums(g, torch.zeros((9, 2), device=dev))
    with pytest.raises(TypeError):
        li.linreg_i8_sums(g, torch.zeros((8, 2), dtype=torch.float64,
                                         device=dev))
    with pytest.raises(ValueError, match='CUDA tensor'):
        li.linreg_i8_sums(g, torch.zeros((8, 2)))


def test_linreg_stats_i8_on_the_card_matches_cpu(dev):
    """K1's path on the card against the same path's plain version on the
    CPU: f32 results at rtol 1e-4, atol 1e-5 (sums in another order)."""
    from hail_tpu_torch.ops import linreg_i8 as li
    rng = np.random.default_rng(12)
    R, N, k, P = 64, 1500, 3, 2
    g = rng.integers(0, 3, (R, N)).astype(np.int8)
    g[rng.random((R, N)) < 0.05] = -1
    g[7] = -1                                    # all-missing row -> NaN
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, k - 1))], 1)
    Q, _ = np.linalg.qr(cov)
    Ys = rng.normal(size=(N, P))
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(0) - (Qty * Qty).sum(0)
    out = {d.type: li.linreg_stats_i8(torch.from_numpy(g).to(d), Q, Ys, Qty,
                                      yyp, N - k - 1)
           for d in (dev, torch.device('cpu'))}
    for f in ('sum_x', 'beta', 'standard_error', 't_stat', 'p_value'):
        a, b = out['cuda'][f], out['cpu'][f]
        assert np.array_equal(np.isnan(a), np.isnan(b)), f
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   equal_nan=True, err_msg=f)


@pytest.mark.parametrize('test', ['wald', 'firth', 'score'])
def test_glm_device_on_the_card_matches_cpu(dev, test):
    """The GLM tier's f64 fits on the card against the CPU, singular rows
    included (cuSOLVER's Cholesky must report them as the CPU's does):
    iteration counts and status equal, numbers at rtol 1e-9."""
    from hail_tpu_torch.ops import glm_device as gd
    from hail_tpu_torch.stats import glmfit
    rng = np.random.RandomState(4)
    N, R, k = 400, 40, 3
    Cov = np.hstack([np.ones((N, 1)), rng.randn(N, k - 1)])
    G = rng.binomial(2, 0.3, size=(R, N)).astype(np.float64)
    M = rng.rand(R, N) < 0.05
    y = (rng.rand(N) < 1 / (1 + np.exp(-(Cov @ rng.randn(k) * 0.4)))
         ).astype(np.float64)
    G[3], M[3] = 0.0, False                      # singular fisher
    M[5] = True                                  # all missing: NaN
    null = glmfit.logreg_fit(Cov, y, None, 25, 1e-8)
    out = {d: gd.logistic_rows_device(G, M, Cov, y, null, test, 25, 1e-8,
                                      device=d) for d in (dev, 'cpu')}
    for key, b in out['cpu'].items():
        a = np.asarray(out[dev][key], np.float64)
        b = np.asarray(b, np.float64)
        if 'status' in key or 'n_iter' in key or key in ('valid', 'nan_input'):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert np.array_equal(np.isnan(a), np.isnan(b)), key
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                       equal_nan=True, err_msg=key)
