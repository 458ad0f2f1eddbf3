"""Each hand-written CUDA kernel of hail_tpu_torch against its plain torch
version, on the card. Without one every test skips. This file imports
neither jax nor hail_tpu, so on a machine without jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

K2, K3, K4 and K6 are integer kernels: their results are bit-equal to the
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
run on the CPU. Neither have the BlockMatrix tier's device ops: the exact
GRM's int8 products (`torch._int_mm`, at shapes it refuses unpadded) are
held to the CPU's int32 products bit for bit and its strips to the f64
product on the card within 1e-12; the ld_prune band to the CPU's bit for
bit, on data whose r² keep 1e-9 away from the threshold. K5 (variant_qc)
is bit-equal to its plain version: integer counts, and f64 sums, min and
max of DP and GQ (exact while C * max² < 2^53, so bit-equal in any order),
at ragged shapes and at few, wide rows whose segments meet at ragged edges
(4 x 200,003, 130 x 40,000), with A = 2, 3, 9 and 7,000 and alleles at and
above A, DP and GQ apart, inputs off 16-byte boundaries in the same phase
(the vector body behind a head) and in different phases (the scalar
loop), and DP just below 2^19 at C = 10,001, near the top of the exact
range. One call is one launch. The linear mixed model's contractions
(ops/lmm) and ld_score's window sums (ops/ldscore) have no kernel either:
each is held to its run on the CPU within rtol 1e-12.
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


def _unpack_against_plain(u8, N):
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    before = _kernels.launches['hail_unpack_gt_2bit']
    gz8, m8 = li.unpack_gt_2bit(u8, N)
    assert _kernels.launches['hail_unpack_gt_2bit'] == before + 1
    gz8_p, m8_p = li._unpack_plain(u8, N)
    torch.cuda.synchronize()
    assert gz8.dtype == m8.dtype == torch.int8
    assert gz8.shape == m8.shape == (u8.shape[0], N)
    assert torch.equal(gz8, gz8_p) and torch.equal(m8, m8_p)
    # and the codes themselves, decoded on the host
    codes = (u8.cpu().numpy()[:, :, None] >> np.arange(0, 8, 2)) & 3
    codes = codes.reshape(u8.shape[0], -1)[:, :N]
    np.testing.assert_array_equal(gz8.cpu().numpy(),
                                  np.where(codes == 3, 0, codes))
    np.testing.assert_array_equal(m8.cpu().numpy(), codes == 3)


# the flat path: n % 4 == 0 (16 | n, 16 | R n only, a tail of 1-3 bytes);
# the general path: n % 4 != 0, n < 16, rows off 16 bytes
@pytest.mark.parametrize('R,N', [(1, 1), (3, 7), (64, 1003), (300, 10000),
                                 (64, 1024), (5, 16), (7, 12), (3, 4),
                                 (1, 20), (2050, 528), (33, 10001),
                                 (9, 15), (40, 17), (4, 2), (1500, 2502),
                                 (11, 4099)])
def test_unpack_matches_plain(dev, R, N):
    gen = torch.Generator().manual_seed(R * N)
    u8 = torch.randint(0, 256, (R, -(-N // 4)), dtype=torch.uint8,
                       generator=gen).to(dev)
    _unpack_against_plain(u8, N)


@pytest.mark.parametrize('R,N', [(9, 1000), (9, 40), (6, 1003), (17, 68),
                                 (5, 10)])
def test_unpack_row_slice_base(dev, R, N):
    """u8[1:] of a larger tensor: contiguous, its base n4 bytes into the
    allocation, so off 4 bytes whenever n4 % 4 != 0."""
    gen = torch.Generator().manual_seed(R + N)
    whole = torch.randint(0, 256, (R + 1, -(-N // 4)), dtype=torch.uint8,
                          generator=gen).to(dev)
    u8 = whole[1:]
    assert u8.is_contiguous() and u8.data_ptr() == whole.data_ptr() + u8.shape[1]
    _unpack_against_plain(u8, N)


@pytest.mark.parametrize('N', [64, 1003, 10, 4100])
def test_unpack_all_and_no_missing_rows(dev, N):
    gen = torch.Generator().manual_seed(N)
    u8 = torch.randint(0, 256, (6, -(-N // 4)), dtype=torch.uint8,
                       generator=gen)
    u8[1] = 0xFF                                 # every entry missing
    u8[2] = 0xA4                                 # codes 0, 1, 2, 2: none
    u8[4] = 0x00
    _unpack_against_plain(u8.to(dev), N)


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
                                    (9, 2048, 8), (300, 10000, 5),
                                    (33, 1000, 1), (31, 520, 2), (35, 515, 3),
                                    (5, 4100, 4), (67, 2056, 6), (19, 777, 7),
                                    (17, 1030, 9), (130, 512, 5),
                                    (3, 10007, 13), (64, 100, 8)])
def test_linreg_i8_sums_matches_plain(dev, R, N, KP):
    rng = np.random.default_rng(R + N + KP)
    g = rng.integers(0, 3, (R, N)).astype(np.int8)
    g[rng.random((R, N)) < 0.1] = -1
    g[R // 2] = -1                               # an all-missing row
    W = rng.normal(size=(N, KP)).astype(np.float32)
    _sums_against_plain(torch.from_numpy(g).to(dev), g,
                        torch.from_numpy(W).to(dev), W)


@pytest.mark.parametrize('offset,N', [(1, 1000), (2, 1024), (4, 1000),
                                      (3, 515)])
def test_linreg_i8_sums_off_aligned_base(dev, offset, N):
    """G8 that starts `offset` bytes into its allocation: rows off 4 bytes
    load their words byte by byte."""
    rng = np.random.default_rng(offset + N)
    R, KP = 37, 5
    g = rng.integers(0, 3, (R, N)).astype(np.int8)
    g[rng.random((R, N)) < 0.1] = -1
    W = rng.normal(size=(N, KP)).astype(np.float32)
    buf = torch.zeros(offset + g.size, dtype=torch.int8, device=dev)
    buf[offset:] = torch.from_numpy(g).to(dev).reshape(-1)
    G8 = buf[offset:].view(R, N)
    assert G8.is_contiguous() and G8.data_ptr() % 16 == offset
    _sums_against_plain(G8, g, torch.from_numpy(W).to(dev), W)


def _sums_against_plain(G8, g, Wd, W):
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    (R, N), KP = g.shape, W.shape[1]
    op = li.f32_operand(Wd)
    before = _kernels.launches['hail_linreg_i8_sums']
    got = li.linreg_i8_sums(G8, op)
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
        li.linreg_i8_sums(g, li.f32_operand(torch.zeros((9, 2), device=dev)))
    with pytest.raises(TypeError):
        li.linreg_i8_sums(g, li.F32Operand(
            torch.zeros((8, 2), dtype=torch.float64, device=dev),
            torch.zeros((2, 8), device=dev)))
    with pytest.raises(ValueError, match='CUDA tensor'):
        li.linreg_i8_sums(g, li.f32_operand(torch.zeros((8, 2))))
    with pytest.raises(TypeError, match='F32Operand'):
        li.linreg_i8_sums(g, torch.zeros((8, 2), device=dev))
    # a layout that is not this W's
    W = torch.zeros((8, 2), device=dev)
    with pytest.raises(ValueError, match='linreg_i8_sums/WT'):
        li.linreg_i8_sums(g, li.F32Operand(
            W, li.f32_operand(torch.zeros((12, 2), device=dev)).WT))


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


def _grm_inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (m, n))
    M = rng.random((m, n)) < 0.1
    G[2], M[2] = 1, False                        # monomorphic: excluded
    cnt = (~M).sum(axis=1)
    p = np.where(M, 0, G).sum(axis=1) / np.maximum(2 * cnt, 1)
    ok = (2 * p * (1 - p) > 0) & (cnt > 0)
    return np.where(M, 0, G).astype(np.int8), M.astype(np.int8), p, ok


@pytest.mark.parametrize('m,n,width', [
    (64, 48, 16), (61, 10, 3), (300, 517, 200), (1000, 2048, 1024)])
def test_exact_grm_on_the_card_matches_f64_route(dev, m, n, width):
    """ExactGrm's strips on the card against the f64 route (Zᵀ Z / m by
    torch.matmul in f64 on the card) within 1e-12, and each plane's int32
    product (torch._int_mm on padded operands) equal to the CPU's int32
    product."""
    from hail_tpu_torch.ops.grm import ExactGrm, _plane_product
    gz8, m8, p, ok = _grm_inputs(m, n, m + n)
    g = ExactGrm(torch.from_numpy(gz8).to(dev), torch.from_numpy(m8).to(dev),
                 p, ok)
    q = g._planes[0]
    strip = g.ct[:-(-width // 8) * 8]       # 8-aligned, as strip() pads
    for k in range(q.shape[0]):
        got = _plane_product(g.b1t, strip, q[k])
        want = _plane_product(g.b1t.cpu(), strip.cpu(), q[k].cpu())
        assert torch.equal(got.cpu(), want)
    G = torch.from_numpy(gz8).to(dev, torch.float64)
    miss = torch.from_numpy(m8).to(dev) > 0
    mean = torch.from_numpy(2 * p).to(dev)
    d = torch.from_numpy(np.sqrt(2 * p * (1 - p))).to(dev)
    okd = torch.from_numpy(ok).to(dev)
    Z = torch.where(okd[:, None] & ~miss,
                    (G - mean[:, None]) / torch.where(okd, d, 1.0)[:, None],
                    0.0)
    K = (Z.T @ Z) / max(int(ok.sum()), 1)
    for lo, hi, strip in g.strips(width):
        assert strip.dtype == torch.float64 and strip.shape == (n, hi - lo)
        err = float((strip - K[:, lo:hi]).abs().max())
        assert err < 1e-12, (lo, err)


def test_ld_band_on_the_card_matches_cpu(dev):
    from hail_tpu_torch.ops import ldprune
    rng = np.random.default_rng(8)
    m, n, w = 3000, 500, 37
    G = rng.integers(0, 3, (m, n)).astype(np.float64)
    copy = rng.random(m) < 0.6
    for i in np.flatnonzero(copy[1:]) + 1:       # planted LD
        redraw = rng.random(n) < 0.1
        G[i] = np.where(redraw, rng.integers(0, 3, n), G[i - 1])
    G -= G.mean(axis=1, keepdims=True)
    Z = G / np.sqrt((G * G).sum(axis=1, keepdims=True))
    i, k = np.meshgrid(np.arange(m), np.arange(w), indexing='ij')
    j = i - w + k
    r = np.einsum('ikn,ikn->ik', Z[i], Z[np.maximum(j, 0)])
    assert np.abs(r[j >= 0] ** 2 - 0.2).min() > 1e-9
    got = np.concatenate([h for _, _, h in ldprune.banded_r2_hits(
        torch.from_numpy(Z).to(dev), w, 0.2, block=1024)])
    want = np.concatenate([h for _, _, h in ldprune.banded_r2_hits(
        torch.from_numpy(Z), w, 0.2, block=1024)])
    np.testing.assert_array_equal(got, want)
    assert got.any()
    m8 = torch.from_numpy((rng.random((64, n)) < 0.05).astype(np.int8))
    gz8 = torch.from_numpy(rng.integers(0, 3, (64, n)).astype(np.int8)) * (1 - m8)
    z_c, mean_c, ok_c = ldprune.standardize_rows_device(gz8.to(dev), m8.to(dev))
    z_h, mean_h, ok_h = ldprune.standardize_rows_device(gz8, m8)
    np.testing.assert_array_equal(mean_c, mean_h)
    np.testing.assert_array_equal(ok_c, ok_h)
    np.testing.assert_allclose(z_c.cpu().numpy(), z_h.numpy(), rtol=1e-14)


# ---- K5: variant_qc -------------------------------------------------------

def _qc_inputs(R, N, A, seed):
    """Packed calls of ploidy 0-2 with alleles up to A + 2 (some at or above
    A; stray bits in the allele fields a haploid or ploidy-0 call does not
    use), arbitrary bits under 6% missing, DP below 2^16 and GQ below 100
    with 10% -1, row 0 with no defined DP and row 1 with every call
    missing."""
    rng = np.random.default_rng(seed)
    ploidy = rng.choice([0, 1, 2], (R, N), p=[0.05, 0.1, 0.85])
    j = rng.integers(0, A + 2, (R, N))
    k = rng.integers(0, A + 2, (R, N))
    j, k = np.minimum(j, k), np.maximum(j, k)
    packed = (ploidy | (j << 3) | (k << 17)).astype(np.int32)
    missing = rng.random((R, N)) < 0.06
    if R > 1:
        missing[1] = True
    packed = np.where(missing, rng.integers(-2**31, 2**31, (R, N)),
                      packed).astype(np.int32)
    dp = rng.integers(0, 1 << 16, (R, N)).astype(np.int32)
    dp[rng.random((R, N)) < 0.1] = -1
    dp[0] = -1
    gq = rng.integers(0, 100, (R, N)).astype(np.int32)
    gq[rng.random((R, N)) < 0.1] = -1
    return packed, missing, dp, gq


def _on_card(a, dev, offset=0):
    """`a` on the card as a contiguous slice that starts `offset` elements
    into a buffer whose own base is aligned."""
    flat = np.zeros(a.size + offset, a.dtype)
    flat[offset:] = a.ravel()
    return torch.from_numpy(flat).to(dev)[offset:].view(a.shape)


def _qc_against_plain(dev, R, N, A, has_dp, has_gq, offsets=(0, 0, 0, 0),
                      inputs=None):
    from hail_tpu_torch.ops import _kernels, qc
    if inputs is None:
        inputs = _qc_inputs(R, N, A, R * 31 + N + A)
    packed, missing, dp, gq = (_on_card(a, dev, o)
                               for a, o in zip(inputs, offsets))
    args = (packed, missing, dp if has_dp else None, gq if has_gq else None,
            A, has_dp, has_gq)
    before = _kernels.launches['hail_variant_qc']
    got = qc.variant_qc_block(*args)
    assert _kernels.launches['hail_variant_qc'] == before + 1
    want = qc._variant_qc_ref(*args)
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if w.dtype == torch.float64:
            assert g.dtype == torch.float64
            assert torch.equal(g, w), key           # bit-equal, inf included
        else:
            assert g.dtype == torch.int32
            assert torch.equal(g.to(torch.int64), w), key
    if has_dp:
        assert got['dp_n'][0] == 0 and got['dp_min'][0] == float('inf')
        assert got['dp_max'][0] == float('-inf')
    if R > 1:
        assert got['n_called'][1] == 0 and got['AN'][1] == 0
    return got


# the few, wide rows are cut into 97 segments of 2,064 entries and 16 of
# 2,512 that meet off 16-byte boundaries (C odd) and at rows' ends
# (ops/qc._launch_plan on 132 SMs)
@pytest.mark.parametrize('R,N', [(1, 1), (3, 7), (37, 1003), (2048, 10000),
                                 (300, 10001), (4, 200003), (130, 40000)])
@pytest.mark.parametrize('A', [2, 3, 9])
def test_variant_qc_matches_plain(dev, R, N, A):
    _qc_against_plain(dev, R, N, A, True, True)


def _phase(t):
    """An int32 input's data_ptr / 4, or the mask's data_ptr, modulo 4: the
    kernel takes its vector body only where all inputs' phases agree."""
    p = t.data_ptr()
    return (p >> 2 if t.element_size() == 4 else p) % 4


# (packed, missing, DP, GQ) offsets in elements: all in one phase off 16
# bytes (a head, then the vector body), and phases that differ (the scalar
# loop for the whole launch), among them a slice [1:] of an odd-C buffer
@pytest.mark.parametrize('offsets,same', [
    ((1, 1, 1, 1), True), ((3, 3, 7, 11), True), ((2, 6, 2, 2), True),
    ((10001, 3, 0, 0), False), ((0, 0, 2, 0), False), ((1, 2, 3, 0), False),
    ((0, 0, 0, 1), False)])
@pytest.mark.parametrize('A', [2, 9])
def test_variant_qc_misaligned_inputs(dev, offsets, same, A):
    R, N = 37, 10001
    ts = [_on_card(np.zeros((R, N), d), dev, o) for d, o in
          zip((np.int32, np.bool_, np.int32, np.int32), offsets)]
    assert (len({_phase(t) for t in ts}) == 1) == same
    assert any(t.data_ptr() % 16 for t in ts)
    _qc_against_plain(dev, R, N, A, True, True, offsets)


def test_variant_qc_dp_near_the_top_of_the_exact_range(dev):
    """DP just below 2^19 at C = 10,001: C * max² = 2.7e15 < 2^53, so every
    partial sum of squares is an exact integer; the sums equal int64 ones."""
    R, N = 64, 10001
    packed, missing, dp, gq = _qc_inputs(R, N, 3, 19)
    rng = np.random.default_rng(19)
    dp = np.where(dp >= 0, rng.integers((1 << 19) - 4096, 1 << 19, (R, N)),
                  -1).astype(np.int32)
    assert N * int(dp.max()) ** 2 < 2 ** 53
    got = _qc_against_plain(dev, R, N, 3, True, True,
                            inputs=(packed, missing, dp, gq))
    d = np.where(dp >= 0, dp, 0).astype(np.int64)
    np.testing.assert_array_equal(got['dp_sum'].cpu().numpy(),
                                  d.sum(axis=1).astype(np.float64))
    np.testing.assert_array_equal(got['dp_sumsq'].cpu().numpy(),
                                  (d * d).sum(axis=1).astype(np.float64))


@pytest.mark.parametrize('has_dp,has_gq', [(True, False), (False, True),
                                           (False, False)])
@pytest.mark.parametrize('R,N', [(37, 1003), (300, 10001)])
def test_variant_qc_fields_apart(dev, R, N, has_dp, has_gq):
    _qc_against_plain(dev, R, N, 3, has_dp, has_gq)


def test_variant_qc_many_alleles_across_segments(dev):
    """A = 7,000 (alleles 3..6,999 through the warp-aggregated atomics) in
    rows of 8,195 entries cut into 4 segments, DP and GQ apart too."""
    _qc_against_plain(dev, 4, 8195, 7000, True, True)
    _qc_against_plain(dev, 4, 8195, 7000, False, True, (1, 1, 0, 1))


def test_variant_qc_wide_histogram_and_empty_shapes(dev):
    """An A of 7,000 (whose histogram took more than 48 KB of shared memory
    in the first design), a block with no columns and one with no rows (no
    launch)."""
    from hail_tpu_torch.ops import _kernels, qc
    _qc_against_plain(dev, 5, 300, 7000, True, True)
    e = torch.zeros((4, 0), dtype=torch.int32, device=dev)
    out = qc.variant_qc_block(e, e.bool(), e, e, 2, True, True)
    assert out['n_called'].tolist() == [0] * 4
    assert out['dp_min'].tolist() == [float('inf')] * 4
    before = _kernels.launches['hail_variant_qc']
    z = torch.zeros((0, 5), dtype=torch.int32, device=dev)
    out = qc.variant_qc_block(z, z.bool(), None, None, 2, False, False)
    assert out['AC'].shape == (0, 2)
    assert _kernels.launches['hail_variant_qc'] == before


def test_variant_qc_rejects_bad_input(dev):
    from hail_tpu_torch.ops import qc
    p = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    m = torch.zeros((3, 5), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        qc.variant_qc_block(p.long(), m, None, None, 2, False, False)
    with pytest.raises(TypeError):
        qc.variant_qc_block(p, m.to(torch.uint8), None, None, 2, False, False)
    with pytest.raises(ValueError, match='shape'):
        qc.variant_qc_block(p, m[:2], None, None, 2, False, False)
    with pytest.raises(ValueError, match='shape'):
        qc.variant_qc_block(p, m, p[:, :4].contiguous(), None, 2, True, False)
    with pytest.raises(ValueError, match='contiguous'):
        qc.variant_qc_block(p.t(), m.t(), None, None, 2, False, False)
    with pytest.raises(ValueError, match='CUDA'):
        qc.variant_qc_block(p, m.cpu(), None, None, 2, False, False)


@pytest.mark.parametrize('n,m,k', [(97, 33, 2), (1024, 2500, 4)])
def test_lmm_contractions_match_cpu(dev, n, m, k):
    """ops/lmm (torch f64 on the card; no hand-written kernel) against the
    same function on the CPU."""
    from hail_tpu_torch.ops.lmm import contractions
    rng = np.random.default_rng(n + m)
    args = [torch.from_numpy(a) for a in (rng.normal(size=(n, m)),
                                          rng.normal(size=(n, k)),
                                          rng.random(n) + 0.5,
                                          rng.normal(size=n))]
    want = contractions(*args)
    got = contractions(*(a.to(dev) for a in args))
    assert got.device.type == 'cuda' and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize('m,n,radius', [(257, 40, 1000), (5000, 300, 2.5e4)])
def test_ld_window_scores_match_cpu(dev, m, n, radius):
    """ops/ldscore (torch f64 on the card, strips of STRIP rows) against the
    same function on the CPU, with global positions past 2^24."""
    from hail_tpu_torch.ops.ldscore import window_scores
    rng = np.random.default_rng(m)
    Z = rng.normal(size=(m, n))
    Z /= np.linalg.norm(Z, axis=1, keepdims=True)
    gp = (3_000_000_000 + np.cumsum(rng.integers(1, 300, m))).astype(np.int64)
    z, g = torch.from_numpy(Z), torch.from_numpy(gp)
    want = window_scores(z, g, n, radius)
    got = window_scores(z.to(dev), g.to(dev), n, radius)
    assert got.device.type == 'cuda' and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# K6: the device decode of packed calls
# ---------------------------------------------------------------------------

def _packed_calls(R, N, seed, miss_rate=0.07):
    """Packed int32 calls of ploidy 0-3, j and k anywhere in their fields
    (some with bit 31, the k field's top bit, set), and a bool mask."""
    rng = np.random.default_rng(seed)
    ploidy = rng.choice(4, (R, N), p=[0.05, 0.25, 0.65, 0.05])
    j = np.where(rng.random((R, N)) < 0.5, 0, rng.integers(1, 1 << 14, (R, N)))
    k = np.where(rng.random((R, N)) < 0.4, 0, rng.integers(0, 1 << 15, (R, N)))
    raw = (ploidy | (j << 3) | (k << 17)).astype(np.int64)
    return (raw.astype(np.uint32).view(np.int32),
            rng.random((R, N)) < miss_rate)


def _decode_against_plain(packed, miss):
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    before = _kernels.launches['hail_decode_packed_gt']
    gz8, m8 = li.decode_packed_gt(packed, miss)
    G8 = li.decode_packed_g8(packed, miss)
    assert _kernels.launches['hail_decode_packed_gt'] == before + 2
    gz8_p, m8_p = li._decode_plain(packed, miss)
    G8_p = li._decode_plain(packed, miss, True)
    torch.cuda.synchronize()
    assert gz8.dtype == m8.dtype == G8.dtype == torch.int8
    assert gz8.shape == m8.shape == G8.shape == packed.shape
    assert torch.equal(gz8, gz8_p) and torch.equal(m8, m8_p)
    assert torch.equal(G8, G8_p)
    # and the pair equals K4's unpack of the host's 2-bit packing
    u8 = li.pack_gt_2bit(packed.cpu().numpy(),
                         None if miss is None else miss.cpu().numpy())
    gz8_u, m8_u = li.unpack_gt_2bit(torch.from_numpy(u8).to(packed.device),
                                    packed.shape[1])
    assert torch.equal(gz8, gz8_u) and torch.equal(m8, m8_u)


# the vector path (16 entries a thread) with and without a tail of 1-15
# entries, shapes below one vector, and the bench's shape
@pytest.mark.parametrize('R,N', [(1, 1), (3, 7), (64, 1003), (5, 16), (4, 4),
                                 (33, 10001), (300, 10000), (2, 24),
                                 (8192, 10000)])
@pytest.mark.parametrize('with_missing', [True, False])
def test_decode_matches_plain(dev, R, N, with_missing):
    packed, miss = _packed_calls(R, N, seed=R + N)
    _decode_against_plain(torch.from_numpy(packed).to(dev),
                          torch.from_numpy(miss).to(dev) if with_missing
                          else None)


@pytest.mark.parametrize('off_calls,off_mask', [(1, 0), (0, 3), (5, 5)])
def test_decode_off_aligned_base(dev, off_calls, off_mask):
    """Calls or mask that do not start on 16 bytes (a slice of a larger
    tensor) take the entry-by-entry path, with the same result."""
    packed, miss = _packed_calls(17, 333, seed=off_calls + 7 * off_mask)
    flat_p = torch.from_numpy(np.concatenate(
        [np.zeros(off_calls, np.int32), packed.ravel()])).to(dev)
    flat_m = torch.from_numpy(np.concatenate(
        [np.zeros(off_mask, bool), miss.ravel()])).to(dev)
    p = flat_p[off_calls:].view(17, 333)
    m = flat_m[off_mask:].view(17, 333)
    _decode_against_plain(p, m)


def test_decode_rejects_bad_input(dev):
    from hail_tpu_torch.ops import linreg_i8 as li
    p = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    m = torch.zeros((4, 8), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        li.decode_packed_gt(p.to(torch.int64), m)
    with pytest.raises(TypeError):
        li.decode_packed_gt(p, m.to(torch.uint8))
    with pytest.raises(ValueError, match='shape'):
        li.decode_packed_gt(p, m[:2])
    with pytest.raises(ValueError, match='contiguous'):
        li.decode_packed_g8(p.t(), None)
    with pytest.raises(ValueError, match=r'\(R, N\)'):
        li.decode_packed_g8(p.view(-1), None)
    with pytest.raises(ValueError, match='CUDA'):
        li.decode_packed_gt(p, m.cpu())


def test_packed_call_routes_on_the_card_match_cpu(dev):
    """`linreg_stats_call_exact` (K6, K3) on the card against its plain
    run on the CPU at rtol 1e-10, and `linreg_stats_call` (K6 in G8 mode,
    K1) at the f32 bar of `linreg_stats_i8`'s test (rtol 1e-4, atol 1e-5)."""
    from hail_tpu_torch.ops import linreg_i8 as li
    rng = np.random.default_rng(13)
    R, N, k, P = 64, 1500, 3, 2
    packed, miss = _packed_calls(R, N, seed=13)
    miss[7] = True                               # all-missing row -> NaN
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, k - 1))], 1)
    Q, _ = np.linalg.qr(cov)
    Ys = rng.normal(size=(N, P))
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(0) - (Qty * Qty).sum(0)
    for fn, rtol, atol in ((li.linreg_stats_call_exact, 1e-10, 0.0),
                           (li.linreg_stats_call, 1e-4, 1e-5)):
        out = {d.type: fn(None, None, Q, Ys, Qty, yyp, N - k - 1,
                          packed_dev=torch.from_numpy(packed).to(d),
                          missing_dev=torch.from_numpy(miss).to(d))
               for d in (dev, torch.device('cpu'))}
        for f in ('sum_x', 'beta', 'standard_error', 't_stat', 'p_value'):
            a, b = out['cuda'][f], out['cpu'][f]
            assert np.array_equal(np.isnan(a), np.isnan(b)), f
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=f)


# ---------------------------------------------------------------------------
# K7: the digit planes of the exact linreg's operand
# ---------------------------------------------------------------------------

# (N, k, P) of each case of `digit_plane_case`; test_torch_linreg_i8.py
# holds the plain version to the host's and the reference's on the first
# seven, which are also ragged: N not a multiple of 16, 7·(k + P) not of 8
DIGIT_PLANE_SHAPES = {
    'random': (301, 4, 3), 'zero_column': (301, 3, 2),
    'pow2_max': (160, 2, 3), 'pow2_ulp': (77, 2, 2),
    'tiny_huge': (250, 3, 4), 'ties': (1003, 1, 4),
    'wide': (1000, 30, 50), 'kg': (2504, 5, 1), 'ukb': (361194, 26, 16)}


def digit_plane_case(name):
    """(Q, Ys) f64 of one case: `random` normal columns; `zero_column` a
    column of zeros and one of -0.0; `pow2_max` columns whose max |w| is
    exactly a power of two (8, -2^-4, and a column of ones); `pow2_ulp`
    maxima one ulp above 4 and one ulp below 2^-3 (where a log2 that rounds
    otherwise than numpy's would take another base); `tiny_huge` columns of
    1e-300 and 1e300, one whose entries underflow to subnormal residuals
    under a max of 1e300, subnormal entries under a max of 1, a column of
    subnormals (its base is subnormal, so K7 divides by it: 1 / base is no
    double) and one whose base overflows to inf (every digit 0); `ties`
    multiples of 2^-8
    and 2^-15 under a max of 1 (digits that round half to even); `wide`
    more than the 64 columns of one K7 block; `kg` and `ukb` the two
    cells' widths at their sample counts."""
    N, k, P = DIGIT_PLANE_SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    Q = rng.normal(size=(N, k))
    Ys = rng.normal(size=(N, P))
    if name == 'zero_column':
        Ys[:, 1] = 0.0
        Q[:, 2] = -0.0
    elif name == 'pow2_max':
        Ys[:, 0] *= 7.5 / np.abs(Ys[:, 0]).max()
        Ys[17, 0] = 8.0
        Ys[:, 1] *= 2.0 ** -5 / np.abs(Ys[:, 1]).max()
        Ys[3, 1] = -2.0 ** -4
        Q[:, 0] = 1.0
    elif name == 'pow2_ulp':
        Ys[:, 0] *= 3.0 / np.abs(Ys[:, 0]).max()
        Ys[5, 0] = np.nextafter(4.0, np.inf)
        Ys[:, 1] *= 2.0 ** -4 / np.abs(Ys[:, 1]).max()
        Ys[9, 1] = -np.nextafter(2.0 ** -3, 0.0)
    elif name == 'tiny_huge':
        Q[:, 1] *= 1e-300
        Ys[:, 0] *= 1e300
        Ys[:, 1] *= 1e-300
        Ys[0, 1] = 1e300
        Ys[:, 2] *= 1e-310
        Ys[1, 2] = 1.0
        Ys[:, 3] *= 1e-310                       # a subnormal base: 2^-1027
        Q[4, 2] = 1.5e308                        # base 2^1024 = inf
    elif name == 'ties':
        for j, step in ((0, 2.0 ** -8), (1, 2.0 ** -8), (2, 2.0 ** -15)):
            Ys[:, j] = rng.integers(-255, 256, N) * step
            Ys[0, j] = 1.0
    return Q, Ys


def _k7_against_host(dev, Q, Ys):
    """K7's operand and scales against `exact_operand` of the host's
    `_digit_planes` and against the plain version on the card, bit for
    bit; two launches, one of each entry point."""
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    Qd, Ysd = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in (Q, Ys))
    before = dict(_kernels.launches)
    W, scales = li.digit_operand(Qd, Ysd)
    assert {n: _kernels.launches[n] - before[n] for n in before
            if _kernels.launches[n] != before[n]} == {
                'hail_digit_amax': 1, 'hail_digit_planes': 1}
    Wd_h, sc_h = li._digit_planes(np.concatenate([Q, Ys], axis=1))
    want = li.exact_operand(torch.from_numpy(Wd_h).to(dev))
    Wd_p, sc_p = li._digit_planes_plain(Qd, Ysd)
    torch.cuda.synchronize()
    assert W.Wdig.dtype == W.WT.dtype == torch.int8
    assert W.Wdig.shape == want.Wdig.shape and W.WT.shape == want.WT.shape
    assert torch.equal(W.Wdig, want.Wdig)
    assert torch.equal(W.WT, want.WT)
    assert torch.equal(W.Wdig, Wd_p)
    assert np.array_equal(scales, sc_h) and np.array_equal(sc_p, sc_h)
    assert scales.dtype == np.float64 and scales.shape == (7, Q.shape[1]
                                                           + Ys.shape[1])


@pytest.mark.parametrize('case', list(DIGIT_PLANE_SHAPES))
def test_digit_planes_match_host(dev, case):
    _k7_against_host(dev, *digit_plane_case(case))


@pytest.mark.parametrize('N,k,P', [(1, 1, 1), (16, 0, 3), (17, 2, 1),
                                   (63, 64, 0), (65, 64, 1), (129, 100, 28)])
def test_digit_planes_edge_shapes(dev, N, k, P):
    """One sample, no covariates, N one past 16 and 64 (the padding of
    WT's rows and the last block), W exactly one block wide and one
    column past it, and two tiles of columns."""
    rng = np.random.default_rng(N + k + P)
    if P == 0:
        Q, Ys = rng.normal(size=(N, k - 1)), rng.normal(size=(N, 1))
    else:
        Q, Ys = rng.normal(size=(N, k)), rng.normal(size=(N, P))
    _k7_against_host(dev, Q, Ys)


def test_exact_consts_launch_k7_once(dev):
    """`exact_consts` on the card makes its operand with K7: one launch of
    each entry point a call, from host arrays or from tensors already on
    the card; `_exact_consts_cached` keeps nothing, so each of its calls
    launches K7 again."""
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    Q, Ys = digit_plane_case('kg')
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(0) - (Qty * Qty).sum(0)
    names = ('hail_digit_amax', 'hail_digit_planes')
    before = [_kernels.launches[n] for n in names]
    W, sc, Qtyd, yypd, d = li.exact_consts(Q, Ys, Qty, yyp, 2000, dev)
    assert [_kernels.launches[n] - b for n, b in zip(names, before)] == [1, 1]
    Wd_h, sc_h = li._digit_planes(np.concatenate([Q, Ys], axis=1))
    assert torch.equal(W.WT, li.exact_operand(torch.from_numpy(Wd_h).to(dev)).WT)
    assert sc.device.type == 'cuda' and torch.equal(sc.cpu(),
                                                    torch.from_numpy(sc_h))
    # the column plane's tensors on the card: each call makes its operand
    Qd, Ysd, Qtyd, yypd = (torch.from_numpy(v).to(dev)
                           for v in (Q, Ys, Qty, yyp))
    a = statgen._exact_consts_cached(Qd, Ysd, Qtyd, yypd, 2000, dev)
    b = statgen._exact_consts_cached(Qd, Ysd, Qtyd, yypd, 2000, dev)
    assert b is not a and a[2] is Qtyd and a[3] is yypd
    assert torch.equal(a[0].WT, W.WT) and torch.equal(b[0].WT, W.WT)
    assert [_kernels.launches[n] - b_ for n, b_ in zip(names, before)] == [3, 3]


def test_digit_planes_reject_bad_input(dev):
    from hail_tpu_torch.ops import linreg_i8 as li
    Q = torch.zeros((8, 2), dtype=torch.float64, device=dev)
    Ys = torch.zeros((8, 1), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        li.digit_operand(Q.float(), Ys)
    with pytest.raises(ValueError, match='contiguous'):
        li.digit_operand(torch.zeros((2, 8), dtype=torch.float64,
                                     device=dev).t(), Ys)
    with pytest.raises(ValueError, match=r'\(N, k\)'):
        li.digit_operand(Q, Ys[:4])
    with pytest.raises(ValueError, match='CUDA'):
        li.digit_operand(Q, Ys.cpu())


def test_gwas_through_k7_equals_host_planes(dev, monkeypatch):
    """`linear_regression_rows` on a small MatrixTable on the card: with
    K7's planes its statistics are bitwise those of the host's planes
    (`_digit_planes`, copied to the card as before K7)."""
    import chip_smoke
    import hail_tpu_torch as hl
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    hl.init(device='cuda', quiet=True)
    try:
        mt = chip_smoke.build_mt(hl, np.random.default_rng(3), 1003, 96, 2,
                                 with_pheno=True)[0]
        covs = [1.0] + [getattr(mt, f'c{i}') for i in range(chip_smoke.K - 1)]
        fields = ('sum_x', 'y_transpose_x', 'beta', 'standard_error',
                  't_stat', 'p_value')

        def stats():
            before = _kernels.launches['hail_digit_planes']
            res = hl.linear_regression_rows(y=mt.pheno,
                                            x=mt.GT.n_alt_alleles(),
                                            covariates=covs)
            out = {f: np.concatenate([
                np.asarray(b.columns[f].values, np.float64)
                for b in res._stage.collect_batches()]) for f in fields}
            return out, _kernels.launches['hail_digit_planes'] - before

        k7, n_k7 = stats()

        def host_planes(Q, Ys):
            Wd, sc = li._digit_planes(np.concatenate(
                [Q.cpu().numpy(), Ys.cpu().numpy()], axis=1))
            return li.exact_operand(torch.from_numpy(Wd).to(Q.device)), sc
        monkeypatch.setattr(li, 'digit_operand', host_planes)
        host, n_host = stats()
    finally:
        hl.stop()
    assert (n_k7, n_host) == (1, 0)
    for f in fields:
        assert k7[f].shape == (192,) and np.isfinite(k7[f]).all(), f
        assert np.array_equal(k7[f].view(np.int64), host[f].view(np.int64)), f


@pytest.mark.parametrize('case', ['all_kept', 'missing_pheno',
                                  'intercept_only', 'int_x'])
def test_gwas_column_plane_on_the_card_equals_the_host_qr(dev, monkeypatch,
                                                           case):
    """`linear_regression_rows` on the card makes its column plane there
    (`statgen._column_plane_device`: the QR, Qty and yyp in f64 on the
    card, handed to K7): every field equals that of a numpy column plane
    (numpy's QR on the host, its arrays copied to the card: the test's
    oracle) at rtol 1e-10, with every sample kept, with a phenotype
    missing for some samples, with the intercept alone (k = 1), and from
    an integer entry field. One `linreg.qr` span records the group's rows
    and columns, and K7's two entry points launch once a call."""
    import hail_tpu_torch as hl
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.ops import _kernels
    from hail_tpu_torch.utils import timer
    from test_torch_slice import build_mt
    names = ('hail_digit_amax', 'hail_digit_planes')
    fields = ('n', 'sum_x', 'y_transpose_x', 'beta', 'standard_error',
              't_stat', 'p_value')
    hl.init(device='cuda', quiet=True)
    try:
        mt = build_mt('hail_tpu_torch', seed=9, n_samples=1003, rows=64,
                      parts=3)
        y = mt.p2 if case == 'missing_pheno' else mt.pheno
        x = mt.X if case == 'int_x' else mt.GT.n_alt_alleles()
        covs = [1.0] if case == 'intercept_only' else [1.0, mt.c0, mt.c1]

        def stats():
            before = [_kernels.launches[n] for n in names]
            timer.clear()
            with timer.recording():
                res = hl.linear_regression_rows(y=y, x=x, covariates=covs)
                out = {f: np.concatenate([
                    np.asarray(b.columns[f].values, np.float64)
                    for b in res._stage.collect_batches()]) for f in fields}
            spans = timer.spans()
            timer.clear()
            return out, spans, [_kernels.launches[n] - b
                                for n, b in zip(names, before)]

        card, spans, launches = stats()

        def host_qr(Cs, Ys, device):
            Q = np.linalg.qr(Cs)[0]
            Qty = Q.T @ Ys
            return Q, Ys, Qty, (Ys * Ys).sum(0) - (Qty * Qty).sum(0)
        monkeypatch.setattr(statgen, '_column_plane_device', host_qr)
        host, _, host_launches = stats()
    finally:
        hl.stop()
    n_kept = 1003 if case != 'missing_pheno' else int(card['n'][0])
    assert case != 'missing_pheno' or n_kept < 1003
    assert [s.attrs for s in spans if s.name == 'linreg.qr'] == [
        {'rows': n_kept, 'cols': len(covs)}]
    assert len([s for s in spans if s.name == 'linreg.consts']) == 1
    assert launches == host_launches == [1, 1]
    for f in fields:
        assert card[f].shape == (192,) and np.isfinite(card[f]).all(), f
        np.testing.assert_allclose(card[f], host[f], rtol=1e-10, err_msg=f)
