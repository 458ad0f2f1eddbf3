"""The port's exact linreg ops (hail_tpu_torch/ops/linreg_i8.py) against
hail_tpu's on the same numpy inputs, on the CPU, where the port's wrappers
run their kernels' plain torch versions.

Tolerances: integer results (2-bit codes, unpacked pairs, digit planes,
int32 partials) are bit-equal; f64 outputs agree at rtol 1e-10 (the same
sums, recombined in another order), with NaN at the same positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hail_tpu.genetics.call import pack_diploid
from hail_tpu.ops import linreg_i8 as ref
from hail_tpu_torch import interop
from hail_tpu_torch.ops import linreg_i8 as port

RTOL = 1e-10


def _calls(R, N, miss_rate, seed):
    rng = np.random.default_rng(seed)
    nalt = rng.integers(0, 3, (R, N)).astype(np.int32)
    miss = rng.random((R, N)) < miss_rate
    gt = pack_diploid((nalt == 2).astype(np.int32), (nalt >= 1).astype(np.int32))
    return nalt, miss, gt


def _ols_setup(N, k, P, seed):
    rng = np.random.default_rng(seed)
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, k - 1))], axis=1)
    Q, _ = np.linalg.qr(cov)
    Ys = rng.normal(size=(N, P))
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(axis=0) - (Qty * Qty).sum(axis=0)
    return Q, Ys, Qty, yyp, N - k - 1


@pytest.mark.parametrize('N', [16, 1003, 4, 7])
@pytest.mark.parametrize('with_missing', [True, False])
def test_pack_unpack_bit_equal(N, with_missing):
    nalt, miss, gt = _calls(33, N, 0.07, seed=N)
    m = miss if with_missing else None
    u8 = port.pack_gt_2bit(gt, m)
    np.testing.assert_array_equal(u8, ref.pack_gt_2bit(gt, m))
    gz8, m8 = port.unpack_gt_2bit(torch.from_numpy(u8), N)
    gz8_r, m8_r = ref.unpack_gt_2bit(jnp.asarray(u8), N)
    assert gz8.dtype == m8.dtype == torch.int8
    np.testing.assert_array_equal(gz8.numpy(), np.asarray(gz8_r))
    np.testing.assert_array_equal(m8.numpy(), np.asarray(m8_r))
    want_m = miss if with_missing else np.zeros_like(miss)
    np.testing.assert_array_equal(m8.numpy(), want_m.astype(np.int8))
    np.testing.assert_array_equal(gz8.numpy(), np.where(want_m, 0, nalt))


@pytest.mark.parametrize('k,P', [(1, 1), (4, 1), (3, 2), (5, 4)])
def test_digit_planes_bit_equal(k, P):
    Q, Ys, _, _, _ = _ols_setup(301, k, P, seed=k * 10 + P)
    W = np.concatenate([Q, Ys], axis=1)
    W[:, 0] *= 1e-3                               # columns of other scales
    Wd, sc = port._digit_planes(W)
    Wd_r, sc_r = ref._digit_planes(W)
    assert Wd.dtype == np.int8 and Wd.shape == (301, 7 * (k + P))
    np.testing.assert_array_equal(Wd, Wd_r)
    np.testing.assert_array_equal(sc, sc_r)


@pytest.mark.parametrize('case', ['random', 'zero_column', 'pow2_max',
                                  'pow2_ulp', 'tiny_huge', 'ties', 'wide'])
def test_digit_planes_plain_bit_equal(case):
    """K7's plain version (`_digit_planes_plain`, the route of CPU tensors)
    against the port's and the reference's `_digit_planes`, digits and
    scales bit for bit, and CPU `exact_consts` against `exact_operand` of
    the host's planes, on the cases of test_torch_kernels_cuda.py."""
    from test_torch_kernels_cuda import digit_plane_case
    Q, Ys = digit_plane_case(case)
    N, KP = Q.shape[0], Q.shape[1] + Ys.shape[1]
    W = np.concatenate([Q, Ys], axis=1)
    Wd, sc = port._digit_planes(W)
    Wd_r, sc_r = ref._digit_planes(W)
    np.testing.assert_array_equal(Wd, Wd_r)
    np.testing.assert_array_equal(sc, sc_r)
    Wd_t, sc_t = port._digit_planes_plain(torch.from_numpy(Q),
                                          torch.from_numpy(Ys))
    assert Wd_t.dtype == torch.int8 and tuple(Wd_t.shape) == (N, 7 * KP)
    np.testing.assert_array_equal(Wd_t.numpy(), Wd)
    assert sc_t.dtype == np.float64
    np.testing.assert_array_equal(sc_t, sc)
    W_op, sc_d = port.exact_consts(Q, Ys, np.zeros((Q.shape[1], Ys.shape[1])),
                                   np.ones(Ys.shape[1]), N - KP, 'cpu')[:2]
    want = port.exact_operand(torch.from_numpy(Wd))
    assert isinstance(W_op, port.ExactOperand)
    assert torch.equal(W_op.Wdig, want.Wdig) and torch.equal(W_op.WT, want.WT)
    np.testing.assert_array_equal(sc_d.numpy(), sc)


def _reference_pair_and_consts(R, N, k, P, seed, all_missing_row=None):
    nalt, miss, gt = _calls(R, N, 0.1, seed)
    if all_missing_row is not None:
        miss[all_missing_row] = True
    gz8_r, m8_r = ref.unpack_gt_2bit(jnp.asarray(ref.pack_gt_2bit(gt, miss)), N)
    Q, Ys, Qty, yyp, dof = _ols_setup(N, k, P, seed + 1)
    Wd, sc = ref._digit_planes(np.concatenate([Q, Ys], axis=1))
    return (gz8_r, m8_r), (Wd, sc, Qty, yyp, dof)


@pytest.mark.parametrize('R,N,k,P', [(40, 257, 3, 2), (64, 300, 4, 1),
                                     (17, 1000, 2, 6)])
def test_exact_core_matches_reference(R, N, k, P):
    (gz8_r, m8_r), (Wd, sc, Qty, yyp, dof) = _reference_pair_and_consts(
        R, N, k, P, seed=R, all_missing_row=3)
    want = np.asarray(ref.linreg_block_gz_exact_packed(
        gz8_r, m8_r, jnp.asarray(Wd), jnp.asarray(sc), jnp.asarray(Qty),
        jnp.asarray(yyp), jnp.asarray(float(dof)), k))
    gz8, m8 = interop.entry_pair_from_reference(np.asarray(gz8_r),
                                                np.asarray(m8_r), 'cpu')
    consts = interop.consts_from_reference(Wd, sc, Qty, yyp, dof, 'cpu')
    # the int32 partials against an int64 numpy oracle
    GWd, MWd, nmiss, s, ss = port.exact_pass(gz8, m8, consts[0])
    g64, m64, w64 = (np.asarray(a, np.int64) for a in (gz8_r, m8_r, Wd))
    np.testing.assert_array_equal(GWd.numpy(), g64 @ w64)
    np.testing.assert_array_equal(MWd.numpy(), m64 @ w64)
    np.testing.assert_array_equal(nmiss.numpy(), m64.sum(1))
    np.testing.assert_array_equal(s.numpy(), g64.sum(1))
    np.testing.assert_array_equal(ss.numpy(), (g64 * g64).sum(1))
    assert GWd.dtype == torch.int32
    got = port.linreg_block_gz_exact_packed(gz8, m8, *consts, k).numpy()
    assert got.shape == want.shape == (R, 1 + 4 * P)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3, 1 + P:]).all() and np.isfinite(got[:3]).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)


def test_block_i8_exact_packed_matches_reference():
    rng = np.random.default_rng(5)
    R, N, k, P = 30, 222, 3, 1
    G8 = rng.integers(0, 5, (R, N)).astype(np.int8)   # integer x beyond GT
    G8[rng.random((R, N)) < 0.1] = -1
    Q, Ys, Qty, yyp, dof = _ols_setup(N, k, P, seed=6)
    Wd, sc = ref._digit_planes(np.concatenate([Q, Ys], axis=1))
    want = np.asarray(ref._linreg_block_i8_exact_packed(
        jnp.asarray(G8), jnp.asarray(Wd), jnp.asarray(sc), jnp.asarray(Qty),
        jnp.asarray(yyp), jnp.asarray(float(dof)), k))
    consts = interop.consts_from_reference(Wd, sc, Qty, yyp, dof, 'cpu')
    got = port._linreg_block_i8_exact_packed(torch.from_numpy(G8), *consts,
                                             k).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_linreg_stats_i8_exact_matches_f64_formula():
    """Mirrors tests/test_linreg_i8.py::test_exact_i8_kernel_matches_f64_path
    with the port: the exact int8 path reproduces the f64 formula."""
    import hail_tpu_torch as hl
    from hail_tpu_torch.ops.regression import linreg_stats
    rng = np.random.default_rng(7)
    R, N, k, P = 40, 257, 3, 2
    G8 = rng.integers(0, 3, (R, N)).astype(np.int8)
    G8[rng.random((R, N)) < 0.15] = -1
    G8[5] = -1                                   # all-missing row -> NaN
    Q, Y, Qty, yyp, d = _ols_setup(N, k, P, seed=8)
    hl.init(device='cpu', quiet=True)
    try:
        want = linreg_stats(np.where(G8 < 0, 0, G8).astype(np.float64),
                            G8 < 0, None, Q, Y, Qty, yyp, d)
    finally:
        hl.stop()
    got = port.linreg_stats_i8_exact(torch.from_numpy(G8), Q, Y, Qty, yyp, d)
    for f in ('sum_x', 'y_transpose_x', 'beta', 'standard_error', 't_stat',
              'p_value'):
        a, b = want[f], got[f]
        assert np.array_equal(np.isnan(a), np.isnan(b)), f
        ok = np.isfinite(a)
        np.testing.assert_allclose(b[ok], a[ok], rtol=RTOL, err_msg=f)


def test_finish_stats_packed_matches_reference():
    rng = np.random.default_rng(9)
    arr = rng.normal(size=(12, 1 + 4 * 3))
    a = port._finish_stats_packed(torch.from_numpy(arr), 3, 50)
    b = ref._finish_stats_packed(arr, 3, 50)
    for f in b:
        np.testing.assert_array_equal(a[f], b[f])


def test_exact_pass_rejects_too_many_samples():
    # N above the int32 accumulator bound; R = 0 rows allocate nothing
    gz8 = torch.empty((0, port._MAX_EXACT_N + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match='int32 accumulator'):
        Wd = torch.empty((port._MAX_EXACT_N + 1, 7), dtype=torch.int8)
        port.exact_pass(gz8, gz8, port.ExactOperand(Wd, Wd))


@pytest.mark.parametrize('R,N,k,P', [(9, 31, 1, 0), (40, 257, 3, 2),
                                     (33, 1003, 4, 1), (17, 64, 3, 5)])
def test_kernel_layout_products_equal_the_reference_partials(R, N, k, P):
    """K3's arithmetic on the CPU: int products of (gz8, m8) with the
    kernel's operand `exact_operand(Wdig).WT` (Wdig transposed, a row of ones,
    zero padding) are the reference's int32 partials in columns < C and
    its row sums Σgz8, Σm8 in column C; Σgz8² is the product of gz8 with
    itself. Bit-equal."""
    (gz8_r, m8_r), (Wd, sc, Qty, yyp, dof) = _reference_pair_and_consts(
        R, N, k, max(P, 1), seed=R + N)
    Wd = Wd[:, :7 * (k + P)] if P == 0 else Wd       # C = 7, 35, 35, 56
    gz, m = np.asarray(gz8_r).astype(np.int64), np.asarray(m8_r).astype(np.int64)
    C = Wd.shape[1]
    WT = port.exact_operand(
        torch.from_numpy(np.ascontiguousarray(Wd))).WT.numpy()
    ldw = WT.shape[1]
    pad = np.zeros((R, ldw - N), np.int64)           # the zero-filled tail
    g_ext = np.concatenate([gz, pad], axis=1) @ WT.astype(np.int64).T
    m_ext = np.concatenate([m, pad], axis=1) @ WT.astype(np.int64).T
    want = port._exact_pass_plain(torch.from_numpy(np.array(gz8_r)),
                                  torch.from_numpy(np.array(m8_r)),
                                  torch.from_numpy(np.ascontiguousarray(Wd)))
    GWd, MWd, nmiss, s, ss = (a.numpy() for a in want)
    np.testing.assert_array_equal(g_ext[:, :C], GWd)
    np.testing.assert_array_equal(m_ext[:, :C], MWd)
    np.testing.assert_array_equal(g_ext[:, C], s)
    np.testing.assert_array_equal(m_ext[:, C], nmiss)
    assert not g_ext[:, C + 1:].any() and not m_ext[:, C + 1:].any()
    np.testing.assert_array_equal((gz * gz).sum(axis=1), ss)
    # and they are the reference's: its two dot_generals and row sums
    Wj = jnp.asarray(Wd)
    np.testing.assert_array_equal(
        GWd, np.asarray(jnp.dot(gz8_r.astype(jnp.int32), Wj.astype(jnp.int32))))
    np.testing.assert_array_equal(
        s, np.asarray(gz8_r.astype(jnp.int32).sum(axis=1)))
