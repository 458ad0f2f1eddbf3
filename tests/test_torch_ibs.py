"""The port's IBS counts (hail_tpu_torch/ops/ibs.py) against hail_tpu's, on
the CPU: the reference's Pallas kernel in interpret mode and its int8
`_ibs_dot`. Counts are integers: bit-equal. The sizes cross the Pallas
kernel's 512-variant and 128-sample tile edges and the CUDA kernel's
1,024-variant stage and 64-sample tile edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hail_tpu.ops import ibs as ref
from hail_tpu_torch.ops import ibs as port


def _indicators(m, n, seed, miss_rate=0.1):
    rng = np.random.default_rng(seed)
    nalt = rng.integers(0, 3, (m, n))
    called = rng.random((m, n)) >= miss_rate
    return (called & (nalt == 1), called & (nalt == 0), called & (nalt == 2),
            called)


def _port_plain(het, hom_ref, hom_var, called):
    return [c.numpy() for c in port.ibs_counts(
        *(torch.from_numpy(a) for a in (het, hom_ref, hom_var, called)))]


def test_plain_matches_pallas_interpret():
    het, hom_ref, hom_var, called = _indicators(600, 130, seed=0)
    got = _port_plain(het, hom_ref, hom_var, called)
    want = ref.ibs_counts_pallas(het, hom_ref, hom_var, called)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (130, 130)
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize('m,n', [(600, 130), (1, 1), (129, 65), (257, 200)])
def test_plain_matches_ibs_dot(m, n):
    het, hom_ref, hom_var, called = _indicators(m, n, seed=m + n)
    got = _port_plain(het, hom_ref, hom_var, called)
    want = ref._ibs_dot(*(jnp.asarray(a) for a in (het, hom_ref, hom_var,
                                                     called)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # every called pair falls in exactly one IBS class
    both = called.astype(np.int64).T @ called.astype(np.int64)
    np.testing.assert_array_equal(got[0] + got[1] + got[2], both)


def test_genotype_codes_match_reference_precedence():
    rng = np.random.default_rng(3)
    # overlapping indicators: hom_var wins over het over hom_ref
    het, hom_ref, hom_var = (rng.random((50, 40)) < 0.4 for _ in range(3))
    codes = port.genotype_codes(*(torch.from_numpy(a)
                                  for a in (het, hom_ref, hom_var)))
    want = np.full((50, 40), 3, np.int8)
    want[hom_ref] = 0
    want[het] = 1
    want[hom_var] = 2
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), want)


def test_codes_kernel_needs_cuda():
    codes = torch.full((4, 3), 3, dtype=torch.int8)
    with pytest.raises(ValueError, match='CUDA tensor'):
        port.ibs_counts_codes(codes)


def _expand(lo, hi):
    """csrc/ibs.cu `expand` in numpy: the indicator bits of 32 codes from
    the words of their low and high bit planes."""
    return dict(hr=~(lo | hi), het=lo & ~hi, hv=hi & ~lo, homo=~lo,
                called=~(lo & hi))


@pytest.mark.parametrize('m,n', [(1, 1), (31, 5), (128, 64), (129, 65),
                                 (600, 130), (1025, 3)])
def test_kernel_operand_and_arithmetic(m, n):
    """What surrounds K2's MMAs, on the CPU: the bit planes the wrapper's
    first kernel makes of the codes (`_code_bit_planes` is its plain
    version), the indicator words of a pair of plane words, the five
    AND-popcount products (IBS0 and IBS1 at doubled depth) and the
    upper-tile-plus-mirror rule, against the reference's `_ibs_dot` (and
    the port's plain version)."""
    het, hom_ref, hom_var, called = _indicators(m, n, seed=7 * m + n)
    if n > 2:
        for a in (het, hom_ref, hom_var, called):
            a[:, 1] = False                              # an all-missing sample
    ind = [torch.from_numpy(a) for a in (het, hom_ref, hom_var, called)]
    codes = port.genotype_codes(*ind[:3])
    planes = port._code_bit_planes(codes)
    n_pad, m_pad = -(-n // 64) * 64, -(-m // 1024) * 1024
    assert planes.dtype == torch.uint8 and planes.is_contiguous()
    assert tuple(planes.shape) == (n_pad, 2, m_pad // 8)
    bits = np.unpackbits(planes.numpy(), axis=-1, bitorder='little')
    padded = np.full((n_pad, m_pad), 3, np.uint8)
    padded[:n, :m] = codes.numpy().T
    np.testing.assert_array_equal(bits[:, 0], padded & 1)
    np.testing.assert_array_equal(bits[:, 1], padded >> 1)

    words = np.ascontiguousarray(planes.numpy()).view(np.uint32)
    x = {k: np.unpackbits(np.ascontiguousarray(v).view(np.uint8), axis=-1,
                          bitorder='little').astype(np.int64)
         for k, v in _expand(words[:, 0], words[:, 1]).items()}
    for k, a in (('het', het), ('hr', hom_ref), ('hv', hom_var),
                 ('called', called), ('homo', hom_ref | hom_var)):
        np.testing.assert_array_equal(x[k][:n, :m], a.T.astype(np.int64))
        assert not x[k][n:].any() and not x[k][:, m:].any()
    # popcount(a & b) over the depth is the product of the 0/1 rows
    ibs0 = x['hr'] @ x['hv'].T + x['hv'] @ x['hr'].T
    ibs1 = x['het'] @ x['homo'].T + x['homo'] @ x['het'].T
    ibs2 = x['called'] @ x['called'].T - ibs0 - ibs1
    want = ref._ibs_dot(*(jnp.asarray(a) for a in (het, hom_ref, hom_var,
                                                     called)))
    plain = port._ibs_plain(*ind)
    for got, w, pl in zip((ibs0, ibs1, ibs2), want, plain):
        upper = np.triu(got[:n, :n])                     # elements j >= i
        full = upper + np.triu(got[:n, :n], 1).T         # mirrored where j > i
        np.testing.assert_array_equal(full, np.asarray(w))
        np.testing.assert_array_equal(full, pl.numpy())
