"""The port's IBS counts (hail_tpu_torch/ops/ibs.py) against hail_tpu's, on
the CPU: the reference's Pallas kernel in interpret mode and its int8
`_ibs_dot`. Counts are integers: bit-equal. The sizes cross the Pallas
kernel's 512-variant and 128-sample tile edges and the CUDA kernel's
128-variant stage and 64-sample tile edges.
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
