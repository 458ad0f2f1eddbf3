"""Pairwise IBS (identity-by-state) counts (port of hail_tpu/ops/ibs.py).

From (m variants, n samples) indicator matrices het / hom_ref / hom_var /
called, the (n, n) counts
    IBS0 = hom_refᵀ·hom_var + hom_varᵀ·hom_ref
    IBS1 = hetᵀ·(hom_ref|hom_var) + (hom_ref|hom_var)ᵀ·het
    IBS2 = calledᵀ·called − IBS0 − IBS1
On CUDA the hand-written kernel K2 (csrc/ibs.cu) counts them from int8
class codes built on the device; `_ibs_plain` is its plain torch version,
which the wrapper runs only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _kernels


def _ibs_plain(het: torch.Tensor, hom_ref: torch.Tensor,
               hom_var: torch.Tensor, called: torch.Tensor):
    """The counts as indicator products (reference `_ibs_dot`). In f64, not
    int8 (torch.mm on int8 wraps around, CUDA has no integer matmul): the
    counts are integers ≤ m < 2⁵³, so the products and the cast are exact."""
    def dot(a, b):
        return (a.to(torch.float64).T @ b.to(torch.float64)).to(torch.int32)
    ibs0 = dot(hom_ref, hom_var)
    ibs0 = ibs0 + ibs0.T
    ibs1_half = dot(het, hom_ref | hom_var)
    ibs1 = ibs1_half + ibs1_half.T
    ibs2 = dot(called, called) - ibs0 - ibs1
    return ibs0, ibs1, ibs2


def genotype_codes(het: torch.Tensor, hom_ref: torch.Tensor,
                   hom_var: torch.Tensor) -> torch.Tensor:
    """int8 class codes (0 hom-ref, 1 het, 2 hom-var, 3 missing) with the
    reference's precedence: hom_ref, then het, then hom_var."""
    codes = torch.full(het.shape, 3, dtype=torch.int8, device=het.device)
    codes.masked_fill_(hom_ref, 0)
    codes.masked_fill_(het, 1)
    codes.masked_fill_(hom_var, 2)
    return codes


def ibs_counts_codes(codes: torch.Tensor):
    """K2: (ibs0, ibs1, ibs2) int32 (n, n) from CUDA int8 codes (m, n)."""
    _kernels.check(codes, 'ibs_counts/codes', torch.int8)
    m, n = codes.shape
    # zeroed: the kernel's blocks add their variant slices into them
    ibs0, ibs1, ibs2 = (torch.zeros((n, n), dtype=torch.int32,
                                    device=codes.device) for _ in range(3))
    _kernels.launch('hail_ibs_counts', codes.data_ptr(), m, n,
                    ibs0.data_ptr(), ibs1.data_ptr(), ibs2.data_ptr())
    return ibs0, ibs1, ibs2


def ibs_counts(het: torch.Tensor, hom_ref: torch.Tensor,
               hom_var: torch.Tensor, called: torch.Tensor):
    """Pairwise (n, n) int32 IBS0/1/2 counts from (m, n) bool indicator
    tensors. CPU tensors take the plain version; CUDA tensors launch K2,
    which reads the class codes (the indicators must be exclusive, and
    `called` their union, as they are for calls)."""
    if het.device.type == 'cpu':
        return _ibs_plain(het, hom_ref, hom_var, called)
    return ibs_counts_codes(genotype_codes(het, hom_ref, hom_var))
