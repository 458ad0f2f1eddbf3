"""Pairwise IBS (identity-by-state) counts (port of hail_tpu/ops/ibs.py).

From (m variants, n samples) indicator matrices het / hom_ref / hom_var /
called, the (n, n) counts
    IBS0 = hom_refᵀ·hom_var + hom_varᵀ·hom_ref
    IBS1 = hetᵀ·(hom_ref|hom_var) + (hom_ref|hom_var)ᵀ·het
    IBS2 = calledᵀ·called − IBS0 − IBS1
On CUDA the hand-written kernel K2 (csrc/ibs.cu) takes the products on the
tensor cores, as 1-bit AND-popcount MMAs over bit planes of class codes
built on the device; `_ibs_plain` is its plain torch version, which the
wrapper runs only for CPU tensors.
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


_TILE = 64        # samples per tile edge of K2
_STAGE = 1024     # variants per stage of K2


def _padded(m: int, n: int):
    """(n_pad, m_pad): whole 64-sample tiles and 1,024-variant stages."""
    return -(-n // _TILE) * _TILE, -(-m // _STAGE) * _STAGE


def _code_bit_planes(codes: torch.Tensor) -> torch.Tensor:
    """Plain version of K2's first step, its operand: uint8 (n_pad, 2,
    m_pad / 8), per sample the low bits of its codes and then the high
    bits, variant v in bit v % 8 of byte v / 8 (the variants contiguous per
    sample, which is what both operands of the 1-bit MMA want). Padding
    samples and variants hold code 3 (missing, sets no indicator), up to
    whole 64-sample tiles and 1,024-variant stages, so that every 16-byte
    copy of the main kernel is aligned and in bounds."""
    m, n = codes.shape
    n_pad, m_pad = _padded(m, n)
    full = torch.full((n_pad, m_pad), 3, dtype=torch.uint8,
                      device=codes.device)
    full[:n, :m] = codes.t().to(torch.uint8)
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=codes.device)
    bits = torch.stack([full & 1, (full >> 1) & 1], dim=1)   # (n_pad, 2, m_pad)
    return (bits.reshape(n_pad, 2, m_pad // 8, 8).to(torch.int32)
            * weights).sum(dim=-1).to(torch.uint8)


def ibs_counts_codes(codes: torch.Tensor):
    """K2: (ibs0, ibs1, ibs2) int32 (n, n) from CUDA int8 codes (m, n) in
    {0, 1, 2, 3}. One launch runs two kernels: the codes' bit planes into
    `planes` (scratch; `_code_bit_planes` is its plain version) and the
    counts as 1-bit tensor-core products."""
    _kernels.check(codes, 'ibs_counts/codes', torch.int8)
    m, n = codes.shape
    n_pad, m_pad = _padded(m, n)
    # scratch on the current stream, which is also the launch's: torch hands
    # the block to a later allocation only in stream order, after the kernels
    planes = torch.empty((n_pad, 2, m_pad // 8), dtype=torch.uint8,
                         device=codes.device)
    # zeroed: the kernel's blocks add their variant slices into them
    ibs0, ibs1, ibs2 = torch.zeros((3, n, n), dtype=torch.int32,
                                   device=codes.device).unbind(0)
    _kernels.launch('hail_ibs_counts', codes.data_ptr(), m, n,
                    planes.data_ptr(), m_pad, n_pad, ibs0.data_ptr(),
                    ibs1.data_ptr(), ibs2.data_ptr())
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
