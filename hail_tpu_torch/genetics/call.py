"""Genotype calls, packed into int32 for vectorized columns.

Capability parity with reference `is/hail/variant/Call.scala:14-77` and
`hail/python/hail/genetics/call.py`, with our own packing scheme designed
for numpy/jax bit ops:

    bits [0:2)  ploidy (0, 1, or 2; 3 = escaped wide diploid call)
    bit  [2]    phased
    bits [3:17) allele index j (first allele), 14 bits
    bits [17:32) allele index k (second allele), 15 bits

Diploid calls whose allele indices exceed the fast fields use an escape
(ploidy field == 3) holding the reference's 29-bit gt-index representation
(`is/hail/variant/Call.scala:27-46`): unphased t = hi*(hi+1)/2 + lo, phased
t = (j+k)*(j+k+1)/2 + j, stored in bits [3:32). Escaped calls never arise
from real importers (VCF/BGEN allele counts are small); hot kernels may
assume the fast layout.

Missing calls are represented by the column's missing mask, not a sentinel.
All `calls_*` functions are vectorized over packed int32 arrays and work on
both numpy and jax.numpy arrays.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

PLOIDY_MASK = 0x3
PHASED_BIT = 0x4
J_SHIFT = 3
J_MASK = (1 << 14) - 1
K_SHIFT = 17
K_MASK = (1 << 15) - 1
MAX_ALLELE = (1 << 14) - 1
ESCAPE_PLOIDY = 3          # wide diploid call: bits [3:32) = 29-bit gt-index
ESCAPE_REPR_MAX = (1 << 29) - 1


def pack_call(alleles: Sequence[int], phased: bool = False) -> int:
    ploidy = len(alleles)
    if ploidy > 2:
        raise ValueError(f'ploidy > 2 not supported: {alleles}')
    j = alleles[0] if ploidy >= 1 else 0
    k = alleles[1] if ploidy == 2 else 0
    if j < 0 or k < 0:
        raise ValueError(f'allele index out of range: {alleles}')
    if j > MAX_ALLELE or k > K_MASK:
        # escape: the reference's 29-bit gt-index repr (Call.scala:27-46)
        if ploidy != 2:
            # escape is diploid-only; haploid indices fit 14 bits in practice
            raise ValueError(f'allele index out of range: {alleles}')
        if phased:
            t = (j + k) * (j + k + 1) // 2 + j
        else:
            lo, hi = (j, k) if j <= k else (k, j)
            t = hi * (hi + 1) // 2 + lo
        if t > ESCAPE_REPR_MAX:
            raise ValueError(
                f'invalid allele representation: {t}. Max value is 2^29 - 1')
        return ESCAPE_PLOIDY | (PHASED_BIT if phased else 0) | (t << J_SHIFT)
    return ploidy | (PHASED_BIT if phased else 0) | (j << J_SHIFT) | (k << K_SHIFT)


def _unpack_escaped(packed: int):
    """Decode one escaped wide diploid call → (j, k)."""
    t = (packed >> J_SHIFT) & ((1 << 29) - 1)
    import math
    s = (math.isqrt(8 * t + 1) - 1) // 2
    rem = t - s * (s + 1) // 2
    if packed & PHASED_BIT:
        j = rem
        k = s - j
        return j, k
    return rem, s


class Call:
    """An immutable genotype call: an ordered list of allele indices + phasing."""

    __slots__ = ('_alleles', '_phased')

    def __init__(self, alleles: Sequence[int], phased: bool = False):
        if len(alleles) > 2:
            raise NotImplementedError(
                'Calls with greater than 2 alleles are not supported.')
        alleles = list(alleles)
        if not phased and len(alleles) == 2 and alleles[1] < alleles[0]:
            # unphased diploid calls are normalized j <= k (reference
            # python Call.__init__ / Scala Genotype.diploidGtIndexWithSwap)
            alleles = [alleles[1], alleles[0]]
        self._alleles: List[int] = alleles
        self._phased = phased

    @classmethod
    def from_packed(cls, packed: int) -> 'Call':
        ploidy = packed & PLOIDY_MASK
        phased = bool(packed & PHASED_BIT)
        if ploidy == ESCAPE_PLOIDY:
            j, k = _unpack_escaped(packed)
            return cls([j, k], phased)
        alleles = []
        if ploidy >= 1:
            alleles.append((packed >> J_SHIFT) & J_MASK)
        if ploidy == 2:
            alleles.append((packed >> K_SHIFT) & K_MASK)
        return cls(alleles, phased)

    @property
    def packed(self) -> int:
        return pack_call(self._alleles, self._phased)

    @property
    def alleles(self) -> List[int]:
        return list(self._alleles)

    @property
    def ploidy(self) -> int:
        return len(self._alleles)

    @property
    def phased(self) -> bool:
        return self._phased

    def __getitem__(self, i: int) -> int:
        return self._alleles[i]

    def is_haploid(self) -> bool:
        return self.ploidy == 1

    def is_diploid(self) -> bool:
        return self.ploidy == 2

    def is_hom_ref(self) -> bool:
        return len(self._alleles) > 0 and all(a == 0 for a in self._alleles)

    def is_hom_var(self) -> bool:
        return len(self._alleles) > 0 and all(a == self._alleles[0] and a > 0 for a in self._alleles)

    def is_het(self) -> bool:
        return self.ploidy == 2 and self._alleles[0] != self._alleles[1]

    def is_het_ref(self) -> bool:
        return self.is_het() and 0 in self._alleles

    def is_het_non_ref(self) -> bool:
        return self.is_het() and 0 not in self._alleles

    def is_non_ref(self) -> bool:
        return any(a != 0 for a in self._alleles)

    def n_alt_alleles(self) -> int:
        return sum(1 for a in self._alleles if a != 0)

    def unphased_diploid_gt_index(self) -> int:
        if self.ploidy != 2:
            raise ValueError('unphased_diploid_gt_index requires diploid call')
        j, k = sorted(self._alleles)
        return k * (k + 1) // 2 + j

    def one_hot_alleles(self, n_alleles: int) -> List[int]:
        out = [0] * n_alleles
        for a in self._alleles:
            out[a] += 1
        return out

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Call):
            return NotImplemented
        return self._alleles == other._alleles and self._phased == other._phased

    def __hash__(self) -> int:
        return hash((tuple(self._alleles), self._phased))

    def __str__(self) -> str:
        sep = '|' if self._phased else '/'
        return sep.join(str(a) for a in self._alleles)

    def __repr__(self) -> str:
        return f'Call(alleles={self._alleles}, phased={self._phased})'


# ---------------------------------------------------------------------------
# Vectorized operations over packed-call arrays (numpy or jax.numpy).
# `missing` masks are handled by the caller (expression evaluator).
# ---------------------------------------------------------------------------

def _has_escapes(packed) -> bool:
    """True when a NUMPY packed array contains escaped wide calls. jax arrays
    (device tensors from importers) never carry escapes — return False without
    a device sync so traced kernels keep the fast layout."""
    if isinstance(packed, np.ndarray):
        return bool(((packed & PLOIDY_MASK) == ESCAPE_PLOIDY).any())
    if isinstance(packed, (int, np.integer)):
        return (packed & PLOIDY_MASK) == ESCAPE_PLOIDY
    return False


def _escaped_jk(packed):
    """Vectorized decode of escaped calls (numpy only) → (j, k) arrays."""
    t = (np.asarray(packed, dtype=np.int64) >> J_SHIFT) & ((1 << 29) - 1)
    st = np.floor((np.sqrt(8.0 * t.astype(np.float64) + 1.0) - 1.0) / 2.0).astype(np.int64)
    # float-precision correction
    st = np.where((st + 1) * (st + 2) // 2 <= t, st + 1, st)
    st = np.where(st * (st + 1) // 2 > t, st - 1, st)
    rem = t - st * (st + 1) // 2
    phased = (np.asarray(packed) & PHASED_BIT) != 0
    j = rem
    k = np.where(phased, st - rem, st)
    return j, k


def calls_ploidy(packed):
    raw = packed & PLOIDY_MASK
    if _has_escapes(packed):
        raw = np.where(raw == ESCAPE_PLOIDY, 2, raw)
    return raw.astype(np.int32) if hasattr(raw, 'astype') else raw


def calls_is_phased(packed):
    return (packed & PHASED_BIT) != 0


def calls_allele_j(packed):
    fast = (packed >> J_SHIFT) & J_MASK
    if _has_escapes(packed):
        ej, _ = _escaped_jk(packed)
        return np.where((packed & PLOIDY_MASK) == ESCAPE_PLOIDY, ej, fast)
    return fast


def calls_allele_k(packed):
    fast = (packed >> K_SHIFT) & K_MASK
    if _has_escapes(packed):
        _, ek = _escaped_jk(packed)
        return np.where((packed & PLOIDY_MASK) == ESCAPE_PLOIDY, ek, fast)
    return fast


def calls_n_alt_alleles(packed):
    """Number of non-reference alleles; 0 for ploidy-0 calls."""
    ploidy = calls_ploidy(packed)
    j = calls_allele_j(packed)
    k = calls_allele_k(packed)
    nj = ((j != 0) & (ploidy >= 1)).astype(np.int32)
    nk = ((k != 0) & (ploidy == 2)).astype(np.int32)
    return nj + nk


def calls_is_het(packed):
    return (calls_ploidy(packed) == 2) & (calls_allele_j(packed) != calls_allele_k(packed))


def calls_is_hom_ref(packed):
    ploidy = calls_ploidy(packed)
    return (ploidy > 0) & (calls_allele_j(packed) == 0) & ((ploidy < 2) | (calls_allele_k(packed) == 0))


def calls_is_hom_var(packed):
    ploidy = calls_ploidy(packed)
    j = calls_allele_j(packed)
    k = calls_allele_k(packed)
    return (ploidy > 0) & (j > 0) & ((ploidy < 2) | (j == k))


def calls_is_het_ref(packed):
    j = calls_allele_j(packed)
    k = calls_allele_k(packed)
    return calls_is_het(packed) & ((j == 0) | (k == 0))


def calls_is_het_non_ref(packed):
    j = calls_allele_j(packed)
    k = calls_allele_k(packed)
    return calls_is_het(packed) & (j != 0) & (k != 0)


def calls_is_non_ref(packed):
    return calls_n_alt_alleles(packed) > 0


def calls_unphased_diploid_gt_index(packed):
    j = calls_allele_j(packed)
    k = calls_allele_k(packed)
    lo = np.minimum(j, k)
    hi = np.maximum(j, k)
    return hi * (hi + 1) // 2 + lo


def pack_diploid(j, k, phased=False):
    """Vectorized packing of diploid calls from allele-index arrays; numpy
    inputs with out-of-range indices take the 29-bit gt-index escape."""
    base = 2 | (PHASED_BIT if phased else 0)
    fast = (base | (j.astype(np.int32) << J_SHIFT) | (k.astype(np.int32) << K_SHIFT)).astype(np.int32)
    if isinstance(j, np.ndarray) or isinstance(k, np.ndarray):
        j64 = np.asarray(j, dtype=np.int64)
        k64 = np.asarray(k, dtype=np.int64)
        wide = (j64 > MAX_ALLELE) | (k64 > K_MASK)
        if wide.any():
            if phased:
                t = (j64 + k64) * (j64 + k64 + 1) // 2 + j64
            else:
                lo = np.minimum(j64, k64)
                hi = np.maximum(j64, k64)
                t = hi * (hi + 1) // 2 + lo
            if (t[wide] > ESCAPE_REPR_MAX).any():
                bad = np.argwhere(wide & (t > ESCAPE_REPR_MAX))[0]
                raise ValueError(f'allele index out of range at {tuple(bad)}')
            esc_base = ESCAPE_PLOIDY | (PHASED_BIT if phased else 0)
            esc = (esc_base | (t << J_SHIFT)).astype(np.int32)
            return np.where(wide, esc, fast).astype(np.int32)
    return fast
