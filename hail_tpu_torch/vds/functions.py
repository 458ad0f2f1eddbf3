"""Local-allele expression functions (reference hail/vds/functions.py):
lgt_to_gt and local_to_global reindex gVCF-style locally-indexed fields to
global allele indices.
"""

from __future__ import annotations

import numpy as np

from .. import types as ht
from ..expr import functions as F
from ..expr.expression import to_expr
from ..genetics.call import Call


def lgt_to_gt(lgt, la):
    """Transform a local-alleles call LGT into a global GT via the LA array
    (reference vds/functions.py:8)."""
    t = ht.tcall

    def impl(c, local):
        if c is None:
            return None
        if local is None:
            return c
        als = [local[a] if a < len(local) else a for a in c.alleles]
        return Call(als, phased=c.phased)
    return F._apply('lgt_to_gt', t, F._obj_impl_lenient(t, impl),
                    to_expr(lgt), to_expr(la))


def local_to_global(array, local_alleles, n_alleles, fill_value, number: str):
    """Reindex a locally-indexed array to global allele indexing (reference
    vds/functions.py:32). `number` follows VCF semantics: 'A' one value per
    alt, 'R' one per allele incl. ref, 'G' one per diploid genotype.

    >>> hl.eval(local_to_global(hl.literal([9, 10]), hl.literal([0, 2]), 3, 0, 'R'))
    [9, 0, 10]
    """
    if number not in ('A', 'R', 'G'):
        raise ValueError(f"number must be one of 'A', 'R', 'G', found {number!r}")
    ae = to_expr(array)
    t = ae.dtype

    def impl(arr, la, n, fill):
        if arr is None:
            return None
        n = int(n)
        if la is not None:
            for ga in la:
                if ga is not None and ga >= n:
                    from ..utils.java import HailUserError
                    raise HailUserError(
                        f'local_to_global: local allele of {ga} out of bounds '
                        f'given n_total_alleles of {n}')
        if number == 'G':
            out = [fill] * (n * (n + 1) // 2)
            k = len(la)
            for j in range(k):
                for i in range(j + 1):
                    gi_local = j * (j + 1) // 2 + i
                    if gi_local >= len(arr):
                        continue
                    gi_, gj_ = la[i], la[j]
                    lo, hi = min(gi_, gj_), max(gi_, gj_)
                    out[hi * (hi + 1) // 2 + lo] = arr[gi_local]
            return out
        if number == 'R':
            out = [fill] * n
            for i, ga in enumerate(la):
                if i < len(arr):
                    out[ga] = arr[i]
            return out
        # 'A': per-alt; local index i corresponds to local allele i+1
        out = [fill] * (n - 1)
        for i, ga in enumerate(la):
            if i == 0:
                continue
            if i - 1 < len(arr) and ga >= 1:
                out[ga - 1] = arr[i - 1]
        return out
    return F._apply('local_to_global', t, F._obj_impl_lenient(t, impl),
                    ae, to_expr(local_alleles), to_expr(n_alleles),
                    to_expr(fill_value))
