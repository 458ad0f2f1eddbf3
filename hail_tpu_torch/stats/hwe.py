"""Hardy-Weinberg equilibrium exact test (Levene-Haldane distribution).

Reference: `is/hail/stats/LeveneHaldane.scala` — fresh implementation of the
exact test (Wigginton/Cutler/Abecasis recurrence) returning
(het_freq_hwe, p_value) with Hail's definitions: het_freq_hwe is the
expected heterozygote frequency E[nAB]/n under the Levene-Haldane
distribution; p_value is the two-sided exact mid-p? No — Hail uses
P(X = nAB)/2 + P(more extreme) ... Hail's definition (LeveneHaldane.exactMidP):
p = min(1, sum_{P(x) <= P(obs)} P(x)), the standard exact test.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=65536)
def _lh_distribution(n: int, nA: int) -> Tuple[np.ndarray, np.ndarray]:
    """Levene-Haldane pmf over het counts for n diploid genotypes and nA copies
    of the rarer allele. Returns (het_counts, pmf)."""
    if n == 0 or nA == 0:
        return np.asarray([0]), np.asarray([1.0])
    # het counts share parity with nA; max possible is min(nA, 2n - nA)
    parity = nA % 2
    max_het = min(nA, 2 * n - nA)
    hets = np.arange(parity, max_het + 1, 2)
    # unnormalized recurrence (Wigginton et al. 2005):
    # P(nAB-2) / P(nAB) = nAB*(nAB-1) / (4*nAA_next*nBB_next) form; build in
    # log space from the mode outward for stability.
    probs = np.zeros(len(hets), dtype=np.float64)
    # start at the largest het count and recurse downward:
    # P(h-2)/P(h) = h*(h-1) / (4*(nAA(h)+1)*(nBB(h)+1))
    # where nAA(h) = (nA - h)/2, nBB(h) = n - h - nAA(h)
    logp = np.zeros(len(hets), dtype=np.float64)
    for i in range(len(hets) - 2, -1, -1):
        h = int(hets[i + 1])
        nAA = (nA - h) // 2
        nBB = n - h - nAA
        ratio = (h * (h - 1)) / (4.0 * (nAA + 1) * (nBB + 1))
        logp[i] = logp[i + 1] + np.log(ratio)
    m = np.max(logp)
    probs = np.exp(logp - m)
    probs /= probs.sum()
    return hets, probs


def hwe_test(n_hom_ref: int, n_het: int, n_hom_var: int,
             one_sided: bool = False) -> Tuple[float, float]:
    """(het_freq_hwe, p_value) with the reference's exact semantics
    (is/hail/stats/package.scala:114 `hardyWeinbergTest`):

    - het_freq_hwe = E[nAB]/n with the Levene-Haldane closed-form mean
      nA*nB/(2n-1) — NaN when n == 0 (mean is -0.0/0).
    - one_sided: rightMidP(nAB) = P(X > nAB) + P(nAB)/2 (test for excess
      heterozygosity).
    - two-sided: exactMidP(nAB) = sum of P(x) for x strictly less probable
      than nAB plus half-weight for outcomes of (relatively) equal
      probability, D_== tolerance 1e-12.
    - degenerate distributions (all mass at one het count, including no
      data) give p = 0.5.
    """
    if n_hom_ref < 0 or n_het < 0 or n_hom_var < 0:
        from ..utils.java import FatalError
        raise FatalError(
            f'hardy_weinberg_test: all arguments must be non-negative, '
            f'got {n_hom_ref}, {n_het}, {n_hom_var}')
    n = n_hom_ref + n_het + n_hom_var
    nAB = n_het
    nA = nAB + 2 * min(n_hom_ref, n_hom_var)  # rarer allele copies
    nB = 2 * n - nA
    # closed-form Levene-Haldane mean, matching the reference bit for bit
    mean = 1.0 * nA * nB / (2 * n - 1) if n > 0 else -0.0
    het_freq = mean / n if n > 0 else float('nan')

    hets, pmf = _lh_distribution(n, nA)
    idx = np.searchsorted(hets, nAB)
    p_obs = float(pmf[idx]) if idx < len(hets) and hets[idx] == nAB else 0.0
    if one_sided:
        # reference LeveneHaldane.rightMidP: P(X > obs) + 0.5 * P(obs)
        p = float(np.sum(pmf[hets > nAB]) + 0.5 * p_obs)
        return het_freq, min(p, 1.0)
    # two-sided exact mid-p (reference LeveneHaldane.exactMidP): outcomes of
    # smaller probability fully, equal probability (incl. obs) at half weight
    if p_obs == 0.0:
        return het_freq, 0.0
    tol = 1e-12
    eps = tol * np.maximum(pmf, p_obs)
    less = pmf < p_obs - eps
    equal = np.abs(pmf - p_obs) <= eps
    p = float(np.sum(pmf[less]) + 0.5 * np.sum(pmf[equal]))
    return het_freq, min(p, 1.0)


def hwe_test_vec(n_hom_ref: np.ndarray, n_het: np.ndarray, n_hom_var: np.ndarray,
                 with_one_sided: bool = False, one_sided: bool = False):
    n_hom_ref = np.asarray(n_hom_ref).ravel()
    n_het = np.asarray(n_het).ravel()
    n_hom_var = np.asarray(n_hom_var).ravel()
    het_freq = np.empty(n_hom_ref.shape, dtype=np.float64)
    p = np.empty(n_hom_ref.shape, dtype=np.float64)
    p1 = np.empty(n_hom_ref.shape, dtype=np.float64)
    for i in range(n_hom_ref.size):
        het_freq[i], p[i] = hwe_test(int(n_hom_ref[i]), int(n_het[i]), int(n_hom_var[i]),
                                     one_sided=one_sided)
        if with_one_sided:
            _, p1[i] = hwe_test(int(n_hom_ref[i]), int(n_het[i]), int(n_hom_var[i]),
                                one_sided=True)
    if with_one_sided:
        return het_freq, p, p1
    return het_freq, p
