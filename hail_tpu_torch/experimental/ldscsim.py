"""Phenotype simulation helpers (reference experimental/ldscsim.py):
multi-trait genetic covariance construction and the simulate_phenotypes
surface (re-exported from the experimental package)."""

from __future__ import annotations

import numpy as np


def _nearpsd(A: np.ndarray) -> np.ndarray:
    """Nearest positive semi-definite matrix (reference ldscsim._nearpsd:
    eigenvalue clipping with diagonal renormalization)."""
    A = (A + A.T) / 2
    w, v = np.linalg.eigh(A)
    w = np.maximum(w, 0)
    B = v @ np.diag(w) @ v.T
    d = np.sqrt(np.diag(B))
    d = np.where(d == 0, 1, d)
    return B / np.outer(d, d)


def get_cov_matrix(h2, rg, psd_rg: bool = False):
    """Covariance matrix from per-trait heritabilities and pairwise genetic
    correlations (reference ldscsim.get_cov_matrix): cov[i,j] =
    rg_ij * sqrt(h2_i * h2_j), with `rg` in upper-triangle row order.

    Returns (cov_matrix, rg): when `psd_rg` the correlations are projected
    to the nearest PSD set and the adjusted rg list is returned."""
    h2 = list(h2)
    rg = list(rg)
    n = len(h2)
    exp = n * (n - 1) // 2
    if len(rg) != exp:
        raise ValueError(f'expected {exp} rg values for {n} traits, '
                         f'got {len(rg)}')
    corr = np.eye(n)
    idx = 0
    for i in range(n):
        for j in range(i + 1, n):
            corr[i, j] = corr[j, i] = rg[idx]
            idx += 1
    if psd_rg:
        corr = _nearpsd(corr)
        rg = [float(corr[i, j]) for i in range(n) for j in range(i + 1, n)]
    sd = np.sqrt(np.asarray(h2, dtype=np.float64))
    cov = corr * np.outer(sd, sd)
    np.fill_diagonal(cov, h2)
    return cov, rg


def normalize_genotypes(genotype):
    """Mean-0 variance-1 normalized genotypes as an annotated MT (reference
    ldscsim.normalize_genotypes)."""
    from ..expr.expression import to_expr
    from ..expr import aggregators as agg
    ge = to_expr(genotype)
    mt = ge._indices.source
    mt = mt.annotate_entries(__gt=ge)
    mt = mt.annotate_rows(__gt_stats=agg.stats(mt.__gt))
    return mt.annotate_entries(
        norm_gt=(mt.__gt - mt.__gt_stats.mean) / mt.__gt_stats.stdev)


def simulate_phenotypes(*args, **kwargs):
    from . import simulate_phenotypes as _sp
    return _sp(*args, **kwargs)
