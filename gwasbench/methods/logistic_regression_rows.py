"""`hl.logistic_regression_rows(test='wald')` on one binary phenotype, as
`run.py` says a method module is: one call with every output field read
into host arrays as columns (`Table._stage.collect_batches()`), and the
plain reference of `reference/logistic.py`.

The phenotype of a call is binarised at a liability threshold,
`hl.if_else(y > THRESHOLD, 1.0, 0.0)`, in the program's expression and in
the reference alike; `max_iterations` and `tolerance` are the method's
defaults, 25 and 1e-8.
"""

from __future__ import annotations

import numpy as np
import torch

from gwasbench.reference.logistic import FIELDS, Covariates, wald_rows

THRESHOLD = 2.5
EXACT = ('fit.n_iterations', 'fit.converged', 'fit.exploded')
FLOAT = ('beta', 'standard_error', 'z_stat', 'p_value')


def call(hl, mt, x, ys, covariates, label) -> dict:
    """Every field as an (R,) host array, the fit's as `fit.<field>`."""
    if len(ys) != 1:
        raise ValueError('logistic_regression_rows takes one phenotype a '
                         f'call, not {len(ys)}')
    res = hl.logistic_regression_rows(
        test='wald', y=hl.if_else(ys[0] > THRESHOLD, 1.0, 0.0), x=x,
        covariates=covariates)
    batches = res._stage.collect_batches()
    with label('read'):
        out = {f: np.concatenate([np.asarray(b.columns[f].values)
                                  for b in batches]) for f in FLOAT}
        for f in EXACT:
            sub = f.split('.', 1)[1]
            out[f] = np.concatenate([
                np.asarray(b.columns['fit'].fields[sub].values)
                for b in batches])
    return out


def size(out: dict) -> tuple:
    """(rows, tests): a test is one variant and the call's phenotype."""
    return out['beta'].shape[0], out['beta'].size


def bad_rows(out: dict, R: int) -> int:
    """Rows missing from a call's result, or whose fit converged but that
    hold a value that is not finite."""
    n = out['beta'].shape[0]
    bad = abs(n - R)
    if n == R:
        finite = np.ones(n, bool)
        for f in FLOAT:
            finite &= np.isfinite(out[f])
        bad += int((out['fit.converged'] & ~finite).sum())
    return bad


def context(C: np.ndarray, dtype) -> Covariates:
    return Covariates(C, torch.float32 if np.dtype(dtype) == np.float32
                      else torch.float64)


def reference(x: np.ndarray, missing: np.ndarray, Y: np.ndarray,
              ctx: Covariates) -> dict:
    return wald_rows(x, missing, ctx, (Y[:, 0] > THRESHOLD).astype(np.float64))
