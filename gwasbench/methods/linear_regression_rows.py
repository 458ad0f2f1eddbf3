"""`hl.linear_regression_rows`, as `run.py` says a method module is: one
call with every output field read into host arrays as columns (the port has
no public columnar route, so `Table._stage.collect_batches()`), and the
plain reference of `reference/ols.py`."""

from __future__ import annotations

import numpy as np

from gwasbench.reference.ols import FIELDS, Covariates, ols_rows

EXACT = ('n',)
FLOAT = FIELDS[1:]


def call(hl, mt, x, ys, covariates, label) -> dict:
    """Every field as a host array, (R,) for n and sum_x, (R, P) for the
    others; a single phenotype is passed as one expression, more as a
    list."""
    res = hl.linear_regression_rows(
        y=ys if len(ys) > 1 else ys[0], x=x, covariates=covariates)
    batches = res._stage.collect_batches()
    with label('read'):
        out = {f: np.concatenate([np.asarray(b.columns[f].values)
                                  for b in batches]) for f in FIELDS}
    for f in FIELDS[2:]:
        out[f] = out[f].reshape(out[f].shape[0], -1)
    return out


def size(out: dict) -> tuple:
    """(rows, tests): a test is one variant and one phenotype."""
    return out['n'].shape[0], out['beta'].size


def bad_rows(out: dict, R: int) -> int:
    """Rows missing from a call's result, or holding a value that is not
    finite."""
    n = out['n'].shape[0]
    bad = abs(n - R)
    if n == R:
        finite = np.ones(n, bool)
        for f in FLOAT:
            finite &= np.isfinite(out[f].reshape(n, -1)).all(axis=1)
        bad += int((~finite).sum())
    return bad


def context(C: np.ndarray, dtype) -> Covariates:
    return Covariates(C, dtype)


def reference(x: np.ndarray, missing: np.ndarray, Y: np.ndarray,
              ctx: Covariates) -> dict:
    return ols_rows(x, missing, ctx, Y)
