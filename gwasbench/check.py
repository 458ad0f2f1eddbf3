"""The comparison that decides `correct`.

Every call of the window keeps the outputs of a seeded sample of its rows.
Once the window has closed, a seeded sample of the finished calls is worked
out again by the reference (`reference/ols.py`) from the inputs the
benchmark made, and compared field by field:

- `max_rel_err`: over the float fields, the largest gap between the
  program's value and the reference's, each field's gaps taken as a share of
  the median magnitude of that field's reference values;
- `n_wrong`: rows whose sample count differs from the reference's;
- `rows_bad`: over every call of the window, rows missing from a call's
  result or holding a value that is not finite;
- `cache_faults`: calls whose device-cache hits, misses or K4 launches were
  not those the traffic mix makes (every call a hit of every partition, or
  every call a miss and one K4 launch per partition);
- `calls_checked`: how many calls the reference worked out again.

Each number has its limit in `limits/<cell>.json`; `calls_checked` has to
reach its limit, the others must not pass theirs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .reference.ols import FIELDS, Covariates, ols_rows

FLOAT_FIELDS = FIELDS[1:]


def gaps(got: List[dict], want: List[dict]) -> Dict[str, float]:
    """Each float field's largest gap as a share of the median |reference|,
    over every compared row and phenotype; inf where one side is not finite
    and the other is."""
    out = {}
    for f in FLOAT_FIELDS:
        g = np.concatenate([np.ravel(np.asarray(d[f], np.float64))
                            for d in got])
        w = np.concatenate([np.ravel(np.asarray(d[f], np.float64))
                            for d in want])
        scale = float(np.median(np.abs(w[np.isfinite(w)]))) if \
            np.isfinite(w).any() else 1.0
        scale = scale if scale > 0 else 1.0
        both = np.isfinite(g) & np.isfinite(w)
        if (np.isfinite(g) != np.isfinite(w)).any() or g.shape != w.shape:
            out[f] = float('inf')
        else:
            out[f] = float(np.max(np.abs(g[both] - w[both]), initial=0.0)
                           / scale)
    return out


def reference_rows(job: dict, cov: Covariates) -> dict:
    """The reference's fields for one compared call: `job` holds the
    sampled rows' n_alt and missing masks and the call's phenotypes."""
    return ols_rows(job['n_alt'], job['missing'], cov, job['Y'])


def compare(jobs: List[dict], C: np.ndarray, dtype=np.float64):
    """(gaps per field, n_wrong) of the program's kept rows against the
    reference computed in `dtype`."""
    cov = Covariates(C, dtype)
    got, want, n_wrong = [], [], 0
    for job in jobs:
        ref = reference_rows(job, cov)
        n_wrong += int(np.sum(np.asarray(job['got']['n']) != ref['n']))
        got.append(job['got'])
        want.append(ref)
    return gaps(got, want), n_wrong


def control(jobs: List[dict], C: np.ndarray) -> Dict[str, float]:
    """The control: the reference in float32 put in the program's place,
    held to the reference in float64 by the same rule."""
    cov64, cov32 = Covariates(C, np.float64), Covariates(C, np.float32)
    low = [reference_rows(j, cov32) for j in jobs]
    high = [reference_rows(j, cov64) for j in jobs]
    return gaps(low, high)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit: `calls_checked` at least its limit,
    the others at most theirs."""
    for name, limit in limits.items():
        v = numbers[name]
        ok = v >= limit if name == 'calls_checked' else v <= limit
        if not ok:
            return False
    return True
