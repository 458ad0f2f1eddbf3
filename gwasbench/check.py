"""The comparison that decides `correct`.

Every call of the window keeps the outputs of a seeded sample of its rows.
Once the window has closed, a seeded sample of the finished calls is worked
out again by the method's reference (`methods/<method>.py`, `reference/`)
from the inputs the benchmark made, and compared field by field:

- `max_rel_err`: over the method's `FLOAT` fields, the largest gap between
  the program's value and the reference's, each field's gaps taken as a
  share of the median magnitude of that field's reference values;
- `n_wrong`: rows where one of the method's `EXACT` fields differs from the
  reference's;
- `rows_bad`: over every call of the window, rows that the method's
  `bad_rows` counts: missing from a call's result or not to be trusted;
- `cache_faults`: calls whose device-cache hits, misses or K4 launches were
  not those the genotype mode makes (`run.cache_fault`);
- `calls_checked`: how many calls the reference worked out again.

Each number has its limit in `limits/<cell>.json`; `calls_checked` has to
reach its limit, the others must not pass theirs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def gaps(got: List[dict], want: List[dict],
         fields: Sequence[str]) -> Dict[str, float]:
    """Each field's largest gap as a share of the median |reference|, over
    every compared row and phenotype; inf where one side is not finite and
    the other is."""
    out = {}
    for f in fields:
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


def reference_rows(method, job: dict, ctx) -> dict:
    """The reference's fields for one compared call: `job` holds the
    sampled rows' genotypes and missing masks and the call's phenotypes."""
    return method.reference(job['x'], job['missing'], job['Y'], ctx)


def wrong_rows(method, got: dict, want: dict) -> int:
    """Rows where one of the method's exact fields differs."""
    wrong = None
    for f in method.EXACT:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        differ = (g.reshape(g.shape[0], -1) != w.reshape(w.shape[0], -1)
                  ).any(axis=1)
        wrong = differ if wrong is None else wrong | differ
    return 0 if wrong is None else int(wrong.sum())


def compare(method, jobs: List[dict], C: np.ndarray, dtype=np.float64):
    """(gaps per field, n_wrong) of the program's kept rows against the
    reference computed in `dtype`."""
    ctx = method.context(C, dtype)
    got, want, n_wrong = [], [], 0
    for job in jobs:
        ref = reference_rows(method, job, ctx)
        n_wrong += wrong_rows(method, job['got'], ref)
        got.append(job['got'])
        want.append(ref)
    return gaps(got, want, method.FLOAT), n_wrong


def control(method, jobs: List[dict], C: np.ndarray) -> Dict[str, float]:
    """The control: the reference in float32 put in the program's place,
    held to the reference in float64 by the same rule."""
    ctx64 = method.context(C, np.float64)
    ctx32 = method.context(C, np.float32)
    low = [reference_rows(method, j, ctx32) for j in jobs]
    high = [reference_rows(method, j, ctx64) for j in jobs]
    return gaps(low, high, method.FLOAT)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit: `calls_checked` at least its limit,
    the others at most theirs."""
    for name, limit in limits.items():
        v = numbers[name]
        ok = v >= limit if name == 'calls_checked' else v <= limit
        if not ok:
            return False
    return True
