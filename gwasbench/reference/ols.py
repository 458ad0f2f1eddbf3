"""Per-variant least squares, as `linear_regression_rows` defines it, in
plain NumPy.

For each variant row x (its missing calls replaced by the mean of the row's
other calls) and each phenotype y, the model y ~ covariates + x. By the
Frisch-Waugh-Lovell theorem the coefficient of x is that of the regression
of y's residual on x's residual, both after the covariates are regressed
out: beta = <x_r, y_r> / <x_r, x_r>, with n - k - 1 degrees of freedom for
the residual variance. `dtype` float32 computes every step in single
precision, the control that the comparison has to reject.
"""

from __future__ import annotations

import numpy as np
import scipy.stats

FIELDS = ('n', 'sum_x', 'y_transpose_x', 'beta', 'standard_error', 't_stat',
          'p_value')


class Covariates:
    """An orthonormal basis of the covariates' column space, computed once
    and shared by every call of a run."""

    def __init__(self, C: np.ndarray, dtype=np.float64):
        self.dtype = dtype
        self.n, self.k = C.shape
        self.Q, _ = np.linalg.qr(np.asarray(C, dtype))

    def residual(self, A: np.ndarray) -> np.ndarray:
        """A (n, m) less its projection on the covariates."""
        A = np.asarray(A, self.dtype)
        return A - self.Q @ (self.Q.T @ A)


def ols_rows(n_alt: np.ndarray, missing: np.ndarray, cov: Covariates,
             Y: np.ndarray) -> dict:
    """n_alt (R, n) integers and missing (R, n) bool, Y (n, P): each field
    of `FIELDS` for every row and phenotype, (R,) or (R, P)."""
    dt = cov.dtype
    x = np.asarray(n_alt, dt)
    present = ~missing
    mean = (x * present).sum(axis=1) / present.sum(axis=1)
    x = np.where(missing, mean[:, None].astype(dt), x)        # (R, n)
    Y = np.asarray(Y, dt)
    xr = cov.residual(x.T)                                     # (n, R)
    yr = cov.residual(Y)                                       # (n, P)
    xx = (xr * xr).sum(axis=0)                                 # (R,)
    yy = (yr * yr).sum(axis=0)                                 # (P,)
    xy = xr.T @ yr                                             # (R, P)
    dof = cov.n - cov.k - 1
    beta = xy / xx[:, None]
    se = np.sqrt((yy[None, :] / xx[:, None] - beta * beta) / dof)
    t = beta / se
    p = 2 * scipy.stats.t.sf(np.abs(t.astype(np.float64)), dof)
    return {'n': np.full(x.shape[0], cov.n), 'sum_x': x.sum(axis=1),
            'y_transpose_x': x @ Y, 'beta': beta, 'standard_error': se,
            't_stat': t, 'p_value': p}
