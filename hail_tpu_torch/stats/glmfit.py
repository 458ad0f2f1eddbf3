"""Faithful ports of the reference's lowered GLM fit loops.

These mirror `hail/python/hail/methods/statgen.py` (`logreg_fit` :1041,
`_firth_fit` :1191, `_poisson_fit` :1852, and the wald/lrt/score/firth test
builders :1136-1298) operation-for-operation in numpy float64, so that
convergence/explosion behavior — including exact `n_iterations` counts the
reference's tests assert — matches the reference, which lowers these same
formulas to LAPACK calls (hl.nd.solve → dgesv, hl.nd.qr → dgeqrf,
solve_triangular → dtrtrs).

The results are plain-python dicts shaped like the reference's
`numerical_regression_fit_dtype`:
  {b, score, fisher, mu, n_iterations, log_lkhd, converged, exploded}
with None for "missing" ndarray fields in the blank (failed) case.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg
import scipy.special


def _solve_no_crash(A: np.ndarray, b: np.ndarray):
    """hl.nd.solve(no_crash=True): LAPACK dgesv; failed = singular."""
    try:
        x = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return True, np.full_like(b, np.nan)
    return False, x


def _solve_triangular_no_crash(A: np.ndarray, b: np.ndarray):
    try:
        x = scipy.linalg.solve_triangular(A, b, lower=False)
    except (np.linalg.LinAlgError, scipy.linalg.LinAlgError, ValueError):
        return True, np.full_like(b, np.nan)
    if not np.all(np.isfinite(np.diag(A))) or np.any(np.diag(A) == 0.0):
        return True, np.full_like(b, np.nan)
    return False, x


def _sigmoid(x):
    # reference sigmoid = hl.expit = 1/(1+exp(-x))
    with np.errstate(over='ignore'):
        return 1.0 / (1.0 + np.exp(-x))


def _blank(n_iterations: int, log_lkhd: float):
    return dict(b=None, score=None, fisher=None, mu=None,
                n_iterations=n_iterations, log_lkhd=log_lkhd,
                converged=False, exploded=False)


def logreg_fit(X: np.ndarray, y: np.ndarray,
               null_fit: Optional[dict], max_iterations: int,
               tolerance: float) -> dict:
    """Newton fit of y ~ Bernoulli(logit(X b)) (ref statgen.py:1041)."""
    n, m = X.shape
    if null_fit is None:
        avg = y.sum() / n
        logit_avg = np.log(avg / (1 - avg))
        b = np.concatenate([[logit_avg], np.zeros(m - 1)])
        mu = _sigmoid(X @ b)
        score = X.T @ (y - mu)
        fisher = X.T @ (X * (mu * (1 - mu))[:, None])
    else:
        m0 = null_fit['b'].shape[0]
        X0 = X[:, :m0]
        X1 = X[:, m0:]
        b = np.concatenate([null_fit['b'], np.zeros(m - m0)])
        mu = _sigmoid(X @ b)
        score = np.concatenate([null_fit['score'], X1.T @ (y - mu)])
        f01 = X0.T @ (X1 * (mu * (1 - mu))[:, None])
        f11 = X1.T @ (X1 * (mu * (1 - mu))[:, None])
        fisher = np.block([[null_fit['fisher'], f01], [f01.T, f11]])

    if max_iterations == 0:
        return _blank(0, 0.0)

    iteration = 1
    while True:
        exploded, delta_b = _solve_no_crash(fisher, score)
        max_delta_b = np.max(np.abs(delta_b)) if not exploded else np.inf
        with np.errstate(divide='ignore', invalid='ignore'):
            log_lkhd = float(np.log(y * mu + (1 - y) * (1 - mu)).sum())
        if exploded or np.isnan(delta_b[0]):
            out = _blank(iteration, log_lkhd)
            out['exploded'] = True
            return out
        if max_delta_b < tolerance:
            return dict(b=b, score=score, fisher=fisher, mu=mu,
                        n_iterations=iteration, log_lkhd=log_lkhd,
                        converged=True, exploded=False)
        if iteration == max_iterations:
            return _blank(iteration, log_lkhd)
        b = b + delta_b
        mu = _sigmoid(X @ b)
        score = X.T @ (y - mu)
        fisher = X.T @ (X * (mu * (1 - mu))[:, None])
        iteration += 1


def firth_fit(b0: np.ndarray, X: np.ndarray, y: np.ndarray,
              max_iterations: int, tolerance: float) -> dict:
    """Firth penalized fit (ref statgen.py:1191 _firth_fit): the QR/hat-diag
    update always uses the FULL design X; only the first len(b0) coefficients
    move."""
    if max_iterations == 0:
        return dict(b=None, mu=None, n_iterations=0, log_lkhd=0.0,
                    converged=False, exploded=False)
    b = b0.copy()
    m = b0.shape[0]
    iteration = 1
    while True:
        mu = _sigmoid(X[:, :m] @ b)
        sqrtW = np.sqrt(mu * (1 - mu))
        q, r = np.linalg.qr(X * sqrtW[:, None])
        h = (q * q).sum(axis=1)
        coef = r[:m, :m]
        residual = y - mu
        with np.errstate(divide='ignore', invalid='ignore'):
            dep = q[:, :m].T @ ((residual + (h * (0.5 - mu))) / sqrtW)
        exploded, delta_b = _solve_triangular_no_crash(coef, dep)
        max_delta_b = np.max(np.abs(delta_b)) if np.all(np.isfinite(delta_b)) else np.inf
        with np.errstate(divide='ignore', invalid='ignore'):
            log_lkhd_left = float(np.log(y * mu + (1.0 - y) * (1 - mu)).sum())
            log_lkhd_right = float(np.log(np.abs(np.diag(r))).sum())
        log_lkhd = log_lkhd_left + log_lkhd_right
        if exploded or np.isnan(delta_b[0]):
            return dict(b=None, mu=None, n_iterations=iteration,
                        log_lkhd=log_lkhd, converged=False, exploded=True)
        if max_delta_b < tolerance:
            return dict(b=b, mu=mu, n_iterations=iteration,
                        log_lkhd=log_lkhd, converged=True, exploded=False)
        if iteration == max_iterations:
            return dict(b=None, mu=None, n_iterations=iteration,
                        log_lkhd=log_lkhd, converged=False, exploded=False)
        b = b + delta_b
        iteration += 1


def poisson_fit(X: np.ndarray, y: np.ndarray, b: np.ndarray, mu: np.ndarray,
                score: np.ndarray, fisher: np.ndarray, max_iterations: int,
                tolerance: float) -> dict:
    """Newton fit of y ~ Poisson(exp(X b)) (ref statgen.py:1852)."""
    if max_iterations == 0:
        return _blank(0, 0.0)
    iteration = 1
    while True:
        exploded, delta_b = _solve_no_crash(fisher, score)
        max_delta_b = np.max(np.abs(delta_b)) if not exploded else np.inf
        with np.errstate(divide='ignore', invalid='ignore'):
            log_lkhd = float(y @ np.log(mu) - mu.sum())
        if exploded or np.isnan(delta_b[0]):
            out = _blank(iteration, log_lkhd)
            out['exploded'] = True
            return out
        if max_delta_b < tolerance:
            return dict(b=b, score=score, fisher=fisher, mu=mu,
                        n_iterations=iteration, log_lkhd=log_lkhd,
                        converged=True, exploded=False)
        if iteration == max_iterations:
            return _blank(iteration, log_lkhd)
        b = b + delta_b
        with np.errstate(over='ignore'):
            mu = np.exp(X @ b)
        score = X.T @ (y - mu)
        fisher = (mu * X.T) @ X
        iteration += 1


# ---------------------------------------------------------------------------
# tests on a fit (ref statgen.py:1136-1298, 1924)
# ---------------------------------------------------------------------------

def _pnorm(z):
    return 0.5 * scipy.special.erfc(-z / np.sqrt(2.0))


def _pchisqtail(x, df):
    if x is None or (isinstance(x, float) and np.isnan(x)):
        return None if x is None else float('nan')
    return float(scipy.special.gammaincc(df / 2.0, x / 2.0))


def wald_test(X: np.ndarray, fit: dict) -> dict:
    """ref statgen.py:1136 — beta/se/z/p from inv(fisher) at the fit."""
    m = X.shape[1]
    if fit['b'] is None:
        return dict(beta=None, standard_error=None, z_stat=None, p_value=None,
                    fit=_fit_view(fit))
    with np.errstate(invalid='ignore'):
        cov = np.linalg.inv(fit['fisher'])
        se = np.sqrt(np.diag(cov))
        z = fit['b'] / se
        p = 2 * _pnorm(-np.abs(z))
    return dict(beta=float(fit['b'][m - 1]), standard_error=float(se[m - 1]),
                z_stat=float(z[m - 1]), p_value=float(p[m - 1]),
                fit=_fit_view(fit))


def lrt_test(X: np.ndarray, null_fit: dict, fit: dict) -> dict:
    m = X.shape[1]
    m0 = null_fit['b'].shape[0]
    if not fit['converged'] or fit['b'] is None:
        chi_sq = None
        p = None
        beta = None
    else:
        chi_sq = 2 * (fit['log_lkhd'] - null_fit['log_lkhd'])
        p = _pchisqtail(chi_sq, m - m0)
        beta = float(fit['b'][m - 1])
    return dict(beta=beta, chi_sq_stat=chi_sq, p_value=p, fit=_fit_view(fit))


def logistic_score_test(X: np.ndarray, y: np.ndarray, null_fit: dict) -> dict:
    """ref statgen.py:1161 — full (k+1)-system score test at the null."""
    m = X.shape[1]
    m0 = null_fit['b'].shape[0]
    b = np.concatenate([null_fit['b'], np.zeros(m - m0)])
    X0 = X[:, :m0]
    X1 = X[:, m0:]
    mu = _sigmoid(X @ b)
    score = np.concatenate([null_fit['score'], X1.T @ (y - mu)])
    w = (mu * (1 - mu))[:, None]
    f01 = X0.T @ (X1 * w)
    f11 = X1.T @ (X1 * w)
    fisher = np.block([[null_fit['fisher'], f01], [f01.T, f11]])
    failed, sol = _solve_no_crash(fisher, score)
    if failed:
        return dict(chi_sq_stat=None, p_value=None)
    chi_sq = float((score * sol).sum())
    return dict(chi_sq_stat=chi_sq, p_value=_pchisqtail(chi_sq, m - m0))


def firth_test(null_fit: dict, X: np.ndarray, y: np.ndarray,
               max_iterations: int, tolerance: float) -> dict:
    """ref statgen.py:1257 — improved null fit then full Firth fit."""
    improved_null = firth_fit(null_fit['b'], X, y, max_iterations, tolerance)
    if not improved_null['converged']:
        return dict(beta=None, chi_sq_stat=None, p_value=None,
                    fit=None, firth_null_fit=improved_null)
    b_full0 = np.concatenate([improved_null['b'], [0.0]])
    full = firth_fit(b_full0, X, y, max_iterations, tolerance)
    if not full['converged']:
        return dict(beta=None, chi_sq_stat=None, p_value=None,
                    fit=full, firth_null_fit=improved_null)
    chi_sq = 2 * (full['log_lkhd'] - improved_null['log_lkhd'])
    return dict(beta=float(full['b'][-1]), chi_sq_stat=chi_sq,
                p_value=_pchisqtail(chi_sq, 1), fit=full,
                firth_null_fit=improved_null)


def poisson_score_test(null_fit: dict, covmat: np.ndarray, y: np.ndarray,
                       xvec: np.ndarray) -> dict:
    """ref statgen.py:1924 _poisson_score_test."""
    X = np.hstack([covmat, xvec.reshape(-1, 1)])
    b = np.concatenate([null_fit['b'], [0.0]])
    with np.errstate(over='ignore'):
        mu = np.exp(X @ b)
    score = np.concatenate([null_fit['score'], [xvec @ (y - mu)]])
    f01 = ((mu * covmat.T) @ xvec).reshape(-1, 1)
    f11 = np.array([[(mu * xvec) @ xvec]])
    fisher = np.block([[null_fit['fisher'], f01], [f01.T, f11]])
    failed, sol = _solve_no_crash(fisher, score)
    if failed:
        return dict(chi_sq_stat=None, p_value=None)
    chi_sq = float(score @ sol)
    return dict(chi_sq_stat=chi_sq, p_value=_pchisqtail(chi_sq, 1))


def _fit_view(fit: dict) -> dict:
    return dict(n_iterations=int(fit['n_iterations']),
                converged=bool(fit['converged']),
                exploded=bool(fit['exploded']))
