"""Per-variant logistic regression with the Wald test, as Hail defines
`hl.logistic_regression_rows(test='wald')` (hail.is/docs/0.2/methods/
stats.html, and `logreg_fit` / `wald_test` in Hail's
`hail/methods/statgen.py`), in plain torch. It imports nothing of the
program, nor jax, nor hail_tpu.

For one binary phenotype y and covariates C (n, k), the first of them the
intercept:

- the null fit: Newton's method on y ~ C from b = [logit(mean y), 0, ...],
  with the score Cᵀ(y - μ) and the Fisher matrix Cᵀ diag(μ(1 - μ)) C at
  each b, μ = 1 / (1 + exp(-C b));
- for each variant, x its calls' alternate allele counts with the missing
  ones replaced by the mean of the row's other calls, X = [C | x], the full
  fit starts from b = [null b, 0], with the null fit's covariate score and
  Fisher blocks beside the new ones: score [null score, xᵀ(y - μ)], Fisher
  [[null Fisher, Cᵀ diag(w) x], [xᵀ diag(w) C, xᵀ diag(w) x]];
- each iteration solves Fisher · Δb = score. The fit stops as exploded
  where that step is not finite, as converged where max |Δb| < tolerance
  (its b, score and Fisher those at which the step was taken), and as not
  converged at `max_iterations`; otherwise b += Δb, and μ, score and
  Fisher are computed again at the new b;
- for a converged fit, se = sqrt of the last diagonal entry of the inverse
  Fisher matrix, z = b_x / se and p = 2 Φ(-|z|) = erfc(|z| / √2); the four
  are NaN where the fit did not converge.

Departures from Hail's text: the solve is `torch.linalg.solve` (LU with
partial pivoting, as Hail's `hl.nd.solve`), and a solve that raises, as
well as a step with an entry that is not finite, counts as an explosion
(Hail: a failed solve or a NaN first entry); the sums are torch's, in
another order than Hail's BLAS. Where the null fit does not converge,
Hail raises an error; here every row reads as not converged, with
`n_iterations` 0, so that the check fails instead of the run. Hail's
defaults: `max_iterations` 25 and `tolerance` 1e-8 for the Wald test.

The arithmetic is in `dtype`, float64 as the program's, or float32 for the
control that the comparison has to reject. It runs on the card where there
is one: a block of rows is moved there and imputed at once, then the
variants are fitted one at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_ITERATIONS, TOLERANCE = 25, 1e-8
FIELDS = ('beta', 'standard_error', 'z_stat', 'p_value', 'fit.n_iterations',
          'fit.converged', 'fit.exploded')


def _device() -> torch.device:
    return torch.device('cuda' if torch.cuda.is_available() else 'cpu')


def _sigmoid(t):
    return 1.0 / (1.0 + torch.exp(-t))


def _fisher(X, mu):
    return X.T @ (X * (mu * (1 - mu))[:, None])


def newton(X, y, b, mu, score, fisher, max_iterations: int,
           tolerance: float):
    """Hail's Newton loop from a start: (b, score, fisher, n_iterations,
    converged, exploded), the first three None unless converged."""
    iteration = 1
    while True:
        try:
            delta = torch.linalg.solve(fisher, score)
        except torch.linalg.LinAlgError:
            return None, None, None, iteration, False, True
        if not bool(torch.isfinite(delta).all()):
            return None, None, None, iteration, False, True
        if float(delta.abs().max()) < tolerance:
            return b, score, fisher, iteration, True, False
        if iteration == max_iterations:
            return None, None, None, iteration, False, False
        b = b + delta
        mu = _sigmoid(X @ b)
        score = X.T @ (y - mu)
        fisher = _fisher(X, mu)
        iteration += 1


class Covariates:
    """The (n, k) covariates on the device in `dtype`, shared by every call
    of a run."""

    def __init__(self, C: np.ndarray, dtype=torch.float64, device=None):
        # no float32 product may run in TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.device = _device() if device is None else device
        self.C = torch.as_tensor(np.asarray(C, np.float64),
                                 device=self.device).to(dtype)

    def null_fit(self, y, max_iterations: int, tolerance: float):
        """The covariates-only fit: (b, score, fisher, converged)."""
        C = self.C
        avg = y.mean()
        b = torch.zeros(C.shape[1], dtype=self.dtype, device=self.device)
        b[0] = torch.log(avg / (1 - avg))
        mu = _sigmoid(C @ b)
        b, score, fisher, _, converged, _ = newton(
            C, y, b, mu, C.T @ (y - mu), _fisher(C, mu), max_iterations,
            tolerance)
        return b, score, fisher, converged


def wald_rows(n_alt: np.ndarray, missing: np.ndarray, cov: Covariates,
              y: np.ndarray, max_iterations: int = MAX_ITERATIONS,
              tolerance: float = TOLERANCE) -> dict:
    """n_alt (R, n) integers, missing (R, n) bool, y (n,) 0/1: each field of
    `FIELDS` for every row, (R,) host arrays."""
    dt, dev = cov.dtype, cov.device
    R = n_alt.shape[0]
    out = {f: np.full(R, np.nan) for f in FIELDS[:4]}
    out['fit.n_iterations'] = np.zeros(R, np.int32)
    out['fit.converged'] = np.zeros(R, bool)
    out['fit.exploded'] = np.zeros(R, bool)
    yd = torch.as_tensor(np.asarray(y, np.float64), device=dev).to(dt)
    null_b, null_score, null_fisher, ok = cov.null_fit(yd, max_iterations,
                                                       tolerance)
    if not ok:
        return out
    C = cov.C
    k = C.shape[1]
    miss = torch.as_tensor(np.asarray(missing, bool), device=dev)
    xs = torch.as_tensor(np.asarray(n_alt, np.float64), device=dev).to(dt)
    present = (~miss).to(dt)
    mean = (xs * present).sum(dim=1) / present.sum(dim=1)
    xs = torch.where(miss, mean[:, None], xs)                # (R, n)
    zero = torch.zeros(1, dtype=dt, device=dev)
    for r in range(R):
        x = xs[r]
        X = torch.cat([C, x[:, None]], dim=1)
        b = torch.cat([null_b, zero])
        mu = _sigmoid(X @ b)
        w = mu * (1 - mu)
        f01 = C.T @ (x * w)
        f11 = (x * w) @ x
        fisher = torch.empty((k + 1, k + 1), dtype=dt, device=dev)
        fisher[:k, :k] = null_fisher
        fisher[:k, k] = f01
        fisher[k, :k] = f01
        fisher[k, k] = f11
        score = torch.cat([null_score, (x @ (yd - mu))[None]])
        b, _, fisher, it, conv, expl = newton(X, yd, b, mu, score, fisher,
                                              max_iterations, tolerance)
        out['fit.n_iterations'][r] = it
        out['fit.converged'][r] = conv
        out['fit.exploded'][r] = expl
        if conv:
            se = torch.sqrt(torch.linalg.inv(fisher)[k, k])
            z = b[k] / se
            p = torch.special.erfc(z.abs() / math.sqrt(2.0))
            for f, v in zip(FIELDS[:4], (b[k], se, z, p)):
                out[f][r] = float(v)
    return out
