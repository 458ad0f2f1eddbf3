"""Per-variant regressions on the device (port of
hail_tpu/ops/regression.py).

- OLS: the float-x and weighted fallback of `linear_regression_rows`, the
  reference `_linear_regression_rows_nd` block formula (statgen.py:631
  process_block) over mean-imputed dosages, in f64 (`linreg_block`) or in
  true f32 (`linreg_block_f32`, `linreg_stats(precision='float32')`).
- Logistic and poisson regression by batched Newton steps: the null fit
  `logreg_null_fit`, the per-variant fit `glm_per_variant_fit`, the score
  test `glm_score_test` and the Firth fit `firth_fit`, in f64.

The products are plain matrix products, left to `torch.matmul` as the
reference left them to XLA. The reference's `lax.while_loop`s stop on the
largest |delta| of all rows, so every row takes the same number of
iterations and `n_iter` is one number: `_newton_loop` reads that largest
delta to the host once an iteration. `torch.linalg.cholesky` raises on a
matrix that is not positive definite, where `jnp.linalg.cholesky` returns
NaNs (which the fits then carry): `_chol` makes the factor NaN instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .linreg_i8 import _true_f32_matmul


def _impute_mean_nan(G: torch.Tensor, missing: torch.Tensor) -> torch.Tensor:
    """Reference mean_impute semantics (statgen.py:490): missing entries take
    the mean of the non-missing entries; an all-missing row imputes NaN."""
    cnt = (~missing).sum(dim=1).to(G.dtype)
    s = torch.where(missing, 0.0, G).sum(dim=1)
    mean = s / cnt                                   # 0/0 → nan, as reference
    return torch.where(missing, mean[:, None], G)


def linreg_block(G: torch.Tensor, missing: torch.Tensor, sqrtw: torch.Tensor,
                 Q: torch.Tensor, Ys: torch.Tensor, Qty: torch.Tensor,
                 yyp: torch.Tensor, d: float):
    """Per-variant OLS. G: (R, n) f64 raw dosages over the group's kept
    samples; missing: (R, n) bool; sqrtw: (n,) sqrt-weights (ones when
    unweighted); Q: (n, k) orthonormal basis of the (scaled) covariates;
    Ys: (n, P) scaled phenotypes; Qty: (k, P) = Qᵀ Ys; yyp: (P,) residual
    y·y; d: dof = n-k-1. Degenerate fits propagate NaN (no masking), as in
    the reference. Returns (sum_x, ytx, beta, se, t)."""
    Gi = _impute_mean_nan(G, missing)
    X = Gi * sqrtw[None, :]                  # (R, n)
    sum_x = X.sum(dim=1)
    Qtx = X @ Q                              # (R, k)
    ytx = X @ Ys                             # (R, P)
    xyp = ytx - Qtx @ Qty                    # (R, P)
    xxp = (X * X).sum(dim=1) - (Qtx * Qtx).sum(dim=1)
    xxp_rec = 1.0 / xxp
    beta = xyp * xxp_rec[:, None]
    se = torch.sqrt((1.0 / d) * (yyp[None, :] * xxp_rec[:, None] - beta * beta))
    t = beta / se
    return sum_x, ytx, beta, se, t


def linreg_block_f32(G, missing, sqrtw, Q, Ys, Qty, yyp, d):
    """`linreg_block` in f32 (the reference's fast path for when 1e-8 parity
    is not asked for), its products in true f32: TF32 is ruled out."""
    f32 = torch.float32
    with _true_f32_matmul():
        return linreg_block(G.to(f32), missing, sqrtw.to(f32), Q.to(f32),
                            Ys.to(f32), Qty.to(f32), yyp.to(f32),
                            torch.tensor(d, dtype=f32, device=G.device))


def t_pvalues(t: np.ndarray, dof) -> np.ndarray:
    """Two-sided p-values of t statistics, 2·P(T > |t|) for Student's t
    with `dof` degrees of freedom (scipy), f64; all NaN when dof <= 0."""
    import scipy.stats as st
    with np.errstate(all='ignore'):
        p = 2 * st.t.sf(np.abs(t), dof) if dof > 0 else np.full_like(t, np.nan)
    return np.asarray(p, dtype=np.float64)


def linreg_stats(G: np.ndarray, missing: np.ndarray, sqrtw, Q: np.ndarray,
                 Ys: np.ndarray, Qty: np.ndarray, yyp: np.ndarray, dof: int,
                 precision: str = 'float64'):
    """Host wrapper: runs `linreg_block` (`linreg_block_f32` for
    `precision` 'float32') on the session's device and returns numpy (R, P)
    f64 arrays incl. p-values (`t_pvalues`). The column plane may be host
    arrays or tensors on that device."""
    if precision not in ('float64', 'float32'):
        raise ValueError(f"linreg_stats: precision is 'float64' or "
                         f"'float32', got {precision!r}")
    from ..context import current_device
    device = current_device()
    block = linreg_block if precision == 'float64' else linreg_block_f32
    if sqrtw is None:
        sqrtw = np.ones(G.shape[1])

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    out = block(f64(G), torch.as_tensor(np.asarray(missing, bool),
                                        device=device),
                f64(sqrtw), f64(Q), f64(Ys), f64(Qty), f64(yyp), float(dof))
    sum_x, ytx, beta, se, t = (v.cpu().numpy().astype(np.float64)
                               for v in out)
    return dict(sum_x=sum_x, y_transpose_x=ytx, beta=beta,
                standard_error=se, t_stat=t, p_value=t_pvalues(t, dof))


# ---------------------------------------------------------------------------
# logistic / poisson regression (batched Newton)
# ---------------------------------------------------------------------------

def _impute_mean(G: torch.Tensor, missing: torch.Tensor):
    """Mean-impute missing entries per variant row, an all-missing row with
    0. G: (R, N); missing bool. Returns (Gi, count of calls, sum of calls)."""
    cnt = (~missing).sum(dim=1)
    s = torch.where(missing, 0.0, G).sum(dim=1)
    mean = torch.where(cnt > 0, s / cnt.clamp(min=1), 0.0)
    return torch.where(missing, mean[:, None], G), cnt, s


def _chol(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a batch of symmetric matrices, the factor
    all NaN where one is not positive definite (`jnp.linalg.cholesky`'s
    answer; `torch.linalg.cholesky` would raise)."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, math.nan), L)


def _psd_solve(H, b):
    """Batched SPD solve H x = b via Cholesky."""
    L = _chol(H)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _psd_inv(H):
    L = _chol(H)
    eye = torch.eye(H.shape[-1], dtype=H.dtype,
                    device=H.device).expand(H.shape)
    y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _psd_logdet(H):
    d = torch.diagonal(_chol(H), dim1=-2, dim2=-1)
    return 2.0 * torch.log(torch.clamp(d, min=1e-300)).sum(dim=-1)


def _sigmoid(x):
    return 0.5 * (torch.tanh(x / 2) + 1)


def _largest(deltas) -> float:
    """The largest entry of the deltas of all blocks, NaN if any is NaN (as
    XLA's max reduction), -inf if they hold none."""
    vals = [float(d.max()) if d.numel() else -math.inf for d in deltas]
    if any(math.isnan(v) for v in vals):
        return math.nan
    return max(vals, default=-math.inf)


def _newton_loop(steps, max_iter: int, tol: float) -> int:
    """The reference's `lax.while_loop` over Newton steps: each function of
    `steps` (one per block of rows) makes one step and returns its |delta|,
    until the largest |delta| of all blocks is at most `tol` (or NaN) or
    `max_iter` steps ran. Returns the number of steps."""
    it, dmax = 0, math.inf
    while dmax > tol and it < max_iter:
        dmax = _largest([step() for step in steps])
        it += 1
    return it


def _f64(x, device):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _dev(G):
    return G.device if isinstance(G, torch.Tensor) else torch.device('cpu')


def logreg_null_fit(X, y, max_iter: int = 25, tol: float = 1e-6):
    """Fit logit(y) ~ X by Newton-Raphson. X: (N, k), y: (N,). Returns
    (beta, mu, converged, ll, n_iter)."""
    dev = _dev(X)
    X, y = _f64(X, dev), _f64(y, dev)
    k = X.shape[1]
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    ybar = y.mean()
    beta = torch.zeros(k, dtype=torch.float64, device=dev)
    beta[0] = torch.log(ybar / (1 - ybar + 1e-12) + 1e-12)
    delta = torch.tensor(math.inf, dtype=torch.float64, device=dev)

    def step():
        nonlocal beta, delta
        mu = _sigmoid(X @ beta)
        W = mu * (1 - mu)
        grad = X.T @ (y - mu)
        H = (X * W[:, None]).T @ X
        dv = _psd_solve(H + 1e-12 * eye, grad)
        beta = beta + dv
        delta = dv.abs().max()
        return delta

    it = _newton_loop([step], max_iter, tol)
    mu = _sigmoid(X @ beta)
    ll = (y * torch.log(mu + 1e-300)
          + (1 - y) * torch.log(1 - mu + 1e-300)).sum()
    return beta, mu, delta <= tol, ll, it


def _outer(Cov):
    """(N, k·k): row n holds the outer product Cov[n] Cov[n]ᵀ, so that
    W @ _outer(Cov) gives every row's Covᵀ diag(W_r) Cov in one product."""
    return (Cov[:, :, None] * Cov[:, None, :]).reshape(Cov.shape[0], -1)


def _glm_hessian(W, Gi, Cov, CC):
    """The (R, k+1, k+1) information matrices of the designs [Cov, g_r]
    with weights W (R, N); CC = `_outer(Cov)`."""
    R, k = W.shape[0], Cov.shape[1]
    H = torch.zeros((R, k + 1, k + 1), dtype=W.dtype, device=W.device)
    H[:, :k, :k] = (W @ CC).view(R, k, k)
    Hcg = (W * Gi) @ Cov
    H[:, :k, k] = Hcg
    H[:, k, :k] = Hcg
    H[:, k, k] = (W * Gi * Gi).sum(dim=1)
    return H


class _GlmRows:
    """One block of variant rows of `glm_per_variant_fit`: its state, one
    Newton step (`step`) and the statistics after the last (`result`), so
    that blocks of rows on several devices step together under one
    stopping rule (`parallel/dryrun.py`)."""

    def __init__(self, G, missing, Cov, y, beta_null, link):
        if link not in ('logistic', 'poisson'):
            raise ValueError(f'link {link!r}: logistic or poisson')
        dev = _dev(G)
        self.link = link
        self.Gi, self.cnt, _ = _impute_mean(
            _f64(G, dev), torch.as_tensor(missing, dtype=torch.bool,
                                          device=dev))
        self.Cov, self.y = _f64(Cov, dev), _f64(y, dev)
        self.CC = _outer(self.Cov)
        R, k = self.Gi.shape[0], self.Cov.shape[1]
        self.b = torch.cat([_f64(beta_null, dev).expand(R, k),
                            torch.zeros((R, 1), dtype=torch.float64,
                                        device=dev)], dim=1)
        self.delta = torch.full((R,), math.inf, dtype=torch.float64,
                                device=dev)
        self.ridge = 1e-12 * torch.eye(k + 1, dtype=torch.float64,
                                       device=dev)

    def _fitted(self):
        k = self.Cov.shape[1]
        eta = torch.addcmul(self.b[:, :k] @ self.Cov.T, self.Gi,
                            self.b[:, k:k + 1])
        if self.link == 'logistic':
            mu = _sigmoid(eta)
            return eta, mu, mu * (1 - mu)
        mu = torch.exp(eta)
        return eta, mu, mu

    def step(self):
        _, mu, W = self._fitted()
        r = self.y[None, :] - mu
        grad = torch.cat([r @ self.Cov, (r * self.Gi).sum(dim=1)[:, None]],
                         dim=1)
        delta = _psd_solve(
            _glm_hessian(W, self.Gi, self.Cov, self.CC) + self.ridge, grad)
        self.b = self.b + delta
        self.delta = delta.abs().max(dim=1).values
        return self.delta

    def result(self, n_iter: int, tol: float):
        k = self.Cov.shape[1]
        eta, mu, W = self._fitted()
        cov = _psd_inv(_glm_hessian(W, self.Gi, self.Cov, self.CC)
                       + self.ridge)
        se_g = torch.sqrt(torch.clamp(cov[:, k, k], min=0.0))
        y = self.y[None]
        if self.link == 'logistic':
            ll = (y * torch.log(mu + 1e-300)
                  + (1 - y) * torch.log(1 - mu + 1e-300)).sum(dim=1)
        else:
            ll = (y * eta - mu).sum(dim=1)
        return self.b, se_g, ll, self.delta <= tol, n_iter, self.cnt


def glm_per_variant_fit(G, missing, Cov, y, beta_null, max_iter: int = 25,
                        tol: float = 1e-6, link: str = 'logistic'):
    """Batched per-variant GLM fit: logit/log(y) ~ Cov + g.

    G: (R, N); missing: (R, N) bool; Cov: (N, k); y: (N,); beta_null: (k,)
    warm start. Returns (beta_full (R, k+1) [g coef last], se_g, ll_full,
    converged, n_iter, n_called)."""
    rows = _GlmRows(G, missing, Cov, y, beta_null, link)
    return rows.result(_newton_loop([rows.step], max_iter, tol), tol)


def glm_score_test(G, missing, Cov, y, beta_null, link: str = 'logistic'):
    """Score test at the null fit (reference LogisticRegression score path).
    Returns (chi2 (R,), n_called (R,))."""
    dev = _dev(G)
    Gi, cnt, _ = _impute_mean(_f64(G, dev), torch.as_tensor(
        missing, dtype=torch.bool, device=dev))
    Cov, y, beta_null = _f64(Cov, dev), _f64(y, dev), _f64(beta_null, dev)
    eta0 = Cov @ beta_null
    mu0 = _sigmoid(eta0) if link == 'logistic' else torch.exp(eta0)
    W0 = mu0 * (1 - mu0) if link == 'logistic' else mu0
    U_g = Gi @ (y - mu0)                         # (R,)
    Icc = (Cov * W0[:, None]).T @ Cov            # (k, k)
    Icg = (Gi * W0[None, :]) @ Cov               # (R, k)
    Igg = (W0[None, :] * Gi * Gi).sum(dim=1)
    sol = _psd_solve(Icc.expand((Icg.shape[0],) + Icc.shape), Icg)
    var_g = Igg - (Icg * sol).sum(dim=1)
    return U_g * U_g / torch.clamp(var_g, min=1e-300), cnt


def firth_fit(G, missing, Cov, y, beta_start, m0: int, max_iter: int = 100,
              tol: float = 1e-6):
    """Batched Firth penalized fit of logit(y) ~ [Cov, g] updating only the
    first m0 coefficients (reference `stats/LogisticRegressionModel.scala`
    fitFirth: the hat diagonal and the penalty 0.5·logdet(XᵀWX) always use
    the full design). beta_start: (R, k+1). Returns (beta, penalized
    log-likelihood, converged, n_iter, n_called)."""
    dev = _dev(G)
    Gi, cnt, _ = _impute_mean(_f64(G, dev), torch.as_tensor(
        missing, dtype=torch.bool, device=dev))
    Cov, y = _f64(Cov, dev), _f64(y, dev)
    R, k = Gi.shape[0], Cov.shape[1]
    m = k + 1
    CC = _outer(Cov)
    ridge = 1e-12 * torch.eye(m, dtype=torch.float64, device=dev)
    b = _f64(beta_start, dev).clone()
    delta = torch.full((R,), math.inf, dtype=torch.float64, device=dev)

    def weights(b):
        mu = _sigmoid(torch.addcmul(b[:, :k] @ Cov.T, Gi, b[:, k:k + 1]))
        return mu, mu * (1 - mu)

    def step():
        nonlocal b, delta
        mu, W = weights(b)
        H = _glm_hessian(W, Gi, Cov, CC) + ridge
        Hinv = _psd_inv(H)
        # hat diagonal h_i = w_i · x_iᵀ H⁻¹ x_i over the full design
        q_cc = Hinv[:, :k, :k].reshape(R, k * k) @ CC.T         # (R, N)
        q_cg = Gi * (Hinv[:, :k, k] @ Cov.T)
        h = W * (q_cc + 2 * q_cg + Hinv[:, k, k][:, None] * Gi * Gi)
        adj_r = y[None] - mu + h * (0.5 - mu)
        grad = torch.cat([adj_r @ Cov, (adj_r * Gi).sum(dim=1)[:, None]],
                         dim=1)
        # restricted solve: only the first m0 coefficients move
        dv = torch.zeros((R, m), dtype=torch.float64, device=dev)
        dv[:, :m0] = _psd_solve(H[:, :m0, :m0], grad[:, :m0])
        b = b + dv
        delta = dv.abs().max(dim=1).values
        return delta

    it = _newton_loop([step], max_iter, tol)
    mu, W = weights(b)
    logdet = _psd_logdet(_glm_hessian(W, Gi, Cov, CC) + ridge)
    ll = (y[None] * torch.log(mu + 1e-300)
          + (1 - y[None]) * torch.log(1 - mu + 1e-300)).sum(dim=1)
    return b, ll + 0.5 * logdet, delta <= tol, it, cnt
