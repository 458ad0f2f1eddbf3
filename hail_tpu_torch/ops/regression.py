"""Per-variant OLS in f64 on the device (port of the linreg part of
hail_tpu/ops/regression.py).

The float-x and weighted fallback of `linear_regression_rows`: the
reference `_linear_regression_rows_nd` block formula (statgen.py:631
process_block) over mean-imputed f64 dosages. The products are plain
matrix products, left to `torch.matmul` as the reference left them to XLA.
"""

from __future__ import annotations

import numpy as np
import torch


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


def linreg_stats(G: np.ndarray, missing: np.ndarray, sqrtw, Q: np.ndarray,
                 Ys: np.ndarray, Qty: np.ndarray, yyp: np.ndarray, dof: int,
                 device):
    """Host wrapper: runs `linreg_block` on `device` and returns numpy
    (R, P) arrays incl. p-values (2·pT(-|t|, d), scipy t-dist)."""
    import scipy.stats as st
    if sqrtw is None:
        sqrtw = np.ones(G.shape[1])

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    out = linreg_block(f64(G), torch.as_tensor(np.asarray(missing, bool),
                                               device=device),
                       f64(sqrtw), f64(Q), f64(Ys), f64(Qty), f64(yyp),
                       float(dof))
    sum_x, ytx, beta, se, t = (v.cpu().numpy() for v in out)
    with np.errstate(all='ignore'):
        p = 2 * st.t.sf(np.abs(t), dof) if dof > 0 else np.full_like(t, np.nan)
    return dict(sum_x=sum_x, y_transpose_x=ytx, beta=beta,
                standard_error=se, t_stat=t, p_value=p)
