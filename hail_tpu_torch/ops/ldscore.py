"""LD scores on the session's torch device: the device part of
`experimental.ld_score` (the reference computes it at
hail_tpu/experimental/__init__.py:265-272).

For standardized genotype rows Z (m variants x n samples, f64) and the
variants' global positions gp, variant i's score is

    Σ_j [|gp_i − gp_j| <= radius] · (r²_ij − (1 − r²_ij) / max(n − 2, 1)),

with r = Z·Zᵀ. The reference forms the whole (m, m) r and copies it to the
host; here rows go in strips of at most `STRIP` variants, each strip's
arithmetic the reference's, and only the m scores leave the device. The
positions are compared in int64: global positions pass 2²⁴, where f32
would merge neighbours. The products are plain torch f64 matrix products,
as the reference left them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STRIP = 4096


def int_radius(radius) -> int:
    """The integer radius whose window `|d| <= r` holds the same integer
    distances d as `|d| <= radius`."""
    r = float(radius)
    if math.isnan(r) or r < 0:
        return -1
    return math.floor(r) if r < 2 ** 62 else 2 ** 62


def window_scores(Z: torch.Tensor, gp: torch.Tensor, n_samples: int,
                  radius) -> torch.Tensor:
    """The (m,) f64 scores of Z (m, n) f64 and gp (m,) int64, both on one
    device; the result stays there."""
    r_max = int_radius(radius)
    denom = max(n_samples - 2, 1)
    out = torch.empty(Z.shape[0], dtype=torch.float64, device=Z.device)
    for s in range(0, Z.shape[0], STRIP):
        zs = Z[s:s + STRIP]
        r = zs @ Z.T
        r2 = r * r
        r2 = r2 - (1 - r2) / denom
        mask = (gp[s:s + STRIP, None] - gp[None, :]).abs() <= r_max
        out[s:s + zs.shape[0]] = (r2 * mask).sum(dim=1)
    return out


def ld_scores(Z: np.ndarray, gp: np.ndarray, n_samples: int,
              radius) -> np.ndarray:
    """`window_scores` of host arrays on the session's device; returns the
    scores on the host."""
    from ..context import current_device
    dev = current_device()
    z = torch.from_numpy(np.ascontiguousarray(Z, dtype=np.float64)).to(dev)
    g = torch.from_numpy(np.ascontiguousarray(gp, dtype=np.int64)).to(dev)
    return window_scores(z, g, n_samples, radius).cpu().numpy()
