"""The per-variant contractions of the linear mixed model's batched test,
on the session's torch device (the reference's jnp block at
hail_tpu/stats/linear_mixed_model.py:196-206).

For rotated genotypes pa (n x m), the weighted rotated covariates
wpx = W·px (n x k), the weights w and the null fit's residual r0 (n), one
f64 product of [wpx | w∘r0]ᵀ with pa gives xg = wpxᵀ·pa (k x m) and
gr0 = (w∘r0)ᵀ·pa (m), and ggw = Σₙ w·pa² (m). They come back stacked as
one (k + 2, m) block [xg; ggw; gr0], so the caller makes one copy to the
host. Every tensor is f64: torch's default dtype is f32.
"""

from __future__ import annotations

import torch


def contractions(pa: torch.Tensor, wpx: torch.Tensor, w: torch.Tensor,
                 r0: torch.Tensor) -> torch.Tensor:
    """[xg; ggw; gr0] as one (k + 2, m) f64 tensor on the inputs' device."""
    k = wpx.shape[1]
    xr = torch.cat([wpx, (w * r0)[:, None]], dim=1).T @ pa     # (k + 1, m)
    ggw = (pa * (w[:, None] * pa)).sum(dim=0)
    return torch.cat([xr[:k], ggw[None], xr[k:]])
