"""Exact int8 digit-plane GRM: K = Zᵀ Z from int8 products, f64 parity
(port of hail_tpu/ops/grm.py).

With per-variant allele frequency p_v, weight w_v = 1/(2 p_v (1-p_v)) (the
GRM normalization d_v², scaled by 1/m), called-indicator C and
zero-at-missing genotypes gz ∈ {0,1,2}:

    Z_{v,s} = d_v (gz_{v,s} − 2 p_v) C_{v,s}
    K_{s,t} = Σ_v w_v gz_vs gz_vt
            − Σ_v 2 w_v p_v (gz_vs C_vt + C_vs gz_vt)
            + Σ_v 4 w_v p_v² C_vs C_vt

Every sum is Σ_v u_v A_vs B_vt with A, B ∈ {0,1} matrices (gz splits into
the indicators B1 = gz≥1 and B2 = gz=2) and u a per-variant f64 weight.
Decomposing u into int8 digit planes (u_v ≈ Σ_k c_k q_kv, |q| ≤ 127) makes
each term a sum of int8 products Aᵀ (q_k ∘ B) with exact int32 sums,
recombined in f64: 9 families x 7 planes = 63 products per strip. The
weight quantization (7 planes x 7 bits ≈ 2⁻⁴⁹ relative) is the only
inexactness; the tests hold K to ≤ 1e-12 of the f64 oracle.

The int8 products are plain library products, as the reference left them
to XLA: `torch._int_mm` on the card, an int32 product on the CPU (CPU
torch's int8 `mm` wraps). `torch._int_mm` rejects small shapes and wants
the contraction and the output width in multiples of 8, so the variants,
the samples and each strip are padded with zero rows and columns, which
add nothing to an indicator product.

The output comes in column strips, so a 50k x 50k kinship never needs a
second 20 GB f64 buffer beside the result.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

_PLANES = 7
_BITS = 7
# torch._int_mm on CUDA: the left operand needs more than 16 rows; the
# contraction and the output width must be multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def weight_planes(u: np.ndarray, planes: int = _PLANES, bits: int = _BITS
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-variant f64 weights (m,) → int8 digit planes (planes, m) and f64
    scales (planes,). Same scheme as linreg_i8._digit_planes but for a
    single weight vector (shared block exponent)."""
    u = np.asarray(u, np.float64)
    amax = np.max(np.abs(u)) if u.size else 1.0
    base = float(np.exp2(np.ceil(np.log2(amax)))) if amax > 0 else 1.0
    resid = u / base
    mult = float(1 << bits)
    digs, scales = [], []
    for d in range(planes):
        q = np.clip(np.rint(resid * mult), -127, 127)
        digs.append(q.astype(np.int8))
        resid = resid * mult - q
        scales.append(base / (mult ** (d + 1)))
    return np.stack(digs, axis=0), np.asarray(scales)


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _plane_product(At: torch.Tensor, Bt: torch.Tensor,
                   q: torch.Tensor) -> torch.Tensor:
    """Aᵀ (q ∘ B) with exact int32 sums, from the (n, m) int8 transpose At
    of a 0/1 indicator matrix, the (B, m) rows Bt of the strip's transposed
    indicator and the (m,) int8 digits q of one weight plane.

    The right operand goes to `torch._int_mm` as the transposed view of the
    contiguous (B, m) product Bt ∘ q, i.e. column-major: on the H100 the
    same product with a row-major right operand takes seven times as long
    (chip_smoke.py's `grm_product_row_major_ms`)."""
    qb = Bt * q                           # |q| ≤ 127 times 0/1: int8
    if At.device.type == 'cpu':
        return At.to(torch.int32) @ qb.T.to(torch.int32)
    return torch._int_mm(At, qb.T)


def _grm_strip(b1t, b2t, ct, b1s, b2s, cs, qw, sw, qwp, swp, qwp2, swp2,
               planes: int = _PLANES) -> torch.Tensor:
    """One output strip K[:, strip] in f64.

    b1t, b2t, ct are the strip-invariant (n, m) int8 transposes of the
    indicators, b1s, b2s, cs their (B, m) rows of the strip's samples; q*
    the (planes, m) int8 digit planes on the device and s* their f64 scales
    on the host. The 63 int32 products are added into one f64 accumulator
    in place (acc += s_k · product), which spares the f64 copies of each
    product."""
    acc = torch.zeros((b1t.shape[0], b1s.shape[0]), dtype=torch.float64,
                      device=b1t.device)

    def sweep(At, Bt, q, s, sign):
        # Σ_k s_k · Aᵀ (q_k ∘ B): exact int32 products, f64 recombine
        for k in range(planes):
            acc.add_(_plane_product(At, Bt, q[k]), alpha=sign * float(s[k]))

    # T1: Σ w gz gzᵀ with gz = B1 + B2
    for At in (b1t, b2t):
        for Bt in (b1s, b2s):
            sweep(At, Bt, qw, sw, 1.0)
    # T2: − Σ 2wp (gz Cᵀ + C gzᵀ)
    for At, Bt in ((b1t, cs), (b2t, cs), (ct, b1s), (ct, b2s)):
        sweep(At, Bt, qwp, swp, -1.0)
    # T3: + Σ 4wp² C Cᵀ
    sweep(ct, cs, qwp2, swp2, 1.0)
    return acc


class ExactGrm:
    """Strip-streaming exact GRM over int8 indicator matrices.

    Usage:
        g = ExactGrm(gz8, m8, p, ok)       # device staging, once
        for lo, hi, K_strip in g.strips(4096):   # f64 (n, hi-lo) on device
            ...
    `gz8`, `m8` are (m, n) int8 (tensors or host arrays; host arrays go to
    the session's device), `p` the per-variant allele frequency, `ok` the
    rows actually used (denominator > 0); the 1/m normalization is applied
    here.
    """

    def __init__(self, gz8, m8, p: np.ndarray, ok: np.ndarray):
        if not isinstance(gz8, torch.Tensor):
            from ..context import current_device
            dev = current_device()
            gz8 = torch.as_tensor(np.asarray(gz8, np.int8), device=dev)
            m8 = torch.as_tensor(np.asarray(m8, np.int8), device=dev)
        dev = gz8.device
        m, n = (int(x) for x in gz8.shape)
        m_pad = _round_up(max(m, 1), _ALIGN)
        if m_pad * 127 >= 2 ** 31:
            raise ValueError(f'ExactGrm: {m} variants overflow the int32 '
                             f'sums (m·127 must stay below 2³¹)')
        n_pad = max(_round_up(n, _ALIGN), _round_up(_MIN_ROWS, _ALIGN))
        okj = torch.as_tensor(np.asarray(ok, bool), device=dev)
        # excluded rows contribute nothing: zero their indicators; padding
        # variants and samples are zero rows and columns
        keep = okj[:, None]
        zero = torch.zeros((), dtype=torch.int8, device=dev)
        pad = (0, n_pad - n, 0, m_pad - m)
        # the (n_pad, m_pad) transposes of the indicators: the left operands
        # of every product, and their rows the strips' right operands
        self.b1t, self.b2t, self.ct = (
            torch.nn.functional.pad(torch.where(keep, x.to(torch.int8), zero),
                                    pad).T.contiguous()
            for x in ((gz8 >= 1), (gz8 == 2), (1 - m8)))
        p = np.asarray(p, np.float64)
        ok = np.asarray(ok, bool)
        m_used = max(int(ok.sum()), 1)
        denom = 2.0 * p * (1.0 - p)
        w = np.where(ok, 1.0 / np.where(denom > 0, denom, 1.0), 0.0) / m_used
        self.m_used = m_used
        planes = []
        for u in (w, 2.0 * w * p, 4.0 * w * p * p):
            q, s = weight_planes(u)
            q = np.pad(q, ((0, 0), (0, m_pad - m)))
            planes += [torch.as_tensor(q, device=dev), s]
        self._planes = tuple(planes)
        self.n = n

    def strip(self, lo: int, hi: int) -> torch.Tensor:
        """f64 (n, hi-lo) strip of K (device tensor)."""
        width = _round_up(hi - lo, _ALIGN)
        rows = [torch.nn.functional.pad(x[lo:hi], (0, 0, 0, width - (hi - lo)))
                for x in (self.b1t, self.b2t, self.ct)]
        k = _grm_strip(self.b1t, self.b2t, self.ct, *rows, *self._planes)
        return k[:self.n, :hi - lo]

    def strips(self, width: int) -> Iterator[Tuple[int, int, torch.Tensor]]:
        for lo in range(0, self.n, width):
            hi = min(lo + width, self.n)
            yield lo, hi, self.strip(lo, hi)

    def to_numpy(self, width: int = 8192) -> np.ndarray:
        out = np.empty((self.n, self.n), np.float64)
        for lo, hi, s in self.strips(width):
            out[:, lo:hi] = s.cpu().numpy()
        return out
