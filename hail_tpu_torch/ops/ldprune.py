"""Banded windowed r² for LD pruning, on the session's torch device
(port of hail_tpu/ops/ldprune.py).

Every variant's r² against its W predecessors comes from blocked f64
products over the standardized genotype matrix, thresholded on the device
and bit-packed, and all blocks come back in one device-to-host copy; the
greedy window scans of `statgen.ld_prune` then run on host booleans.

band_hits[i, k] ↔ pair (i, j=i-W+k), k ∈ [0, W): True iff r²(Z_i, Z_j) ≥ t.
Rows j < 0 are zero rows (r = 0, never a hit). Contig / bp-window masking
happens in the caller, which owns the locus arrays.

The products are plain torch f64 matrix products, as the reference left
them to XLA: no kernel is written by hand here (ROADMAP queue 2, "Later
device kernels", says when one would be).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

# big-endian within the byte: bit 128 is k = 8j (np.unpackbits order)
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _band_block(zpad: torch.Tensor, s: int, w: int, block: int,
                thresh: float) -> torch.Tensor:
    """One boolean band tile, bit-packed on the device to (block, ceil(w/8))
    uint8 — the band leaves the card at 1 bit per pair.

    zpad is Z with w zero rows prepended (and zero rows appended to a whole
    number of blocks), so source row i sits at zpad[i+w] and both slices
    below stay in range: torch's `narrow` raises where JAX's dynamic_slice
    would clamp. For output rows i ∈ [s, s+block):
    C = Z[s:s+block] · Z[s-w : s+block]ᵀ, and band[r, k] = C[r, r+k]
    (pair (s+r, s+r-w+k))."""
    zb = zpad.narrow(0, s + w, block)
    zw = zpad.narrow(0, s, block + w)
    c = zb @ zw.T                                   # (block, block + w)
    dev = zpad.device
    idx = (torch.arange(block, device=dev)[:, None]
           + torch.arange(w, device=dev)[None, :])
    band = torch.gather(c, 1, idx)                  # C[r, r + k]
    hits = ((band * band) >= thresh).to(torch.uint8)
    w8 = (w + 7) // 8
    h = torch.nn.functional.pad(hits, (0, w8 * 8 - w))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=dev)
    return (h.reshape(block, w8, 8) * weights).sum(dim=-1, dtype=torch.uint8)


def banded_r2_hits(zd: torch.Tensor, w: int, r2: float, block: int = 2048
                   ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield (s, e, hits) per row block; hits is host bool (e-s, w).

    All blocks are dispatched up front and the packed bands come back in
    ONE device-to-host copy (the hits do not depend on the greedy scan's
    kept set, so the whole band can be made before scanning)."""
    m = int(zd.shape[0])
    if m == 0 or w <= 0:
        return
    # zero rows before (j < 0) and after (tail-block padding): zero rows
    # never produce a hit, and every narrow() stays in range
    pad_end = (-m) % block
    zpad = torch.cat(
        [zd.new_zeros((w, zd.shape[1])), zd,
         zd.new_zeros((pad_end, zd.shape[1]))], dim=0)
    outs = [_band_block(zpad, s, w, block, float(r2))
            for s in range(0, m, block)]
    packed = torch.cat(outs, dim=0).cpu().numpy()   # one d2h
    bits = np.unpackbits(packed, axis=1)[:, :w].astype(bool)
    for s in range(0, m, block):
        e = min(s + block, m)
        yield s, e, bits[s:e]


def standardize_rows_device(gz8: torch.Tensor, m8: torch.Tensor):
    """(gz8, m8) int8 device pair → (Z, mean, ok): unit-norm mean-imputed
    f64 rows on the device plus host per-variant stats (the ld_prune
    normalization, reference statgen.py `mean_imputed` + `normalize`)."""
    g = gz8.to(torch.float64)
    miss = m8 > 0
    cnt = (~miss).sum(dim=1).to(torch.float64)
    s = g.sum(dim=1)
    mean = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
    gi = torch.where(miss, mean[:, None], g)
    centered = gi - mean[:, None]
    ss = torch.sqrt((centered * centered).sum(dim=1))
    ok = ss > 0
    z = torch.where(ok[:, None],
                    centered / torch.where(ok, ss, 1.0)[:, None], 0.0)
    # one stacked device-to-host copy for both stats
    stats = torch.stack([mean, ok.to(torch.float64)]).cpu().numpy()
    return z, stats[0], stats[1] > 0.5
