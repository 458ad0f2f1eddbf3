"""Per-variant QC counters in one pass (port of hail_tpu/ops/qc.py).

`variant_qc_block` computes every counter `methods/qc.variant_qc` needs
from one (R, C) block of packed calls: n_called, n_het, the diploid
hom-ref and hom-var counts, n_non_ref, AN, the allele counts AC and
homozygote_count (R, A), and for DP and GQ when present their sum, sum of
squares, count, min and max over the defined values. On a CUDA tensor it
launches K5 (`csrc/variant_qc.cu`), a hand-written kernel that reads the
block once; on a CPU tensor it runs `_variant_qc_ref`, the reference's
one-hot formulas in plain torch. There is no fallback from the one to the
other: a refused build or launch raises.

The packed call layout is genetics/call.py's: ploidy `& 3`, allele j
`>> 3 & 0x3FFF`, allele k `>> 17 & 0x7FFF`. Alleles at or above A =
`max_alleles` are counted in no AC column, as in the reference.

The kernel's results are bit-equal to the plain version's: the counts
always, and the f64 sums of DP and GQ and of their squares while every
partial sum of squares is an exact integer, that is while C * max(DP)^2
< 2^53 (and the same for GQ). Past that both round, in different orders.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..genetics.call import J_MASK, J_SHIFT, K_MASK, K_SHIFT, PLOIDY_MASK
from . import _kernels

# the per-row counters in the order of K5's int32 output rows
_COUNTS = ('n_called', 'n_het', 'n_hom_ref_diploid', 'n_hom_var_diploid',
           'n_non_ref', 'AN', 'dp_n', 'gq_n')
# and of its f64 output rows
_STATS = ('dp_sum', 'dp_sumsq', 'dp_min', 'dp_max',
          'gq_sum', 'gq_sumsq', 'gq_min', 'gq_max')
# K5 holds each count of a row in an int32: C entries, AN up to 3 C
_MAX_COLS = (1 << 31) // 3 - 1
# K5's launch: each warp of the grid takes one segment of one row; the
# card holds _RESIDENT_WARPS_PER_SM of them a SM at once: two blocks of 256
# threads, as csrc/variant_qc.cu's `kThreads` and `__launch_bounds__(kThreads,
# 2)` set (its 95-123 registers leave no room for a third; the C entry point
# counts the blocks and refuses a grid past the launch limit). Segments are
# at least _MIN_SEG entries (fewer only in a shorter row).
_RESIDENT_WARPS_PER_SM = 16
_MIN_SEG = 2_048
_MAX_ROUNDS = 4


def _launch_plan(R: int, C: int, n_sms: int):
    """(seg_len, n_segs) of K5's launch over an (R, C) block on a card of
    `n_sms` SMs. Warp w of the grid (warps at or past R * n_segs idle)
    takes row w // n_segs, columns [s * seg_len, min(C, (s + 1) * seg_len))
    with s = w % n_segs.

    The card holds _RESIDENT_WARPS_PER_SM warps a SM at once, so R * n_segs
    warps of equal work run in rounds, and the last round's idle slots are
    time lost. n_segs (1 up to what _MIN_SEG and _MAX_ROUNDS allow) is
    the fewest that fill the rounds within 1% of the best. seg_len is a
    multiple of 16, so the segments of a row that starts aligned start
    aligned too; a row of no columns still has its one segment, which
    writes nothing."""
    cap = _RESIDENT_WARPS_PER_SM * n_sms
    rows = max(R, 1)
    most = max(1, min(C // _MIN_SEG, -(-_MAX_ROUNDS * cap // rows)))
    fill = [rows * n / (-(-rows * n // cap) * cap) for n in range(1, most + 1)]
    n_segs = next(n for n, f in enumerate(fill, 1) if f >= 0.99 * max(fill))
    per_seg = -(-C // n_segs)
    seg_len = max(16, -(-per_seg // 16) * 16)
    return seg_len, max(1, -(-C // seg_len))


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _field_stats(prefix, v: torch.Tensor, out: dict) -> None:
    ok = v >= 0
    vf = v.to(torch.float64)
    inf = torch.tensor(float('inf'), dtype=torch.float64, device=v.device)
    out[f'{prefix}_sum'] = torch.where(ok, vf, 0.0).sum(dim=1)
    out[f'{prefix}_sumsq'] = torch.where(ok, vf * vf, 0.0).sum(dim=1)
    out[f'{prefix}_n'] = ok.sum(dim=1)
    if v.shape[1]:
        out[f'{prefix}_min'] = torch.where(ok, vf, inf).amin(dim=1)
        out[f'{prefix}_max'] = torch.where(ok, vf, -inf).amax(dim=1)
    else:
        out[f'{prefix}_min'] = inf.expand(v.shape[0]).clone()
        out[f'{prefix}_max'] = (-inf).expand(v.shape[0]).clone()


def _variant_qc_ref(packed: torch.Tensor, missing: torch.Tensor,
                    dp: Optional[torch.Tensor], gq: Optional[torch.Tensor],
                    max_alleles: int, has_dp: bool, has_gq: bool
                    ) -> Dict[str, torch.Tensor]:
    """The plain version: hail_tpu/ops/qc.py:31-71 in torch, int64 counts
    and f64 sums."""
    called = ~missing
    ploidy = packed & PLOIDY_MASK
    j = (packed >> J_SHIFT) & J_MASK
    k = (packed >> K_SHIFT) & K_MASK
    diploid = called & (ploidy == 2)
    out = {
        'n_called': called.sum(dim=1),
        'n_het': (diploid & (j != k)).sum(dim=1),
        'n_hom_ref_diploid': (diploid & (j == 0) & (k == 0)).sum(dim=1),
        'n_hom_var_diploid': (diploid & (j == k) & (j > 0)).sum(dim=1),
        'n_non_ref': (called & ((j > 0) | ((ploidy == 2) & (k > 0)))).sum(dim=1),
        'AN': torch.where(called, ploidy, 0).to(torch.int64).sum(dim=1),
    }
    alleles = torch.arange(max_alleles, dtype=packed.dtype, device=packed.device)
    jeq = j[..., None] == alleles
    jc = jeq & (called & (ploidy >= 1))[..., None]
    kc = (k[..., None] == alleles) & (called & (ploidy == 2))[..., None]
    out['AC'] = jc.sum(dim=1) + kc.sum(dim=1)
    out['homozygote_count'] = (jeq & (diploid & (j == k))[..., None]).sum(dim=1)
    if has_dp:
        _field_stats('dp', dp, out)
    if has_gq:
        _field_stats('gq', gq, out)
    return out


def variant_qc_block(packed: torch.Tensor, missing: torch.Tensor,
                     dp: Optional[torch.Tensor], gq: Optional[torch.Tensor],
                     max_alleles: int, has_dp: bool, has_gq: bool
                     ) -> Dict[str, torch.Tensor]:
    """Every per-variant QC counter of one block, with the reference's keys.

    packed: (R, C) int32 calls; missing: (R, C) bool; dp, gq: (R, C) int32
    with their missing values folded in as -1 by the caller, read only
    when `has_dp` / `has_gq`. Counts come back as int32 from the kernel
    (int64 from the plain version), sums, min and max as f64 (±inf in a
    row with no defined value)."""
    if packed.device.type == 'cpu':
        return _variant_qc_ref(packed, missing, dp, gq, max_alleles,
                               has_dp, has_gq)
    if packed.dim() != 2:
        raise ValueError(f'variant_qc_block: packed must be (R, C), got '
                         f'{tuple(packed.shape)}')
    R, C = packed.shape
    max_alleles = int(max_alleles)
    _kernels.check(packed, 'variant_qc_block/packed', torch.int32)
    _kernels.check(missing, 'variant_qc_block/missing', torch.bool, (R, C))
    if has_dp:
        _kernels.check(dp, 'variant_qc_block/dp', torch.int32, (R, C))
    if has_gq:
        _kernels.check(gq, 'variant_qc_block/gq', torch.int32, (R, C))
    if C > _MAX_COLS:
        raise ValueError(f'variant_qc_block: {C} columns overflow the int32 '
                         f'counts (at most {_MAX_COLS})')
    if max_alleles < 0:
        raise ValueError(f'variant_qc_block: max_alleles {max_alleles} < 0')
    dev = packed.device
    # K5 adds each segment of a row into its outputs: the counts start at 0
    # (one allocation), the statistics at 0, min at +inf and max at -inf
    ints = torch.zeros(len(_COUNTS) * R + 2 * R * max_alleles,
                       dtype=torch.int32, device=dev)
    counts = ints[:len(_COUNTS) * R].view(len(_COUNTS), R)
    ac, hom = ints[len(_COUNTS) * R:].view(2, R, max_alleles)
    stats = torch.empty((len(_STATS), R), dtype=torch.float64, device=dev)
    per_field = stats.view(2, 4, R)      # (DP, GQ) x (sum, sumsq, min, max)
    per_field[:, :2].zero_()
    per_field[:, 2].fill_(float('inf'))
    per_field[:, 3].fill_(float('-inf'))
    if R:
        seg_len, n_segs = _launch_plan(R, C, _n_sms(dev.index or 0))
        _kernels.launch('hail_variant_qc', packed.data_ptr(),
                        missing.data_ptr(),
                        dp.data_ptr() if has_dp else None,
                        gq.data_ptr() if has_gq else None,
                        R, C, max_alleles, int(has_dp) | 2 * int(has_gq),
                        seg_len, n_segs, counts.data_ptr(), ac.data_ptr(),
                        hom.data_ptr(), stats.data_ptr())
    out = {name: counts[i] for i, name in enumerate(_COUNTS[:6])}
    out['AC'] = ac
    out['homozygote_count'] = hom
    for prefix, flag in (('dp', has_dp), ('gq', has_gq)):
        if flag:
            out[f'{prefix}_n'] = counts[_COUNTS.index(f'{prefix}_n')]
            for key in ('sum', 'sumsq', 'min', 'max'):
                out[f'{prefix}_{key}'] = stats[_STATS.index(f'{prefix}_{key}')]
    return out


def _sentinel(v, miss) -> np.ndarray:
    if miss is None:
        return np.asarray(v, dtype=np.int32)
    return np.where(miss, -1, v).astype(np.int32)


def run_variant_qc_block(packed: np.ndarray, missing: np.ndarray,
                         dp=None, dp_missing=None, gq=None, gq_missing=None,
                         max_alleles: int = 2):
    """Host wrapper: fold missing DP/GQ into the -1 sentinel, run the block
    on the session's device, return numpy with the reference's types
    (int64 counts, f64 sums)."""
    from ..context import current_device
    dev = current_device()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = variant_qc_block(
        put(np.asarray(packed, dtype=np.int32)), put(np.asarray(missing, bool)),
        None if dp is None else put(_sentinel(dp, dp_missing)),
        None if gq is None else put(_sentinel(gq, gq_missing)),
        int(max_alleles), dp is not None, gq is not None)
    res = {}
    for k, v in out.items():
        a = v.cpu().numpy()
        res[k] = a.astype(np.int64) if a.dtype.kind in 'iub' else a
    return res
