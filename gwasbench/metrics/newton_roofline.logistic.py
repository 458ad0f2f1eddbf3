"""newton_roofline.logistic: the Newton loops' least time on one H100 as a
share of the time they took, in percent (program span).

The loops are the traced calls' `glm.newton` spans, which
`hail_tpu_torch.utils.timer` records for each block with its shape (N
samples, k covariates) and `row_iters`, the rows still active summed over
its iterations. An active row's iteration needs, for each sample, the
Fisher matrix's (k + 1)(k + 2) / 2 distinct entries, the k + 1 entries of
the score and the k + 1 of the linear predictor: 2 ((k + 1)(k + 2) / 2 +
2 (k + 1)) f64 flops (864 at k = 26), at 67 TFLOP/s; and the genotypes'
information at 2 bits an entry, N / 4 bytes, at 3.35 TB/s. A block's
least time is the larger of the two. These counts are f64 work, a lower
bound for any implementation of this arithmetic: one that skips the rows
that have stopped, shares the Fisher matrix's symmetric half or fuses
every pass cannot push the share over 100%.

The share is the sum of the blocks' least times over the union of the same
spans, over the calls. A span goes with the call whose [t0, t1] holds its
start. Nothing where the program records no such span, or where the run
has no trace of the card (a time is read on the card only)."""

import bisect

from gwasbench.trace import _intervals_union

F64_FLOPS_PER_S = 67e12
BYTES_PER_S = 3.35e12


def flops_per_row_sample(k: int) -> int:
    m = k + 1
    return 2 * (m * (m + 1) // 2 + 2 * m)


def least_s(row_iters: int, N: int, k: int) -> float:
    return max(row_iters * N * flops_per_row_sample(k) / F64_FLOPS_PER_S,
               row_iters * N / 4 / BYTES_PER_S)


def read(run):
    try:
        from hail_tpu_torch.utils.timer import spans
    except ImportError:
        return None
    if not run.timeline or not run.calls:
        return None
    starts = [r['t0'] * 1e9 for r in run.calls]
    per_call = [[] for _ in run.calls]
    least = 0.0
    for s in spans():
        i = bisect.bisect_right(starts, s.start_ns) - 1
        if (s.name == 'glm.newton' and i >= 0
                and s.start_ns <= run.calls[i]['t1'] * 1e9
                and 'row_iters' in s.attrs):
            per_call[i].append((s.start_ns, s.end_ns))
            least += least_s(s.attrs['row_iters'], s.attrs['samples'],
                             s.attrs['covariates'])
    took_ns = sum(e - s for iv in per_call for s, e in _intervals_union(iv))
    if not took_ns:
        return None
    return 100.0 * least / (took_ns / 1e9)
