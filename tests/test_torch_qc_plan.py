"""K5's launch plan (`hail_tpu_torch.ops.qc._launch_plan`), on the CPU.

The kernel maps warp w of its grid to row w // n_segs and columns
[s * seg_len, min(C, (s + 1) * seg_len)), s = w % n_segs, as the plan's
docstring states. Here every column of every row is covered by exactly one
warp, no segment but a row's last is cut short, and the grid of blocks the
kernel's C entry point counts fits a launch.
"""

import os
import re

import numpy as np
import pytest

from hail_tpu_torch.ops import qc

H100_SMS = 132
_SOURCE = os.path.join(os.path.dirname(qc.__file__), os.pardir, 'csrc',
                       'variant_qc.cu')


def _kernel_geometry():
    """(warps a block, blocks a SM) as csrc/variant_qc.cu sets them:
    `kThreads` and the second argument of its `__launch_bounds__`."""
    with open(_SOURCE) as f:
        src = f.read()
    threads = int(re.search(r'constexpr int kThreads = (\d+);', src).group(1))
    per_sm = re.findall(r'__launch_bounds__\(kThreads, (\d+)\)', src)
    assert len(per_sm) == 1
    return threads // 32, int(per_sm[0])


WARPS, BLOCKS_PER_SM = _kernel_geometry()


def _check_plan(R, C, n_sms):
    seg_len, n_segs = qc._launch_plan(R, C, n_sms)
    assert seg_len > 0 and seg_len % 16 == 0
    n_warps = R * n_segs
    # the entry point's grid: one warp a segment, blocks of WARPS warps
    blocks = -(-n_warps // WARPS)
    assert 1 <= blocks <= (1 << 31) - 1
    # no segment starts at or past the end of its row (a row of no columns
    # keeps its one, empty, segment)
    assert (n_segs - 1) * seg_len < max(C, 1) <= n_segs * seg_len or C == 0
    s = np.arange(n_segs, dtype=np.int64)
    c0 = np.minimum(s * seg_len, C)
    c1 = np.minimum(C, c0 + seg_len)
    # the segments of a row tile [0, C): they start at 0, each begins where
    # the one before ends, the last ends at C, none is empty but in a row
    # of no columns; every row has the same segments
    assert c0[0] == 0 and c1[-1] == C
    assert np.array_equal(c0[1:], c1[:-1])
    assert (c1 > c0).all() or C == 0
    assert int((c1 - c0).sum()) == C
    # segments are at least _MIN_SEG long, unless the row is shorter
    assert (c1 - c0)[:-1].min(initial=seg_len) >= min(C, qc._MIN_SEG)
    # the warps of the grid: each row has n_segs of them, in order
    w = np.arange(n_warps, dtype=np.int64)
    rows, segs = w // n_segs, w % n_segs
    assert np.array_equal(np.bincount(rows, minlength=R), np.full(R, n_segs))
    assert np.array_equal(segs.reshape(R, n_segs),
                          np.broadcast_to(s, (R, n_segs)))
    return seg_len, n_segs


@pytest.mark.parametrize('C', [0, 1, 15, 16, 10_001, 200_003])
@pytest.mark.parametrize('R', [1, 7, 256, 2_048, 70_000])
def test_launch_plan_covers_every_entry_once(R, C):
    _check_plan(R, C, H100_SMS)


@pytest.mark.parametrize('n_sms', [1, 16, 132, 1_000])
def test_launch_plan_fills_the_card(n_sms):
    """Rows are split only as far as segments of _MIN_SEG entries and
    _MAX_ROUNDS rounds of resident warps allow; where that can give a full
    round, the rounds are filled to within 1% of at least half."""
    cap = qc._RESIDENT_WARPS_PER_SM * n_sms
    for R, C in [(1, 200_003), (256, 100_000), (2_048, 10_000),
                 (130, 40_000), (1_100, 10_001), (70_000, 16), (7, 15)]:
        seg_len, n_segs = _check_plan(R, C, n_sms)
        most = max(1, min(C // qc._MIN_SEG, -(-qc._MAX_ROUNDS * cap // R)))
        assert n_segs <= most
        if n_segs > 1:
            assert seg_len >= qc._MIN_SEG
        warps = R * n_segs
        if R * most >= cap:
            assert warps / (-(-warps // cap) * cap) >= 0.99 * 0.5


def test_launch_plan_at_the_main_path_shapes():
    """The plans the source note of csrc/variant_qc.cu states: a warp a row
    at one partition of phase_qc (2,048 warps, 0.97 of a round on 132 SMs),
    33 segments a row at 256 x 100,000 (8,448 warps, four full rounds)."""
    assert qc._launch_plan(2_048, 10_000, H100_SMS) == (10_000, 1)
    assert qc._launch_plan(256, 100_000, H100_SMS) == (3_040, 33)


def test_launch_plan_residency_is_the_kernels():
    """The plan's resident warps a SM are the kernel's: blocks of kThreads
    threads, as many a SM as its launch bounds ask."""
    assert qc._RESIDENT_WARPS_PER_SM == WARPS * BLOCKS_PER_SM
