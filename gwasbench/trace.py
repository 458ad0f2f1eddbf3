"""What a `--trace 1` run reads: spans around the program's layers, and the
device's timeline.

`Probes` wraps, for the traced window only, a few functions of the program
in spans of the benchmark's own on the host clock, from whichever thread
calls them, and collects per call the backend stages' walls that
`hail_tpu_torch.utils.timer` records. `device_timeline` reduces the profiler's
events to the device's busy time (the union of its kernels, copies and
fills), the operations that took most of it, and the idle gaps named by the
innermost span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import List, Optional

PREFIX = 'gwasbench.'


class Probes:
    def __init__(self):
        self._real = []
        # (start ns, end ns, name) on the host clock, from every thread
        self.spans: List[tuple] = []

    @contextlib.contextmanager
    def label(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.perf_counter_ns(), name))

    def _wrap(self, owner, attr: str, name: str):
        real = getattr(owner, attr)
        label = self.label

        def fn(*a, **kw):
            with label(name):
                return real(*a, **kw)
        self._real.append((owner, attr, real))
        setattr(owner, attr, fn)

    def install(self) -> None:
        import numpy as np
        from hail_tpu_torch.backend.backend import Backend
        from hail_tpu_torch.methods import statgen
        from hail_tpu_torch.ops import fetchgroup, linreg_i8
        self._wrap(statgen, '_eval_col_f64', 'columns')
        self._wrap(np.linalg, 'qr', 'qr')
        self._wrap(statgen, '_exact_consts_cached', 'consts')
        self._wrap(Backend, 'map_collect', 'stage')
        self._wrap(linreg_i8, 'linreg_block_gz_exact_packed', 'kernels')
        self._wrap(linreg_i8, '_finish_stats_packed', 'finish')
        self._wrap(fetchgroup, 'flush', 'fetch')

    def phases(self) -> dict:
        """Mean host milliseconds per call in each span, the spans of a
        name that overlap (the partitions' threads) counted once."""
        calls = sorted((a, b) for a, b, n in self.spans if n == 'call')
        by = defaultdict(list)
        for a, b, n in self.spans:
            if n != 'call':
                by[n].append((a, b))
        out = {}
        for n, iv in by.items():
            out[n] = sum(e - s for s, e in _intervals_union(iv)) / 1e6 \
                / max(len(calls), 1)
        return out

    def remove(self) -> None:
        for owner, attr, real in reversed(self._real):
            setattr(owner, attr, real)
        self._real = []

    @contextlib.contextmanager
    def call(self, record: dict):
        """Around one call: its stage walls go into `record`. The call is also a profiler span (`gwasbench.call`), which
        places the host spans on the trace's clock."""
        from torch.profiler import record_function
        from hail_tpu_torch.utils.timer import timed
        with record_function(PREFIX + 'call'), self.label('call'):
            with timed('gwasbench.call', log=False) as timer:
                yield
        record['stage_s'] = sum(n.total_s for n in timer.root.children
                                if n.name.startswith('stage '))


def _intervals_union(iv: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_ms_per_call(run, name: str):
    """The milliseconds of a traced call covered by the program's spans
    named `name` (`hail_tpu_torch.utils.timer`), counted once where they
    overlap (spans from several threads), averaged over the calls. A span
    goes with the call whose [t0, t1] holds its start. None where the
    program records no such span, or where the run has no trace of the
    card (a time is read on the card only)."""
    try:
        from hail_tpu_torch.utils.timer import spans
    except ImportError:
        return None
    if not run.timeline or not run.calls:
        return None
    starts = [r['t0'] * 1e9 for r in run.calls]
    per_call = [[] for _ in run.calls]
    for s in spans():
        i = bisect.bisect_right(starts, s.start_ns) - 1
        if (s.name == name and i >= 0
                and s.start_ns <= run.calls[i]['t1'] * 1e9):
            per_call[i].append((s.start_ns, s.end_ns))
    if not any(per_call):
        return None
    return sum(e - s for iv in per_call for s, e in _intervals_union(iv)) \
        / 1e6 / len(run.calls)


def _on_trace_clock(host_spans: List[tuple], calls: List[tuple]):
    """The host spans moved onto the trace's clock, call by call: each
    call's host span is mapped linearly onto its profiler span (the two
    clocks need not run at one rate), and a span goes with the last call
    that started before it."""
    host_calls = sorted((a, b) for a, b, n in host_spans if n == 'call')
    if not calls or len(calls) != len(host_calls):
        return None
    pairs = list(zip(host_calls, sorted(calls)))
    starts = [h[0] for h, _ in pairs]
    out = []
    for a, b, n in host_spans:
        (h0, h1), (k0, k1) = pairs[max(bisect.bisect_right(starts, a) - 1,
                                       0)]
        scale = (k1 - k0) / (h1 - h0) if h1 > h0 else 1.0
        out.append((k0 + (a - h0) * scale, k0 + (b - h0) * scale, n))
    return sorted(out)


def _innermost(spans: List[tuple], w0, w1):
    """(start, end, name) stretches of [w0, w1], each named by the innermost
    span open in it, or 'between calls' where none is."""
    points = sorted({w0, w1} | {p for a, b, _ in spans for p in (a, b)
                                if w0 < p < w1})
    out, open_, nxt = [], [], 0
    for a, b in zip(points, points[1:]):
        while nxt < len(spans) and spans[nxt][0] <= a:
            open_.append(spans[nxt])
            nxt += 1
        open_ = [sp for sp in open_ if sp[1] > a]
        out.append((a, b, max(open_)[2] if open_ else 'between calls'))
    return out


def _overlap(busy: List[tuple], a, b) -> float:
    """How much of [a, b] the sorted, disjoint intervals `busy` cover."""
    i = bisect.bisect_right(busy, (a, float('inf'))) - 1
    total = 0.0
    for s, e in busy[max(i, 0):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def device_timeline(prof, host_spans: List[tuple]) -> Optional[dict]:
    """busy_s, window_s, the device operations that took most time and the
    idle gaps by host span, from a finished `torch.profiler.profile` and the
    probes' host spans. The window runs from the first call's start to the
    last call's end. None where the trace holds no device operation."""
    dev, calls = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = 'cuda' in str(e.device_type()).lower()
        if name == PREFIX + 'call' and not on_device:
            calls.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif on_device and not (e.is_user_annotation()
                                or name.startswith(PREFIX)):
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    spans = _on_trace_clock(host_spans, calls)
    if not dev or not spans:
        return None
    w0 = min(s[0] for s in spans if s[2] == 'call')
    w1 = max(s[1] for s in spans if s[2] == 'call')
    clipped = [(max(s, w0), min(e, w1)) for s, e, _ in dev if e > w0 and s < w1]
    busy = _intervals_union(clipped)
    busy_ns = sum(e - s for s, e in busy)
    by_op = defaultdict(float)
    for s, e, name in dev:
        if e > w0 and s < w1:
            by_op[name] += (min(e, w1) - max(s, w0)) / 1e9
    # the idle time of each stretch of the window, named by the innermost
    # host span open in it: the latest started of those open (the
    # partitions' threads overlap)
    by_gap = defaultdict(float)
    for a, b, name in _innermost(spans, w0, w1):
        by_gap[name] += (b - a - _overlap(busy, a, b)) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in idle])
