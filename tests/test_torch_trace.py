"""The spans and counters the port records (hail_tpu_torch/utils/timer.py)
around `linear_regression_rows`, on the CPU: a call of 300 samples in 4
partitions, one phenotype and then a list, records every span of its path
with its parent, its action and its counts; partitions on pool threads
belong to the stage; nothing is recorded with recording off, nor in a
worker whose action started unrecorded; `timed()` still lists the stages;
a CPU `torch.profiler` turns recording on, and the spans land inside the
profiler's own events on its clock. The `kernel` spans need the card:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt
from hail_tpu_torch.utils import timer
from test_torch_slice import build_mt

N_SAMPLES, ROWS, PARTS = 300, 50, 4

# every span of the GWAS path but `kernel`, which only a launch on the card
# records, with the span that causes it
PARENTS = {
    'linreg.call': None, 'linreg.columns': 'linreg.call',
    'linreg.qr': 'linreg.call', 'linreg.consts': 'linreg.call',
    'consts.planes': 'linreg.consts',
    'consts.copy': 'linreg.consts', 'table.collect': 'linreg.call',
    'collect.memo': 'table.collect', 'stage': 'table.collect',
    'partition': 'stage', 'part.lookup': 'partition',
    'part.ship': 'part.lookup', 'ship.pack': 'part.ship',
    'ship.copy': 'part.ship', 'part.epilogue': 'partition',
    'fetch': ('stage', 'partition'), 'linreg.pvalues': 'partition',
}


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


@pytest.fixture
def mt():
    from hail_tpu_torch.ops import devcache
    devcache.clear()
    timer.clear()
    yield build_mt('hail_tpu_torch', seed=11, n_samples=N_SAMPLES, rows=ROWS,
                   parts=PARTS)
    timer.clear()


def _call(mt, y):
    """One call, its statistics read as columns."""
    res = hlt.linear_regression_rows(y=y, x=mt.GT.n_alt_alleles(),
                                     covariates=[1.0, mt.c0])
    return [np.asarray(b.columns['p_value'].values)
            for b in res._stage.collect_batches()]


def _calls(mt):
    return [_call(mt, mt.pheno), _call(mt, [mt.pheno, mt.c1])]


def test_every_span_appears_with_its_parent(mt):
    with timer.recording():
        _calls(mt)
    spans = timer.spans()
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} == set(PARENTS)
    for s in spans:
        want = PARENTS[s.name]
        got = by_id[s.parent].name if s.parent else None
        assert got == want or (isinstance(want, tuple) and got in want), \
            (s.name, got)
        assert s.end_ns >= s.start_ns
    calls = [s for s in spans if s.name == 'linreg.call']
    assert [(c.attrs['k'], c.attrs['P'], c.attrs['N']) for c in calls] == [
        (2, 1, N_SAMPLES), (2, 2, N_SAMPLES)]
    # the first call fills the device cache, the second finds it
    assert [s.attrs['hit'] for s in spans if s.name == 'part.lookup'] == \
        [False] * PARTS + [True] * PARTS
    assert len([s for s in spans if s.name == 'linreg.consts']) == 2
    copies = [s.attrs['bytes'] for s in spans if s.name == 'ship.copy']
    assert copies == [ROWS * -(-N_SAMPLES // 4)] * PARTS
    assert sorted(s.attrs['index'] for s in spans
                  if s.name == 'partition') == sorted(list(range(PARTS)) * 2)
    assert [s.attrs['rows'] for s in spans if s.name == 'linreg.pvalues'] \
        == [ROWS] * (2 * PARTS)


def test_partitions_run_in_the_stage_and_the_call(mt):
    with timer.recording():
        _calls(mt)
    spans = timer.spans()
    main = threading.get_ident()
    for call in (s for s in spans if s.name == 'linreg.call'):
        mine = [s for s in spans if s.action == call.action]
        (stage,) = [s for s in mine if s.name == 'stage']
        parts = [s for s in mine if s.name == 'partition']
        assert len(parts) == PARTS
        assert all(p.parent == stage.id for p in parts)
        assert {p.thread for p in parts} - {main}
        assert stage.attrs == {'partitions': PARTS}
        assert call.thread == stage.thread == main
    assert len({s.action for s in spans}) == 2


def test_fetch_counts_the_bytes_fetched(mt):
    with timer.recording():
        one, two = _calls(mt)
    spans = timer.spans()
    calls = [s.action for s in spans if s.name == 'linreg.call']
    fetched = [sum(s.attrs['bytes'] for s in spans
                   if s.name == 'fetch' and s.action == a) for a in calls]
    transfers = [sum(s.attrs['transfers'] for s in spans
                     if s.name == 'fetch' and s.action == a) for a in calls]
    rows = PARTS * ROWS
    # the (R, 1 + 4P) f64 result of each call: one stacked fetch for one
    # phenotype, one per partition for a list
    assert fetched == [rows * (1 + 4 * 1) * 8, rows * (1 + 4 * 2) * 8]
    assert transfers == [1, PARTS]
    assert sum(a.size for a in one) == rows
    assert sum(a.size for a in two) == rows * 2


def test_the_cpu_keeps_the_host_column_plane_and_its_cache(mt):
    """The CPU takes the card's column plane: one `linreg.qr` span per
    phenotype group (its rows and columns alone), the constants made anew
    in each call with no content key, and a repeated phenotype gives the
    same statistics."""
    with timer.recording():
        first, again = _call(mt, mt.pheno), _call(mt, mt.pheno)
        hlt.linear_regression_rows(
            y=[[mt.pheno], [mt.pheno, mt.c1]], x=mt.GT.n_alt_alleles(),
            covariates=[1.0, mt.c0])
    spans = timer.spans()
    assert [s.attrs for s in spans if s.name == 'linreg.qr'] == \
        [{'rows': N_SAMPLES, 'cols': 2}] * 4
    assert [s.attrs for s in spans if s.name == 'linreg.consts'] == [{}] * 2
    assert not [s for s in spans if s.name == 'consts.key']
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_nothing_is_recorded_with_recording_off(mt):
    _calls(mt)
    assert timer.spans() == []


def test_nothing_recorded_in_an_action_that_started_unrecorded(mt):
    """Recording turned on inside an action does not reach it, nor the
    pool threads its stage runs; nor a stage made by an unrecorded call and
    run later."""
    with timer.action():
        with timer.recording():
            _call(mt, mt.pheno)
    res = hlt.linear_regression_rows(y=mt.c1, x=mt.GT.n_alt_alleles(),
                                     covariates=[1.0])
    with timer.recording():
        res._stage.collect_batches()
    assert timer.spans() == []


def test_timed_lists_the_stages(mt):
    with timer.timed('gwas', log=False) as t:
        _calls(mt)
    stages = [n for n in t.root.children if n.name.startswith('stage ')]
    assert len(stages) == 2
    for n in stages:
        assert n.name.endswith(' (LocalBackend)') and n.total_s > 0
        assert n.meta['n_partitions'] == PARTS
    # another thread's timed() sees none of this thread's stages
    seen = []

    def other():
        with timer.timed('other', log=False) as t2:
            time.sleep(0.05)
        seen.append(t2.root.children)
    th = threading.Thread(target=other)
    th.start()
    _call(mt, mt.pheno)
    th.join(timeout=60)
    assert not th.is_alive() and seen == [[]]


def test_a_cpu_profiler_turns_recording_on(mt):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('test.call'):
            _call(mt, mt.pheno)
    (call,) = [s for s in timer.spans() if s.name == 'linreg.call']
    (collect,) = [s for s in timer.spans() if s.name == 'table.collect']
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == 'test.call']
    # on the profiler's clock the program's spans lie inside the event
    # that holds them (within 2 ms of clock reading)
    slack = 2_000_000
    assert ev.start_ns() - slack <= timer.trace_ns(call.start_ns)
    assert timer.trace_ns(collect.end_ns) <= \
        ev.start_ns() + ev.duration_ns() + slack
    # and after it, nothing more
    n = len(timer.spans())
    _call(mt, mt.pheno)
    assert len(timer.spans()) == n


def test_a_span_when_off_is_one_shared_no_op():
    assert timer.span('a') is timer.span('b', rows=3)
    with timer.span('a') as sp:
        sp.set(rows=1)
    assert timer.spans() == []
    # on, an attribute may be called `name`, as a kernel's is
    with timer.recording(), timer.action():
        with timer.span('kernel', name='k', rows=2):
            pass
    (s,) = timer.spans()
    assert (s.name, s.attrs) == ('kernel', {'name': 'k', 'rows': 2})
    timer.clear()


def test_device_cache_counts_every_lookup_from_many_threads():
    """Concurrent misses and hits from more threads than cores, with the
    interpreter switching threads as often as it can: no count is lost."""
    from hail_tpu_torch.ops import devcache

    class Anchor:
        pass
    anchors = [Anchor() for _ in range(8)]
    devcache.clear()
    n_threads, per_thread = 32, 200
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(per_thread):
                devcache.get(anchors[(i + j) % len(anchors)], ('t', j % 50),
                             lambda: torch.zeros(1))
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    st = devcache.stats()
    assert st['hits'] + st['misses'] == n_threads * per_thread
    assert st['misses'] >= len(anchors) * 50
    devcache.clear()


@pytest.mark.cuda
def test_kernel_spans_on_the_card():
    """Each launch is one `kernel` span with its name and shape."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (torch.cuda.is_available() is False)')
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    dev = torch.device('cuda', 0)
    R, N, C = 96, 1003, 21
    g = torch.Generator().manual_seed(3)
    u8 = torch.randint(0, 256, (R, -(-N // 4)), dtype=torch.uint8,
                       generator=g).to(dev)
    Wdig = torch.randint(-127, 128, (N, C), dtype=torch.int8,
                         generator=g).to(dev)
    timer.clear()
    before = dict(_kernels.launches)
    with timer.recording(), timer.action():
        gz8, m8 = li.unpack_gt_2bit(u8, N)
        li.exact_pass(gz8, m8, li.exact_operand(Wdig))
    torch.cuda.synchronize()
    kernels = [(s.attrs.pop('name'), s.attrs) for s in timer.spans()
               if s.name == 'kernel']
    assert kernels == [
        ('hail_unpack_gt_2bit', {'rows': R, 'samples': N}),
        ('hail_linreg_exact_pass', {'rows': R, 'samples': N, 'cols': C})]
    assert {k: v - before[k] for k, v in _kernels.launches.items()
            if v != before[k]} == {'hail_unpack_gt_2bit': 1,
                                   'hail_linreg_exact_pass': 1}
    timer.clear()
