"""The readers of the program's spans (`metrics/*.py` over
`hail_tpu_torch.utils.timer.spans()`): each on a synthetic run and spans,
its number and its None cases; and all of them on the spans of a real
traced run at a size the CPU holds."""

from types import SimpleNamespace

import pytest

from conftest import tiny_run
from gwasbench import run as run_mod

READERS = ['consts_ms_per_call.sweep', 'qr_ms_per_call.sweep',
           'pvalue_ms_per_call.sweep', 'part_ms.sweep',
           'fetch_mb_per_call.sweep', 'k3_roofline.sweep',
           'ship_ms_per_call.fresh', 'pack_ms_per_call.fresh']
# the readers that read spans only where partitions miss the device cache
FRESH_ONLY = {'ship_ms_per_call.fresh', 'pack_ms_per_call.fresh'}
MS = 1_000_000          # ns


def span(name, start_ms, end_ms, /, **attrs):
    from hail_tpu_torch.utils.timer import Span
    return Span(name, int(start_ms * MS), int(end_ms * MS), 0, 0, 0, 0,
                attrs)


def fake_run(device_ops=()):
    """Two calls, [1 s, 2 s] and [3 s, 4 s] on perf_counter, and a trace of
    the card."""
    return SimpleNamespace(
        calls=[dict(t0=1.0, t1=2.0), dict(t0=3.0, t1=4.0)],
        timeline=dict(busy_s=1.0, window_s=3.0,
                      device_ops=[list(o) for o in device_ops],
                      idle_gaps=[]))


@pytest.fixture
def spans(monkeypatch):
    from hail_tpu_torch.utils import timer
    box = []
    monkeypatch.setattr(timer, 'spans', lambda: list(box))
    return box


@pytest.mark.parametrize('metric,name', [
    ('consts_ms_per_call.sweep', 'linreg.consts'),
    ('qr_ms_per_call.sweep', 'linreg.qr'),
    ('pvalue_ms_per_call.sweep', 'linreg.pvalues'),
    ('ship_ms_per_call.fresh', 'part.ship'),
    ('pack_ms_per_call.fresh', 'ship.pack')])
def test_union_per_call(metric, name, spans):
    read = run_mod.reader(metric)
    spans += [span(name, 1100, 1300), span(name, 1200, 1400),    # 300 ms
              span(name, 1500, 1510),                             # 10 ms
              span(name, 3000, 3100),                             # 100 ms
              span(name, 2500, 2900),                   # between calls
              span('other', 1000, 2000)]
    assert read(fake_run()) == pytest.approx((310 + 100) / 2)


def test_part_ms_is_the_mean_partition(spans):
    read = run_mod.reader('part_ms.sweep')
    spans += [span('partition', 1100, 1110), span('partition', 1105, 1135),
              span('partition', 3000, 3020), span('partition', 2100, 2900),
              span('stage', 1000, 1900)]
    assert read(fake_run()) == pytest.approx(20.0)


def test_fetch_mb_sums_bytes_per_call(spans):
    read = run_mod.reader('fetch_mb_per_call.sweep')
    spans += [span('fetch', 1100, 1200, bytes=3_000_000, transfers=1),
              span('fetch', 1300, 1400, bytes=1_000_000, transfers=2),
              span('fetch', 3100, 3200, bytes=2_000_000, transfers=1),
              span('fetch', 4500, 4600, bytes=9_000_000, transfers=1)]
    assert read(fake_run()) == pytest.approx(3.0)


def test_k3_roofline_from_shapes_and_device_time(spans):
    read = run_mod.reader('k3_roofline.sweep')
    R, N, C = 24_576, 2_504, 42
    for t in (1100, 1200, 3100):
        spans.append(span('kernel', t, t + 1, name='hail_linreg_exact_pass',
                          rows=R, samples=N, cols=C))
    spans.append(span('kernel', 1300, 1301, name='hail_unpack_gt_2bit',
                      rows=R, samples=N))
    least = (2 * R * N + N * C + 4 * (2 * R * C + 3 * R)) / 3.35e12
    assert least > 2 * R * N * (C // 7) / 1.979e15        # bytes bound it
    ops = [('void (anonymous namespace)::linreg_exact_pass_kernel<3>('
            'signed char const*)', 3 * 2 * least),
           ('Memcpy DtoH (Device -> Pageable)', 1.0)]
    assert read(fake_run(ops)) == pytest.approx(50.0)
    # the ops bound where the shapes make it the larger
    R, N, C = 10**5, 10**5, 7_000
    spans[:] = [span('kernel', 1100, 1101, name='hail_linreg_exact_pass',
                     rows=R, samples=N, cols=C)]
    ops_s = 2 * R * N * (C // 7) / 1.979e15
    assert ops_s > (2 * R * N + N * C + 4 * (2 * R * C + 3 * R)) / 3.35e12
    assert read(fake_run([('linreg_exact_pass_kernel', 4 * ops_s)])) == \
        pytest.approx(25.0)


@pytest.mark.parametrize('metric', READERS)
def test_nothing_to_read(metric, spans, monkeypatch):
    """None without the spans (a program that records none, as the parent
    of this change), without a trace of the card, without calls."""
    read = run_mod.reader(metric)
    spans += [span('unrelated', 1100, 1200)]
    assert read(fake_run([('linreg_exact_pass_kernel', 1.0)])) is None
    spans += [span(n, 1100, 1200, name='hail_linreg_exact_pass', rows=8,
                   samples=8, cols=7, bytes=8)
              for n in ('linreg.consts', 'linreg.qr', 'linreg.pvalues',
                        'partition', 'fetch', 'kernel', 'part.ship',
                        'ship.pack')]
    ops = [('linreg_exact_pass_kernel', 1.0)]
    assert read(fake_run(ops)) is not None
    no_card = fake_run(ops)
    no_card.timeline = None
    assert read(no_card) is None
    no_calls = fake_run(ops)
    no_calls.calls = []
    assert read(no_calls) is None
    from hail_tpu_torch.utils import timer
    monkeypatch.delattr(timer, 'spans')
    assert read(fake_run(ops)) is None


@pytest.mark.parametrize('cell', ['kg.scan', 'kg.fresh'])
def test_readers_find_the_spans_of_a_traced_run(cell):
    """The names the readers look for are the ones the program records: a
    traced run at a size the CPU holds, its calls taken from the program's
    own call spans, and a made-up device time for K3, whose launches need
    the card. The ship's readers read only where partitions miss the
    device cache."""
    from hail_tpu_torch.utils import timer
    timer.clear()
    tiny_run(cell, trace=True)
    spans = timer.spans()
    by_action = {}
    for s in spans:
        by_action.setdefault(s.action, []).append(s)
    calls = [dict(t0=min(s.start_ns for s in ss) / 1e9,
                  t1=max(s.end_ns for s in ss) / 1e9)
             for ss in by_action.values()
             if any(s.name == 'linreg.call' for s in ss)]
    assert len(calls) >= 2
    run = SimpleNamespace(calls=sorted(calls, key=lambda c: c['t0']),
                          timeline=dict(device_ops=[], busy_s=0.0,
                                        window_s=1.0, idle_gaps=[]))
    got = {m: run_mod.reader(m)(run) for m in READERS}
    assert got.pop('k3_roofline.sweep') is None
    for m in FRESH_ONLY:
        v = got.pop(m)
        assert (v is not None and v > 0) if cell == 'kg.fresh' else v is None
    if cell == 'kg.fresh':
        # packing is a part of the ship
        ship = run_mod.reader('ship_ms_per_call.fresh')(run)
        assert run_mod.reader('pack_ms_per_call.fresh')(run) <= ship
    assert all(v is not None and v > 0 for v in got.values()), got
    # one phenotype over 512 variants: the (512, 5) f64 result a call
    assert got['fetch_mb_per_call.sweep'] == pytest.approx(512 * 5 * 8 / 1e6)
    timer.clear()
