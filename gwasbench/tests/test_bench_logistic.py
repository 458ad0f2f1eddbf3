"""The cell `ukb.logistic` at a size the CPU holds, with its own spec: 3,000
samples (at `tiny_spec`'s 600 the liability threshold leaves 8-33 cases,
too few for the null fit), 512 variants in 4 partitions. Its run is
correct; the float32 control fails its limit; a run with the converged
flags flipped, the threshold off by 0.1, or the phenotypes of the first
call for every call is not correct; and the three readers of the GLM's
spans read a traced run (and read nothing without them)."""

from types import SimpleNamespace

import numpy as np
import pytest

from conftest import tiny_run
from gwasbench import check, run

CELL = 'ukb.logistic'
READERS = ['null_ms_per_call.logistic', 'newton_ms_per_call.logistic',
           'newton_roofline.logistic']


def logistic_spec():
    spec = run.cell_spec(CELL)
    spec.config['samples'] = 3000
    spec.traffic['partitions'] = 4
    spec.traffic['variants'] = 512
    return spec


def test_logistic_run_is_correct_and_the_control_is_not():
    seen = {}
    out = tiny_run(CELL, spec=logistic_spec(), on_check=lambda jobs, wl:
                   seen.update(control=check.control(wl.method, jobs, wl.C)))
    assert out['correct'], out['checks']
    checks = out['checks']
    assert checks['n_wrong']['value'] == checks['rows_bad']['value'] == 0
    assert checks['cache_faults']['value'] == 0
    assert checks['calls_checked']['value'] >= 1
    assert checks['max_rel_err']['value'] <= checks['max_rel_err']['limit']
    assert max(seen['control'].values()) > checks['max_rel_err']['limit']


def _flip_converged(real):
    """Every converged fit reported as stopped at max_iterations."""
    def fn(*a, **kw):
        out = real(*a, **kw)
        if 'status' in out:
            out['status'] = np.where(out['status'] == 1, 3, out['status'])
        return out
    return fn


def _stale(real):
    first = []

    def fn(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0]
    return fn


def _threshold_off(real_find):
    """The method's call made on y - 0.1: cases where y > 2.6, while the
    reference binarises at 2.5."""
    def find(kind, name):
        mod = real_find(kind, name)
        if kind == 'methods':
            real_call = mod.call

            def call(hl, mt, x, ys, covariates, label):
                return real_call(hl, mt, x, [y - 0.1 for y in ys],
                                 covariates, label)
            mod.call = call
        return mod
    return find


FAULTS = {
    'converged_flipped': ('hail_tpu_torch.ops.glm_device',
                          'logistic_rows_device', _flip_converged),
    'threshold_off': ('gwasbench.run', 'find', _threshold_off),
    # a state returned unchanged: the first call's phenotype and
    # covariates for every later call
    'stale_phenotypes': ('hail_tpu_torch.methods.statgen',
                         '_glm_column_setup', _stale),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_broken_logistic_path_is_not_correct(fault, monkeypatch):
    import importlib
    module, attr, breaker = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, breaker(getattr(mod, attr)))
    out = tiny_run(CELL, spec=logistic_spec())
    assert not out['correct'], (fault, out['checks'])


MS = 1_000_000          # ns


def _span(name, start_ms, end_ms, **attrs):
    from hail_tpu_torch.utils.timer import Span
    return Span(name, int(start_ms * MS), int(end_ms * MS), 0, 0, 0, 0,
                attrs)


def _fake_run():
    return SimpleNamespace(
        calls=[dict(t0=1.0, t1=2.0), dict(t0=3.0, t1=4.0)],
        timeline=dict(busy_s=1.0, window_s=3.0, device_ops=[],
                      idle_gaps=[]))


@pytest.fixture
def spans(monkeypatch):
    from hail_tpu_torch.utils import timer
    box = []
    monkeypatch.setattr(timer, 'spans', lambda: list(box))
    return box


def test_newton_roofline_from_row_iters(spans):
    """Two overlapping blocks of one call and one of the next: their least
    times, 864 f64 flops an active row and sample at k = 26 at 67 TFLOP/s,
    over the union of the spans."""
    read = run.reader('newton_roofline.logistic')
    N, k = 361_194, 26
    attrs = dict(samples=N, covariates=k, rows=512, iterations=7)
    spans += [_span('glm.newton', 1100, 1300, row_iters=2000, **attrs),
              _span('glm.newton', 1200, 1400, row_iters=1000, **attrs),
              _span('glm.newton', 3000, 3100, row_iters=3000, **attrs),
              _span('glm.null', 1000, 1100)]
    least = 6000 * N * 864 / 67e12
    assert least > 6000 * N / 4 / 3.35e12           # compute bounds it
    assert read(_fake_run()) == pytest.approx(100 * least / 0.4)
    # bytes bound a block at k = 0: 2 * (1 + 2) = 6 flops against 1/4 B
    spans[:] = [_span('glm.newton', 1100, 1200, row_iters=10, samples=N,
                      covariates=0, rows=10, iterations=1)]
    assert read(_fake_run()) == pytest.approx(
        100 * max(10 * N * 6 / 67e12, 10 * N / 4 / 3.35e12) / 0.1)


@pytest.mark.parametrize('metric,name', [
    ('null_ms_per_call.logistic', 'glm.null'),
    ('newton_ms_per_call.logistic', 'glm.newton')])
def test_glm_unions_per_call(metric, name, spans):
    read = run.reader(metric)
    spans += [_span(name, 1100, 1300), _span(name, 1200, 1400),
              _span(name, 3000, 3100), _span(name, 2500, 2900),
              _span('other', 1000, 2000)]
    assert read(_fake_run()) == pytest.approx((300 + 100) / 2)


@pytest.mark.parametrize('metric', READERS)
def test_glm_readers_read_nothing_without_their_spans(metric, spans,
                                                      monkeypatch):
    """None for a program that records no GLM span (one older than these
    spans), without a trace of the card, or without calls."""
    read = run.reader(metric)
    spans += [_span('linreg.qr', 1100, 1200)]
    assert read(_fake_run()) is None
    spans += [_span(n, 1100, 1200, row_iters=8, samples=8, covariates=2,
                    rows=8, iterations=1)
              for n in ('glm.null', 'glm.newton')]
    assert read(_fake_run()) is not None
    no_card = _fake_run()
    no_card.timeline = None
    assert read(no_card) is None
    no_calls = _fake_run()
    no_calls.calls = []
    assert read(no_calls) is None
    from hail_tpu_torch.utils import timer
    monkeypatch.delattr(timer, 'spans')
    assert read(_fake_run()) is None


def test_readers_find_the_spans_of_a_traced_logistic_run():
    """The GLM readers, and the existing readers attached to the cell that
    read spans, on the spans of a traced run on the CPU, its calls taken
    from the program's own `glm.call` actions."""
    from hail_tpu_torch.utils import timer
    timer.clear()
    out = tiny_run(CELL, spec=logistic_spec(), trace=True, seconds=3.0)
    assert out['correct'], out['checks']
    by_action = {}
    for s in timer.spans():
        by_action.setdefault(s.action, []).append(s)
    calls = [dict(t0=min(s.start_ns for s in ss) / 1e9,
                  t1=max(s.end_ns for s in ss) / 1e9)
             for ss in by_action.values()
             if any(s.name == 'glm.call' for s in ss)]
    assert calls
    fake = SimpleNamespace(calls=sorted(calls, key=lambda c: c['t0']),
                           timeline=dict(device_ops=[], busy_s=0.0,
                                         window_s=1.0, idle_gaps=[]))
    got = {m: run.reader(m)(fake) for m in READERS + [
        'part_ms.sweep', 'fetch_mb_per_call.sweep']}
    assert all(v is not None and v > 0 for v in got.values()), got
    # a CPU's time against the card's peaks: no share to read, only that
    # it is a number
    assert np.isfinite(got['newton_roofline.logistic'])
    # per partition of 128 rows: b (27), n_iter, ll, status, se and z
    assert got['fetch_mb_per_call.sweep'] == pytest.approx(
        512 * (27 + 5) * 8 / 1e6)
    timer.clear()
