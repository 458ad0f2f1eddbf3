"""A run as a whole, at a size the CPU holds: its check passes on the
program, fails on the control and on each fault the cells can have, the run
refuses to start without a card, no JAX module is let through, and the
trace reduction reads busy time and idle gaps."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT, tiny_run
from gwasbench import check, run, trace

CELLS = ['ukb.sweep', 'kg.scan', 'kg.fresh']


@pytest.mark.parametrize('cell', CELLS)
def test_program_passes_and_control_fails(cell):
    """The program's numbers within the cell's limits; the control, the
    reference in float32 in the program's place, above the limit."""
    seen = {}
    out = tiny_run(cell, on_check=lambda jobs, wl: seen.update(
        control=check.control(wl.method, jobs, wl.C)))
    assert out['correct'], out['checks']
    limit = out['checks']['max_rel_err']['limit']
    assert out['checks']['max_rel_err']['value'] <= limit
    assert max(seen['control'].values()) > limit
    assert list(out)[-1] == 'checks'
    assert out['attempted'] >= out['checks']['calls_checked']['value']


def _scale_beta(real):
    def fn(*a, **kw):
        sum_x, ytx, beta, se, t = real(*a, **kw)
        return sum_x, ytx, beta * (1 + 1e-6), se, t
    return fn


def _half_samples(real):
    """Half the samples left out, the mean imputed over the rest."""
    def fn(gz8, m8, W):
        gz8, m8 = gz8.clone(), m8.clone()
        gz8[:, ::2] = 0
        m8[:, ::2] = 1
        return real(gz8, m8, W)
    return fn


def _stale(real):
    """The first result ever made, returned for every later call."""
    first = []

    def fn(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0]
    return fn


FAULTS = {
    # an answer altered where it is produced
    'altered_beta': ('ukb.sweep', 'hail_tpu_torch.ops.linreg_i8',
                     '_exact_epilogue', _scale_beta),
    # half of each call's samples left out, the mean taken over the rest
    'half_samples': ('kg.scan', 'hail_tpu_torch.ops.linreg_i8',
                     'exact_pass', _half_samples),
    # a state returned unchanged: the phenotypes' constants of the first
    # call
    'stale_phenotypes': ('ukb.sweep', 'hail_tpu_torch.methods.statgen',
                         '_exact_consts_cached', _stale),
    # the same faults where every call ships fresh genotypes
    'altered_beta.fresh': ('kg.fresh', 'hail_tpu_torch.ops.linreg_i8',
                           '_exact_epilogue', _scale_beta),
    'half_samples.fresh': ('kg.fresh', 'hail_tpu_torch.ops.linreg_i8',
                           'exact_pass', _half_samples),
    # a state returned unchanged: the first partition's shipped genotypes
    # for every later look-up of the device cache
    'stale_genotypes.fresh': ('kg.fresh', 'hail_tpu_torch.ops.devcache',
                              'get', _stale),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import importlib
    cell, module, attr, breaker = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, breaker(getattr(mod, attr)))
    out = tiny_run(cell)
    assert not out['correct'], (fault, out['checks'])


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(['hail_tpu_torch', 'hail_tpu_torch.ops',
                                  'jaxtyping', 'flaxen', 'numpy']) == []
    assert run.forbidden_modules(['jax.numpy', 'hail_tpu.ops', 'jaxlib',
                                  'flax']) == ['flax', 'hail_tpu', 'jax',
                                               'jaxlib']


def test_a_run_loads_no_jax():
    """A whole run in a fresh process leaves neither jax nor hail_tpu in
    sys.modules."""
    code = ('import sys; sys.path.insert(0, "gwasbench/tests"); '
            'from conftest import tiny_run; from gwasbench import run; '
            'out = tiny_run("kg.scan", seconds=0.5); '
            'print(out["correct"], run.forbidden_modules())')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == 'True []'


def test_no_card_no_result():
    """Without a card the command exits with another code than 0 and prints
    no result line, instead of running on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    res = subprocess.run([sys.executable, '-m', 'gwasbench', '--workload',
                          'kg.scan', '--seed', '1', '--seconds', '1'],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ''
    assert 'no card' in res.stderr


def test_too_few_cards(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(run.NoCard):
        run.check_card(4)


class _Event:
    def __init__(self, name, start, dur, cuda, annotation=False):
        self._v = (name, start, dur, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return 'DeviceType.CUDA' if self._v[3] else 'DeviceType.CPU'

    def is_user_annotation(self):
        return self._v[4]


def test_device_timeline_busy_and_gaps():
    """Host spans on their own clock are placed by the calls' profiler
    spans (here 1,000 ns later), then the gaps are named by them."""
    ev = [_Event('gwasbench.call', 1000, 100, False),
          _Event('gwasbench.call', 1200, 100, False),
          _Event('gwasbench.call', 1000, 100, True, annotation=True),
          _Event('k3', 1060, 20, True), _Event('k3', 1070, 20, True),
          _Event('copy', 1250, 10, True), _Event('late', 1400, 10, True)]
    host = [(0, 100, 'call'), (10, 50, 'qr'), (200, 300, 'call')]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    tl = trace.device_timeline(prof, host)
    assert tl['window_s'] == pytest.approx(300e-9)
    assert tl['busy_s'] == pytest.approx(40e-9)       # 60-90, 250-260
    assert dict(tl['device_ops']) == pytest.approx({'k3': 40e-9,
                                                    'copy': 10e-9})
    gaps = dict(tl['idle_gaps'])
    assert gaps['qr'] == pytest.approx(40e-9)              # 10-50
    assert gaps['between calls'] == pytest.approx(100e-9)    # 100-200
    assert gaps['call'] == pytest.approx(120e-9)   # 0-10, 50-60, 90-100,
    assert sum(gaps.values()) == pytest.approx(260e-9)  # 200-250, 260-300


@pytest.mark.parametrize('cell,names', [
    ('ukb.sweep', {'driver_ms_per_call.sweep', 'stage_ms_per_call.sweep',
                   'cache_hit_share.sweep'}),
    ('kg.scan', {'driver_ms_per_call.sweep', 'stage_ms_per_call.sweep',
                 'cache_hit_share.sweep'}),
    ('kg.fresh', {'driver_ms_per_call.sweep', 'stage_ms_per_call.sweep'})])
def test_traced_run_reads_its_per_layer_metrics(cell, names):
    """The program's spans and counters are read on any device; what the
    device trace gives needs a card."""
    out = tiny_run(cell, trace=True)
    assert out['correct'], out['checks']
    assert set(out['metrics']) == names
    assert 'busy_s' in out['device'] and 'window_s' in out['device']
    if 'cache_hit_share.sweep' in names:
        assert out['metrics']['cache_hit_share.sweep']['value'] == 100.0


def _genotypes(mode):
    import torch
    from gwasbench import data
    dev = torch.device('cpu')
    cfg = dict(samples=8, maf_min=0.05, missing=0.02)
    traffic = dict(variants=8, partitions=4, chunks=2)
    return run.find('genotypes', mode).Genotypes(
        cfg, traffic, data.generator(1, dev), dev,
        data.column_batch({'z': np.zeros(8)}))


@pytest.mark.parametrize('mode,on_card,counts,fault', [
    ('resident', True, (4, 0, 0), False),
    ('resident', False, (4, 0, 0), False),
    ('resident', True, (3, 1, 0), True),
    ('resident', True, (4, 0, 1), True),
    ('resident', True, (0, 4, 4), True),
    ('fresh', True, (0, 4, 4), False),
    ('fresh', False, (0, 4, 0), False),
    ('fresh', True, (0, 4, 0), True),
    ('fresh', True, (1, 3, 3), True),
    ('fresh', True, (4, 0, 0), True),
    ('fresh', False, (0, 4, 4), True)])
def test_cache_fault_by_genotype_mode(mode, on_card, counts, fault):
    """A call's change of the device-cache counters against its mode:
    resident, every partition a hit, no miss, no K4 launch; fresh, every
    partition a miss, no hit, one K4 launch a partition on a card."""
    expected = _genotypes(mode).expected(on_card)
    before = (10, 20, 30)
    after = tuple(b + d for b, d in zip(before, counts))
    assert run.cache_fault(expected, before, after) is fault


def test_fresh_chunks_are_new_tables():
    """Each call of the fresh mode wraps its chunk in a new MatrixTable,
    chunk c mod `chunks`; the resident mode hands over one table."""
    fresh, resident = _genotypes('fresh'), _genotypes('resident')
    assert fresh.table(0) is not fresh.table(0)
    assert fresh.chunk(0) is fresh.chunk(2) and fresh.chunk(0) \
        is not fresh.chunk(1)
    assert resident.table(0) is resident.table(5)
    x0, m0 = fresh.rows(0, np.arange(8))
    x1, _ = fresh.rows(1, np.arange(8))
    assert x0.shape == m0.shape == (8, 8)
    assert not np.array_equal(x0, x1)


def test_fresh_run_misses_the_cache_on_every_partition():
    """A tiny kg.fresh run: every partition of every call, warm calls
    included, a device-cache miss and no hit, and the run correct."""
    from hail_tpu_torch.ops import devcache
    from conftest import tiny_spec
    spec = tiny_spec('kg.fresh')
    h0, m0 = devcache.hits, devcache.misses
    out = tiny_run('kg.fresh', spec=spec)
    assert out['correct'], out['checks']
    assert out['checks']['cache_faults']['value'] == 0
    calls = out['attempted'] + spec.traffic['warm_calls']
    assert devcache.hits - h0 == 0
    assert devcache.misses - m0 == calls * spec.traffic['partitions']


@pytest.mark.cuda
def test_card_run(card):
    res = subprocess.run([sys.executable, '-m', 'gwasbench', '--workload',
                          'kg.scan', '--seed', '3', '--seconds', '2'],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['correct'] and out['device']['platform'] == 'gpu'
    assert np.isfinite(out['metrics']['assoc_per_s']['value'])
