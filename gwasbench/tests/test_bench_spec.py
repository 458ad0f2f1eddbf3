"""BENCHMARK.json against the contract it is written to, and the files the
harness finds by name: each configuration, its method, traffic mix and
genotype mode, limits file and metric reader; and that a new method is a
new file."""

import json
import os
import re

import pytest

from conftest import ROOT, tiny_run, tiny_spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= b['run_seconds'] <= 51
    assert 1 <= len(b['paths']) <= 16
    for p in b['paths']:
        assert re.fullmatch(r'[A-Za-z0-9_./-]{1,200}', p)
        assert not p.startswith('/') and '..' not in p.split('/')
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(b['command']) <= 32
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024


def test_names_units_and_lines():
    b = bench()
    names = []
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in b[group]:
            assert NAME.match(e['name']), e['name']
            names.append((group in ('end_to_end', 'per_layer'), e['name']))
            for key in ('why', 'layer', 'source'):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert '\n' not in e[key] and '\t' not in e[key]
    assert len(set(names)) == len(names)
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for m in b['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in b['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in {e['name'] for e in b['end_to_end']}
        if m['name'].endswith('_roofline') or 'roofline' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('cell', [w['name'] for w in bench()['workloads']])
def test_cell_finds_its_files(cell):
    from gwasbench import run
    spec = run.cell_spec(cell)
    assert spec.chips in (1, 4)
    e2e = {m['name'] for m in spec.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(run.reader(m['name']))
        assert cell in m.get('workloads', [cell])
    for m in spec.per_layer:
        assert m['moves'] in e2e
    for key in ('max_rel_err', 'n_wrong', 'rows_bad', 'cache_faults',
                'calls_checked'):
        assert key in spec.limits
    for key in ('genotypes', 'variants', 'partitions', 'phenotypes',
                'warm_calls', 'check_calls', 'check_rows'):
        assert key in spec.traffic
    assert hasattr(run.find('genotypes', spec.traffic['genotypes']),
                   'Genotypes')


def test_held_back_cell_finds_its_files():
    """The held-back cell's mix, limits and readers are in place, so that
    running it is one entry of BENCHMARK.json."""
    from conftest import HELD_BACK, bench_for_tests
    from gwasbench import run
    cell = HELD_BACK['workload']['name']
    spec = run.cell_spec(cell, bench_for_tests())
    assert spec.traffic['genotypes'] == 'fresh'
    assert {m['name'] for m in spec.per_layer} >= set(HELD_BACK['readers'])
    for m in spec.end_to_end + spec.per_layer:
        assert callable(run.reader(m['name']))
    assert cell not in {w['name'] for w in bench()['workloads']}


@pytest.mark.parametrize('config', [c['file'] for c in bench()['configs']])
def test_each_configuration_names_a_method_file(config):
    """The configuration's method (`linear_regression_rows` where it names
    none) is a file under methods/ with what run.py asks of a method."""
    from gwasbench import run
    with open(os.path.join(ROOT, config)) as f:
        name = json.load(f).get('method', 'linear_regression_rows')
    assert os.path.isfile(os.path.join(ROOT, 'gwasbench', 'methods',
                                       f'{name}.py'))
    method = run.find('methods', name)
    for attr in ('FIELDS', 'EXACT', 'FLOAT', 'call', 'size', 'bad_rows',
                 'context', 'reference'):
        assert hasattr(method, attr), attr
    assert set(method.EXACT) | set(method.FLOAT) <= set(method.FIELDS)


def test_configs_are_used_and_state_their_cuts():
    b = bench()
    used = {w['config'] for w in b['workloads']}
    files = set()
    for c in b['configs']:
        assert c['name'] in used
        assert c['file'].startswith('gwasbench/')
        assert c['file'] not in files
        files.add(c['file'])
        with open(os.path.join(ROOT, c['file'])) as f:
            cfg = json.load(f)
        assert cfg['reduced'] == c['reduced']
        assert len(c['reduced']) <= 16
        for key in ('samples', 'covariates', 'phenotypes_per_call',
                    'assumed', 'source'):
            assert key in cfg
    pairs = [(w['config'], w['traffic']) for w in b['workloads']]
    assert len(set(pairs)) == len(pairs)
    assert sum(w['chips'] == 4 for w in b['workloads']) <= max(
        1, len(b['workloads']) // 4)


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    """A reader is found by its name alone: a file added under metrics/
    is read without an edit to the harness."""
    from gwasbench import run
    metrics = tmp_path / 'metrics'
    metrics.mkdir()
    (metrics / 'calls.sweep.py').write_text(
        'def read(run):\n    return float(len(run.calls))\n')
    monkeypatch.setattr(run, 'HERE', tmp_path)
    assert run.reader('calls.sweep')(type('R', (), {'calls': [1, 2]})) == 2.0


NEW_METHOD = """\"\"\"A method of one field: beta, from linear_regression_rows, held to a
per-row least-squares solve.\"\"\"
import numpy as np

from gwasbench.run import find

FIELDS = ('beta',)
EXACT = ()
FLOAT = ('beta',)
lstsq = find('reference', 'beta_lstsq')


def call(hl, mt, x, ys, covariates, label):
    res = hl.linear_regression_rows(y=ys, x=x, covariates=covariates)
    batches = res._stage.collect_batches()
    with label('read'):
        beta = np.concatenate([np.asarray(b.columns['beta'].values)
                               for b in batches])
    return {'beta': beta.reshape(beta.shape[0], -1)}


def size(out):
    return out['beta'].shape[0], out['beta'].size


def bad_rows(out, R):
    return abs(out['beta'].shape[0] - R) + int(
        (~np.isfinite(out['beta'])).any(axis=1).sum())


def context(C, dtype):
    return np.asarray(C, dtype)


def reference(x, missing, Y, C):
    return {'beta': lstsq.beta(x, missing, C, Y)}
"""

NEW_REFERENCE = """\"\"\"Each row's y ~ [C | x] by np.linalg.lstsq, the missing calls replaced
by the mean of the row's other calls.\"\"\"
import numpy as np


def beta(x, missing, C, Y):
    out = []
    for g, m in zip(x, missing):
        g = g.astype(C.dtype)
        g[m] = g[~m].mean()
        X = np.concatenate([C, g[:, None]], axis=1)
        out.append(np.linalg.lstsq(X, np.asarray(Y, C.dtype),
                                   rcond=None)[0][-1])
    return np.asarray(out)
"""


def test_a_new_method_is_a_new_file(tmp_path, monkeypatch):
    """A method is found by the configuration's `method` key alone: a file
    added under methods/, with its reference added under reference/, runs a
    whole tiny cell without an edit to the harness."""
    from gwasbench import run
    spec = tiny_spec('kg.scan')
    spec.config['method'] = 'linreg_beta'
    for kind in ('genotypes', 'metrics'):
        (tmp_path / kind).symlink_to(os.path.join(ROOT, 'gwasbench', kind))
    (tmp_path / 'methods').mkdir()
    (tmp_path / 'methods' / 'linreg_beta.py').write_text(NEW_METHOD)
    (tmp_path / 'reference').mkdir()
    (tmp_path / 'reference' / 'beta_lstsq.py').write_text(NEW_REFERENCE)
    monkeypatch.setattr(run, 'HERE', tmp_path)
    out = tiny_run('kg.scan', spec=spec)
    assert out['correct'], out['checks']
    assert out['checks']['calls_checked']['value'] >= 1
    assert 0 < out['checks']['max_rel_err']['value'] < 1e-9
