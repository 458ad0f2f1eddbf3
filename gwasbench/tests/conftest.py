"""Shared helpers of the benchmark's tests: a cell cut to a size the CPU
runs in seconds. These tests run on the CPU with the program's plain torch
paths; the `cuda` tests decide in a fixture whether there is a card.

    python -m pytest gwasbench/tests -q
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# a cell whose files the harness holds but BENCHMARK.json does not run yet
# (its runs spread too widely for the bound, PERF.md): its mix, limits and
# readers are tested here as they would run
HELD_BACK = {
    'workload': {'name': 'kg.fresh', 'config': 'kg_tutorial_gwas',
                 'traffic': 'kg.fresh', 'chips': 1},
    'readers': ['ship_ms_per_call.fresh', 'pack_ms_per_call.fresh'],
    'not_read': ['cache_hit_share.sweep'],
}


def bench_for_tests() -> dict:
    """BENCHMARK.json with the held-back cell added: it reports
    `assoc_per_s`, the per-layer metrics of the resident cells but
    `not_read`, and its own `readers`."""
    import json
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cell = HELD_BACK['workload']['name']
    bench['workloads'].append(dict(HELD_BACK['workload']))
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m and m['name'] not in HELD_BACK['not_read']:
            m['workloads'].append(cell)
    for name in HELD_BACK['readers']:
        bench['per_layer'].append(dict(
            name=name, unit='ms', better='lower', source='program_span',
            layer='wire and cache', moves='assoc_per_s', workloads=[cell]))
    return bench


def tiny_spec(cell: str):
    """The cell's spec at 600 samples and at most 512 variants in at most 4
    partitions; every other setting is the cell's own (allele frequencies
    from 0.05, so that no variant is monomorphic at this size)."""
    from gwasbench import run
    spec = run.cell_spec(cell, bench_for_tests())
    spec.config['samples'] = 600
    spec.config['maf_min'] = 0.05
    spec.traffic['partitions'] = min(spec.traffic['partitions'], 4)
    spec.traffic['variants'] = min(spec.traffic['variants'], 512)
    return spec


def tiny_run(cell: str, seed: int = 2**31 + 5, seconds: float = 2.0,
             on_check=None, trace=False, spec=None):
    """One run of the cell on the CPU at `tiny_spec`'s size, or of `spec`
    where given."""
    import torch
    from gwasbench import run
    return run.run_cell(spec or tiny_spec(cell), seed, seconds, trace,
                        torch.device('cpu'), time.perf_counter(),
                        log=lambda *a, **k: None, on_check=on_check)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda', 0)
