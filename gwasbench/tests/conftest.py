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


def tiny_spec(cell: str):
    """The cell's spec at 600 samples and at most 512 variants in at most 4
    partitions; every other setting is the cell's own (allele frequencies
    from 0.05, so that no variant is monomorphic at this size)."""
    from gwasbench import run
    spec = run.cell_spec(cell)
    spec.config['samples'] = 600
    spec.config['maf_min'] = 0.05
    spec.traffic['partitions'] = min(spec.traffic['partitions'], 4)
    spec.traffic['variants'] = min(spec.traffic['variants'], 512)
    return spec


def tiny_run(cell: str, seed: int = 2**31 + 5, seconds: float = 2.0,
             on_check=None, trace=False):
    import torch
    from gwasbench import run
    return run.run_cell(tiny_spec(cell), seed, seconds, trace,
                        torch.device('cpu'), time.perf_counter(),
                        log=lambda *a, **k: None, on_check=on_check)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda', 0)
