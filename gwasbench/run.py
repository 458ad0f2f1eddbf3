"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m gwasbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (`configs/<file>`), a traffic mix
(`traffic/<traffic>.json`) and, by its own name, its limits
(`limits/<cell>.json`). Everything else is found by name too, as a module
loaded from its file (`find`):

- `methods/<method>.py`, named by the configuration's `method` key
  (`linear_regression_rows` where it has none): the program's call and its
  reading. It provides `FIELDS`, the output fields read into host arrays,
  each (rows,) or (rows, P); `EXACT` and `FLOAT`, those of them compared
  exactly and by their largest relative gap; `call(hl, mt, x, ys,
  covariates, label)`, which calls the program on the MatrixTable `mt` with
  the genotype expression `x`, the phenotype expressions `ys` and the
  covariate expressions, and returns every field as a host array, the read
  inside `label('read')`; `size(out)`, a result's (rows, tests);
  `bad_rows(out, R)`, rows missing from a result of R or not to be
  trusted; `context(C, dtype)`, what its reference shares over a run's
  compared calls, from the (n, k) covariates in `dtype`; and
  `reference(x, missing, Y, ctx)`, the plain reference's fields for the
  compared rows (`reference/`), from their genotypes, missing masks and the
  call's (n, P) phenotypes.
- `genotypes/<mode>.py`, named by the mix's `genotypes` key: where a call's
  genotypes come from (`traffic.py` says what a mode provides). `resident`:
  one MatrixTable built in set-up and used by every call, so each call
  finds every partition in the device cache; `fresh`: each call wraps a
  chunk of a pool made in set-up in a new MatrixTable, so each call misses
  the cache on every partition and the program packs, ships and unpacks
  (K4) it.
- `metrics/<metric>.py`, one for each metric the cell reports: `read(run)`
  returns a number or None. `run` holds the cell's sizes (`N`, `k`, `P`,
  `R` variants a call), its configuration and traffic, `setup_s`,
  `window_start`, the calls of the window (`calls`, each with `t0`, `t1`,
  `variants`, `tests` and, traced, `stage_s`, and the device-cache `hits`
  and `misses`; `completed`, those that ended in the window) and, traced on
  a card, `timeline` (`trace.device_timeline`).

With `--trace 0` the line holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a `torch.profiler` trace of
the window and from spans around the program's layers (`trace.py`). After
the window a seeded sample of the calls is worked out again by the method's
reference and compared (`check.py`).

The run exits with another code than 0 and prints no result where there is
no NVIDIA card, fewer cards than the cell asks for, no program to measure, or
where jax, jaxlib, flax or hail_tpu is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hail_tpu')


class NoCard(RuntimeError):
    pass


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN: compared whole, so hail_tpu_torch is not hail_tpu."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, bench: Optional[dict] = None) -> SimpleNamespace:
    """Everything `BENCHMARK.json` (or `bench`, a dict of its form) and
    the files it names say of one cell."""
    bench = load_json(ROOT / 'BENCHMARK.json') if bench is None else bench
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    cell = cells[workload]
    config = {c['name']: c for c in bench['configs']}[cell['config']]
    e2e = [m for m in bench['end_to_end']
           if workload in m.get('workloads', [workload])]
    reported = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if workload in m.get('workloads', [workload] if m['moves']
                                  in reported else [])]
    return SimpleNamespace(
        cell=cell, chips=cell['chips'],
        config=load_json(ROOT / config['file']),
        traffic=load_json(HERE / 'traffic' / f"{cell['traffic']}.json"),
        limits=load_json(HERE / 'limits' / f'{workload}.json'),
        end_to_end=e2e, per_layer=layer)


def find(kind: str, name: str):
    """`<kind>/<name>.py` of the harness, loaded as a module of its own."""
    path = HERE / kind / f'{name}.py'
    if not path.is_file():
        raise KeyError(f'no {kind} {name!r}: {path} is not a file')
    spec = importlib.util.spec_from_file_location(
        f'gwasbench_{kind}_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    return find('metrics', name).read


def check_card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoCard('torch.cuda.is_available() is False')
    if torch.cuda.device_count() < chips:
        raise NoCard(f'the cell asks for {chips} cards, '
                     f'{torch.cuda.device_count()} are visible')
    return torch.device('cuda', 0)


def counters() -> tuple:
    """The program's device-cache hits and misses and K4 launches so far."""
    from hail_tpu_torch.ops import _kernels, devcache
    return devcache.hits, devcache.misses, \
        _kernels.launches['hail_unpack_gt_2bit']


def cache_fault(expected, before, after) -> bool:
    """Whether a call's device-cache hits, misses and K4 launches, the
    change of `counters()` over it, differ from the `expected` ones of its
    genotype mode."""
    return tuple(a - b for a, b in zip(after, before)) != tuple(expected)


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device, t0: float, log=print, on_check=None) -> dict:
    """Set up, measure and check one run of a cell on `device`. Returns the
    result line as a dict, its `checks` last. `on_check(jobs, wl)`, where
    given, sees the compared calls and the workload (`control.py`)."""
    import torch
    import hail_tpu_torch as hl
    from . import check, traffic as traffic_mod
    from .trace import Probes, device_timeline

    hl.init(device=str(device), quiet=True)
    wl = traffic_mod.Workload(hl, spec.config, spec.traffic, seed, device)
    wl.setup()
    on_card = device.type == 'cuda'
    expected = wl.genotypes.expected(on_card)
    if on_card:
        torch.cuda.synchronize(device)
    # what set-up made stays: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    calls, kept, attempted, failed, rows_bad, cache_faults = [], [], 0, 0, 0, 0
    probes, prof = (Probes(), None) if trace else (None, None)
    with contextlib.ExitStack() as window:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            probes.install()
            window.callback(probes.remove)
            prof = window.enter_context(profile(activities=[
                ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])))
        w0 = time.perf_counter()
        deadline = w0 + seconds
        while time.perf_counter() < deadline:
            c = attempted
            rec = dict(c=c)
            before = counters()
            attempted += 1
            t_a = time.perf_counter()
            try:
                if trace:
                    with probes.call(rec):
                        res = wl.call(c, label=probes.label)
                else:
                    res = wl.call(c)
            except Exception:
                failed += 1
                log(traceback.format_exc(), file=sys.stderr)
                continue
            t_b = time.perf_counter()
            after = counters()
            variants, tests = wl.method.size(res['out'])
            rec.update(t0=t_a, t1=t_b, variants=variants, tests=tests,
                       hits=after[0] - before[0], misses=after[1] - before[1])
            cache_faults += cache_fault(expected, before, after)
            rows_bad += wl.bad_rows(res['out'])
            k = wl.keep(c, res)
            if k is not None:
                kept.append(k)
            calls.append(rec)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    timeline = (device_timeline(prof, probes.spans) if (trace and on_card)
                else None)

    run = SimpleNamespace(
        config=spec.config, traffic=spec.traffic, N=wl.N, k=len(wl.terms),
        P=wl.P, R=wl.R, setup_s=setup_s, window_start=w0, calls=calls,
        completed=[r for r in calls if r['t1'] <= deadline],
        timeline=timeline)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = reader(m['name'])(run)
        if v is not None:
            metrics[m['name']] = {'value': v, 'unit': m['unit']}

    # the check, once the program's state is freed
    wl.close()
    hl.stop()
    gc.unfreeze()
    jobs = wl.jobs(kept)
    field_gaps, n_wrong = (check.compare(wl.method, jobs, wl.C) if jobs
                           else ({}, 0))
    log('setup_phases_s ' + ' '.join(f'{n}={v:.3f}' for n, v in
                                     wl.setup_phases.items()),
        file=sys.stderr)
    log('calls_s ' + ' '.join(f"{r['t1'] - r['t0']:.4f}" for r in calls),
        file=sys.stderr)
    if trace:
        log('phases_ms ' + ' '.join(f'{n}={v:.1f}' for n, v in
                                    sorted(probes.phases().items())),
            file=sys.stderr)
    for f, g in field_gaps.items():
        log(f'gap {f} {g!r}', file=sys.stderr)
    numbers = {'max_rel_err': max(field_gaps.values(), default=float('inf')),
               'n_wrong': n_wrong, 'rows_bad': rows_bad,
               'cache_faults': cache_faults, 'calls_checked': len(jobs)}
    if on_check is not None:
        on_check(jobs, wl)
    correct = (check.verdict(numbers, spec.limits) and failed == 0
               and bool(calls))
    device_out = {'platform': 'gpu' if on_card else device.type,
                  'kind': (torch.cuda.get_device_name(device) if on_card
                           else 'cpu'),
                  'count': spec.chips if on_card else 1,
                  'memory_peak_bytes': int(peak)}
    if trace:
        device_out['busy_s'] = timeline['busy_s'] if timeline else 0.0
        device_out['window_s'] = (timeline['window_s'] if timeline
                                  else time.perf_counter() - w0)
    out = {'correct': bool(correct), 'attempted': attempted,
           'failed': failed, 'metrics': metrics, 'device': device_out}
    if timeline:
        out['breakdown'] = {'device_ops': timeline['device_ops'],
                            'idle_gaps': timeline['idle_gaps']}
    # a number that is not finite (no call compared) is printed as null
    out['checks'] = {n: {'value': numbers[n] if math.isfinite(numbers[n])
                         else None, 'limit': spec.limits[n]}
                     for n in spec.limits}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog='python3 -m gwasbench')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    spec = cell_spec(args.workload)
    try:
        device = check_card(spec.chips)
    except NoCard as e:
        print(f'gwasbench: no card to measure: {e}', file=sys.stderr)
        return 2
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ.setdefault(var, str(ROOT / '.gwasbench_cache' / sub))
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, t0)
    bad = forbidden_modules()
    if bad:
        print(f'gwasbench: loaded in this process: {", ".join(bad)}',
              file=sys.stderr)
        return 3
    for name, c in out['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
