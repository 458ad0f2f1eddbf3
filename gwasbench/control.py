"""The readings that a cell's limits are set from, on the card.

    python3 -m gwasbench.control --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, in one process: a run of the cell with a short window (the
program's readings: every number of the check, and each field's gap), and
the control on the same compared calls: the reference computed in float32,
the nearest precision below the float64 that the configuration states, put
in the program's place and held to the reference in float64 by the same
rule. One JSON line per seed; the control has to read above the limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from . import check
from .run import cell_spec, check_card


def card_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi: {e}'


def readings(spec, seed: int, seconds: float, device) -> dict:
    from .run import run_cell
    seen = {}

    def on_check(jobs, wl):
        seen['control'] = check.control(wl.method, jobs, wl.C) if jobs else {}
    t0 = time.perf_counter()
    out = run_cell(spec, seed, seconds, False, device, t0,
                   log=lambda *a, **k: None, on_check=on_check)
    ctrl = seen['control']
    return dict(seed=seed, correct=out['correct'],
                program={n: c['value'] for n, c in out['checks'].items()},
                control_max_rel_err=max(ctrl.values(), default=None),
                control=ctrl, metrics=out['metrics'])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python3 -m gwasbench.control')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    device = check_card(spec.chips)
    print(json.dumps({'card': card_line()}), flush=True)
    for s in args.seeds.split(','):
        print(json.dumps(readings(spec, int(s), args.seconds, device)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
