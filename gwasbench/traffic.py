"""The one generator of every traffic mix.

A mix is a data file, `traffic/<name>.json`, read by `Workload`. Every mix
is a closed loop with one caller: it makes the next call once the last one's
outputs are on the host. A call hands the method (`methods/<method>.py`,
named by the configuration) a MatrixTable from the mix's genotype mode, its
genotype expression, the call's P phenotype expressions and the
configuration's covariates; the method calls the program and reads every
output field into host arrays. Keys of a mix:

- `genotypes`: the mode, `genotypes/<mode>.py`, a module with a class
  `Genotypes(cfg, traffic, gen, device, columns)` that makes the mode's
  host calls from the device generator `gen` in set-up and provides
  `table(c)`, the MatrixTable of call `c` (made inside the timed call);
  `x(mt)`, the genotype expression; `rows(c, rows)`, the reference's
  genotypes and missing masks of rows `rows` of call `c`, from the calls
  the benchmark made; `expected(on_card)`, the device-cache hits, misses
  and K4 launches one call makes; and `close()`, which drops what the
  program holds. `resident` and `fresh` so far (`run.py`);
- `variants`, `partitions`: the rows of one call and the equal partitions
  they come in; a mode may read more keys (`fresh`: `chunks`);
- `phenotypes`: `new`, each call's P phenotypes being new columns, y_a + c
  * y_b over the configuration's pool with seeded a, b and c (the only
  kind so far);
- `warm_calls`: calls made in set-up, before the window;
- `check_calls`, `check_rows`: how many finished calls the reference works
  out again, and how many seeded rows of each call are kept for that.

P, the samples, the covariates and the method are the configuration's
(`configs/<name>.json`).
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

from . import data

WINDOW, WARM = 1, 2          # streams of the host generator, per call


def _no_label(name: str):
    return contextlib.nullcontext()


class Workload:
    def __init__(self, hl, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from .run import find
        self.hl, self.cfg, self.trf = hl, config, traffic
        self.seed, self.device = seed, device
        self.N = config['samples']
        self.P = config['phenotypes_per_call']
        self.terms = data.covariate_terms(config['covariates'])
        self.pool = config['phenotype_pool']
        self.R = traffic['variants']
        if self.R % traffic['partitions']:
            raise ValueError('variants must split evenly into partitions')
        if traffic['phenotypes'] != 'new':
            raise ValueError(f"unknown phenotypes {traffic['phenotypes']!r}")
        self.method = find('methods',
                           config.get('method', 'linear_regression_rows'))
        self._mode = find('genotypes', traffic['genotypes']).Genotypes
        self.genotypes = None

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        """Make the inputs from the seed, the column fields first, then the
        genotype mode's calls, and make the warm-up calls (the first fills
        the device cache where the mix is resident)."""
        t = time.perf_counter()
        gen = data.generator(self.seed, self.device)
        self.cols = data.make_columns(gen, self.device, self.N,
                                      self.cfg['column_fields'], self.pool)
        self.columns = data.column_batch(self.cols)
        self.genotypes = self._mode(self.cfg, self.trf, gen, self.device,
                                    self.columns)
        self.C = data.covariate_matrix(self.terms, self.cols, self.N)
        self.setup_phases = {'inputs': time.perf_counter() - t}
        for c in range(self.trf['warm_calls']):
            t = time.perf_counter()
            self.call(c, WARM)
            self.setup_phases[f'warm{c}'] = time.perf_counter() - t

    # -- one call --------------------------------------------------------
    def phenotypes(self, c: int, stream: int) -> List[tuple]:
        """(a, b, coefficient) of each of the call's P phenotypes, y_a + coef
        * y_b."""
        rng = data.host_rng(self.seed, 4, stream, c)
        a = rng.choice(self.pool, self.P, replace=False)
        b = (a + 1 + rng.integers(0, self.pool - 1, self.P)) % self.pool
        coef = rng.uniform(0.25, 1.0, self.P)
        return [(int(x), int(y), float(k)) for x, y, k in zip(a, b, coef)]

    def Y(self, spec) -> np.ndarray:
        """The reference's (N, P) phenotypes of a call."""
        cols = []
        for a, b, coef in spec:
            y = self.cols[f'y{a}']
            cols.append(y + coef * self.cols[f'y{b}'])
        return np.stack(cols, axis=1)

    def call(self, c: int, stream: int = WINDOW, label=None) -> dict:
        """One call, its outputs read to the host: `out`, the method's
        fields as host arrays, and `spec`, the call's phenotypes."""
        spec = self.phenotypes(c, stream)
        mt = self.genotypes.table(c)
        ys = [mt[f'y{a}'] + coef * mt[f'y{b}'] for a, b, coef in spec]
        out = self.method.call(self.hl, mt, self.genotypes.x(mt), ys,
                               data.covariate_exprs(mt, self.terms),
                               label or _no_label)
        return dict(out=out, spec=spec)

    # -- what the check keeps ---------------------------------------------
    def kept_rows(self, c: int) -> np.ndarray:
        rng = data.host_rng(self.seed, 5, c)
        return np.sort(rng.choice(self.R, min(self.trf['check_rows'], self.R),
                                  replace=False))

    def bad_rows(self, out: dict) -> int:
        return self.method.bad_rows(out, self.R)

    def keep(self, c: int, result: dict) -> Optional[dict]:
        out = result['out']
        if self.method.size(out)[0] != self.R:
            return None
        rows = self.kept_rows(c)
        return dict(c=c, spec=result['spec'], rows=rows,
                    got={f: out[f][rows].copy() for f in self.method.FIELDS})

    def jobs(self, kept: List[dict]) -> List[dict]:
        """The seeded sample of finished calls the reference works out
        again, with the inputs it needs: the sampled rows' genotypes and
        missing masks, taken from the calls the benchmark made, and the
        call's phenotypes."""
        rng = data.host_rng(self.seed, 6)
        n = min(self.trf['check_calls'], len(kept))
        jobs = []
        for i in sorted(int(i) for i in rng.permutation(len(kept))[:n]):
            j = kept[i]
            x, missing = self.genotypes.rows(j['c'], j['rows'])
            jobs.append(dict(c=j['c'], x=x, missing=missing,
                             Y=self.Y(j['spec']), got=j['got']))
        return jobs

    def close(self) -> None:
        """Drop what the program made or holds: the MatrixTables and their
        device buffers. The inputs stay for the reference."""
        if self.genotypes is not None:
            self.genotypes.close()
