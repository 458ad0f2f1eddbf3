"""The one generator of every traffic mix.

A mix is a data file, `traffic/<name>.json`, read by `Workload`. Every mix
is a closed loop with one caller: it makes the next call once the last one's
statistics are on the host. A call is

    hl.linear_regression_rows(y=<P phenotypes>, x=mt.GT.n_alt_alleles(),
                              covariates=<the configuration's covariates>)

with every output field of every row read into host arrays. Keys of a mix:

- `genotypes`: `resident`, one MatrixTable of `variants` rows in
  `partitions` equal partitions, built in set-up and used by every call
  (the only kind so far);
- `phenotypes`: `new`, each call's P phenotypes being new columns, y_a + c
  * y_b over the configuration's pool with seeded a, b and c (the only
  kind so far);
- `warm_calls`: calls made in set-up, before the window;
- `check_calls`, `check_rows`: how many finished calls the reference works
  out again, and how many seeded rows of each call are kept for that.

P, the samples, the covariates and the call spectrum are the
configuration's (`configs/<name>.json`).
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

from . import data
from .reference.ols import FIELDS

WINDOW, WARM = 1, 2          # streams of the host generator, per call


class Workload:
    def __init__(self, hl, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.hl, self.cfg, self.trf = hl, config, traffic
        self.seed, self.device = seed, device
        self.N = config['samples']
        self.P = config['phenotypes_per_call']
        self.terms = data.covariate_terms(config['covariates'])
        self.pool = config['phenotype_pool']
        self.R = traffic['variants']
        self.n_parts = traffic['partitions']
        if self.R % self.n_parts:
            raise ValueError('variants must split evenly into partitions')
        self.per_part = self.R // self.n_parts
        self.mode = traffic['genotypes']
        if self.mode != 'resident':
            raise ValueError(f'unknown genotypes {self.mode!r}')
        if traffic['phenotypes'] != 'new':
            raise ValueError(f"unknown phenotypes {traffic['phenotypes']!r}")

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        """Make the inputs from the seed, build what the mix keeps, and make
        the warm-up calls (the first fills the device cache where the mix is
        resident)."""
        t = time.perf_counter()
        gen = data.generator(self.seed, self.device)
        self.cols = data.make_columns(gen, self.device, self.N,
                                      self.cfg['column_fields'], self.pool)
        self.columns = data.column_batch(self.cols)

        self.parts = [data.make_calls(gen, self.device, self.per_part,
                                      self.N, self.cfg['maf_min'],
                                      self.cfg['missing'])
                      for _ in range(self.n_parts)]
        self.mt = data.matrix_table(self.parts, self.columns)
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
        """One call, its outputs read to the host. Returns every field as a
        host array, (R,) for n and sum_x, (R, P) for the others."""
        hl, mt = self.hl, self.mt
        spec = self.phenotypes(c, stream)
        ys = [mt[f'y{a}'] + coef * mt[f'y{b}'] for a, b, coef in spec]
        res = hl.linear_regression_rows(
            y=ys if self.P > 1 else ys[0], x=mt.GT.n_alt_alleles(),
            covariates=data.covariate_exprs(mt, self.terms))
        batches = res._stage.collect_batches()
        with label('read') if label else contextlib.nullcontext():
            out = {f: np.concatenate([np.asarray(b.columns[f].values)
                                      for b in batches]) for f in FIELDS}
        for f in FIELDS[2:]:
            out[f] = out[f].reshape(out[f].shape[0], -1)
        return dict(out=out, spec=spec)

    # -- what the check keeps ---------------------------------------------
    def kept_rows(self, c: int) -> np.ndarray:
        rng = data.host_rng(self.seed, 5, c)
        return np.sort(rng.choice(self.R, min(self.trf['check_rows'], self.R),
                                  replace=False))

    def bad_rows(self, out: dict) -> int:
        """Rows missing from a call's result, or holding a value that is not
        finite."""
        n = out['n'].shape[0]
        bad = abs(n - self.R)
        if n == self.R:
            finite = np.ones(n, bool)
            for f in FIELDS[1:]:
                v = out[f].reshape(n, -1)
                finite &= np.isfinite(v).all(axis=1)
            bad += int((~finite).sum())
        return bad

    def keep(self, c: int, result: dict) -> Optional[dict]:
        out = result['out']
        if out['n'].shape[0] != self.R:
            return None
        rows = self.kept_rows(c)
        return dict(c=c, spec=result['spec'],
                    rows=rows, got={f: out[f][rows].copy() for f in FIELDS})

    def jobs(self, kept: List[dict]) -> List[dict]:
        """The seeded sample of finished calls the reference works out
        again, with the inputs it needs: the sampled rows' n_alt and missing
        masks, decoded from the calls the benchmark made, and the call's
        phenotypes."""
        rng = data.host_rng(self.seed, 6)
        n = min(self.trf['check_calls'], len(kept))
        jobs = []
        for i in sorted(int(i) for i in rng.permutation(len(kept))[:n]):
            j = kept[i]
            parts = self.parts
            p, r = j['rows'] // self.per_part, j['rows'] % self.per_part
            packed = np.stack([parts[a][0][b] for a, b in zip(p, r)])
            miss = np.stack([parts[a][1][b] for a, b in zip(p, r)])
            jobs.append(dict(c=j['c'], n_alt=data.decode_n_alt(packed),
                             missing=miss, Y=self.Y(j['spec']), got=j['got']))
        return jobs

    def close(self) -> None:
        """Drop what the program made or holds: the MatrixTable and its
        device buffers. The inputs stay for the reference."""
        self.mt = None
