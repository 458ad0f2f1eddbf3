"""Resident genotypes: one MatrixTable of `variants` rows in `partitions`
equal partitions, built in set-up and used by every call. The first call
ships it to the device cache; every later one finds each partition there:
a hit of every partition, no miss and no K4 launch."""

from __future__ import annotations

import numpy as np

from gwasbench import data


class Genotypes:
    def __init__(self, cfg: dict, traffic: dict, gen, device, columns):
        self.n_parts = traffic['partitions']
        self.per_part = traffic['variants'] // self.n_parts
        self.chunks = [self.make_chunk(cfg, gen, device)]
        self.mt = data.matrix_table(self.chunks[0], columns)

    def make_chunk(self, cfg: dict, gen, device) -> list:
        """One call's calls: a (packed, missing) pair of host arrays a
        partition."""
        return [data.make_calls(gen, device, self.per_part, cfg['samples'],
                                cfg['maf_min'], cfg['missing'])
                for _ in range(self.n_parts)]

    def table(self, c: int):
        return self.mt

    def chunk(self, c: int) -> list:
        return self.chunks[0]

    def x(self, mt):
        return mt.GT.n_alt_alleles()

    def rows(self, c: int, rows: np.ndarray):
        """n_alt and missing masks of call `c`'s rows `rows`, decoded from
        the calls the program was handed."""
        parts = self.chunk(c)
        p, r = rows // self.per_part, rows % self.per_part
        packed = np.stack([parts[a][0][b] for a, b in zip(p, r)])
        missing = np.stack([parts[a][1][b] for a, b in zip(p, r)])
        return data.decode_n_alt(packed), missing

    def expected(self, on_card: bool) -> tuple:
        return self.n_parts, 0, 0

    def close(self) -> None:
        self.mt = None
