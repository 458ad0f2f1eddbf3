"""Fresh genotypes: a pool of `chunks` chunks of `variants` rows in
`partitions` equal partitions, made in set-up as host calls. Call c wraps
chunk c mod `chunks` in a new MatrixTable inside the timed call, as a
reader of VCF, BGEN or a stored MatrixTable would hand it over, so the
program has seen none of its partitions: each is a device-cache miss that
the program packs, ships and unpacks, with one K4 launch on a card."""

from __future__ import annotations

from gwasbench import data
from gwasbench.genotypes.resident import Genotypes as Resident


class Genotypes(Resident):
    def __init__(self, cfg: dict, traffic: dict, gen, device, columns):
        self.n_parts = traffic['partitions']
        self.per_part = traffic['variants'] // self.n_parts
        self.chunks = [self.make_chunk(cfg, gen, device)
                       for _ in range(traffic['chunks'])]
        self.columns = columns

    def chunk(self, c: int) -> list:
        return self.chunks[c % len(self.chunks)]

    def table(self, c: int):
        return data.matrix_table(self.chunk(c), self.columns)

    def expected(self, on_card: bool) -> tuple:
        return 0, self.n_parts, self.n_parts if on_card else 0

    def close(self) -> None:
        pass
