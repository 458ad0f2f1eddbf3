"""Locus value class (contig, position) on a reference genome.

Parity with reference `hail/python/hail/genetics/locus.py` /
`is/hail/variant/Locus.scala`.
"""

from __future__ import annotations

from .reference_genome import ReferenceGenome, default_reference


class Locus:
    __slots__ = ('contig', 'position', '_rg')

    def __init__(self, contig: str, position: int, reference_genome='default'):
        if reference_genome == 'default':
            rg = default_reference()
        elif isinstance(reference_genome, str):
            rg = ReferenceGenome.get(reference_genome)
        else:
            rg = reference_genome
        if not rg.has_contig(str(contig)):
            raise ValueError(f'contig {contig!r} not in reference genome {rg.name}')
        self.contig = str(contig)
        self.position = int(position)
        self._rg = rg

    @classmethod
    def parse(cls, s: str, reference_genome='default') -> 'Locus':
        contig, pos = s.rsplit(':', 1)
        return cls(contig, int(pos), reference_genome)

    @property
    def reference_genome(self) -> ReferenceGenome:
        return self._rg

    def global_position(self) -> int:
        return self._rg.global_position(self.contig, self.position)

    def in_autosome(self) -> bool:
        return self._rg.is_autosomal(self.contig)

    def in_x_par(self) -> bool:
        return self._rg.is_x(self.contig) and self._rg.in_par(self.contig, self.position)

    def in_x_nonpar(self) -> bool:
        return self._rg.is_x(self.contig) and not self._rg.in_par(self.contig, self.position)

    def in_y_par(self) -> bool:
        return self._rg.is_y(self.contig) and self._rg.in_par(self.contig, self.position)

    def in_y_nonpar(self) -> bool:
        return self._rg.is_y(self.contig) and not self._rg.in_par(self.contig, self.position)

    def in_mito(self) -> bool:
        return self._rg.is_mitochondrial(self.contig)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Locus):
            return NotImplemented
        return self.contig == other.contig and self.position == other.position and self._rg.name == other._rg.name

    def __lt__(self, other: 'Locus') -> bool:
        return self.global_position() < other.global_position()

    def __le__(self, other: 'Locus') -> bool:
        return self.global_position() <= other.global_position()

    def __gt__(self, other: 'Locus') -> bool:
        return self.global_position() > other.global_position()

    def __ge__(self, other: 'Locus') -> bool:
        return self.global_position() >= other.global_position()

    def __hash__(self) -> int:
        return hash((self.contig, self.position, self._rg.name))

    def __str__(self) -> str:
        return f'{self.contig}:{self.position}'

    def __repr__(self) -> str:
        return f'Locus(contig={self.contig}, position={self.position}, reference_genome={self._rg.name})'
