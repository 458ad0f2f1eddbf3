"""Reference genomes: contigs, lengths, sex/mito contigs, PAR intervals.

Capability parity with reference `is/hail/variant/ReferenceGenome.scala` and
`hail/python/hail/genetics/reference_genome.py`. Builtin genomes are loaded
from factual contig tables in hail_tpu/resources/reference/*.json.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

_BUILTIN = ('GRCh37', 'GRCh38', 'GRCm38', 'CanFam3')
_RESOURCE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'resources', 'reference')


class ReferenceGenome:
    """A reference genome: ordered contigs with lengths, X/Y/MT designations,
    and pseudoautosomal regions. User-definable like the reference's."""

    _registry: Dict[str, 'ReferenceGenome'] = {}

    def __init__(
        self,
        name: str,
        contigs: Sequence[str],
        lengths: Dict[str, int],
        x_contigs: Sequence[str] = (),
        y_contigs: Sequence[str] = (),
        mt_contigs: Sequence[str] = (),
        par: Sequence[Tuple[str, int, str, int]] = (),
        _register: bool = True,
    ):
        self.name = name
        self.contigs: List[str] = list(contigs)
        self.lengths: Dict[str, int] = dict(lengths)
        self.x_contigs = list(x_contigs)
        self.y_contigs = list(y_contigs)
        self.mt_contigs = list(mt_contigs)
        self._par_tuples = [tuple(p) for p in par]
        self._contig_index = {c: i for i, c in enumerate(self.contigs)}
        # global position offsets: contig -> cumulative start (for sorting loci as int64)
        self._global_offsets: Dict[str, int] = {}
        off = 0
        for c in self.contigs:
            self._global_offsets[c] = off
            off += self.lengths[c]
        self._total_length = off
        if _register:
            ReferenceGenome._registry[name] = self
        self._sequence = None
        self._liftovers: Dict[str, object] = {}

    # -- registry ----------------------------------------------------------
    @classmethod
    def get(cls, name: str) -> 'ReferenceGenome':
        if name == 'default':
            return default_reference()
        if name not in cls._registry:
            if name in _BUILTIN:
                cls._load_builtin(name)
            else:
                raise ValueError(f'unknown reference genome {name!r}')
        return cls._registry[name]

    @classmethod
    def _load_builtin(cls, name: str) -> 'ReferenceGenome':
        with open(os.path.join(_RESOURCE_DIR, f'{name}.json')) as f:
            d = json.load(f)
        contigs = [c['name'] for c in d['contigs']]
        lengths = {c['name']: c['length'] for c in d['contigs']}
        return cls(
            d['name'], contigs, lengths,
            x_contigs=d['x_contigs'], y_contigs=d['y_contigs'],
            mt_contigs=d['mt_contigs'], par=[tuple(p) for p in d['par']],
        )

    @classmethod
    def read(cls, path: str) -> 'ReferenceGenome':
        """Read a custom reference genome from a JSON file (our schema, or the
        reference's schema with contigs as [{name, length}] + xContigs etc.)."""
        with open(path) as f:
            d = json.load(f)
        contigs = [c['name'] for c in d['contigs']]
        lengths = {c['name']: c['length'] for c in d['contigs']}
        par = d.get('par', [])
        norm_par = []
        for p in par:
            if isinstance(p, dict):
                norm_par.append((p['start']['contig'], p['start']['position'],
                                 p['end']['contig'], p['end']['position']))
            else:
                norm_par.append(tuple(p))
        return cls(
            d['name'], contigs, lengths,
            x_contigs=d.get('x_contigs', d.get('xContigs', [])),
            y_contigs=d.get('y_contigs', d.get('yContigs', [])),
            mt_contigs=d.get('mt_contigs', d.get('mtContigs', [])),
            par=norm_par,
        )

    # -- queries -----------------------------------------------------------
    def contig_index(self, contig: str) -> int:
        return self._contig_index[contig]

    @property
    def par(self):
        """Pseudoautosomal regions as locus Intervals (reference
        ReferenceGenome.par)."""
        from ..utils.structs import Interval
        from .locus import Locus
        return [Interval(Locus(c0, s0, self), Locus(c1, e0, self))
                for (c0, s0, c1, e0) in self._par_tuples]

    def has_contig(self, contig: str) -> bool:
        return contig in self._contig_index

    def contig_length(self, contig: str) -> int:
        try:
            return self.lengths[contig]
        except KeyError:
            from ..utils.misc import FatalError
            raise FatalError(
                f'Invalid contig {contig!r} for reference genome '
                f'{self.name}') from None

    def to_locus_interval(self, contig: str, start: int, end: int,
                          includes_start: bool, includes_end: bool,
                          invalid_missing: bool = False):
        """Validate + canonicalize a locus interval (reference
        ReferenceGenome.toLocusInterval, variant/ReferenceGenome.scala:227):
        bound checks against contig length, open-at-0 / open-past-end
        normalization, and the canonical empty-interval forms."""
        from ..utils.misc import FatalError
        from ..utils.structs import Interval
        from .locus import Locus

        def invalid(msg):
            if invalid_missing:
                return None
            raise FatalError(msg)

        if not self.has_contig(contig):
            return invalid(f"Contig '{contig}' is not in the reference "
                           f"genome '{self.name}'.")
        clen = self.lengths[contig]

        def valid(pos):
            return 1 <= pos <= clen
        if not valid(start if includes_start else start + 1):
            return invalid(f"Invalid interval: start {start} is not within "
                           f'[1-{clen}] for {self.name}')
        if not valid(end if includes_end else end - 1):
            return invalid(f"Invalid interval: end {end} is not within "
                           f'[1-{clen}] for {self.name}')
        if not includes_start and start == 0:
            start, includes_start = 1, True
        if not includes_end and end == clen + 1:
            end, includes_end = clen, True
        if start == end:
            if includes_start and not includes_end:
                if start != 1:
                    start, includes_start = start - 1, False
            elif includes_end and not includes_start:
                if end != clen:
                    end, includes_end = end + 1, False
        # validity (Interval.isValid): start < end, or a single fully
        # inclusive point
        if not (start < end or (start == end and includes_start and includes_end)):
            return invalid('Invalid interval: empty')
        return Interval(Locus(contig, start, self), Locus(contig, end, self),
                        includes_start, includes_end)

    def global_position(self, contig: str, position: int) -> int:
        """1-based locus → 0-based global genome coordinate (sort key)."""
        return self._global_offsets[contig] + (position - 1)

    def locus_from_global_position(self, gpos: int) -> 'Locus':
        # reference ReferenceGenome.locus_from_global_position returns a
        # Locus (reference_genome.py:538 doctest)
        from .locus import Locus
        if gpos < 0:
            raise ValueError(f'global position {gpos} is negative')
        for c in self.contigs:
            off = self._global_offsets[c]
            if gpos < off + self.lengths[c]:
                return Locus(c, gpos - off + 1, self)
        raise ValueError(f'global position {gpos} out of range')

    @property
    def total_length(self) -> int:
        return self._total_length

    def is_x(self, contig: str) -> bool:
        return contig in self.x_contigs

    def is_y(self, contig: str) -> bool:
        return contig in self.y_contigs

    def is_mitochondrial(self, contig: str) -> bool:
        return contig in self.mt_contigs

    def is_autosomal(self, contig: str) -> bool:
        return not (self.is_x(contig) or self.is_y(contig) or self.is_mitochondrial(contig))

    def in_par(self, contig: str, position: int) -> bool:
        for (c0, s, c1, e) in self._par_tuples:
            if contig == c0 and s <= position < e:
                return True
        return False

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ReferenceGenome) and self.name == other.name

    def __hash__(self) -> int:
        return hash(self.name)

    def __repr__(self) -> str:
        return f'ReferenceGenome({self.name!r}, {len(self.contigs)} contigs)'

    # -- FASTA sequence / liftover (gated: require user-supplied files) ----
    def add_sequence(self, fasta_file: str, index_file: Optional[str] = None) -> None:
        from .fasta import FastaSequence
        self._sequence = FastaSequence(fasta_file, index_file)

    def has_sequence(self) -> bool:
        return self._sequence is not None

    def sequence(self, contig: str, position: int, before: int = 0, after: int = 0) -> str:
        if self._sequence is None:
            raise ValueError(f'reference genome {self.name} has no sequence loaded; call add_sequence')
        return self._sequence.query(contig, position, before, after)

    def add_liftover(self, chain_file: str, dest_ref: 'ReferenceGenome') -> None:
        from .liftover import LiftOver
        dest = dest_ref if isinstance(dest_ref, ReferenceGenome) else ReferenceGenome.get(dest_ref)
        self._liftovers[dest.name] = LiftOver(chain_file, self, dest)

    def has_liftover(self, dest: str) -> bool:
        name = dest.name if isinstance(dest, ReferenceGenome) else dest
        return name in self._liftovers

    def liftover(self, dest: str):
        name = dest.name if isinstance(dest, ReferenceGenome) else dest
        return self._liftovers[name]


_default_reference: Optional[ReferenceGenome] = None


def default_reference() -> ReferenceGenome:
    global _default_reference
    if _default_reference is None:
        _default_reference = ReferenceGenome.get('GRCh37')
    return _default_reference


def set_default_reference(rg) -> None:
    global _default_reference
    _default_reference = rg if isinstance(rg, ReferenceGenome) else ReferenceGenome.get(rg)


def _rg_global_positions_dict(self):
    """contig -> global start offset (reference ReferenceGenome
    .global_positions_dict)."""
    return dict(self._global_offsets)


def _rg_remove_sequence(self):
    self._sequence = None


def _rg_remove_liftover(self, dest):
    name = dest.name if hasattr(dest, 'name') else dest
    if hasattr(self, '_liftovers'):
        self._liftovers.pop(name, None)


def _rg_write(self, path: str):
    """Serialize in the reference's JSON schema (reference
    ReferenceGenome.write)."""
    import json as _json
    d = {
        'name': self.name,
        'contigs': [{'name': c, 'length': self.lengths[c]} for c in self.contigs],
        'xContigs': list(self.x_contigs),
        'yContigs': list(self.y_contigs),
        'mtContigs': list(self.mt_contigs),
        'par': [f'{c0}:{s}-{e}' for (c0, s, c1, e) in self._par_tuples],
    }
    with open(path, 'w') as f:
        _json.dump(d, f)


def _rg_from_fasta_file(name, fasta_file, index_file=None,
                        x_contigs=(), y_contigs=(), mt_contigs=(), par=()):
    """Build a reference genome from a FASTA + .fai index (reference
    ReferenceGenome.from_fasta_file)."""
    idx_path = index_file or fasta_file + '.fai'
    contigs = []
    lengths = {}
    with open(idx_path) as f:
        for line in f:
            parts = line.rstrip('\n').split('\t')
            if len(parts) >= 2:
                contigs.append(parts[0])
                lengths[parts[0]] = int(parts[1])
    rg = ReferenceGenome(name, contigs, lengths, x_contigs=x_contigs,
                         y_contigs=y_contigs, mt_contigs=mt_contigs,
                         par=[tuple(p) for p in par])
    rg.add_sequence(fasta_file, idx_path)
    return rg


ReferenceGenome.global_positions_dict = property(_rg_global_positions_dict)
ReferenceGenome.remove_sequence = _rg_remove_sequence
ReferenceGenome.remove_liftover = _rg_remove_liftover
ReferenceGenome.write = _rg_write
ReferenceGenome.from_fasta_file = staticmethod(_rg_from_fasta_file)
