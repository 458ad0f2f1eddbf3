"""Trio / Pedigree: .fam file parsing.

Parity with reference `hail/python/hail/genetics/pedigree.py` — fresh
implementation of the PLINK .fam format (6 columns: fam_id, id, pat_id,
mat_id, sex, phenotype).
"""

from __future__ import annotations

from typing import List, Optional


class Trio:
    __slots__ = ('s', 'fam_id', 'pat_id', 'mat_id', 'is_female')

    def __init__(self, s: str, fam_id: Optional[str] = None, pat_id: Optional[str] = None,
                 mat_id: Optional[str] = None, is_female: Optional[bool] = None):
        self.s = s
        self.fam_id = fam_id
        self.pat_id = pat_id
        self.mat_id = mat_id
        self.is_female = is_female

    @property
    def is_male(self) -> Optional[bool]:
        return None if self.is_female is None else not self.is_female

    def is_complete(self) -> bool:
        return self.pat_id is not None and self.mat_id is not None

    def __eq__(self, other):
        if not isinstance(other, Trio):
            return NotImplemented
        return (self.s, self.fam_id, self.pat_id, self.mat_id, self.is_female) == \
               (other.s, other.fam_id, other.pat_id, other.mat_id, other.is_female)

    def __hash__(self):
        return hash((self.s, self.fam_id, self.pat_id, self.mat_id, self.is_female))

    def __repr__(self):
        return f'Trio(s={self.s!r}, fam_id={self.fam_id!r}, pat={self.pat_id!r}, mat={self.mat_id!r}, is_female={self.is_female})'


class Pedigree:
    def __init__(self, trios: List[Trio]):
        self.trios = list(trios)

    @classmethod
    def read(cls, fam_path: str, delimiter: str = r'\s+') -> 'Pedigree':
        import re
        trios = []
        with open(fam_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = re.split(delimiter, line)
                if len(parts) != 6:
                    raise ValueError(f'.fam line does not have 6 fields: {line!r}')
                fam, kid, dad, mom, sex, _pheno = parts
                is_female = {'1': False, '2': True}.get(sex)
                trios.append(Trio(
                    kid,
                    fam_id=None if fam == '0' else fam,
                    pat_id=None if dad == '0' else dad,
                    mat_id=None if mom == '0' else mom,
                    is_female=is_female,
                ))
        from collections import Counter
        from ..utils.misc import FatalError
        dup = [s for s, n in Counter(t.s for t in trios).items() if n > 1]
        if dup:
            raise FatalError(
                f'Invalid pedigree: found duplicate proband IDs\n{dup}')
        return cls(trios)

    def complete_trios(self) -> List[Trio]:
        return [t for t in self.trios if t.is_complete()]

    def filter_to(self, samples) -> 'Pedigree':
        s = set(samples)
        out = []
        for t in self.trios:
            out.append(Trio(
                t.s, t.fam_id,
                t.pat_id if t.pat_id in s else None,
                t.mat_id if t.mat_id in s else None,
                t.is_female,
            ))
        return Pedigree([t for t in out if t.s in s])

    def write(self, path: str) -> None:
        with open(path, 'w') as f:
            for t in self.trios:
                sex = '0' if t.is_female is None else ('2' if t.is_female else '1')
                f.write('\t'.join([
                    t.fam_id or '0', t.s, t.pat_id or '0', t.mat_id or '0', sex, '-9',
                ]) + '\n')

    def __eq__(self, other):
        return isinstance(other, Pedigree) and self.trios == other.trios

    def __repr__(self):
        return f'Pedigree({len(self.trios)} trios)'
