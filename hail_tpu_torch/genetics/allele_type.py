"""Allele classification (SNP/insertion/deletion/...).

Parity with reference `hail/python/hail/genetics/allele_type.py` and the
AlleleType logic in `is/hail/variant/AltAlleleMethods` — fresh implementation.
"""

from __future__ import annotations

from enum import IntEnum


class AlleleType(IntEnum):
    UNKNOWN = 0
    SNP = 1
    MNP = 2
    INSERTION = 3
    DELETION = 4
    COMPLEX = 5
    STAR = 6
    SYMBOLIC = 7
    TRANSITION = 8
    TRANSVERSION = 9

    def __str__(self):
        return self.name

    @property
    def pretty_name(self):
        # reference genetics/allele_type.py _ALLELE_STRS: acronyms stay
        # uppercase ('SNP', 'MNP'), the rest are capitalized ('Insertion')
        if self.name in ('SNP', 'MNP'):
            return self.name
        return self.name.capitalize()


_TRANSITIONS = {('A', 'G'), ('G', 'A'), ('C', 'T'), ('T', 'C')}

_BASES = frozenset('ACGTNacgtn')


def _is_symbolic(alt: str) -> bool:
    """VCF symbolic/breakend alt forms: <ID>, [p[t / ]p]t, and
    single-breakend '.'-anchored alleles (reference AltAlleleMethods)."""
    if not alt:
        return False
    return ('[' in alt or ']' in alt
            or ('<' in alt and '>' in alt)
            or alt[0] == '.' or alt[-1] == '.')


def _valid_bases(s: str) -> bool:
    return len(s) > 0 and all(c in _BASES for c in s)


def allele_type(ref: str, alt: str, include_ti_tv: bool = False) -> AlleleType:
    if _is_symbolic(alt):
        return AlleleType.SYMBOLIC
    if alt == '*':
        return AlleleType.STAR
    if not _valid_bases(ref) or not _valid_bases(alt):
        return AlleleType.UNKNOWN
    if ref == alt:
        return AlleleType.UNKNOWN
    if len(ref) == len(alt):
        if len(ref) == 1:
            if include_ti_tv:
                if (ref.upper(), alt.upper()) in _TRANSITIONS:
                    return AlleleType.TRANSITION
                return AlleleType.TRANSVERSION
            return AlleleType.SNP
        n_mismatch = sum(1 for a, b in zip(ref, alt) if a != b)
        if n_mismatch == 1:
            return AlleleType.SNP if not include_ti_tv else (
                AlleleType.TRANSITION
                if next((a.upper(), b.upper()) for a, b in zip(ref, alt) if a != b) in _TRANSITIONS
                else AlleleType.TRANSVERSION
            )
        return AlleleType.MNP
    # indel classification anchors the shared first base and requires the
    # shorter allele's tail to be a suffix of the longer one
    if len(ref) < len(alt):
        if ref[0] == alt[0] and alt.endswith(ref[1:]):
            return AlleleType.INSERTION
        return AlleleType.COMPLEX
    if ref[0] == alt[0] and ref.endswith(alt[1:]):
        return AlleleType.DELETION
    return AlleleType.COMPLEX


def is_snp(ref: str, alt: str) -> bool:
    return allele_type(ref, alt) == AlleleType.SNP


def is_mnp(ref: str, alt: str) -> bool:
    return allele_type(ref, alt) == AlleleType.MNP


def is_insertion(ref: str, alt: str) -> bool:
    return allele_type(ref, alt) == AlleleType.INSERTION


def is_deletion(ref: str, alt: str) -> bool:
    return allele_type(ref, alt) == AlleleType.DELETION


def is_indel(ref: str, alt: str) -> bool:
    return allele_type(ref, alt) in (AlleleType.INSERTION, AlleleType.DELETION)


def is_star(ref: str, alt: str) -> bool:
    return alt == '*'


def is_complex(ref: str, alt: str) -> bool:
    return allele_type(ref, alt) == AlleleType.COMPLEX

def is_transition(ref: str, alt: str) -> bool:
    return allele_type(ref, alt, include_ti_tv=True) == AlleleType.TRANSITION


def is_transversion(ref: str, alt: str) -> bool:
    return allele_type(ref, alt, include_ti_tv=True) == AlleleType.TRANSVERSION
