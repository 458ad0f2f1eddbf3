from .allele_type import AlleleType, allele_type
from .call import Call
from .locus import Locus
from .pedigree import Pedigree, Trio
from .reference_genome import ReferenceGenome, default_reference, set_default_reference

__all__ = [
    'AlleleType', 'allele_type', 'Call', 'Locus', 'Pedigree', 'Trio',
    'ReferenceGenome', 'default_reference', 'set_default_reference',
]
