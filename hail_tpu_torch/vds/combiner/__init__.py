"""VDS combiner package (reference `hail/vds/combiner/__init__.py`)."""

from .combine import (combine_references, combine_variant_datasets,
                      defined_entry_fields, make_ref_entry_struct,
                      parse_allele_specific_fields, transform_gvcf)
from .variant_dataset_combiner import (VariantDatasetCombiner, VDS_VERSION,
                                       load_combiner, new_combiner)

__all__ = [
    'VariantDatasetCombiner',
    'VDS_VERSION',
    'combine_references',
    'combine_variant_datasets',
    'defined_entry_fields',
    'load_combiner',
    'make_ref_entry_struct',
    'new_combiner',
    'parse_allele_specific_fields',
    'transform_gvcf',
]
