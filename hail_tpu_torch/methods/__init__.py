from .qc import (sample_qc, variant_qc, summarize_variants, vep_json_typ,
                 VEPConfig, VEPConfigGRCh37Version85, VEPConfigGRCh38Version95)
from .statgen import (linear_regression_rows, logistic_regression_rows,
                      poisson_regression_rows, balding_nichols_model,
                      split_multi, split_multi_hts, ld_prune,
                      genetic_relatedness_matrix, realized_relationship_matrix,
                      row_correlation, impute_sex, ld_matrix, lambda_gc,
                      filter_alleles, filter_alleles_hts,
                      simulate_random_mating, skat, _linear_skat,
                      _logistic_skat, linear_mixed_model,
                      linear_mixed_regression_rows,
                      _linear_regression_rows_nd, _logistic_regression_rows_nd)
from .pca import (pca, hwe_normalized_pca, _blanczos_pca, _spectral_moments,
                  _hwe_normalized_blanczos, _pca_and_moments)
from .relatedness import identity_by_descent, king, pc_relate, maximal_independent_set
from .family_methods import (trio_matrix, mendel_errors, de_novo,
                             transmission_disequilibrium_test)
from .misc import (rename_duplicates, filter_intervals, segment_intervals,
                   compute_charr, concordance, require_biallelic,
                   require_row_key_variant)
from .annotators import vep, nirvana
from .impex import (import_vcf, export_vcf, import_plink, export_plink,
                    import_bgen, export_bgen, index_bgen, import_gen, export_gen,
                    import_table, export_table, import_lines, import_fam,
                    import_bed, import_locus_intervals, import_matrix_table,
                    get_vcf_metadata, grep, import_avro, import_csv,
                    get_vcf_header_info, import_gvcf_interval,
                    export_elasticsearch)

__all__ = ['sample_qc', 'variant_qc', 'linear_regression_rows',
           'logistic_regression_rows', 'poisson_regression_rows',
           'balding_nichols_model', 'split_multi', 'split_multi_hts',
           'ld_prune', 'genetic_relatedness_matrix',
           'realized_relationship_matrix', 'row_correlation', 'impute_sex',
           'ld_matrix', 'lambda_gc', 'simulate_random_mating', 'skat',
           'linear_mixed_model', 'linear_mixed_regression_rows',
           'pca', 'hwe_normalized_pca',
           'identity_by_descent', 'king', 'pc_relate', 'maximal_independent_set',
           'trio_matrix', 'mendel_errors', 'de_novo',
           'transmission_disequilibrium_test', 'rename_duplicates',
           'filter_intervals', 'segment_intervals', 'compute_charr',
           'concordance', 'vep', 'nirvana',
           'import_vcf', 'export_vcf', 'import_plink', 'export_plink',
           'import_bgen', 'export_bgen', 'index_bgen', 'import_gen',
           'export_gen', 'import_table', 'export_table', 'import_lines',
           'import_fam', 'import_bed', 'import_locus_intervals',
           'import_matrix_table', 'get_vcf_metadata', 'grep', 'import_avro',
           'import_csv', 'get_vcf_header_info', 'import_gvcf_interval',
           'export_elasticsearch', 'summarize_variants', 'vep_json_typ',
           'VEPConfig', 'VEPConfigGRCh37Version85', 'VEPConfigGRCh38Version95',
           'filter_alleles', 'filter_alleles_hts']
