from .qc import (sample_qc, variant_qc, summarize_variants, vep_json_typ,
                 VEPConfig, VEPConfigGRCh37Version85, VEPConfigGRCh38Version95)
from .statgen import (linear_regression_rows, logistic_regression_rows,
                      poisson_regression_rows, balding_nichols_model,
                      split_multi, split_multi_hts, ld_prune,
                      genetic_relatedness_matrix, realized_relationship_matrix,
                      row_correlation, impute_sex, ld_matrix, lambda_gc,
                      filter_alleles, filter_alleles_hts,
                      _linear_regression_rows_nd, _logistic_regression_rows_nd)
from .pca import (pca, hwe_normalized_pca, _blanczos_pca, _spectral_moments,
                  _hwe_normalized_blanczos, _pca_and_moments)
from .relatedness import identity_by_descent, king, pc_relate, maximal_independent_set
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
           'ld_matrix', 'lambda_gc',
           'pca', 'hwe_normalized_pca',
           'identity_by_descent', 'king', 'pc_relate', 'maximal_independent_set',
           'import_vcf', 'export_vcf', 'import_plink', 'export_plink',
           'import_bgen', 'export_bgen', 'index_bgen', 'import_gen',
           'export_gen', 'import_table', 'export_table', 'import_lines',
           'import_fam', 'import_bed', 'import_locus_intervals',
           'import_matrix_table', 'get_vcf_metadata', 'grep', 'import_avro',
           'import_csv', 'get_vcf_header_info', 'import_gvcf_interval',
           'export_elasticsearch', 'summarize_variants', 'vep_json_typ',
           'VEPConfig', 'VEPConfigGRCh37Version85', 'VEPConfigGRCh38Version95',
           'filter_alleles', 'filter_alleles_hts']
