from .statgen import (linear_regression_rows, logistic_regression_rows,
                      poisson_regression_rows, balding_nichols_model,
                      ld_prune, genetic_relatedness_matrix,
                      realized_relationship_matrix, row_correlation,
                      ld_matrix)
from .relatedness import identity_by_descent

__all__ = ['linear_regression_rows', 'logistic_regression_rows',
           'poisson_regression_rows', 'balding_nichols_model',
           'ld_prune', 'genetic_relatedness_matrix',
           'realized_relationship_matrix', 'row_correlation', 'ld_matrix',
           'identity_by_descent']
