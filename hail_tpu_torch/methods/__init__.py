from .statgen import (linear_regression_rows, logistic_regression_rows,
                      poisson_regression_rows, balding_nichols_model)
from .relatedness import identity_by_descent

__all__ = ['linear_regression_rows', 'logistic_regression_rows',
           'poisson_regression_rows', 'balding_nichols_model',
           'identity_by_descent']
