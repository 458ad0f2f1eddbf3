from . import utils
from .blockmatrix import (BlockMatrix, _breeze_from_ndarray, _eigh,
                          _jarray_from_ndarray, _svd)

__all__ = ['BlockMatrix', '_breeze_from_ndarray', '_eigh',
           '_jarray_from_ndarray', '_svd', 'utils']
