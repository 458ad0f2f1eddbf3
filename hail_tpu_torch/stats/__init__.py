from .hwe import hwe_test, hwe_test_vec
from .linear_mixed_model import LinearMixedModel

__all__ = ['hwe_test', 'hwe_test_vec', 'LinearMixedModel']
