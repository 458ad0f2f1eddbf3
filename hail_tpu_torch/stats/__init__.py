from .hwe import hwe_test, hwe_test_vec

__all__ = ['hwe_test', 'hwe_test_vec']
