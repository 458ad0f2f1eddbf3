from .backend import Backend, LocalBackend

__all__ = ['Backend', 'LocalBackend']
