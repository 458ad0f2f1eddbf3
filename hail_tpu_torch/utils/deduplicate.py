"""Module alias: the reference exposes deduplicate at
`hail.utils.deduplicate` (reference `hail/utils/deduplicate.py`)."""

from .misc import deduplicate

__all__ = ['deduplicate']
