"""Module alias: the reference exposes LinkedList at
`hail.utils.linkedlist` (reference `hail/utils/linkedlist.py`)."""

from .misc import LinkedList

__all__ = ['LinkedList']
