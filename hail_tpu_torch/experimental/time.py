"""Module alias: the reference exposes strftime/strptime at
`hail.experimental.time` (reference `hail/experimental/time.py`)."""

from .extras import strftime, strptime

__all__ = ['strftime', 'strptime']
