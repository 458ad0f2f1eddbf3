"""Human-readable binary file sizes (reference hailtop/utils/filesize.py)."""

from __future__ import annotations

_PREFIXES = 'KMGTPEZY'


def filesize(n: int) -> str:
    """`n` bytes with a binary prefix, floor-rounded; capped at YiB."""
    if n < 0:
        raise ValueError(f'n must be non-negative: {n}')
    if n < 1024:
        return f'{n}B'
    for p in _PREFIXES:
        n //= 1024
        if n < 1024 or p == _PREFIXES[-1]:
            return f'{n}{p}iB'
    raise AssertionError('unreachable')
