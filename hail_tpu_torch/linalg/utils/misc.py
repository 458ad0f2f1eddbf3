"""Window helpers for banded BlockMatrix sparsification
(reference hail/linalg/utils/misc.py)."""

from __future__ import annotations

import numpy as np


def array_windows(a: np.ndarray, radius):
    """For ascending `a`, per-index maximal [start, stop) ranges of values
    within +/- radius (reference linalg/utils/misc.py:10).

    >>> array_windows(np.array([1, 2, 4, 4, 6, 8]), 2)
    (array([0, 0, 1, 1, 2, 4]), array([2, 4, 5, 5, 6, 6]))
    """
    if radius < 0:
        raise ValueError(f'array_windows: radius must be non-negative, found {radius}')
    if a.ndim != 1:
        raise ValueError("array_windows: 'a' must be 1-dimensional")
    if not (np.issubdtype(a.dtype, np.signedinteger) or np.issubdtype(a.dtype, np.floating)):
        raise ValueError(f"array_windows: 'a' must be signed integer or float, found {a.dtype}")
    size = a.size
    if size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if (not np.all(a[:-1] <= a[1:])) or np.isnan(a[0]):
        raise ValueError("array_windows: 'a' must be ascending with no nan elements")
    # vectorized: searchsorted on the sorted array gives the same maximal
    # ranges as the reference's two-pointer sweep
    starts = np.searchsorted(a, a - radius, side='left').astype(np.int64)
    stops = np.searchsorted(a, a + radius, side='right').astype(np.int64)
    return starts, stops


def locus_windows(locus_expr, radius, coord_expr=None, _localize=True):
    """Window ranges for loci within `radius` base pairs on the same contig
    (reference linalg/utils/misc.py:82). Contig boundaries break windows."""
    from ...expr.expression import to_expr
    from ...expr.typefuncs import ExpressionException
    from ...utils.misc import FatalError, HailUserError
    e = to_expr(locus_expr)
    src = e._indices.source
    if src is None:
        raise ExpressionException("locus_windows: 'locus_expr' has no source")
    if 'row' not in e._indices.axes:
        raise ExpressionException(
            "locus_windows: 'locus_expr' must be row-indexed")
    ce = None
    if coord_expr is not None:
        ce = to_expr(coord_expr)
        csrc = ce._indices.source
        if csrc is None:
            raise ExpressionException(
                "locus_windows: 'coord_expr' has no source")
        if csrc is not src:
            raise ExpressionException(
                "locus_windows: 'coord_expr' has a different source than "
                "'locus_expr'")
        if 'row' not in ce._indices.axes:
            raise ExpressionException(
                "locus_windows: 'coord_expr' must be row-indexed")
    st = src._stage
    loci = []
    coords_l = []
    for i, ctx in enumerate(st.contexts):
        b = st.partition_fn(ctx)
        env = src._row_env(b, i)
        loci.extend(e._ir.evaluate(env).to_pylist())
        if ce is not None:
            coords_l.extend(ce._ir.evaluate(env).to_pylist())
    if any(l is None for l in loci):
        raise HailUserError("locus_windows: missing value for 'locus_expr'")
    contigs = np.asarray([l.contig for l in loci])
    if coord_expr is None:
        coords = np.asarray([l.position for l in loci], dtype=np.float64)
    else:
        if any(c is None for c in coords_l):
            raise FatalError(
                "locus_windows: missing value for 'coord_expr'")
        coords = np.asarray(coords_l, dtype=np.float64)
    # loci must ascend in global position (reference checks the same)
    gpos = np.asarray([l.reference_genome.global_position(l.contig, l.position)
                       if l.reference_genome is not None else l.position
                       for l in loci], dtype=np.int64)
    if not np.all(gpos[:-1] <= gpos[1:]):
        raise HailUserError(
            "locus_windows: 'locus_expr' must be in ascending order")
    n = len(coords)
    starts = np.zeros(n, np.int64)
    stops = np.zeros(n, np.int64)
    i = 0
    while i < n:
        j = i
        while j < n and contigs[j] == contigs[i]:
            j += 1
        s, t = array_windows(coords[i:j], radius)
        starts[i:j] = s + i
        stops[i:j] = t + i
        i = j
    return starts, stops


def _check_dims(a, name: str, ndim: int, min_size: int = 1):
    if a.ndim != ndim:
        raise ValueError(f'{name} must be {ndim}-dimensional, found {a.ndim}')
    for i in range(ndim):
        if a.shape[i] < min_size:
            raise ValueError(f'{name} must have at least {min_size} elements in axis {i}')
