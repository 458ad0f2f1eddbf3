"""`hl.scan.*` — streaming prefix (scan) aggregators.

Parity with reference scan support (`aggregators.py` scan variants lowered by
`LowerTableIR.scala:1607-1660` two-phase prefix). Round-1: exclusive prefix
scans over tables, computed per partition with carried prefix states.
"""

from __future__ import annotations

import numpy as np

from .. import types as ht
from ..ir import agg as A
from ..ir.nodes import AggOp
from .expression import Expression, Indices, construct_expr, to_expr, unify_all


class ScanOp(AggOp):
    """Marker subclass: same aggregator machinery, prefix semantics."""
    is_scan = True


def _scan(aggregator, args, init_args=()) -> Expression:
    exprs = [to_expr(a) for a in args]
    rt = aggregator.result_type([e.dtype for e in exprs], init_args)
    ind = unify_all(*exprs) if exprs else Indices()
    node = ScanOp(aggregator, [e._ir for e in exprs], rt, None, init_args)
    return construct_expr(node, ind)


def count() -> Expression:
    return _scan(A.CountAgg(), [])


def sum(expr) -> Expression:
    return _scan(A.SumAgg(), [expr])


def mean(expr) -> Expression:
    return _scan(A.MeanAgg(), [expr])


def min(expr) -> Expression:
    return _scan(A.MinMaxAgg(True), [expr])


def max(expr) -> Expression:
    return _scan(A.MinMaxAgg(False), [expr])


def count_where(cond) -> Expression:
    return _scan(A.CountWhereAgg(), [cond])


def collect(expr) -> Expression:
    return _scan(A.CollectAgg('collect'), [expr])


# ---------------------------------------------------------------------------
# full aggregator mirror: every hl.agg.* is available as hl.scan.* (reference
# aggregators.py scan variants). Build the aggregation expression, then mark
# its AggOp nodes as ScanOp — prefix evaluation uses ir/agg.scan_partition
# (vectorized fast paths + a generic sequential fallback).
# ---------------------------------------------------------------------------

def _scanify(e: Expression) -> Expression:
    def conv(ir):
        new = ir.map_children(conv)
        if type(new) is AggOp:
            s = ScanOp.__new__(ScanOp)
            s.__dict__.update(new.__dict__)
            return s
        return new
    out = Expression.__new__(type(e))
    out.__dict__.update(e.__dict__)
    out._ir = conv(e._ir)
    return out


def _mirror(agg_name):
    from . import aggregators as _aggmod
    f = getattr(_aggmod, agg_name)

    def scan_fn(*args, **kwargs):
        return _scanify(f(*args, **kwargs))
    scan_fn.__name__ = agg_name
    scan_fn.__doc__ = f'Scan (running prefix) form of hl.agg.{agg_name}.'
    return scan_fn


_MIRRORED = [
    'any', 'all', 'approx_cdf', 'approx_median', 'approx_quantiles',
    'array_agg', 'array_sum', 'ndarray_sum', 'avg', 'call_stats',
    'collect_as_set', 'corr', 'counter', 'downsample', 'explode', 'filter',
    'fraction', 'group_by', 'hardy_weinberg_test', 'hist', 'info_score',
    'inbreeding', 'linreg', 'product', 'stats', 'take', '_take_by', 'fold',
    '_reservoir_sample', '_prev_nonnull', '_densify',
]

import sys as _sys
_self = _sys.modules[__name__]
for _n in _MIRRORED:
    try:
        from . import aggregators as _aggmod_check
        if hasattr(_aggmod_check, _n) and not hasattr(_self, _n):
            setattr(_self, _n, _mirror(_n))
    except Exception:
        pass
del _sys, _self, _n
