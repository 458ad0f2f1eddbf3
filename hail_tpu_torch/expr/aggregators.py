"""`hl.agg.*` aggregator API.

Parity with reference `hail/python/hail/expr/aggregators/aggregators.py`;
builds AggOp IR nodes evaluated by hail_tpu.ir.agg.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .. import types as ht
from ..ir import agg as A
from ..ir.nodes import AggOp, ApplyBinaryOp, IR
from .expression import Expression, Indices, construct_expr, to_expr, unify_all
from . import functions as F


def _refs_outside_aggs(ir: IR, names) -> list:
    """Names from `names` referenced outside any AggOp subtree of `ir`."""
    from ..ir.nodes import Ref
    found = []
    def rec(n):
        if isinstance(n, AggOp):
            return
        if isinstance(n, Ref) and n.name in names:
            found.append(n.name)
        for c in n.children:
            rec(c)
    rec(ir)
    return found


def _agg(aggregator: A.Aggregator, args, init_args=()) -> Expression:
    from ..ir import agg as aggmod
    exprs = [to_expr(a) for a in args]
    for e in exprs:
        if aggmod.collect_agg_nodes(e._ir):
            from .typefuncs import ExpressionException
            raise ExpressionException(
                f"'{aggregator.name}': cannot aggregate an already-aggregated expression")
    rt = aggregator.result_type([e.dtype for e in exprs], init_args)
    aggregator._result_t = rt
    ind = unify_all(*exprs) if exprs else Indices()
    node = AggOp(aggregator, [e._ir for e in exprs], rt, None, init_args)
    return construct_expr(node, ind)


def count() -> Expression:
    return _agg(A.CountAgg(), [])


def count_where(condition) -> Expression:
    return _agg(A.CountWhereAgg(), [condition])


def sum(expr) -> Expression:
    e = to_expr(expr)
    if isinstance(e.dtype, ht.tarray):
        return array_sum(e)
    return _agg(A.SumAgg(), [e])


def array_sum(expr) -> Expression:
    return _agg(A.ArraySumAgg(), [expr])


def ndarray_sum(expr) -> Expression:
    """Elementwise sum of ndarray records of the same shape (reference
    aggregators.py:961 ndarray_sum)."""
    return _agg(A.NDArraySumAgg(), [expr])


def product(expr) -> Expression:
    return _agg(A.ProductAgg(), [expr])


def mean(expr) -> Expression:
    return _agg(A.MeanAgg(), [expr])


def avg(expr) -> Expression:
    return mean(expr)


def stats(expr) -> Expression:
    return _agg(A.StatsAgg(), [expr])


def min(expr) -> Expression:
    return _agg(A.MinMaxAgg(True), [expr])


def max(expr) -> Expression:
    return _agg(A.MinMaxAgg(False), [expr])


def any(condition) -> Expression:
    return _agg(A.AnyAllAgg(True), [condition])


def all(condition) -> Expression:
    return _agg(A.AnyAllAgg(False), [condition])


def fraction(condition) -> Expression:
    return _agg(A.FractionAgg(), [condition])


def counter(expr, *, weight=None) -> Expression:
    if weight is not None:
        # reference aggregators.py counter: group_by(expr, sum(weight))
        return group_by(expr, sum(weight))
    return _agg(A.CollectAgg('counter'), [expr])


def collect(expr) -> Expression:
    return _agg(A.CollectAgg('collect'), [expr])


def collect_as_set(expr) -> Expression:
    return _agg(A.CollectAgg('collect_as_set'), [expr])


def take(expr, n, ordering=None) -> Expression:
    if ordering is not None:
        e = to_expr(expr)
        key = to_expr(ordering(e)) if callable(ordering) else to_expr(ordering)
        return _agg(A.TakeByAgg(), [e, key], (n,))
    return _agg(A.TakeAgg(), [expr], (n,))


def _take_by(expr, key, n) -> Expression:
    return _agg(A.TakeByAgg(), [expr, key], (n,))


def call_stats(call, alleles) -> Expression:
    c = to_expr(call)
    a = to_expr(alleles)
    if isinstance(a.dtype, ht.tarray):
        n_alleles = a.length()
    else:
        n_alleles = a
    return _agg(A.CallStatsAgg(), [c, n_alleles])


def hardy_weinberg_test(call, one_sided: bool = False) -> Expression:
    return _agg(A.HWEAgg(), [call], (bool(one_sided),))


def inbreeding(call, prior) -> Expression:
    return _agg(A.InbreedingAgg(), [call, prior])


def hist(expr, start, end, bins) -> Expression:
    return _agg(A.HistAgg(), [expr], (start, end, bins))


def corr(x, y) -> Expression:
    return _agg(A.CorrAgg(), [x, y])


def linreg(y, x, nested_dim: int = 1, weight=None) -> Expression:
    """Per-group linear regression aggregator (reference
    `agg/LinearRegressionAggregator`). For the GWAS path use
    hail_tpu.methods.linear_regression_rows (jit tier)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    ye = to_expr(y)
    xes = [to_expr(xx) for xx in xs]
    if weight is not None:
        we = to_expr(weight)
        return _agg(A.LinRegAgg(), [ye] + xes + [we],
                    (len(xes), nested_dim, True))
    return _agg(A.LinRegAgg(), [ye] + xes, (len(xes), nested_dim, False))


def info_score(gp) -> Expression:
    return _agg(A.InfoScoreAgg(), [gp])


def filter(condition, agg_expr) -> Expression:
    """Restrict an aggregation to records where `condition` holds."""
    from ..ir import agg as aggmod
    cond = to_expr(condition)
    e = to_expr(agg_expr)
    if not aggmod.collect_agg_nodes(e._ir):
        from .typefuncs import ExpressionException
        raise ExpressionException(
            "'filter': the aggregation expression must contain aggregations")

    def add_filter(ir: IR) -> IR:
        if isinstance(ir, AggOp):
            new_filter = cond._ir if ir.filter_ir is None else ApplyBinaryOp('&', ir.filter_ir, cond._ir)
            # fresh uid: the filtered copy must NOT share state with the
            # original node (hl.agg.filter(c, x) alongside bare x aggregates
            # two distinct states — reference test_aggregator_cse)
            return type(ir)(ir.aggregator, ir.args, ir.typ, new_filter, ir.init_args)
        return ir.map_children(add_filter)

    return construct_expr(add_filter(e._ir), unify_all(cond, e))


def explode(f, array_agg_expr) -> Expression:
    """Aggregate over the elements of an array/set expression (reference
    agg.explode / AggExplode)."""
    from ..ir import agg as aggmod
    from .expression import _fresh_name, construct_expr, Indices
    from ..ir.nodes import Ref
    arr = to_expr(array_agg_expr)
    var = _fresh_name('exp_elem')
    elem = construct_expr(Ref(var, arr.dtype.element_type), arr._indices)
    inner = to_expr(f(elem))
    if _refs_outside_aggs(inner._ir, {var}):
        from .typefuncs import ExpressionException
        raise ExpressionException(
            "'explode': the exploded element may only be referenced inside "
            "aggregations in the lambda body")
    inner_nodes = aggmod.collect_agg_nodes(inner._ir)
    agg_ = A.ExplodedAgg(arr._ir, var, inner._ir, inner_nodes, inner.dtype)
    node = AggOp(agg_, [], inner.dtype)
    return construct_expr(node, unify_all(arr, inner))


def group_by(group, agg_expr) -> Expression:
    """Group records by a key expression and aggregate within groups
    (reference agg.group_by / GroupedAggregator)."""
    from ..ir import agg as aggmod
    key = to_expr(group)
    e = to_expr(agg_expr)
    import builtins
    inner_nodes_pre = aggmod.collect_agg_nodes(e._ir)
    is_scan = builtins.any(getattr(n, 'is_scan', False) for n in inner_nodes_pre)
    # scans are per-row results so row refs in the body are fine; plain
    # aggregations may only use row fields inside the inner aggregators
    if not is_scan and _refs_outside_aggs(e._ir, {'row'}):
        from .typefuncs import ExpressionException
        raise ExpressionException(
            "'group_by': row fields may only be referenced inside "
            "aggregations in the group body")
    inner_nodes = aggmod.collect_agg_nodes(e._ir)
    agg_ = A.GroupedAgg(key._ir, e._ir, inner_nodes, key.dtype, e.dtype)
    node = AggOp(agg_, [], ht.tdict(key.dtype, e.dtype))
    return construct_expr(node, unify_all(key, e))


def array_agg(f, array) -> Expression:
    """Aggregate positionally across same-length arrays (reference
    agg.array_agg / AggArrayPerElement)."""
    from ..ir import agg as aggmod
    from .expression import _fresh_name, construct_expr
    from ..ir.nodes import Ref
    arr = to_expr(array)
    var = _fresh_name('aa_elem')
    elem = construct_expr(Ref(var, arr.dtype.element_type), arr._indices)
    inner = to_expr(f(elem))
    inner_nodes = aggmod.collect_agg_nodes(inner._ir)
    agg_ = A.ArrayAggAgg(arr._ir, var, inner._ir, inner_nodes, inner.dtype)
    node = AggOp(agg_, [], ht.tarray(inner.dtype))
    return construct_expr(node, unify_all(arr, inner))


def fold(zero, seq_op, comb_op) -> Expression:
    """Generic fold aggregator (reference agg.fold / AggFold)."""
    from .expression import _fresh_name, construct_expr
    from ..ir.nodes import Ref
    z = to_expr(zero)
    accum_name = _fresh_name('fold_acc')
    accum = construct_expr(Ref(accum_name, z.dtype))
    seq = to_expr(seq_op(accum))
    a1, a2 = _fresh_name('fold_a'), _fresh_name('fold_b')
    c1 = construct_expr(Ref(a1, z.dtype))
    c2 = construct_expr(Ref(a2, z.dtype))
    comb = to_expr(comb_op(c1, c2))

    def refs_fields(ir):
        from ..ir.nodes import Ref as _Ref
        if isinstance(ir, _Ref) and ir.name in ('va', 'sa', 'g', 'global'):
            return True
        import builtins
        return builtins.any(refs_fields(c) for c in getattr(ir, 'children', ()))
    if refs_fields(comb._ir):
        from ..utils.misc import HailUserError
        raise HailUserError(
            'The comb_op function of fold cannot reference any fields')
    agg_ = A.FoldAgg(z._ir, accum_name, seq._ir, a1, a2, comb._ir, z.dtype)
    node = AggOp(agg_, [], z.dtype)
    return construct_expr(node, unify_all(z, seq))


def approx_cdf(expr, k: int = 100, _raw: bool = False) -> Expression:
    return _agg(A.ApproxCDFAgg(), [expr], (k, _raw))


def approx_quantiles(expr, qs, k: int = 100) -> Expression:
    cdf = approx_cdf(expr, k)
    if isinstance(qs, (list, tuple)):
        return F.array([_cdf_quantile(cdf, q) for q in qs])
    return _cdf_quantile(cdf, qs)


def approx_median(expr, k: int = 100) -> Expression:
    return approx_quantiles(expr, 0.5, k)


def _cdf_quantile(cdf_expr, q):
    values = cdf_expr['values']
    ranks = cdf_expr['ranks']
    n = ranks[-1]
    target = F.int64(F.floor(q * F.float64(n)))
    def pick(vals, rks, t):
        # first value whose rank exceeds target
        return vals[F.max(0, F.argmax(rks.map(lambda r: F.if_else(r <= t, 1, 0))) - 0)]
    # simple approach: index via fold
    idx = ranks.fold(lambda acc, r: F.if_else(r <= target, acc + 1, acc), 0) - 1
    return values[F.max(0, F.min(idx, values.length() - 1))]


def downsample(x, y, label=None, n_divisions: int = 500) -> Expression:
    args = [to_expr(x), to_expr(y)]
    if label is not None:
        args.append(to_expr(label))
    return _agg(A.DownsampleAgg(), args, (n_divisions, label is not None))


def _reservoir_sample(expr, n) -> Expression:
    """Uniform sample of n records (reference _reservoir_sample)."""
    return _agg(A.ReservoirSampleAgg(), [expr], (n,))


def _prev_nonnull(expr) -> Expression:
    """Last non-missing value in order (reference _prev_nonnull)."""
    return _agg(A.PrevNonnullAgg(), [expr])


def _densify(len_, expr) -> Expression:
    """Positional forward-fill over fixed-length arrays (reference _densify):
    each output slot holds the last non-missing element seen at that index."""
    return _agg(A.DensifyAgg(), [to_expr(expr), to_expr(len_)])


def _aggregate_local_array(array, f):
    """Aggregate over a local array's elements (reference
    _aggregate_local_array); same as ArrayExpression.aggregate."""
    return to_expr(array).aggregate(f)


def _check_agg_bindings(*args, **kwargs):
    return None


def _impute_type(x):
    from .expression import impute_type as _it
    return _it(x)
