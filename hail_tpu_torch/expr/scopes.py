"""Axis-scope analysis over expression IR.

The reference tracks, for every expression, which dimensional axes it uses
outside aggregators (its free indices) and which it aggregates over
(`expressions/base_expression.py` indices + `check_*` helpers). Here the
information is recovered by walking the IR: environment references carry the
axis (`va` = row, `sa` = column, `g` = entry, `global` = none), and AggOp
subtrees count as aggregated usage."""

from __future__ import annotations

from typing import FrozenSet, Tuple

from ..ir.nodes import AggOp, Ref, aggregator_held_irs

_REF_AXES = {
    'va': frozenset({'row'}),
    'sa': frozenset({'column'}),
    'g': frozenset({'row', 'column'}),
    'global': frozenset(),
}


def axis_usage(ir) -> Tuple[FrozenSet[str], FrozenSet[str]]:
    """(free axes, aggregated axes) of a predicate IR."""
    free, agged = set(), set()

    def walk(node, in_agg):
        if isinstance(node, Ref):
            axes = _REF_AXES.get(node.name)
            if axes:
                (agged if in_agg else free).update(axes)
            return
        if isinstance(node, AggOp):
            for ch in node.args:
                walk(ch, True)
            if node.filter_ir is not None:
                walk(node.filter_ir, True)
            return
        for ch in getattr(node, 'children', ()):
            walk(ch, in_agg)

    walk(ir, False)
    return frozenset(free), frozenset(agged)


_BASE_AXES = {
    'row': frozenset({'row'}),
    'va': frozenset({'row'}),
    'sa': frozenset({'column'}),
    'g': frozenset({'row', 'column'}),
    'global': frozenset(),
}


def field_refs(ir):
    """[(field_name, axes, in_agg)] for every top-level field access
    (reference expression_utils.get_refs, keyed by the struct the field was
    read from)."""
    from ..ir.nodes import GetField
    out = []

    def walk(node, in_agg):
        if isinstance(node, GetField) and isinstance(node.struct, Ref):
            axes = _BASE_AXES.get(node.struct.name)
            if axes is not None:
                out.append((node.name, axes, in_agg))
                return
        if isinstance(node, AggOp):
            for ch in node.args:
                walk(ch, True)
            if node.filter_ir is not None:
                walk(node.filter_ir, True)
            for held in aggregator_held_irs(node.aggregator):
                walk(held, True)
            return
        ch = node.children() if callable(getattr(node, 'children', None)) \
            else getattr(node, 'children', ())
        for c in ch:
            if hasattr(c, 'children'):
                walk(c, in_agg)

    walk(ir, False)
    return out


def analyze(caller: str, expr, expected_axes, aggregation_axes=frozenset()):
    """Reject expressions whose free indices exceed the method's scope
    (reference expression_utils.analyze, the 'scope violation' error)."""
    from .typefuncs import ExpressionException
    expected = frozenset(expected_axes)
    agg_allowed = expected | frozenset(aggregation_axes)
    bad = []
    for name, axes, in_agg in field_refs(expr._ir):
        allowed = agg_allowed if in_agg else expected
        if axes - allowed:
            bad.append((name, axes))
    if bad:
        fields = ''.join(
            "\n        '{}' (indices {})".format(name, sorted(axes))
            for name, axes in bad)
        agg_note = ('' if not aggregation_axes else
                    "\n    '{}' supports aggregation over axes {}, so these "
                    'fields may appear inside an aggregator function.'.format(
                        caller, sorted(aggregation_axes)))
        raise ExpressionException(
            "scope violation: '{}' expects an expression indexed by {}"
            '\n    Found invalid fields:{}{}'.format(
                caller, sorted(expected), fields, agg_note))
