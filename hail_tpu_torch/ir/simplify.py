"""Relational rewrite rules — the Simplify layer.

The reference runs a dedicated rewrite pass over its relational IR
(`is/hail/expr/ir/Simplify.scala`, ~1.7k LoC of rules applied to fixpoint
before lowering). This engine lowers eagerly — each Table operator extends a
TableStage pipeline at call time — so the same rewrites are applied *at
construction*, when both sides of the rule are visible:

- **filter fusion** (`Simplify.scala` TableFilter(TableFilter(t, a), b) →
  TableFilter(t, a && b)): `Table.filter` on a table whose stage is itself a
  filter re-plans from the filter's parent, evaluating every predicate on
  the same materialized batch and compressing once — one pass over the data
  instead of one per filter.
- **count-of-known-length** (`Simplify.scala` TableCount(TableRange(n)) →
  n, TableCount(TableMapRows(t, _)) → TableCount(t)): TableStage carries
  `known_counts` (per-partition row counts) when the source declares them
  (range_table, materialized batches) and every downstream operator is
  length-preserving (annotate/select/drop/rename). `Table.count` then
  answers without touching a single partition.
- **literal-predicate shortcut** (TableFilter(t, True) → t,
  TableFilter(t, False) → empty): `Table.filter` returns its input or an
  empty zero-partition stage without building a pipeline stage.

The row-expression side (constant folding, If(True, a, b) → a, dead-let
elimination …) is XLA's job: value-level expressions compile through
jax.jit, where the compiler's simplification pass subsumes the reference's
scalar rules.

This module holds the helpers shared by those call sites; the rules
themselves live where the operators are built (`table.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple


def literal_bool_predicate(ir) -> Optional[bool]:
    """The predicate's static truth value, if it is a literal (or a
    missing literal, which filters like False), else None."""
    from . import nodes
    if isinstance(ir, nodes.Literal) and isinstance(ir.value, bool):
        return ir.value
    if isinstance(ir, nodes.NA):
        return False
    return None


def fused_filter_tag(parents_tag: Optional[str],
                     preds) -> Optional[str]:
    """Cache-correct lineage tag for a conjunction of filter predicates.

    The fused stage must hash identically whether it was built as one
    filter call or as a chain that the rewrite collapsed — the tag is
    derived from the ordered (semhash, keep) list, not from the pipeline
    shape, mirroring how the reference's SemanticHash is computed on the
    *simplified* IR."""
    from .semhash import semhash
    parts = []
    for e, keep in preds:
        sh = semhash(e._ir)
        if sh is None:
            return None
        parts.append(f'filter:{keep}:{sh}')
    return '|'.join(parts)
