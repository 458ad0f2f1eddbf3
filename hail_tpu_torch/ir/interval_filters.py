"""Extract key-range constraints from filter predicates.

The analogue of the reference's `ExtractIntervalFilters.scala`: a filter
predicate over a table/matrix row key is analysed for comparisons against
literals (`locus < L`, `locus.position >= p`, `locus.contig == c`,
`row_key == struct`, conjunctions/disjunctions thereof). The result is a
union of closed global-position ranges that COVERS every row which could
satisfy the predicate; partitions whose key bounds miss all ranges are
pruned before execution. Unrecognised sub-predicates relax to
"unconstrained", so pruning is always sound.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .nodes import (Apply, ApplyBinaryOp, ApplyUnaryOp, GetField, IsMissing,
                    Literal, MakeStruct, Ref)

# A constraint is None (unconstrained) or a sorted list of closed
# [lo, hi] global-position ranges (empty list = provably no rows).
Ranges = Optional[List[Tuple[int, int]]]

_FLIP = {'<': '>', '<=': '>=', '>': '<', '>=': '<=', '==': '=='}


def _merge(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    if not ranges:
        return []
    ranges = sorted(ranges)
    out = [ranges[0]]
    for lo, hi in ranges[1:]:
        plo, phi = out[-1]
        if lo <= phi + 1:
            out[-1] = (plo, max(phi, hi))
        else:
            out.append((lo, hi))
    return out


def _intersect(a: Ranges, b: Ranges) -> Ranges:
    if a is None:
        return b
    if b is None:
        return a
    out = []
    for alo, ahi in a:
        for blo, bhi in b:
            lo, hi = max(alo, blo), min(ahi, bhi)
            if lo <= hi:
                out.append((lo, hi))
    return _merge(out)


def _union(a: Ranges, b: Ranges) -> Ranges:
    if a is None or b is None:
        return None
    return _merge(a + b)


class _KeyAnalyzer:
    def __init__(self, key_field: str, rg):
        self.key_field = key_field
        self.rg = rg
        total = sum(rg.lengths[c] for c in rg.contigs) if rg is not None else None
        self.max_gp = (total - 1) if total else None

    # -- pattern recognisers ------------------------------------------------
    def _is_key(self, ir) -> bool:
        """GetField(Ref(row), key_field) — the key column itself."""
        return (isinstance(ir, GetField) and ir.name == self.key_field
                and isinstance(ir.struct, Ref))

    def _key_apply(self, ir, fn_name: str) -> bool:
        """Apply(fn_name, key) — e.g. locus.position / locus.contig."""
        return (isinstance(ir, Apply) and ir.name == fn_name
                and len(ir.args) == 1 and self._is_key(ir.args[0]))

    # -- range builders -----------------------------------------------------
    def _gp_cmp(self, op: str, gp: int) -> Ranges:
        if op == '<':
            return [(0, gp - 1)] if gp > 0 else []
        if op == '<=':
            return [(0, gp)]
        if op == '==':
            return [(gp, gp)]
        if op == '>=':
            return [(gp, self.max_gp)]
        if op == '>':
            return [(gp + 1, self.max_gp)] if gp < self.max_gp else []
        return None

    def _position_cmp(self, op: str, p: int) -> Ranges:
        """Per-contig ranges for `position CMP p` (1-based positions)."""
        out = []
        for c in self.rg.contigs:
            off = self.rg._global_offsets[c]
            n = self.rg.lengths[c]
            # positions within contig: 1..n → gp off..off+n-1
            if op == '<':
                lo, hi = 1, min(p - 1, n)
            elif op == '<=':
                lo, hi = 1, min(p, n)
            elif op == '==':
                lo, hi = p, (p if p <= n else 0)
            elif op == '>=':
                lo, hi = max(p, 1), n
            elif op == '>':
                lo, hi = max(p + 1, 1), n
            else:
                return None
            if lo <= hi:
                out.append((off + lo - 1, off + hi - 1))
        return _merge(out)

    def _contig_eq(self, c: str) -> Ranges:
        if c not in self.rg.lengths:
            return []
        off = self.rg._global_offsets[c]
        return [(off, off + self.rg.lengths[c] - 1)]

    # -- main walk ----------------------------------------------------------
    def analyze(self, ir) -> Ranges:
        if isinstance(ir, Literal):
            if ir.value is True:
                return None
            if ir.value is False:
                return []
            return None
        if isinstance(ir, ApplyBinaryOp):
            if ir.op == '&':
                return _intersect(self.analyze(ir.l), self.analyze(ir.r))
            if ir.op == '|':
                return _union(self.analyze(ir.l), self.analyze(ir.r))
            if ir.op in _FLIP:
                return self._compare(ir.op, ir.l, ir.r)
        return None

    def _compare(self, op: str, l, r) -> Ranges:
        if _is_constant(l):
            l, r, op = r, l, _FLIP[op]
        if self.rg is None:
            return None
        v = _constant_value(r)
        if v is _NOT_CONSTANT:
            return None
        if v is None:
            return []            # key comparisons with missing never hold
        if self._is_key(l) and hasattr(v, 'global_position'):
            return self._gp_cmp(op, v.global_position())
        if self._key_apply(l, 'position') and isinstance(v, int):
            return self._position_cmp(op, v)
        if self._key_apply(l, 'contig') and op == '==' and isinstance(v, str):
            return self._contig_eq(v)
        if (op == '==' and isinstance(l, MakeStruct)
                and self.key_field in l.fields
                and self._is_key(l.fields[self.key_field])):
            # full-key equality: constrain by the key-prefix (locus) component
            sub = v.get(self.key_field) if hasattr(v, 'get') else None
            if sub is not None and hasattr(sub, 'global_position'):
                gp = sub.global_position()
                return [(gp, gp)]
        return None


class _NotConstant:
    pass


_NOT_CONSTANT = _NotConstant()


def _has_refs(ir) -> bool:
    if isinstance(ir, Ref):
        return True
    return any(_has_refs(c) for c in getattr(ir, 'children', ()))


def _is_constant(ir) -> bool:
    return isinstance(ir, Literal) or not _has_refs(ir)


def _constant_value(ir):
    """Fold a source-free subtree to its value (handles probes built as
    expressions, e.g. `hl.locus('20', p)`)."""
    if isinstance(ir, Literal):
        return ir.value
    if _has_refs(ir):
        return _NOT_CONSTANT
    try:
        from .semhash import semhash
        if semhash(ir) is None:       # nondeterministic (e.g. rand_*): no fold
            return _NOT_CONSTANT
        from .nodes import EvalEnv
        col = ir.evaluate(EvalEnv({}, (1,)))
        vals = col.to_pylist()
        return vals[0] if vals else _NOT_CONSTANT
    except Exception:
        return _NOT_CONSTANT


def extract_gp_ranges(ir, key_field: str, rg) -> Ranges:
    """Analyse a boolean predicate IR; see module docstring."""
    if rg is None:
        return None
    a = _KeyAnalyzer(key_field, rg)
    if a.max_gp is None:
        return None
    return a.analyze(ir)


def prune_indices(bounds, ranges: Ranges) -> Optional[List[int]]:
    """Partition indices whose [lo, hi] gp bounds intersect any range.
    `bounds` entries of None (unknown) are always kept. Returns None when
    no pruning applies."""
    if ranges is None or bounds is None:
        return None
    keep = []
    for i, b in enumerate(bounds):
        if b is None:
            keep.append(i)
            continue
        lo, hi = b
        if any(not (hi < rlo or lo > rhi) for rlo, rhi in ranges):
            keep.append(i)
    return keep
