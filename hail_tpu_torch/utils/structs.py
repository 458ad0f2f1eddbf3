"""Core value containers: Struct, frozendict, Interval.

Capability parity with reference hail/python/hail/utils/struct.py,
frozendict.py, interval.py — fresh implementations.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping


class Struct(Mapping):
    """An immutable record with named fields, accessible as attributes.

    >>> s = Struct(a=1, b='x')
    >>> s.a
    1
    >>> s['b']
    'x'
    """

    __slots__ = ('_fields',)

    def __init__(self, **kwargs: Any) -> None:
        object.__setattr__(self, '_fields', dict(kwargs))

    def __getattr__(self, name: str) -> Any:
        if name.startswith('_'):
            raise AttributeError(name)
        try:
            return self._fields[name]
        except KeyError:
            raise AttributeError(f'Struct has no field {name!r}') from None

    def __setattr__(self, name: str, value: Any) -> None:
        raise TypeError('Struct is immutable')

    def __reduce__(self):
        # __slots__ + immutable __setattr__ need explicit pickle support
        return (_struct_from_dict, (dict(self._fields),))

    def __getitem__(self, name: str) -> Any:
        return self._fields[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, name: object) -> bool:
        return name in self._fields

    def keys(self):
        return self._fields.keys()

    def values(self):
        return self._fields.values()

    def items(self):
        return self._fields.items()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Struct):
            return self._fields == other._fields
        if isinstance(other, dict):
            return self._fields == other
        return NotImplemented

    def __lt__(self, other):
        if not isinstance(other, Struct):
            return NotImplemented
        from ..expr.functions import _cmp_values
        return _cmp_values(self, other) < 0

    def __le__(self, other):
        if not isinstance(other, Struct):
            return NotImplemented
        from ..expr.functions import _cmp_values
        return _cmp_values(self, other) <= 0

    def __gt__(self, other):
        if not isinstance(other, Struct):
            return NotImplemented
        from ..expr.functions import _cmp_values
        return _cmp_values(self, other) > 0

    def __ge__(self, other):
        if not isinstance(other, Struct):
            return NotImplemented
        from ..expr.functions import _cmp_values
        return _cmp_values(self, other) >= 0

    def __hash__(self) -> int:
        return hash(tuple(sorted((k, _try_hash(v)) for k, v in self._fields.items())))

    def __repr__(self) -> str:
        if all(k.isidentifier() for k in self._fields):
            inner = ', '.join(f'{k}={v!r}' for k, v in self._fields.items())
            return f'Struct({inner})'
        # non-identifier field names render in the **{...} constructor form
        # the reference uses (utils/struct.py __str__)
        inner = ', '.join(f'{k!r}: {v!r}' for k, v in self._fields.items())
        return 'Struct(**{' + inner + '})'

    def annotate(self, **kwargs: Any) -> 'Struct':
        d = dict(self._fields)
        d.update(kwargs)
        return Struct(**d)

    def select(self, *names: str, **kwargs: Any) -> 'Struct':
        d = {n: self._fields[n] for n in names}
        d.update(kwargs)
        return Struct(**d)

    def drop(self, *names: str) -> 'Struct':
        return Struct(**{k: v for k, v in self._fields.items() if k not in names})


def _try_hash(v: Any) -> int:
    try:
        return hash(v)
    except TypeError:
        # hash the FROZEN form so a struct holding a raw list hashes the same
        # as one holding the frozenlist it compares equal to (set/dict
        # membership consistency; import_bgen variant-filter containment)
        if isinstance(v, (list, tuple, dict, set)):
            return hash(freeze(v))
        return 0


try:
    from frozenlist import FrozenList as _FrozenListBase
except ImportError:  # pragma: no cover - frozenlist ships with aiohttp
    _FrozenListBase = None

if _FrozenListBase is not None:
    class frozenlist(_FrozenListBase):
        """Hashable list for set elements / dict keys (reference
        hailtop/hail_frozenlist.py semantics: a FrozenList frozen at birth)."""

        def __init__(self, items=()):
            super().__init__(list(items))
            self.freeze()

        def __repr__(self):
            return f'frozenlist({list(self)})'

        def __reduce__(self):
            # the C-extension base isn't picklable; rebuild from a list
            return (frozenlist, (list(self),))
else:
    class frozenlist(tuple):
        def __repr__(self):
            return f'frozenlist({list(self)})'


def freeze(v):
    """Recursively convert a value to its hashable form: list→frozenlist,
    dict→frozendict, set→frozenset, struct/tuple elementwise (reference
    freezes container values at JSON/encoding conversion when they land in
    sets or dict keys, expr/types.py _convert_from_json _should_freeze)."""
    if isinstance(v, frozenlist):
        return v
    if isinstance(v, list):
        return frozenlist([freeze(x) for x in v])
    if isinstance(v, tuple):
        return tuple(freeze(x) for x in v)
    if isinstance(v, Struct):
        return Struct(**{k: freeze(x) for k, x in v.items()})
    if isinstance(v, frozendict):
        return frozendict({freeze(k): freeze(x) for k, x in v.items()})
    if isinstance(v, dict):
        return frozendict({freeze(k): freeze(x) for k, x in v.items()})
    if isinstance(v, (set, frozenset)):
        return frozenset(freeze(x) for x in v)
    return v


class frozendict(Mapping):
    """An immutable, hashable dict (value type for tdict)."""

    __slots__ = ('_d', '_hash')

    def __init__(self, d: Mapping = (), **kwargs: Any) -> None:
        object.__setattr__(self, '_d', dict(d, **kwargs))
        object.__setattr__(self, '_hash', None)

    def __getitem__(self, k: Any) -> Any:
        return self._d[k]

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __hash__(self) -> int:
        if self._hash is None:
            object.__setattr__(
                self, '_hash', hash(frozenset((k, _try_hash(v)) for k, v in self._d.items()))
            )
        return self._hash

    def __eq__(self, other: object) -> bool:
        if isinstance(other, frozendict):
            return self._d == other._d
        if isinstance(other, dict):
            return self._d == other
        return NotImplemented

    def __repr__(self) -> str:
        return f'frozendict({self._d!r})'


class Interval:
    """A typed interval with inclusive/exclusive endpoints.

    Mirrors the semantics of the reference's Interval
    (hail/python/hail/utils/interval.py); used for locus intervals and
    partitioner range bounds (rvd/RVDPartitioner.scala:18-23).
    """

    __slots__ = ('start', 'end', 'includes_start', 'includes_end')

    def __init__(self, start, end, includes_start: bool = True,
                 includes_end: bool = False, point_type=None):
        # point_type is accepted for reference-signature parity; the point
        # type is recoverable from the endpoints
        self.start = start
        self.end = end
        self.includes_start = includes_start
        self.includes_end = includes_end

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Interval):
            return NotImplemented
        return (
            self.start == other.start
            and self.end == other.end
            and self.includes_start == other.includes_start
            and self.includes_end == other.includes_end
        )

    def __hash__(self) -> int:
        return hash((_try_hash(self.start), _try_hash(self.end), self.includes_start, self.includes_end))

    @staticmethod
    def _point_key(p):
        # loci order by (contig index, position); other points by themselves
        if hasattr(p, 'contig') and hasattr(p, 'position'):
            return (p.reference_genome.contig_index(p.contig), p.position)
        return p

    def _order_key(self):
        # inclusive start sorts before exclusive at the same point; shorter
        # (exclusive-ended) intervals sort first at the same end point
        return (Interval._point_key(self.start), not self.includes_start,
                Interval._point_key(self.end), self.includes_end)

    def __lt__(self, other):
        if not isinstance(other, Interval):
            return NotImplemented
        return self._order_key() < other._order_key()

    def __le__(self, other):
        if not isinstance(other, Interval):
            return NotImplemented
        return self._order_key() <= other._order_key()

    def __gt__(self, other):
        if not isinstance(other, Interval):
            return NotImplemented
        return other.__lt__(self)

    def __ge__(self, other):
        if not isinstance(other, Interval):
            return NotImplemented
        return other.__le__(self)

    def __str__(self) -> str:
        # reference utils/interval.py:59: same-contig locus intervals
        # abbreviate the end to its position
        if hasattr(self.start, 'contig') and hasattr(self.end, 'contig') \
                and self.start.contig == self.end.contig:
            bounds = f'{self.start}-{self.end.position}'
        else:
            bounds = f'{self.start}-{self.end}'
        lb = '[' if self.includes_start else '('
        rb = ']' if self.includes_end else ')'
        return f'{lb}{bounds}{rb}'

    def __repr__(self) -> str:
        return ('Interval(start={}, end={}, includes_start={}, '
                'includes_end={})'.format(repr(self.start), repr(self.end),
                                          repr(self.includes_start),
                                          repr(self.includes_end)))

    def contains(self, point, cmp=None) -> bool:
        """Whether `point` lies in the interval under ordering `cmp` (default: python <)."""
        if cmp is None:
            def cmp(a, b):
                return -1 if a < b else (0 if a == b else 1)
        c0 = cmp(point, self.start)
        if c0 < 0 or (c0 == 0 and not self.includes_start):
            return False
        c1 = cmp(point, self.end)
        if c1 > 0 or (c1 == 0 and not self.includes_end):
            return False
        return True


def _struct_from_dict(d):
    return Struct(**d)


def _interval_overlaps(self, other) -> bool:
    """Whether two intervals share any point (reference
    Interval.overlaps)."""
    def lt(a, b):
        ka = (a.reference_genome.contig_index(a.contig), a.position) \
            if hasattr(a, 'contig') else a
        kb = (b.reference_genome.contig_index(b.contig), b.position) \
            if hasattr(b, 'contig') else b
        return ka < kb

    def le(a, b):
        return lt(a, b) or a == b
    # self.start must be before other's end and vice versa, honoring
    # inclusivity at the touching endpoints
    if lt(other.end, self.start) or (other.end == self.start and not
                                     (other.includes_end and self.includes_start)):
        return False
    if lt(self.end, other.start) or (self.end == other.start and not
                                     (self.includes_end and other.includes_start)):
        return False
    return True


def _interval_point_type(self):
    from ..expr.expression import impute_type
    return impute_type(self.start)


Interval.overlaps = _interval_overlaps
Interval.point_type = property(_interval_point_type)


# --- pprint integration -----------------------------------------------------
# The reference teaches pprint to lay Structs out field-per-line when they
# exceed the line width (utils/struct.py StructPrettyPrinter monkey-patch);
# without this, pprint falls back to single-line repr for any object type.
import pprint as _pprint  # noqa: E402

_base_printer = _pprint.PrettyPrinter


class _StructAwarePrinter(_base_printer):
    def _format(self, obj, stream, indent, allowance, context, level,
                *args, **kwargs):
        if not isinstance(obj, Struct):
            return _base_printer._format(self, obj, stream, indent, allowance,
                                         context, level, *args, **kwargs)
        rep = self._repr(obj, context, level)
        if len(rep) <= self._width - indent - allowance:
            stream.write(rep)
            return
        stream.write('Struct(')
        indent += len('Struct(')
        plain = all(k.isidentifier() for k in obj)
        if not plain:
            stream.write('**{')
            indent += len('**{')
        items = list(obj.items())
        for i, (k, v) in enumerate(items):
            if i:
                stream.write(' ' * indent)
            head = f'{k}=' if plain else f'{k!r}: '
            stream.write(head)
            self._format(v, stream, indent + len(head), allowance,
                         context, level, *args, **kwargs)
            if i != len(items) - 1:
                stream.write(',\n')
        stream.write(')' if plain else '})')


_pprint.PrettyPrinter = _StructAwarePrinter


def thaw(v):
    """Convert internal frozen containers to the mutable forms the reference
    surfaces at output boundaries (its `_convert_from_json` freezes only
    where hashability demands: dict keys and set elements stay frozen;
    top-level and array/struct-nested sets/dicts are plain set/dict)."""
    if isinstance(v, frozenlist):
        return [thaw(x) for x in v]
    if isinstance(v, frozendict):
        return {k: thaw(x) for k, x in v.items()}
    if isinstance(v, dict):
        return {k: thaw(x) for k, x in v.items()}
    if isinstance(v, (frozenset, set)):
        return set(v)      # elements stay frozen (hashability)
    if isinstance(v, Struct):
        return Struct(**{k: thaw(x) for k, x in v.items()})
    if isinstance(v, tuple):
        return tuple(thaw(x) for x in v)
    if isinstance(v, list):
        return [thaw(x) for x in v]
    return v
