"""Hail-style virtual type system.

Capability parity with reference hail/python/hail/expr/types.py (virtual
types) — a fresh implementation. Types classify expressions and columns;
physical layout is handled by hail_tpu.ir.columns (columnar, not off-heap
rows as in the reference's PTypes).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .utils.structs import Interval, Struct, frozendict

__all__ = [
    'HailType', 'tint32', 'tint64', 'tfloat32', 'tfloat64', 'tbool', 'tstr',
    'tcall', 'tvoid', 'tbinary', 'tlocus', 'tarray', 'tset', 'tdict',
    'tstruct', 'ttuple', 'tinterval', 'tndarray', 'trngstate', 'dtype',
    'is_numeric', 'is_primitive', 'unify_types', 'hts_entry_schema',
]


class HailTypeContext:
    """The reference-genome names a type mentions (reference
    expr/types.py HailTypeContext) — what a consumer must have registered
    before values of the type make sense."""

    def __init__(self, references=frozenset()):
        self.references = set(references)

    @property
    def is_empty(self):
        return len(self.references) == 0

    @classmethod
    def union(cls, *types):
        refs = set()
        for t in types:
            refs |= t.get_context().references
        return HailTypeContext(refs)


class HailType:
    """Base class for hail types."""

    def pretty(self, indent=0, increment=4) -> str:
        """Prettily formatted type string (reference expr/types.py:178):
        container element types print inline; structs and tuples expand one
        field per line at `increment` extra spaces."""
        b = [' ' * indent]
        self._pretty(b, indent, increment)
        return ''.join(b)

    def _pretty(self, b, indent, increment):
        b.append(str(self))

    def _convert_to_json(self, v):
        """Value → the reference's JSON wire form (expr/types.py
        _convert_to_json): loci/intervals/structs as dicts, calls as
        strings, sets/arrays as lists."""
        return _to_json(self, v)

    def _convert_from_json(self, v, _should_freeze=False):
        return _from_json(self, v)

    def _convert_from_json_na(self, v):
        if v is None:
            return None
        return _from_json(self, v)

    def __repr__(self) -> str:
        s = str(self).replace("'", "\\'")
        return f"dtype('{s}')"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, HailType) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))

    def get_context(self) -> 'HailTypeContext':
        ctx = getattr(self, '_context', None)
        if ctx is None:
            ctx = self._get_context()
            self._context = ctx
        return ctx

    def _get_context(self) -> 'HailTypeContext':
        return HailTypeContext()

    @property
    def numpy_dtype(self):
        """The numpy dtype used for a vectorized column of this type, or None
        if the type is represented as an object column."""
        return None

    def _typecheck(self, value: Any) -> bool:
        raise NotImplementedError

    def typecheck(self, value: Any) -> None:
        if value is not None and not self._typecheck(value):
            raise TypeError(f'type {self}: invalid value {value!r}')

    def coerce(self, value: Any) -> Any:
        """Convert a python value into this type's canonical python form."""
        return value

    def _to_encoding(self, value: Any) -> bytes:
        """Serialize a single value of this type to bytes (reference
        HailType._to_encoding wire form; here the python object codec — the
        columnar npz codec in io/native.py is the bulk wire format)."""
        import pickle
        return pickle.dumps(value, protocol=4)

    def _from_encoding(self, data: bytes) -> Any:
        import pickle
        return pickle.loads(data)


class _tint32(HailType):
    def __str__(self):
        return 'int32'

    @property
    def numpy_dtype(self):
        return np.dtype(np.int32)

    def _typecheck(self, v):
        return isinstance(v, (int, np.integer)) and not isinstance(v, bool)

    def coerce(self, v):
        return None if v is None else int(v)


class _tint64(HailType):
    def __str__(self):
        return 'int64'

    @property
    def numpy_dtype(self):
        return np.dtype(np.int64)

    def _typecheck(self, v):
        return isinstance(v, (int, np.integer)) and not isinstance(v, bool)

    def coerce(self, v):
        return None if v is None else int(v)


class _tfloat32(HailType):
    def __str__(self):
        return 'float32'

    @property
    def numpy_dtype(self):
        return np.dtype(np.float32)

    def _typecheck(self, v):
        return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)

    def coerce(self, v):
        return None if v is None else float(v)


class _tfloat64(HailType):
    def __str__(self):
        return 'float64'

    @property
    def numpy_dtype(self):
        return np.dtype(np.float64)

    def _typecheck(self, v):
        return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)

    def coerce(self, v):
        return None if v is None else float(v)


class _tbool(HailType):
    def __str__(self):
        return 'bool'

    @property
    def numpy_dtype(self):
        return np.dtype(np.bool_)

    def _typecheck(self, v):
        return isinstance(v, (bool, np.bool_))

    def coerce(self, v):
        return None if v is None else bool(v)


class _tstr(HailType):
    def __str__(self):
        return 'str'

    def _typecheck(self, v):
        return isinstance(v, str)


class _tvoid(HailType):
    def __str__(self):
        return 'void'

    def _typecheck(self, v):
        return False


class _tbinary(HailType):
    def __str__(self):
        return 'binary'

    def _typecheck(self, v):
        return isinstance(v, bytes)


class _tcall(HailType):
    """Genotype call; represented as a packed int32 column
    (see hail_tpu.genetics.call; reference variant/Call.scala:14-77)."""

    def __str__(self):
        return 'call'

    @property
    def numpy_dtype(self):
        return np.dtype(np.int32)

    def _typecheck(self, v):
        from .genetics.call import Call
        return isinstance(v, Call)


class _trngstate(HailType):
    def __str__(self):
        return 'rng_state'

    def _typecheck(self, v):
        return False


tint32 = _tint32()
tint64 = _tint64()
tfloat32 = _tfloat32()
tfloat64 = _tfloat64()
tbool = _tbool()
tstr = _tstr()
tvoid = _tvoid()
tbinary = _tbinary()
tcall = _tcall()
trngstate = _trngstate()


class tlocus(HailType):
    """Genomic locus (contig, position) on a reference genome."""

    def __init__(self, reference_genome: Any = 'default'):
        from .genetics.reference_genome import ReferenceGenome, default_reference
        if reference_genome == 'default':
            reference_genome = default_reference()
        elif isinstance(reference_genome, str):
            reference_genome = ReferenceGenome.get(reference_genome)
        self.reference_genome = reference_genome

    def __str__(self):
        return f'locus<{self.reference_genome.name}>'

    def _typecheck(self, v):
        from .genetics.locus import Locus
        return isinstance(v, Locus)

    def _get_context(self):
        return HailTypeContext({self.reference_genome.name})

    @classmethod
    def _schema_from_rg(cls, reference_genome='default'):
        """The locus schema import_vcf produces for `reference_genome`
        (reference tlocus._schema_from_rg / TLocus.schemaFromRG): a bare
        contig/position struct when no genome is given."""
        if reference_genome is None:
            return tstruct(contig=tstr, position=tint32)
        return cls(reference_genome)


class tarray(HailType):
    def __init__(self, element_type: HailType):
        self.element_type = element_type

    def __str__(self):
        return f'array<{self.element_type}>'

    def _pretty(self, b, indent, increment):
        b.append('array<')
        self.element_type._pretty(b, indent, increment)
        b.append('>')

    def _typecheck(self, v):
        return isinstance(v, (list, tuple, np.ndarray))

    def _get_context(self):
        return self.element_type.get_context()

    def coerce(self, v):
        if v is None:
            return None
        return [self.element_type.coerce(x) if x is not None else None for x in v]


class tset(HailType):
    def __init__(self, element_type: HailType):
        self.element_type = element_type

    def __str__(self):
        return f'set<{self.element_type}>'

    def _pretty(self, b, indent, increment):
        b.append('set<')
        self.element_type._pretty(b, indent, increment)
        b.append('>')

    def _typecheck(self, v):
        return isinstance(v, (set, frozenset))

    def _get_context(self):
        return self.element_type.get_context()

    def coerce(self, v):
        if v is None:
            return None
        return frozenset(self.element_type.coerce(x) for x in v)


class tdict(HailType):
    def __init__(self, key_type: HailType, value_type: HailType):
        self.key_type = key_type
        self.value_type = value_type

    def __str__(self):
        return f'dict<{self.key_type}, {self.value_type}>'

    def _pretty(self, b, indent, increment):
        b.append('dict<')
        self.key_type._pretty(b, indent, increment)
        b.append(', ')
        self.value_type._pretty(b, indent, increment)
        b.append('>')

    def _typecheck(self, v):
        return isinstance(v, (dict, frozendict))

    def _get_context(self):
        return HailTypeContext.union(self.key_type, self.value_type)

    def coerce(self, v):
        if v is None:
            return None
        return frozendict({self.key_type.coerce(k): self.value_type.coerce(x) for k, x in v.items()})


class tstruct(HailType):
    def __init__(self, **fields: HailType):
        self.fields: Dict[str, HailType] = dict(fields)

    @staticmethod
    def from_fields(fields: Sequence[Tuple[str, HailType]]) -> 'tstruct':
        t = tstruct()
        t.fields = dict(fields)
        return t

    def __str__(self):
        inner = ', '.join(f'{_escape_field(k)}: {v}' for k, v in self.fields.items())
        return f'struct{{{inner}}}'

    def _pretty(self, b, indent, increment):
        if not self.fields:
            b.append('struct {}')
            return
        pre_indent = indent
        indent += increment
        b.append('struct {')
        for i, (f, t) in enumerate(self.fields.items()):
            if i > 0:
                b.append(', ')
            b.append('\n')
            b.append(' ' * indent)
            b.append(f'{_escape_field(f)}: ')
            t._pretty(b, indent, increment)
        b.append('\n')
        b.append(' ' * pre_indent)
        b.append('}')

    def __getitem__(self, name) -> 'HailType':
        # like the reference's tbaseStruct: accepts a field name, a positional
        # index, or a slice over the ordered fields
        if isinstance(name, int):
            return list(self.fields.values())[name]
        if isinstance(name, slice):
            items = list(self.fields.items())[name]
            return tstruct(**dict(items))
        return self.fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def __iter__(self):
        return iter(self.fields)

    def keys(self):
        return self.fields.keys()

    def items(self):
        return self.fields.items()

    def values(self):
        return self.fields.values()

    def __len__(self):
        return len(self.fields)

    def _typecheck(self, v):
        return isinstance(v, (Struct, dict))

    def coerce(self, v):
        if v is None:
            return None
        return Struct(**{k: t.coerce(v.get(k)) for k, t in self.fields.items()})

    def _get_context(self):
        return HailTypeContext.union(*self.fields.values())

    def _rename(self, m: Dict[str, str]) -> 'tstruct':
        """Rename fields by map, rejecting collisions (reference
        tstruct._rename)."""
        seen: Dict[str, str] = {}
        out = []
        for f0, t in self.fields.items():
            f = m.get(f0, f0)
            if f in seen:
                raise ValueError(
                    'Cannot rename two fields to the same name: attempted '
                    f'to rename {seen[f]!r} and {f0!r} both to {f!r}')
            seen[f] = f0
            out.append((f, t))
        return tstruct.from_fields(out)

    def _insert_field(self, name: str, typ: HailType) -> 'tstruct':
        d = dict(self.fields)
        d[name] = typ
        return tstruct(**d)

    def _drop_fields(self, names) -> 'tstruct':
        names = set(names)
        return tstruct.from_fields([(k, v) for k, v in self.fields.items() if k not in names])

    def _select_fields(self, names) -> 'tstruct':
        return tstruct.from_fields([(k, self.fields[k]) for k in names])


class ttuple(HailType):
    def __init__(self, *types: HailType):
        self.types = tuple(types)

    def __str__(self):
        return f'tuple({", ".join(str(t) for t in self.types)})'

    def _pretty(self, b, indent, increment):
        pre_indent = indent
        indent += increment
        b.append('tuple (')
        for i, t in enumerate(self.types):
            if i > 0:
                b.append(', ')
            b.append('\n')
            b.append(' ' * indent)
            t._pretty(b, indent, increment)
        b.append('\n')
        b.append(' ' * pre_indent)
        b.append(')')

    def __getitem__(self, i: int) -> HailType:
        return self.types[i]

    def __len__(self):
        return len(self.types)

    def _typecheck(self, v):
        return isinstance(v, tuple) and len(v) == len(self.types)

    def _get_context(self):
        return HailTypeContext.union(*self.types)


class tinterval(HailType):
    def __init__(self, point_type: HailType):
        self.point_type = point_type

    def __str__(self):
        return f'interval<{self.point_type}>'

    def _pretty(self, b, indent, increment):
        b.append('interval<')
        self.point_type._pretty(b, indent, increment)
        b.append('>')

    def _typecheck(self, v):
        return isinstance(v, Interval)

    def _get_context(self):
        return self.point_type.get_context()


class tndarray(HailType):
    def __init__(self, element_type: HailType, ndim: int):
        self.element_type = element_type
        self.ndim = ndim

    def __str__(self):
        return f'ndarray<{self.element_type}, {self.ndim}>'

    def _pretty(self, b, indent, increment):
        b.append('ndarray<')
        self.element_type._pretty(b, indent, increment)
        b.append(f', {self.ndim}>')

    def _typecheck(self, v):
        return isinstance(v, np.ndarray) or hasattr(v, '__array__')

    def _get_context(self):
        return self.element_type.get_context()


def is_numeric(t: HailType) -> bool:
    return t in (tint32, tint64, tfloat32, tfloat64)


def is_primitive(t: HailType) -> bool:
    return t in (tint32, tint64, tfloat32, tfloat64, tbool, tstr, tcall)


_NUMERIC_RANK = {str(tbool): 0, str(tint32): 1, str(tint64): 2, str(tfloat32): 3, str(tfloat64): 4}
_RANK_TYPE = [tbool, tint32, tint64, tfloat32, tfloat64]


def unify_types(*ts: HailType) -> Optional[HailType]:
    """Least upper bound of numeric types; identical types unify to themselves.
    tvoid (the type of an all-missing value) unifies with anything."""
    ts = [t for t in ts if t is not None and t != tvoid]
    if not ts:
        return tvoid
    if all(t == ts[0] for t in ts):
        return ts[0]
    if all(str(t) in _NUMERIC_RANK for t in ts):
        return _RANK_TYPE[max(_NUMERIC_RANK[str(t)] for t in ts)]
    if all(isinstance(t, tarray) for t in ts):
        elem = unify_types(*[t.element_type for t in ts])
        return tarray(elem) if elem is not None else None
    if all(isinstance(t, tndarray) for t in ts) and \
            all(t.ndim == ts[0].ndim for t in ts):
        elem = unify_types(*[t.element_type for t in ts])
        return tndarray(elem, ts[0].ndim) if elem is not None else None
    if all(isinstance(t, tstruct) for t in ts) and \
            all(list(t.fields) == list(ts[0].fields) for t in ts):
        out = []
        for k in ts[0].fields:
            u = unify_types(*[t[k] for t in ts])
            if u is None:
                return None
            out.append((k, u))
        return tstruct.from_fields(out)
    return None


def _escape_field(name: str) -> str:
    from .utils.misc import escape_id
    return escape_id(name)


_UNESCAPE_MAP = {'n': '\n', 't': '\t', 'r': '\r', 'b': '\b', 'f': '\f',
                 'a': '\a', 'v': '\v', '\\': '\\', '`': '`', '"': '"',
                 "'": "'"}


def _unescape(s: str) -> str:
    """Reverse of utils.misc.escape_str for backticked identifiers."""
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == '\\' and i + 1 < len(s):
            n = s[i + 1]
            if n == 'u' and i + 5 < len(s):
                out.append(chr(int(s[i + 2:i + 6], 16)))
                i += 6
                continue
            out.append(_UNESCAPE_MAP.get(n, n))
            i += 2
            continue
        out.append(c)
        i += 1
    return ''.join(out)


# ---------------------------------------------------------------------------
# dtype(): parse a type string ('array<int32>' etc.)
# ---------------------------------------------------------------------------

_SIMPLE = {
    'int': tint32, 'int32': tint32, 'int64': tint64,
    'float': tfloat64, 'float32': tfloat32, 'float64': tfloat64,
    'bool': tbool, 'str': tstr, 'call': tcall, 'void': tvoid, 'binary': tbinary,
}
# the reference grammar accepts t-prefixed spellings for every type
# (type_parsing.py:10-29: "tint32" / "int32" etc.)
_SIMPLE.update({'t' + k: v for k, v in list(_SIMPLE.items())})

_TOKEN = re.compile(r'\s*([A-Za-z_][A-Za-z0-9_]*|`(?:\\.|[^\\`])*`|[<>{}(),:]|\d+)')


class _TypeParser:
    def __init__(self, s: str):
        self.tokens = []
        pos = 0
        while pos < len(s):
            m = _TOKEN.match(s, pos)
            if not m:
                if s[pos:].strip() == '':
                    break
                raise ValueError(f'could not parse type string at {s[pos:]!r}')
            self.tokens.append(m.group(1))
            pos = m.end()
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, tok):
        t = self.next()
        if t != tok:
            raise ValueError(f'expected {tok!r}, got {t!r}')

    def parse(self) -> HailType:
        tok = self.next()
        if tok in _SIMPLE:
            return _SIMPLE[tok]
        if tok and tok.startswith('t') and tok[1:] in (
                'array', 'set', 'dict', 'interval', 'ndarray', 'locus',
                'struct', 'tuple', 'stream'):
            tok = tok[1:]
        if tok == 'array':
            self.expect('<')
            t = self.parse()
            self.expect('>')
            return tarray(t)
        if tok == 'set':
            self.expect('<')
            t = self.parse()
            self.expect('>')
            return tset(t)
        if tok == 'dict':
            self.expect('<')
            k = self.parse()
            self.expect(',')
            v = self.parse()
            self.expect('>')
            return tdict(k, v)
        if tok == 'interval':
            self.expect('<')
            t = self.parse()
            self.expect('>')
            return tinterval(t)
        if tok == 'ndarray':
            self.expect('<')
            t = self.parse()
            self.expect(',')
            ndim = int(self.next())
            self.expect('>')
            return tndarray(t, ndim)
        if tok == 'locus':
            self.expect('<')
            rg = self.next()
            self.expect('>')
            return tlocus(rg)
        if tok == 'struct':
            self.expect('{')
            fields = []
            if self.peek() != '}':
                while True:
                    name = self.next()
                    if name.startswith('`'):
                        name = _unescape(name[1:-1])
                    self.expect(':')
                    fields.append((name, self.parse()))
                    if self.peek() == ',':
                        self.next()
                    else:
                        break
            self.expect('}')
            return tstruct.from_fields(fields)
        if tok == 'tuple':
            self.expect('(')
            types = []
            if self.peek() != ')':
                while True:
                    types.append(self.parse())
                    if self.peek() == ',':
                        self.next()
                    else:
                        break
            self.expect(')')
            return ttuple(*types)
        raise ValueError(f'unknown type token {tok!r}')


def dtype(s) -> HailType:
    """Parse a type from its string representation."""
    if isinstance(s, HailType):
        return s
    return _TypeParser(str(s)).parse()


def hts_entry_schema() -> tstruct:
    """The standard high-throughput-sequencing entry schema (GT/AD/DP/GQ/PL),
    as produced by import_vcf of a standard VCF (reference: LoadVCF.scala)."""
    return tstruct(
        GT=tcall,
        AD=tarray(tint32),
        DP=tint32,
        GQ=tint32,
        PL=tarray(tint32),
    )


#: reference aliases
tfloat = tfloat64
tint = tint32

# ---------------------------------------------------------------------------
# JSON wire conversions (reference expr/types.py _convert_to/from_json)
# ---------------------------------------------------------------------------

def _to_json(t, v):
    if v is None:
        return None
    if isinstance(t, tstruct):
        return {k: _to_json(ft, v[k]) for k, ft in t.fields.items()}
    if isinstance(t, ttuple):
        return [_to_json(ft, x) for ft, x in zip(t.types, v)]
    if isinstance(t, (tarray, tset)):
        return [_to_json(t.element_type, x) for x in v]
    if isinstance(t, tdict):
        return [{'key': _to_json(t.key_type, k),
                 'value': _to_json(t.value_type, x)} for k, x in v.items()]
    if isinstance(t, tlocus):
        return {'contig': v.contig, 'position': v.position}
    if isinstance(t, tinterval):
        return {'start': _to_json(t.point_type, v.start),
                'end': _to_json(t.point_type, v.end),
                'includeStart': v.includes_start,
                'includeEnd': v.includes_end}
    if t == tcall:
        return str(v)
    if isinstance(t, tndarray):
        import numpy as _np
        arr = _np.asarray(v)
        return {'shape': list(arr.shape),
                'data': [_to_json(t.element_type, x) for x in arr.ravel()]}
    return v


def _from_json(t, v):
    if v is None:
        return None
    if isinstance(t, tstruct):
        from .utils.structs import Struct as _Struct
        return _Struct(**{k: _from_json(ft, v.get(k))
                          for k, ft in t.fields.items()})
    if isinstance(t, ttuple):
        return tuple(_from_json(ft, x) for ft, x in zip(t.types, v))
    if isinstance(t, tarray):
        return [_from_json(t.element_type, x) for x in v]
    if isinstance(t, tset):
        from .utils.structs import freeze as _freeze
        return frozenset(_freeze(_from_json(t.element_type, x)) for x in v)
    if isinstance(t, tdict):
        from .utils.structs import freeze as _freeze, frozendict as _fd
        return _fd({_freeze(_from_json(t.key_type, e['key'])):
                    _from_json(t.value_type, e['value']) for e in v})
    if isinstance(t, tlocus):
        from .genetics.locus import Locus as _Locus
        return _Locus(v['contig'], v['position'], t.reference_genome)
    if isinstance(t, tinterval):
        from .utils.structs import Interval as _Interval
        return _Interval(_from_json(t.point_type, v['start']),
                         _from_json(t.point_type, v['end']),
                         v.get('includeStart', True),
                         v.get('includeEnd', False))
    if t == tcall:
        from .genetics.call import Call as _Call
        return _Call.parse(v) if isinstance(v, str) else v
    if isinstance(t, tndarray):
        import numpy as _np
        return _np.asarray(v['data']).reshape(v['shape'])
    return v

