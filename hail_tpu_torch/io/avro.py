"""Avro Object Container File reader (import_avro).

Capability parity with reference `is/hail/io/avro/` + `hl.import_avro`.
fastavro is not in this image, so this is a from-spec minimal decoder:
null/deflate codecs; null, boolean, int, long, float, double, bytes, string,
record, enum, array, map, union, fixed types.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, BinaryIO, Dict, List, Tuple

from .. import types as ht
from ..utils.structs import Struct


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def at_end(self) -> bool:
        return self.pos >= len(self.data)

    def zigzag_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)


def _decode(r: _Reader, schema) -> Any:
    if isinstance(schema, list):  # union
        idx = r.zigzag_long()
        return _decode(r, schema[idx])
    if isinstance(schema, dict):
        t = schema['type']
        if t == 'record':
            return Struct(**{f['name']: _decode(r, f['type'])
                             for f in schema['fields']})
        if t == 'array':
            out = []
            while True:
                n = r.zigzag_long()
                if n == 0:
                    break
                if n < 0:
                    r.zigzag_long()  # block byte size
                    n = -n
                for _ in range(n):
                    out.append(_decode(r, schema['items']))
            return out
        if t == 'map':
            out = {}
            while True:
                n = r.zigzag_long()
                if n == 0:
                    break
                if n < 0:
                    r.zigzag_long()
                    n = -n
                for _ in range(n):
                    k = _decode(r, 'string')
                    out[k] = _decode(r, schema['values'])
            return out
        if t == 'enum':
            return schema['symbols'][r.zigzag_long()]
        if t == 'fixed':
            return r.read(schema['size'])
        return _decode(r, t)
    if schema == 'null':
        return None
    if schema == 'boolean':
        return r.read(1)[0] != 0
    if schema in ('int', 'long'):
        return r.zigzag_long()
    if schema == 'float':
        return struct.unpack('<f', r.read(4))[0]
    if schema == 'double':
        return struct.unpack('<d', r.read(8))[0]
    if schema == 'bytes':
        return r.read(r.zigzag_long())
    if schema == 'string':
        return r.read(r.zigzag_long()).decode()
    raise ValueError(f'unsupported avro type {schema!r}')


def _schema_to_hail(schema) -> ht.HailType:
    if isinstance(schema, list):
        non_null = [s for s in schema if s != 'null']
        if len(non_null) == 1:
            return _schema_to_hail(non_null[0])
        return ht.tstr
    if isinstance(schema, dict):
        t = schema['type']
        if t == 'record':
            return ht.tstruct(**{f['name']: _schema_to_hail(f['type'])
                                 for f in schema['fields']})
        if t == 'array':
            return ht.tarray(_schema_to_hail(schema['items']))
        if t == 'map':
            return ht.tdict(ht.tstr, _schema_to_hail(schema['values']))
        if t in ('enum',):
            return ht.tstr
        if t == 'fixed':
            return ht.tbinary
        return _schema_to_hail(t)
    return {'null': ht.tstr, 'boolean': ht.tbool, 'int': ht.tint32,
            'long': ht.tint64, 'float': ht.tfloat32, 'double': ht.tfloat64,
            'bytes': ht.tbinary, 'string': ht.tstr}[schema]


def read_avro_file(path: str) -> Tuple[ht.HailType, List[Any]]:
    with open(path, 'rb') as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != b'Obj\x01':
        raise ValueError(f'{path} is not an Avro object container file')
    meta: Dict[str, bytes] = {}
    while True:
        n = r.zigzag_long()
        if n == 0:
            break
        if n < 0:
            r.zigzag_long()
            n = -n
        for _ in range(n):
            k = r.read(r.zigzag_long()).decode()
            v = r.read(r.zigzag_long())
            meta[k] = v
    sync = r.read(16)
    schema = json.loads(meta['avro.schema'].decode())
    codec = meta.get('avro.codec', b'null').decode()
    rows: List[Any] = []
    while not r.at_end():
        count = r.zigzag_long()
        size = r.zigzag_long()
        block = r.read(size)
        if codec == 'deflate':
            block = zlib.decompress(block, -15)
        elif codec != 'null':
            raise ValueError(f'unsupported avro codec {codec!r}')
        br = _Reader(block)
        for _ in range(count):
            rows.append(_decode(br, schema))
        if r.read(16) != sync:
            raise ValueError('avro sync marker mismatch')
    return _schema_to_hail(schema), rows


def import_avro(paths, *, key=None, intervals=None):
    """Import Avro files as a Table (reference impex.import_avro)."""
    from ..ir.columns import Batch
    from ..table import Table, TableStage
    paths = [paths] if isinstance(paths, str) else list(paths)
    all_rows = []
    row_t = None
    for p in paths:
        t, rows = read_avro_file(p)
        if row_t is None:
            row_t = t
        elif str(t) != str(row_t):
            raise ValueError(f'inconsistent avro schemas: {row_t} vs {t}')
        all_rows.extend(rows)
    if not isinstance(row_t, ht.tstruct):
        row_t = ht.tstruct(value=row_t)
        all_rows = [Struct(value=v) for v in all_rows]
    b = Batch.from_pylist(row_t, all_rows)
    tbl = Table(TableStage.from_batches(Batch({}, 1), [], row_t, [b]))
    if key:
        tbl = tbl.key_by(*([key] if isinstance(key, str) else list(key)))
    return tbl
