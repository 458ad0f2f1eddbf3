"""Reader for the reference Hail's native on-disk format (0.2.x).

Decodes Table/MatrixTable directories written by the reference
(`is/hail/rvd/AbstractRVDSpec.scala`, `types/encoded/*`, `io/InputBuffers.scala`):
gzipped JSON specs, per-partition part files framed as
[StreamBlock|StreamBlock2] blocks, optionally LZ4/Zstd block-compressed,
optionally LEB128-varint ints, rows encoded per EType (struct missing bits,
varint lengths, raw LE floats). This is what lets `hl.read_table` /
`hl.read_matrix_table` open the reference's own fixtures and user datasets.

Encoded-type grammar (eType strings like
`+EBaseStruct{locus:+EBaseStruct{contig:+EBinary,position:+EInt32},...}`)
and virtual-type strings (`Struct{...}`, `Array[String]`, `Locus(GRCh37)`)
are parsed side by side; requiredness lives only in the eType.
"""

from __future__ import annotations

import gzip
import json
import os
import struct as _struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import types as ht
from ..utils.structs import Struct, Interval

# ---------------------------------------------------------------------------
# LZ4 block decompression (pure python; format: token/literals/offset/match)
# ---------------------------------------------------------------------------


def lz4_decompress_block(src: bytes, decomp_len: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n and len(out) < decomp_len:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        out += src[i:i + lit_len]
        i += lit_len
        if i >= n or len(out) >= decomp_len:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(out) - offset
        for j in range(match_len):
            out.append(out[start + j])
    return bytes(out)


# ---------------------------------------------------------------------------
# buffer stack: part file bytes -> decoded row stream
# ---------------------------------------------------------------------------


def _spec_names(buffer_spec: dict) -> List[str]:
    names = []
    b = buffer_spec
    while b is not None:
        names.append(b['name'])
        b = b.get('child')
    return names


def decode_part_bytes(raw: bytes, buffer_spec: dict) -> Tuple[bytes, bool]:
    """Apply the block/compression layers; returns (flat bytes, leb128)."""
    names = _spec_names(buffer_spec)
    leb128 = 'LEB128BufferSpec' in names
    if 'StreamBufferSpec' in names:
        return raw, leb128

    # find compression + block framing layers
    comp = next((n for n in names if n.endswith('BlockBufferSpec')
                 and n not in ('StreamBlockBufferSpec', 'StreamBlockBufferSpec2')),
                None)
    varint_frames = 'StreamBlockBufferSpec2' in names

    pos = 0
    out = bytearray()
    n = len(raw)
    while pos < n:
        if varint_frames:
            blen = 0
            shift = 0
            while True:
                b = raw[pos]
                pos += 1
                blen |= (b & 0x7F) << shift
                shift += 7
                if not (b & 0x80):
                    break
        else:
            blen = _struct.unpack_from('<i', raw, pos)[0]
            pos += 4
        block = raw[pos:pos + blen]
        pos += blen
        if comp is None:
            out += block
        elif comp.startswith('LZ4'):
            decomp_len = _struct.unpack_from('<i', block, 0)[0]
            out += lz4_decompress_block(block[4:], decomp_len)
        elif comp.startswith('Zstd'):
            import zstandard
            # block layout: [int32 decompressed length][zstd frame]
            # (InputBuffers.scala ZstdInputBlockBuffer.readBlock); the
            # size-based variant flags uncompressed blocks in bit 0
            decomp_len = _struct.unpack_from('<i', block, 0)[0]
            if comp.startswith('ZstdSizedBased'):
                if decomp_len % 2 == 0:
                    out += bytes(block[4:])
                    continue
                out += zstandard.ZstdDecompressor().decompress(
                    bytes(block[4:]), max_output_size=decomp_len >> 1)
            else:
                out += zstandard.ZstdDecompressor().decompress(
                    bytes(block[4:]), max_output_size=max(decomp_len, 1))
        else:
            raise NotImplementedError(f'compression {comp}')
    return bytes(out), leb128


class _Reader:
    __slots__ = ('buf', 'pos', 'leb128')

    def __init__(self, buf: bytes, leb128: bool):
        self.buf = buf
        self.pos = 0
        self.leb128 = leb128

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        x = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            x |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                break
        # 32-bit wrap for negatives (Hail writes ints as 5-byte varints)
        if x >= 1 << 31 and x < 1 << 35:
            x = (x & 0xFFFFFFFF)
            if x >= 1 << 31:
                x -= 1 << 32
        return x

    def int32(self) -> int:
        if self.leb128:
            return self.varint()
        v = _struct.unpack_from('<i', self.buf, self.pos)[0]
        self.pos += 4
        return v

    def int64(self) -> int:
        if self.leb128:
            x = 0
            shift = 0
            while True:
                b = self.buf[self.pos]
                self.pos += 1
                x |= (b & 0x7F) << shift
                shift += 7
                if not (b & 0x80):
                    break
            if x >= 1 << 63:
                x -= 1 << 64
            return x
        v = _struct.unpack_from('<q', self.buf, self.pos)[0]
        self.pos += 8
        return v

    def f32(self) -> float:
        v = _struct.unpack_from('<f', self.buf, self.pos)[0]
        self.pos += 4
        return v

    def f64(self) -> float:
        v = _struct.unpack_from('<d', self.buf, self.pos)[0]
        self.pos += 8
        return v

    def bytes_(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def eof(self) -> bool:
        return self.pos >= len(self.buf)


# ---------------------------------------------------------------------------
# type parsers
# ---------------------------------------------------------------------------


class EType:
    __slots__ = ('kind', 'required', 'fields', 'element', 'ndims')

    def __init__(self, kind, required, fields=None, element=None, ndims=None):
        self.kind = kind
        self.required = required
        self.fields = fields      # list[(name, EType)] for struct
        self.element = element    # EType for arrays / ndarray
        self.ndims = ndims        # int for ndarray


def parse_etype(s: str) -> EType:
    t, rest = _parse_etype(s, 0)
    assert rest == len(s), (s, rest)
    return t


def _parse_etype(s: str, i: int) -> Tuple[EType, int]:
    required = False
    if s[i] == '+':
        required = True
        i += 1
    for kind in ('EBaseStruct', 'EArray', 'EBinary', 'EInt32', 'EInt64',
                 'EFloat32', 'EFloat64', 'EBoolean',
                 'ENDArrayColumnMajor', 'ENDArray'):
        if s.startswith(kind, i):
            i += len(kind)
            break
    else:
        raise ValueError(f'unknown etype at {i}: {s[i:i+30]}')
    if kind == 'EBaseStruct':
        assert s[i] == '{'
        i += 1
        fields = []
        while s[i] != '}':
            j = i
            depth = 0
            while not (s[j] == ':' and depth == 0):
                if s[j] in '{[':
                    depth += 1
                elif s[j] in '}]':
                    depth -= 1
                j += 1
            name = s[i:j].strip('`')
            sub, i = _parse_etype(s, j + 1)
            fields.append((name, sub))
            if s[i] == ',':
                i += 1
        return EType('struct', required, fields=fields), i + 1
    if kind in ('EArray', 'ENDArrayColumnMajor', 'ENDArray'):
        assert s[i] == '['
        sub, i = _parse_etype(s, i + 1)
        # ndarrays carry a ",n" dimension suffix
        j = i
        while i < len(s) and s[i] != ']':
            i += 1
        suffix = s[j:i].lstrip(',')
        ndims = int(suffix) if suffix.isdigit() else None
        return EType('ndarray' if kind != 'EArray' else 'array',
                     required, element=sub, ndims=ndims), i + 1
    return EType(kind[1:].lower(), required), i


_PRIM = {'String': ht.tstr, 'Int32': ht.tint32, 'Int64': ht.tint64,
         'Float32': ht.tfloat32, 'Float64': ht.tfloat64, 'Boolean': ht.tbool,
         'Call': ht.tcall, 'Binary': ht.tstr}


def parse_vtype(s: str) -> ht.HailType:
    t, rest = _parse_vtype(s, 0)
    assert rest == len(s), (s, rest)
    return t


def _parse_vtype(s: str, i: int) -> Tuple[ht.HailType, int]:
    if s[i] == '+':
        i += 1
    for name, t in _PRIM.items():
        if s.startswith(name, i) and not s.startswith(name + 'a', i):
            return t, i + len(name)
    if s.startswith('Locus(', i):
        j = s.index(')', i)
        rg = s[i + len('Locus('):j]
        from ..genetics.reference_genome import ReferenceGenome
        return ht.tlocus(ReferenceGenome.get(rg)), j + 1
    if s.startswith('Struct{', i):
        i += len('Struct{')
        fields = []
        while s[i] != '}':
            j = i
            depth = 0
            while not (s[j] == ':' and depth == 0):
                if s[j] in '{[(':
                    depth += 1
                elif s[j] in '}])':
                    depth -= 1
                j += 1
            name = s[i:j].strip('`')
            sub, i = _parse_vtype(s, j + 1)
            fields.append((name, sub))
            if s[i] == ',':
                i += 1
        return ht.tstruct.from_fields(fields), i + 1
    if s.startswith('Tuple[', i):
        i += len('Tuple[')
        elts = []
        while s[i] != ']':
            sub, i = _parse_vtype(s, i)
            elts.append(sub)
            if s[i] == ',':
                i += 1
        return ht.ttuple(*elts), i + 1
    for ctor, name in ((ht.tarray, 'Array['), (ht.tset, 'Set[')):
        if s.startswith(name, i):
            sub, i = _parse_vtype(s, i + len(name))
            assert s[i] == ']'
            return ctor(sub), i + 1
    if s.startswith('Dict[', i):
        k, i = _parse_vtype(s, i + len('Dict['))
        assert s[i] == ','
        v, i = _parse_vtype(s, i + 1)
        assert s[i] == ']'
        return ht.tdict(k, v), i + 1
    if s.startswith('Interval[', i):
        sub, i = _parse_vtype(s, i + len('Interval['))
        assert s[i] == ']'
        return ht.tinterval(sub), i + 1
    if s.startswith('NDArray[', i):
        sub, i = _parse_vtype(s, i + len('NDArray['))
        j = i
        while s[i] != ']':
            i += 1
        suffix = s[j:i].lstrip(',')
        ndims = int(suffix) if suffix.isdigit() else 1
        return ht.tndarray(sub, ndims), i + 1
    raise ValueError(f'unknown vtype at {i}: {s[i:i+40]}')


# ---------------------------------------------------------------------------
# value decoding
# ---------------------------------------------------------------------------


def _hail_call_to_ours(c: int):
    from ..genetics.call import Call
    phased = bool(c & 1)
    ploidy = (c >> 1) & 0x3
    rep = c >> 3
    if ploidy == 0:
        return Call([], phased)
    if ploidy == 1:
        return Call([rep], phased)
    # diploid: rep is a triangular gt index
    k = int((np.sqrt(8.0 * rep + 1) - 1) // 2)
    while k * (k + 1) // 2 > rep:
        k -= 1
    while (k + 1) * (k + 2) // 2 <= rep:
        k += 1
    j = rep - k * (k + 1) // 2
    if phased:
        # rep = gtIndex(aj, aj+ak) -> aj=j, ak=k-j
        return Call([j, k - j], True)
    return Call([j, k], False)


def decode_value(r: _Reader, et: EType, vt: ht.HailType) -> Any:
    if et.kind == 'struct':
        vfields = getattr(vt, 'fields', None)
        optional = [f for f in et.fields if not f[1].required]
        n_mbytes = (len(optional) + 7) >> 3
        mbytes = r.bytes_(n_mbytes)
        missing = {}
        for idx, (name, _sub) in enumerate(optional):
            missing[name] = bool(mbytes[idx >> 3] & (1 << (idx & 7)))
        out = {}
        is_locus = str(vt).startswith('locus')
        for name, sub in et.fields:
            if missing.get(name, False):
                out[name] = None
                continue
            sub_vt = (vfields[name] if vfields is not None and not is_locus
                      else (ht.tstr if name == 'contig' else ht.tint32))
            out[name] = decode_value(r, sub, sub_vt)
        if is_locus:
            from ..genetics.locus import Locus
            return Locus(out['contig'], out['position'], vt.reference_genome)
        if str(vt).startswith('interval'):
            return Interval(out['start'], out['end'],
                            out['includes_start'], out['includes_end'])
        if str(vt).startswith('tuple'):
            return tuple(out[name] for name, _ in et.fields)
        return Struct(**out)
    if et.kind == 'array':
        n = r.int32()
        elem_missing = [False] * n
        if not et.element.required:
            mbytes = r.bytes_((n + 7) >> 3)
            for i in range(n):
                elem_missing[i] = bool(mbytes[i >> 3] & (1 << (i & 7)))
        svt = str(vt)
        if svt.startswith('array'):
            evt = vt.element_type
        elif svt.startswith('set'):
            evt = vt.element_type
        elif svt.startswith('dict'):
            evt = ht.tstruct(key=vt.key_type, value=vt.value_type)
        else:
            evt = getattr(vt, 'element_type', ht.tstr)
        vals = [None if elem_missing[i] else decode_value(r, et.element, evt)
                for i in range(n)]
        if svt.startswith('set'):
            return frozenset(vals)
        if svt.startswith('dict'):
            return {v['key']: v['value'] for v in vals if v is not None}
        return vals
    if et.kind == 'binary':
        n = r.int32()
        b = r.bytes_(n)
        return b.decode('utf-8', errors='replace') if vt == ht.tstr else b
    if et.kind == 'int32':
        v = r.int32()
        if vt == ht.tcall:
            return _hail_call_to_ours(v)
        return v
    if et.kind == 'int64':
        return r.int64()
    if et.kind == 'float32':
        return r.f32()
    if et.kind == 'float64':
        return r.f64()
    if et.kind == 'boolean':
        return bool(r.byte())
    if et.kind == 'ndarray':
        # ENDArrayColumnMajor.scala:20-47: nDims int64 shape values, then
        # elements in column-major order
        ndims = et.ndims if et.ndims is not None else getattr(vt, 'ndim', 1)
        shape = [r.int64() for _ in range(ndims)]
        total = 1
        for s_ in shape:
            total *= s_
        evt = getattr(vt, 'element_type', ht.tfloat64)
        vals = [decode_value(r, et.element, evt) for _ in range(total)]
        return np.reshape(np.asarray(vals), shape, order='F')
    raise NotImplementedError(et.kind)


def decode_rows_et(raw: bytes, et: EType, vt: ht.HailType,
                   buffer_spec: dict) -> List[Any]:
    flat, leb = decode_part_bytes(raw, buffer_spec)
    r = _Reader(flat, leb)
    rows = []
    while not r.eof():
        marker = r.byte()
        if marker == 0:
            break
        rows.append(decode_value(r, et, vt))
    return rows


def decode_rows(raw: bytes, codec_spec: dict) -> Tuple[List[Any], ht.HailType]:
    et = parse_etype(codec_spec['_eType'])
    vt = parse_vtype(codec_spec['_vType'])
    return decode_rows_et(raw, et, vt, codec_spec['_bufferSpec']), vt


# ---------------------------------------------------------------------------
# legacy (pre-TypedCodecSpec) specs: OrderedRVDSpec / UnpartitionedRVDSpec /
# IndexedRVDSpec with a PackCodecSpec — the encoding is derived from the
# legacy virtual-type string, whose '+' markers carry requiredness
# (reference `is/hail/compatibility/` LegacyEncodedTypeParser)
# ---------------------------------------------------------------------------


def parse_legacy_etype(s: str) -> EType:
    t, rest = _parse_letype(s, 0)
    assert rest == len(s), (s, rest)
    return t


def _parse_letype(s: str, i: int) -> Tuple[EType, int]:
    required = False
    if s[i] == '+':
        required = True
        i += 1
    _prims = {'String': 'binary', 'Binary': 'binary', 'Int32': 'int32',
              'Int64': 'int64', 'Float32': 'float32', 'Float64': 'float64',
              'Boolean': 'boolean', 'Call': 'int32'}
    for name, kind in _prims.items():
        if s.startswith(name, i) and not s.startswith(name + 'a', i):
            return EType(kind, required), i + len(name)
    if s.startswith('Locus(', i):
        j = s.index(')', i)
        return EType('struct', required, fields=[
            ('contig', EType('binary', True)),
            ('position', EType('int32', True))]), j + 1
    if s.startswith('Struct{', i) or s.startswith('Tuple[', i):
        is_tuple = s.startswith('Tuple[', i)
        close = ']' if is_tuple else '}'
        i += len('Tuple[') if is_tuple else len('Struct{')
        fields = []
        fi = 0
        while s[i] != close:
            if is_tuple:
                name = str(fi)
                fi += 1
            else:
                j = i
                depth = 0
                in_tick = False
                while in_tick or not (s[j] == ':' and depth == 0):
                    if s[j] == '`':
                        in_tick = not in_tick
                    elif not in_tick:
                        if s[j] in '{[(':
                            depth += 1
                        elif s[j] in '}])':
                            depth -= 1
                    j += 1
                name = s[i:j].strip('`')
                i = j + 1
            sub, i = _parse_letype(s, i)
            fields.append((name, sub))
            if s[i] == ',':
                i += 1
        return EType('struct', required, fields=fields), i + 1
    for name in ('Array[', 'Set['):
        if s.startswith(name, i):
            sub, i = _parse_letype(s, i + len(name))
            assert s[i] == ']'
            return EType('array', required, element=sub), i + 1
    if s.startswith('Dict[', i):
        k, i = _parse_letype(s, i + len('Dict['))
        assert s[i] == ','
        v, i = _parse_letype(s, i + 1)
        assert s[i] == ']'
        el = EType('struct', True, fields=[('key', k), ('value', v)])
        return EType('array', required, element=el), i + 1
    if s.startswith('Interval[', i):
        sub, i = _parse_letype(s, i + len('Interval['))
        assert s[i] == ']'
        return EType('struct', required, fields=[
            ('start', sub), ('end', sub),
            ('includes_start', EType('boolean', True)),
            ('includes_end', EType('boolean', True))]), i + 1
    if s.startswith('NDArray[', i):
        sub, i = _parse_letype(s, i + len('NDArray['))
        j = i
        while s[i] != ']':
            i += 1
        suffix = s[j:i].lstrip(',')
        ndims = int(suffix) if suffix.isdigit() else 1
        return EType('ndarray', required, element=sub, ndims=ndims), i + 1
    raise ValueError(f'unknown legacy type at {i}: {s[i:i+40]}')


def _legacy_rvd_meta(meta: dict):
    """(row_type_str, key, part_files, jrange_bounds) from a legacy spec."""
    import re
    if meta['name'] == 'UnpartitionedRVDSpec':
        return meta['rowType'], [], meta['partFiles'], None
    ts = meta.get('rvdType') or meta.get('orvdType')
    inner = ts[ts.index('{') + 1:-1]
    assert inner.startswith('key:'), inner
    j = inner.index('[')
    depth = 0
    k = j
    for k in range(j, len(inner)):
        if inner[k] == '[':
            depth += 1
        elif inner[k] == ']':
            depth -= 1
            if depth == 0:
                break
    key_str = inner[j:k + 1]
    key = [p.strip('`') for p in re.findall(r'[^\[\],]+', key_str)]
    row_str = inner[k + 1:]
    assert row_str.startswith(',row:'), row_str[:20]
    return row_str[len(',row:'):], key, meta['partFiles'], meta.get('jRangeBounds')


# ---------------------------------------------------------------------------
# table / matrix table assembly
# ---------------------------------------------------------------------------


def _load_component(path: str, rel: str):
    """Load an RVD component: returns (list of per-partition row lists, vtype,
    key, jRangeBounds). Handles both the current TypedCodecSpec layout and the
    legacy PackCodecSpec specs (OrderedRVDSpec/UnpartitionedRVDSpec/
    IndexedRVDSpec — ref `rvd/AbstractRVDSpec.scala:224`, `compatibility/`)."""
    comp_dir = os.path.join(path, rel)
    with gzip.open(os.path.join(comp_dir, 'metadata.json.gz')) as f:
        meta = json.load(f)
    if '_codecSpec' in meta:
        codec = meta['_codecSpec']
        et = parse_etype(codec['_eType'])
        vt = parse_vtype(codec['_vType'])
        buffer_spec = codec['_bufferSpec']
        parts = meta['_partFiles']
        key = meta.get('_key', [])
        jrb = meta.get('_jRangeBounds')
    else:
        row_str, key, parts, jrb = _legacy_rvd_meta(meta)
        et = parse_legacy_etype(row_str)
        vt = parse_vtype(row_str)
        buffer_spec = meta['codecSpec']['child']
    out = []
    for pf in parts:
        with open(os.path.join(comp_dir, 'parts', pf), 'rb') as f:
            raw = f.read()
        out.append(decode_rows_et(raw, et, vt, buffer_spec))
    return out, vt, key, jrb


def _gp_bounds(jrange_bounds, vt: ht.HailType, key) -> Optional[list]:
    """Partitioner range bounds (`_jRangeBounds` in the RVD spec) →
    per-partition closed [lo, hi] locus global-position bounds, the form the
    interval/key-predicate pruning passes consume
    (hail_tpu/ir/interval_filters.py)."""
    if not jrange_bounds or not key:
        return None
    t0 = vt.fields.get(key[0]) if isinstance(vt, ht.tstruct) else None
    rg = getattr(t0, 'reference_genome', None)
    numeric = t0 in (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64)
    if rg is None and not numeric:
        return None

    def gp(point, end=False):
        v = point.get(key[0]) if isinstance(point, dict) else None
        if rg is not None:
            if not isinstance(v, dict):
                return None
            c, p = v.get('contig'), v.get('position')
            if c not in rg._global_offsets:
                return None
            return rg._global_offsets[c] + p - 1
        if v is None:
            return None
        return v

    out = []
    for b in jrange_bounds:
        lo = gp(b.get('start'))
        hi = gp(b.get('end'), end=True)
        # stored bounds may be half-open on the end; the pruning passes use
        # closed [lo, hi], so widen exclusive integer ends by keeping hi
        # as-is (conservative: may keep one extra partition, never drops)
        out.append(None if lo is None or hi is None else (lo, hi))
    return out


def is_hail_native(path: str) -> bool:
    return os.path.isfile(os.path.join(path, 'metadata.json.gz'))


def _load_references(path: str, rel: Optional[str]) -> None:
    """Register custom reference genomes stored inside the dataset
    (`references_rel_path` dir of RG JSONs — ref RelationalSpec.references)."""
    if not rel:
        return
    ref_dir = os.path.join(path, rel)
    if not os.path.isdir(ref_dir):
        return
    from ..genetics.reference_genome import ReferenceGenome
    for fn in os.listdir(ref_dir):
        full = os.path.join(ref_dir, fn)
        try:
            if fn.endswith('.json.gz'):
                with gzip.open(full) as f:
                    d = json.load(f)
            elif fn.endswith('.json'):
                with open(full) as f:
                    d = json.load(f)
            else:
                continue
        except Exception:
            continue
        if d.get('name') in ReferenceGenome._registry:
            continue
        contigs = [c['name'] for c in d['contigs']]
        lengths = {c['name']: c['length'] for c in d['contigs']}
        par = [(p['start']['contig'], p['start']['position'],
                p['end']['contig'], p['end']['position'])
               for p in d.get('par', [])]
        ReferenceGenome(d['name'], contigs, lengths,
                        x_contigs=d.get('xContigs', []),
                        y_contigs=d.get('yContigs', []),
                        mt_contigs=d.get('mtContigs', []), par=par)


def read_hail_table(path: str):
    from ..ir.columns import Batch
    from ..table import Table, TableStage
    with gzip.open(os.path.join(path, 'metadata.json.gz')) as f:
        meta = json.load(f)
    assert meta['name'] == 'TableSpec', meta['name']
    _load_references(path, meta.get('references_rel_path'))
    comps = meta['components']
    g_parts, g_vt, _, _ = _load_component(path, comps['globals']['rel_path'])
    g_rows = [row for part in g_parts for row in part]
    r_parts, r_vt, key, jrb = _load_component(path, comps['rows']['rel_path'])
    globals_b = Batch.from_pylist(g_vt, g_rows or [Struct()])
    batches = [Batch.from_pylist(r_vt, rows) for rows in r_parts]
    if not batches:
        batches = [Batch.empty(r_vt)]
    st = TableStage.from_batches(globals_b, list(key), r_vt, batches,
                                 partition_bounds=_gp_bounds(jrb, r_vt, key))
    st.uid_tuple = True   # (partIdx, rowIdx) read uids, reference parity
    return Table(st)


def read_hail_matrix_table(path: str):
    from ..ir import columns as C
    from ..ir.columns import Batch
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
    with gzip.open(os.path.join(path, 'metadata.json.gz')) as f:
        meta = json.load(f)
    if 'file_version' not in meta:
        from ..utils.java import FatalError
        raise FatalError(
            f'Error summary: HailException: metadata does not contain file '
            f'version: {path}')
    assert meta['name'] == 'MatrixTableSpec', meta['name']
    _load_references(path, meta.get('references_rel_path'))
    comps = meta['components']
    g_parts, g_vt, _, _ = _load_component(path, comps['globals']['rel_path'])
    c_parts, c_vt, _, _ = _load_component(path, comps['cols']['rel_path'])
    r_parts, r_vt, row_key, jrb = _load_component(path, comps['rows']['rel_path'])
    e_parts, e_vt, _, _ = _load_component(path, comps['entries']['rel_path'])

    g_rows = [row for part in g_parts for row in part]
    cols_rows = [row for part in c_parts for row in part]
    n_cols = len(cols_rows)
    globals_b = Batch.from_pylist(g_vt, g_rows or [Struct()])
    cols_b = Batch.from_pylist(c_vt, cols_rows)

    # matrix type for col key / entry type
    from ..matrixtable import MatrixTable as _MT
    mt_type = meta['matrix_type']
    # col_key: [s] — parse from "col_key:[a,b]"
    ck = mt_type.split('col_key:[')[1].split(']')[0]
    col_key = [k.strip() for k in ck.split(',') if k.strip()]

    (ename, entries_arr_t), = e_vt.fields.items()
    entry_t = entries_arr_t.element_type

    import numpy as _np
    mbs = []
    for rows, ents in zip(r_parts, e_parts):
        R = len(rows)
        rows_b = Batch.from_pylist(r_vt, rows)
        ent_cols = {}
        for f, ft in entry_t.fields.items():
            flat = [None if e is None else e[f]
                    for erow in ents for e in erow[ename]]
            col = C.from_pylist(ft, flat).reshape((R, n_cols))
            ent_cols[f] = col
        # a missing ELEMENT of the entries array is a FILTERED entry
        # (reference localize/unlocalize round-trip semantics)
        filt = _np.asarray([e is None for erow in ents for e in erow[ename]],
                           dtype=bool).reshape((R, n_cols))
        mbs.append(MatrixBatch(rows_b, ent_cols,
                               filt if filt.any() else None))
    if not mbs:
        mbs = [MatrixBatch(Batch.empty(r_vt), {})]
    return MatrixTable(MatrixStage.from_batches(
        globals_b, cols_b, list(row_key), col_key, r_vt, c_vt, entry_t, mbs,
        partition_bounds=_gp_bounds(jrb, r_vt, row_key)))
