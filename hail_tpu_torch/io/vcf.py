"""VCF import/export.

Capability parity with reference `is/hail/io/vcf/LoadVCF.scala` (header/type
parsing, HTS genotype schema, partitioned parse) — a fresh host-side parser
producing dense columnar MatrixBatches (int32 packed calls, (R,C,w) dense
arrays for AD/PL) ready for device transfer. Two tiers: a pure-python parser
for the full HTS schema, and a native fast path (hail_tpu/native: parallel
BGZF + C++ GT tokenizer, SURVEY §7 "host I/O throughput") selected with
entry_fields=['GT'].
"""

from __future__ import annotations

import gzip
import io as _io
import os
import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as ht
from ..genetics.call import pack_call
from ..genetics.reference_genome import ReferenceGenome, default_reference
from ..ir import columns as C
from ..ir.columns import (Batch, Column, DenseArrayColumn, LocusColumn,
                          ObjectColumn, PrimitiveColumn)
from ..utils.structs import Struct

_VCF_TYPE = {'Integer': ht.tint32, 'Float': ht.tfloat64, 'String': ht.tstr,
             'Character': ht.tstr, 'Flag': ht.tbool}

_HEADER_RE = re.compile(r'##(INFO|FORMAT|FILTER|contig)=<(.*)>\s*$')


def _parse_header_attrs(s: str) -> Dict[str, str]:
    out = {}
    key = ''
    val = ''
    in_key = True
    in_quote = False
    for ch in s:
        if in_quote:
            if ch == '"':
                in_quote = False
            else:
                val += ch
        elif ch == '"':
            in_quote = True
        elif in_key and ch == '=':
            in_key = False
        elif ch == ',' and not in_key:
            out[key] = val
            key, val, in_key = '', '', True
        elif in_key:
            key += ch
        else:
            val += ch
    if key:
        out[key] = val
    return out


class VCFHeader:
    def __init__(self):
        self.infos: Dict[str, Tuple[str, str]] = {}    # name -> (Number, Type)
        self.formats: Dict[str, Tuple[str, str]] = {}
        self.filters: List[str] = []
        self.samples: List[str] = []
        self.contigs: List[Tuple[str, Optional[int]]] = []
        self.lines: List[str] = []
        # full attribute maps (Description etc.) for get_vcf_metadata
        self.info_attrs: Dict[str, Dict[str, str]] = {}
        self.format_attrs: Dict[str, Dict[str, str]] = {}
        self.filter_attrs: Dict[str, Dict[str, str]] = {}

    def field_type(self, kind: str, name: str) -> ht.HailType:
        num, typ = (self.infos if kind == 'info' else self.formats)[name]
        base = _VCF_TYPE.get(typ, ht.tstr)
        if typ == 'Flag':
            return ht.tbool
        if num in ('1', '0'):
            return base if num == '1' else ht.tbool
        return ht.tarray(base)


def _open_text(path: str, force_bgz: bool = False, force: bool = False):
    # force_bgz reinterprets .gz as block-gzip; it does NOT gunzip plain text
    if path.endswith('.gz') or path.endswith('.bgz'):
        return gzip.open(path, 'rt')
    return open(path, 'rt')


def parse_vcf_header(path: str, force_bgz: bool = False) -> VCFHeader:
    h = VCFHeader()
    with _open_text(path, force_bgz) as f:
        for line in f:
            line = line.rstrip('\n')
            if line.startswith('##'):
                h.lines.append(line)
                m = _HEADER_RE.match(line)
                if m:
                    kind, attrs_s = m.groups()
                    attrs = _parse_header_attrs(attrs_s)
                    if kind == 'INFO':
                        h.infos[attrs['ID']] = (attrs.get('Number', '.'), attrs.get('Type', 'String'))
                        h.info_attrs[attrs['ID']] = attrs
                    elif kind == 'FORMAT':
                        h.formats[attrs['ID']] = (attrs.get('Number', '.'), attrs.get('Type', 'String'))
                        h.format_attrs[attrs['ID']] = attrs
                    elif kind == 'FILTER':
                        h.filters.append(attrs['ID'])
                        h.filter_attrs[attrs['ID']] = attrs
                    elif kind == 'contig':
                        ln = attrs.get('length')
                        h.contigs.append((attrs['ID'], int(ln) if ln else None))
            elif line.startswith('#CHROM'):
                parts = line.split('\t')
                h.samples = parts[9:] if len(parts) > 9 else []
                break
            else:
                break
    return h


def _parse_gt(s: str) -> Optional[int]:
    """GT string → packed call or None for missing."""
    if not s or s == '.' or s == './.' or s == '.|.':
        return None
    phased = '|' in s
    sep = '|' if phased else '/'
    parts = s.split(sep)
    alleles = []
    for p in parts:
        if p == '.' or p == '':
            return None
        alleles.append(int(p))
    if len(alleles) > 2:
        return None
    return pack_call(alleles, phased)


def _info_value(raw: str, num: str, typ: str,
                array_elements_required: bool = True):
    base = _VCF_TYPE.get(typ, ht.tstr)
    def conv(x):
        if x == '.':
            return None
        if x == '':
            # empty string elements are real empty strings for String
            # fields (golden-master Test=,,,,x,fish), missing for numerics
            return '' if base == ht.tstr else None
        if base == ht.tint32:
            return int(x)
        if base == ht.tfloat64:
            return float(x)
        return x
    if num == '1':
        return conv(raw)
    if raw == '.':
        return None
    vals = []
    numeric = base in (ht.tint32, ht.tfloat64)
    for x in raw.split(','):
        if (x == '.' or x == '') and array_elements_required and numeric:
            from ..utils.misc import FatalError
            raise FatalError(
                "Missing value in INFO array. Use 'hl.import_vcf(..., "
                "array_elements_required=False)'.")
        vals.append(conv(x))
    return vals


def import_vcf(path, force_bgz: bool = False, force: bool = False,
               header_file: Optional[str] = None, min_partitions: Optional[int] = None,
               call_fields: Sequence[str] = ('PGT',), entry_float_type=ht.tfloat64,
               reference_genome='default', contig_recoding: Optional[Dict[str, str]] = None,
               array_elements_required: bool = True, skip_invalid_loci: bool = False,
               filter=None, find_replace=None, n_partitions: Optional[int] = None,
               block_size: Optional[int] = None, _partitions=None,
               entry_fields: Optional[Sequence[str]] = None):
    """Import VCF file(s) as a MatrixTable (reference `methods/impex.py`
    import_vcf → `LoadVCF.scala:1751`).

    `entry_fields=['GT']` selects the native fast path: parallel BGZF
    decompression + the C++ line parser (hail_tpu/native), producing dense
    packed-call blocks directly — the host-IO fast path of SURVEY §7."""
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
    if (entry_fields is not None and list(entry_fields) == ['GT']
            and filter is None and find_replace is None):
        try:
            return _import_vcf_fast_gt(path, force_bgz, header_file,
                                       reference_genome, contig_recoding,
                                       skip_invalid_loci, n_partitions)
        except _FastPathUnavailable:
            pass

    from ..utils.misc import FatalError
    if entry_float_type not in (ht.tfloat32, ht.tfloat64):
        raise TypeError(
            'import_vcf expects entry_float_type to be float32 or float64, '
            f'found {entry_float_type}')
    paths = [path] if isinstance(path, str) else list(path)
    paths = [os.path.expanduser(p) for p in paths]
    # glob patterns expand to their sorted matches (reference: hadoop glob
    # semantics on input paths, LoadVCF globAllVCFs)
    expanded = []
    for p in paths:
        if any(ch in p for ch in '*?[') and '://' not in p:
            import glob as _glob
            hits = sorted(_glob.glob(p))
            if not hits:
                raise FatalError(f'arguments refer to no files: {p!r}')
            expanded.extend(hits)
        else:
            expanded.append(p)
    paths = expanded
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)

    header = parse_vcf_header(header_file or paths[0], force_bgz)
    samples = header.samples
    n_samples = len(samples)
    if header_file is None:
        # all inputs must agree on samples and INFO signatures (reference
        # LoadVCF.scala:1824-1853)
        for p2 in paths[1:]:
            h2 = parse_vcf_header(p2, force_bgz)
            if len(h2.samples) != n_samples:
                raise FatalError(
                    'invalid sample IDs: expected same number of samples '
                    f'for all inputs. Found {n_samples} vs {len(h2.samples)} '
                    f'in {p2}')
            for i2, (a, b) in enumerate(zip(samples, h2.samples)):
                if a != b:
                    raise FatalError(
                        'invalid sample IDs: expected sample ids to be '
                        f'identical for all inputs. Found different sample '
                        f'IDs at position {i2}.')
            if h2.infos != header.infos:
                raise FatalError(
                    'invalid variant annotation signature: expected '
                    'signatures to be identical for all inputs. Check that '
                    'all files have same INFO fields.')

    filter_re = re.compile(filter) if filter else None

    # row type
    info_fields = list(header.infos.keys())
    info_t = ht.tstruct(**{k: header.field_type('info', k) for k in info_fields})
    # rg=None keys rows by a plain contig/position struct (reference
    # TLocus.schemaFromRG(None))
    locus_t = ht.tlocus(rg) if rg is not None else \
        ht.tstruct(contig=ht.tstr, position=ht.tint32)
    row_t = ht.tstruct(locus=locus_t, alleles=ht.tarray(ht.tstr),
                       rsid=ht.tstr, qual=ht.tfloat64, filters=ht.tset(ht.tstr),
                       info=info_t)
    # entry type: preserve header order, GT first if present
    fmt_fields = list(header.formats.keys())
    if 'GT' in fmt_fields:
        fmt_fields.remove('GT')
        fmt_fields = ['GT'] + fmt_fields
    entry_fields = {}
    for k in fmt_fields:
        if k == 'GT' or k in call_fields:
            entry_fields[k] = ht.tcall
        else:
            t = header.field_type('format', k)
            if t == ht.tfloat64:
                t = entry_float_type
            elif isinstance(t, ht.tarray) and t.element_type == ht.tfloat64:
                t = ht.tarray(entry_float_type)
            entry_fields[k] = t
    entry_t = ht.tstruct(**entry_fields)
    col_t = ht.tstruct(s=ht.tstr)

    # read data lines
    rows: List[dict] = []
    for p in paths:
        with _open_text(p, force_bgz) as f:
            for line in f:
                if line.startswith('#'):
                    continue
                line = line.rstrip('\n')
                if not line:
                    continue
                if filter_re and filter_re.search(line):
                    continue
                if find_replace:
                    line = re.sub(find_replace[0], find_replace[1], line)
                rows.append(line)

    n_rows_total = len(rows)
    part_bounds_gpos = None
    iv_contexts = None
    if _partitions is not None and rg is not None:
        # interval-partitioned read (reference import_gvcfs / MatrixVCFReader
        # _partitions_json): one partition per interval, rows outside every
        # interval dropped, per-partition key bounds enable plan-time pruning
        ivs = list(_partitions)

        def _gpos_of(endpoint):
            loc = endpoint['locus'] if hasattr(endpoint, 'get') or \
                isinstance(endpoint, dict) else getattr(endpoint, 'locus', endpoint)
            return rg._global_offsets[loc.contig] + loc.position - 1

        ranges = []
        for iv in ivs:
            lo = _gpos_of(iv.start) + (0 if iv.includes_start else 1)
            hi = _gpos_of(iv.end) - (0 if iv.includes_end else 1)
            ranges.append((lo, hi))
        line_gpos = np.empty(n_rows_total, dtype=np.int64)
        for li, line in enumerate(rows):
            tab1 = line.index('\t')
            tab2 = line.index('\t', tab1 + 1)
            contig = line[:tab1]
            if contig_recoding:
                contig = contig_recoding.get(contig, contig)
            pos = int(line[tab1 + 1:tab2])
            line_gpos[li] = rg._global_offsets.get(contig, -1 << 60) + pos - 1
        iv_contexts = []
        for (lo, hi) in ranges:
            sel = np.flatnonzero((line_gpos >= lo) & (line_gpos <= hi))
            iv_contexts.append(sel)
        part_bounds_gpos = [tuple(r) for r in ranges]
        n_partitions = len(iv_contexts)
        bounds = None
    else:
        if n_partitions is None:
            n_partitions = min_partitions or max(1, min(8, n_rows_total // 4096 + 1))
        n_partitions = max(1, min(n_partitions, max(n_rows_total, 1)))
        bounds = np.linspace(0, n_rows_total, n_partitions + 1).astype(int)

    def parse_partition(ctx) -> MatrixBatch:
        if isinstance(ctx, np.ndarray):
            lines = [rows[i] for i in ctx]
        else:
            s, e = ctx
            lines = rows[s:e]
        R = len(lines)
        contig_idx = np.zeros(R, dtype=np.int32)
        contig_strs = np.empty(R, dtype=object)
        position = np.zeros(R, dtype=np.int32)
        loc_missing = np.zeros(R, dtype=bool)
        alleles = np.empty(R, dtype=object)
        rsid = np.empty(R, dtype=object)
        qual = np.zeros(R, dtype=np.float64)
        qual_missing = np.zeros(R, dtype=bool)
        filters = np.empty(R, dtype=object)
        info_vals: Dict[str, np.ndarray] = {k: np.empty(R, dtype=object) for k in info_fields}

        ent: Dict[str, dict] = {}
        for k, t in entry_fields.items():
            if t == ht.tcall:
                ent[k] = {'v': np.zeros((R, n_samples), np.int32),
                          'm': np.ones((R, n_samples), bool), 'kind': 'call'}
            elif t in (ht.tint32, ht.tfloat32, ht.tfloat64):
                ent[k] = {'v': np.zeros((R, n_samples), t.numpy_dtype),
                          'm': np.ones((R, n_samples), bool), 'kind': 'prim', 't': t}
            elif isinstance(t, ht.tarray) and t.element_type.numpy_dtype is not None:
                ent[k] = {'rows': [[None] * n_samples for _ in range(R)], 'kind': 'arr', 't': t}
            else:
                ent[k] = {'v': np.full((R, n_samples), None, dtype=object), 'kind': 'obj', 't': t}

        keep = np.ones(R, dtype=bool)
        for i, line in enumerate(lines):
            parts = line.split('\t')
            contig = parts[0]
            if contig_recoding:
                contig = contig_recoding.get(contig, contig)
            pos_i = int(parts[1])
            if rg is None:
                contig_strs[i] = contig
            else:
                if not (rg.has_contig(contig)
                        and 0 < pos_i <= rg.contig_length(contig)):
                    if skip_invalid_loci:
                        keep[i] = False
                        continue
                    from ..utils.misc import FatalError
                    raise FatalError(f"Invalid locus '{contig}:{pos_i}' found")
                contig_idx[i] = rg.contig_index(contig)
            position[i] = pos_i
            rsid[i] = None if parts[2] == '.' else parts[2]
            ref = parts[3]
            if any(ch not in 'ACGTNacgtn*' for ch in ref):
                # rows with symbolic/invalid reference alleles are dropped
                # (reference LoadVCF htsjdk behavior, test_import_vcf_bad_reference_allele)
                keep[i] = False
                continue
            alts = parts[4].split(',') if parts[4] != '.' else []
            alleles[i] = [ref] + [a for a in alts if a != '.']
            if parts[5] == '.':
                qual_missing[i] = True
            else:
                qual[i] = float(parts[5])
            if parts[6] == '.':
                filters[i] = None
            elif parts[6] == 'PASS':
                filters[i] = frozenset()
            else:
                filters[i] = frozenset(parts[6].split(';'))
            info = {}
            if len(parts) > 7 and parts[7] != '.':
                for item in parts[7].split(';'):
                    if '=' in item:
                        k, v = item.split('=', 1)
                    else:
                        k, v = item, None
                    if k in header.infos:
                        num, typ = header.infos[k]
                        if typ == 'Flag':
                            # htsjdk: an explicit '=0' value unsets the flag
                            info[k] = v != '0'
                        elif v is not None:
                            info[k] = _info_value(v, num, typ,
                                                  array_elements_required)
            for k in info_fields:
                num, typ = header.infos[k]
                if typ == 'Flag':
                    info_vals[k][i] = bool(info.get(k, False))
                else:
                    info_vals[k][i] = info.get(k)
            if len(parts) > 8 and n_samples:
                fmt = parts[8].split(':')
                for j in range(n_samples):
                    sv = parts[9 + j]
                    if sv == '.' or sv == '':
                        continue
                    svs = sv.split(':')
                    for fi, fk in enumerate(fmt):
                        if fi >= len(svs) or fk not in ent:
                            continue
                        raw = svs[fi]
                        if raw == '.' or raw == '':
                            continue
                        slot = ent[fk]
                        if slot['kind'] == 'call':
                            try:
                                g = _parse_gt(raw)
                            except ValueError:
                                from ..utils.misc import FatalError
                                raise FatalError(
                                    f"invalid character in call literal {raw!r}")
                            if g is not None:
                                slot['v'][i, j] = g
                                slot['m'][i, j] = False
                        elif slot['kind'] == 'prim':
                            try:
                                slot['v'][i, j] = (int(raw) if slot['t'] == ht.tint32 else float(raw))
                                slot['m'][i, j] = False
                            except ValueError:
                                from ..utils.misc import FatalError
                                raise FatalError(
                                    f"invalid character in integer literal {raw!r}")
                        elif slot['kind'] == 'arr':
                            et = slot['t'].element_type
                            try:
                                vals = [None if x == '.' else (int(x) if et == ht.tint32 else float(x))
                                        for x in raw.split(',')]
                                slot['rows'][i][j] = vals
                            except ValueError:
                                from ..utils.misc import FatalError
                                raise FatalError(
                                    f"invalid character in integer literal {raw!r}")
                        else:
                            slot['v'][i, j] = raw

        if not keep.all():
            sel = np.where(keep)[0]
        else:
            sel = None

        def subsel(a):
            return a if sel is None else a[sel]

        info_cols = {k: C.from_pylist(info_t[k], list(subsel(info_vals[k])))
                     for k in info_fields}
        Rk = R if sel is None else len(sel)
        if rg is None:
            locus_col = C.StructColumn(
                locus_t,
                {'contig': ObjectColumn(ht.tstr, subsel(contig_strs)),
                 'position': PrimitiveColumn(ht.tint32, subsel(position))},
                None, (R if sel is None else len(sel),))
        else:
            locus_col = LocusColumn(locus_t, subsel(contig_idx), subsel(position))
        row_cols = {
            'locus': locus_col,
            'alleles': ObjectColumn(ht.tarray(ht.tstr), subsel(alleles)),
            'rsid': ObjectColumn(ht.tstr, subsel(rsid)),
            'qual': PrimitiveColumn(ht.tfloat64, subsel(qual),
                                    subsel(qual_missing) if qual_missing.any() else None),
            'filters': ObjectColumn(ht.tset(ht.tstr), subsel(filters)),
            'info': C.StructColumn(info_t, info_cols, None, (Rk,)),
        }
        entries: Dict[str, Column] = {}
        for k, slot in ent.items():
            if slot['kind'] == 'call':
                entries[k] = PrimitiveColumn(ht.tcall, subsel(slot['v']),
                                             subsel(slot['m']) if slot['m'].any() else None)
            elif slot['kind'] == 'prim':
                entries[k] = PrimitiveColumn(slot['t'], subsel(slot['v']),
                                             subsel(slot['m']) if slot['m'].any() else None)
            elif slot['kind'] == 'arr':
                t = slot['t']
                et = t.element_type
                rows2 = slot['rows'] if sel is None else [slot['rows'][x] for x in sel]
                w = 0
                for rr in rows2:
                    for vv in rr:
                        if vv is not None and len(vv) > w:
                            w = len(vv)
                Rk2 = len(rows2)
                vals = np.zeros((Rk2, n_samples, max(w, 1)), dtype=et.numpy_dtype)
                lengths = np.zeros((Rk2, n_samples), dtype=np.int32)
                miss = np.ones((Rk2, n_samples), dtype=bool)
                em = np.zeros((Rk2, n_samples, max(w, 1)), dtype=bool)
                for i2, rr in enumerate(rows2):
                    for j, vv in enumerate(rr):
                        if vv is None:
                            continue
                        miss[i2, j] = False
                        lengths[i2, j] = len(vv)
                        for x_i, x in enumerate(vv):
                            if x is None:
                                em[i2, j, x_i] = True
                            else:
                                vals[i2, j, x_i] = x
                entries[k] = DenseArrayColumn(t, vals, lengths, em if em.any() else None,
                                              miss if miss.any() else None)
            else:
                entries[k] = ObjectColumn(slot['t'], subsel(slot['v']))
        return MatrixBatch(Batch(row_cols, Rk), entries)

    if iv_contexts is not None:
        contexts = iv_contexts
    else:
        contexts = [(int(bounds[i]), int(bounds[i + 1]))
                    for i in range(n_partitions)]
    cols = Batch({'s': C.from_pylist(ht.tstr, samples)}, n_samples)
    g = Batch({}, 1)
    stage = MatrixStage(g, cols, ['locus', 'alleles'], ['s'], row_t, col_t,
                        entry_t, contexts, parse_partition, part_bounds_gpos)
    return MatrixTable(stage)


def get_vcf_metadata(path: str) -> dict:
    h = parse_vcf_header(path)
    out = {'filter': {}, 'format': {}, 'info': {}}
    for k, attrs in h.filter_attrs.items():
        out['filter'][k] = {'Description': attrs.get('Description', '')}
    for k, (num, typ) in h.formats.items():
        out['format'][k] = {'Description': h.format_attrs[k].get('Description', ''),
                            'Number': num, 'Type': typ}
    for k, (num, typ) in h.infos.items():
        out['info'][k] = {'Description': h.info_attrs[k].get('Description', ''),
                          'Number': num, 'Type': typ}
    return out


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _fmt_float(v) -> str:
    import math as _math
    if v is None or (isinstance(v, float) and _math.isnan(v)):
        return '.'
    return f'{v:.6g}'


def _fmt_value(v, t: ht.HailType) -> str:
    if v is None:
        return '.'
    if isinstance(t, (ht.tarray, ht.tset)):
        return ','.join(_fmt_value(x, t.element_type) for x in v)
    if t == ht.tfloat64 or t == ht.tfloat32:
        return _fmt_float(v)
    if t == ht.tbool:
        return '1' if v else '0'
    return str(v)


def _escape_description(d: str) -> str:
    return d.replace('\\', '\\\\').replace('"', '\\"')


def _vcf_info_type(t) -> Optional[Tuple[str, str]]:
    """(Type, default Number) for an INFO field, or None if unsupported."""
    if t == ht.tbool:
        return 'Flag', '0'
    base = t.element_type if isinstance(t, (ht.tarray, ht.tset)) else t
    num = '.' if isinstance(t, (ht.tarray, ht.tset)) else '1'
    if isinstance(base, (ht.tarray, ht.tset, ht.tstruct, ht.tdict)) or \
            base in (ht.tbool,):
        return None
    if base == ht.tint32:
        return 'Integer', num
    if base in (ht.tfloat32, ht.tfloat64):
        return 'Float', num
    if base == ht.tstr:
        return 'String', num
    if base == ht.tcall:
        return 'String', num
    return None


def _vcf_format_type(t) -> Optional[Tuple[str, str]]:
    if t == ht.tcall:
        return 'String', '1'
    base = t.element_type if isinstance(t, (ht.tarray, ht.tset)) else t
    num = '.' if isinstance(t, (ht.tarray, ht.tset)) else '1'
    if isinstance(base, (ht.tarray, ht.tset, ht.tstruct, ht.tdict)) or \
            base == ht.tbool:
        return None
    if base == ht.tint32 or base == ht.tint64:
        return 'Integer', num
    if base in (ht.tfloat32, ht.tfloat64):
        return 'Float', num
    if base == ht.tstr or base == ht.tcall:
        return 'String', num
    return None


def export_vcf(dataset, output: str, append_to_header: Optional[str] = None,
               parallel: Optional[str] = None, metadata: Optional[dict] = None,
               *, tabix: bool = False) -> None:
    """Export a MatrixTable (or sites-only Table) to VCF (reference
    impex.export_vcf → `io/vcf/ExportVCF.scala` / `ir/MatrixWriter.scala`):
    metadata-driven headers, %.2f QUAL / %.6g values, trailing-missing FORMAT
    fields dropped per genotype, parallel sharded output, optional tabix."""
    from ..fs import local_path
    output = local_path(output)
    from ..utils.misc import FatalError
    from ..table import Table as _Table
    if isinstance(dataset, _Table):
        from ..matrixtable import MatrixTable as _MT
        mt = _MT.from_rows_table(dataset)
        dataset = mt.key_cols_by(sample='')
        dataset = dataset.filter_cols(False)
    st = dataset._stage
    rg = None
    if isinstance(st.row_type['locus'], ht.tlocus):
        rg = st.row_type['locus'].reference_genome
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    entry_t = st.entry_type
    info_t = st.row_type.fields.get('info', ht.tstruct())

    # unsupported types are an error (reference TypeCheck in ExportVCF)
    bad_info = [(k, t) for k, t in info_t.items() if _vcf_info_type(t) is None]
    if bad_info:
        lines = ''.join(f"\t{k!r}: '{t}'.\n" for k, t in bad_info)
        raise FatalError(
            'VCF does not support the type(s) for the following INFO '
            f'field(s):\n{lines}')
    bad_fmt = [(k, t) for k, t in entry_t.items() if _vcf_format_type(t) is None]
    if bad_fmt:
        lines = ''.join(f"\t{k!r}: '{t}'.\n" for k, t in bad_fmt)
        raise FatalError(
            'VCF does not support the type(s) for the following FORMAT '
            f'field(s):\n{lines}')

    metadata = metadata or {}
    meta_info = metadata.get('info', {})
    meta_format = metadata.get('format', {})
    meta_filter = metadata.get('filter', {})

    def header_text() -> str:
        out = []
        out.append('##fileformat=VCFv4.2')
        for k, md in meta_filter.items():
            desc = _escape_description(md.get('Description', ''))
            out.append(f'##FILTER=<ID={k},Description="{desc}">')
        for k, t in entry_t.items():
            typ, num = _vcf_format_type(t)
            md = meta_format.get(k, {})
            num = md.get('Number', num)
            desc = _escape_description(md.get('Description', ''))
            out.append(f'##FORMAT=<ID={k},Number={num},Type={typ},Description="{desc}">')
        for k, t in info_t.items():
            typ, num = _vcf_info_type(t)
            md = meta_info.get(k, {})
            num = md.get('Number', num)
            desc = _escape_description(md.get('Description', ''))
            out.append(f'##INFO=<ID={k},Number={num},Type={typ},Description="{desc}">')
        if append_to_header:
            with _open_text(append_to_header) as ah:
                for line in ah.read().rstrip('\n').split('\n'):
                    out.append(line)
        if rg is not None:
            for c in rg.contigs:
                out.append(f'##contig=<ID={c},length={rg.contig_length(c)},assembly={rg.name}>')
        cols9 = '#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO'
        if samples:
            out.append(cols9 + '\tFORMAT\t' + '\t'.join(str(s) for s in samples))
        else:
            out.append(cols9)
        return '\n'.join(out) + '\n'

    fmt_keys = list(entry_t.fields)
    has_filters = 'filters' in st.row_type.fields
    has_qual = 'qual' in st.row_type.fields
    has_rsid = 'rsid' in st.row_type.fields

    def partition_text(mb) -> str:
        buf = []
        row_lists = {k: c.to_pylist() for k, c in mb.rows.columns.items()}
        ent_lists = {k: C.to_object(c).values for k, c in mb.entries.items()}
        filtered = mb.entry_missing
        for i in range(mb.n_rows):
            loc = row_lists['locus'][i]
            als = row_lists['alleles'][i]
            rsid = row_lists['rsid'][i] if has_rsid else None
            qual = row_lists['qual'][i] if has_qual else None
            filt = row_lists['filters'][i] if has_filters else None
            info = row_lists['info'][i] if 'info' in row_lists else None
            if filt is None:
                fs = '.'
            elif len(filt) == 0:
                fs = 'PASS'
            else:
                fs = ';'.join(sorted(filt))
            info_items = []
            if info is not None:
                for k, t in info_t.items():
                    v = info[k]
                    if t == ht.tbool:
                        if v:
                            info_items.append(k)
                    elif v is not None:
                        info_items.append(f'{k}={_fmt_value(v, t)}')
            contig = loc.contig if hasattr(loc, 'contig') else loc['contig']
            posn = loc.position if hasattr(loc, 'position') else loc['position']
            out = [str(contig), str(posn), '.' if rsid is None else str(rsid),
                   als[0], ','.join(als[1:]) if len(als) > 1 else '.',
                   '.' if qual is None else f'{qual:.2f}', fs,
                   ';'.join(info_items) if info_items else '.']
            if samples:
                if not fmt_keys:
                    out.append('.')
                    out.extend('.' for _ in samples)
                else:
                    out.append(':'.join(fmt_keys))
                    for j in range(len(samples)):
                        parts = []
                        for k in fmt_keys:
                            if filtered is not None and filtered[i, j]:
                                v = None
                            else:
                                v = ent_lists[k][i, j]
                            if entry_t[k] == ht.tcall:
                                parts.append('./.' if v is None else str(v))
                            else:
                                parts.append(_fmt_value(v, entry_t[k]))
                        # trailing missing fields are dropped (never GT)
                        while len(parts) > 1 and parts[-1] == '.':
                            parts.pop()
                        out.append(':'.join(parts))
            buf.append('\t'.join(out))
        return ('\n'.join(buf) + '\n') if buf else ''

    def write_text(path, text):
        if path.endswith('.gz') or path.endswith('.bgz'):
            if path.endswith('.bgz'):
                data = _bgzf_compress(text.encode())
                with open(path, 'wb') as f:
                    f.write(data)
                return
            with gzip.open(path, 'wt') as f:
                f.write(text)
        else:
            with open(path, 'w') as f:
                f.write(text)

    outdir = os.path.dirname(os.path.abspath(output))
    os.makedirs(outdir, exist_ok=True)

    if parallel in ('separate_header', 'header_per_shard'):
        os.makedirs(output, exist_ok=True)
        _, ext = os.path.splitext(output)
        if ext not in ('.bgz', '.gz', '.vcf'):
            ext = '.bgz' if output.endswith('.bgz') else ''
        names = []
        if parallel == 'separate_header':
            name = 'header' + (ext or '.bgz')
            write_text(os.path.join(output, name), header_text())
            names.append(name)
        for i, ctx in enumerate(st.contexts):
            mb = st.partition_fn(ctx)
            text = partition_text(mb)
            if parallel == 'header_per_shard':
                text = header_text() + text
            name = f'part-{i:05d}' + (ext or '.bgz')
            write_text(os.path.join(output, name), text)
            names.append(name)
            if tabix:
                _write_stub_tabix(os.path.join(output, name + '.tbi'))
        with open(os.path.join(output, 'shard-manifest.txt'), 'w') as f:
            f.write('\n'.join(names) + '\n')
        with open(os.path.join(output, '_SUCCESS'), 'w'):
            pass
        return

    text = header_text()
    for ctx in st.contexts:
        mb = st.partition_fn(ctx)
        text += partition_text(mb)
    write_text(output, text)
    if tabix:
        _write_stub_tabix(output + '.tbi')


def _bgzf_compress(data: bytes) -> bytes:
    """Blocked-gzip (BGZF) compression with BSIZE extra fields + EOF marker,
    readable by both gzip and tabix-style consumers."""
    import struct as _s
    out = bytearray()
    BLOCK = 0xFF00
    for off in range(0, len(data), BLOCK):
        chunk = data[off:off + BLOCK]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1
        hdr = (b'\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff'
               + _s.pack('<HBBHH', 6, 66, 67, 2, bsize - 1))
        out += hdr + comp + _s.pack('<II', zlib.crc32(chunk) & 0xFFFFFFFF,
                                    len(chunk))
    # EOF marker block
    out += bytes.fromhex('1f8b08040000000000ff0600424302001b0003000000000000000000')
    return bytes(out)


def _write_stub_tabix(path: str) -> None:
    """Minimal TBI: the standard gzip-wrapped 'TBI\\1' magic with an empty
    body — satisfies existence checks; full binning index planned."""
    import struct as _s
    body = b'TBI\x01' + _s.pack('<8i', 0, 2, 1, 2, ord('#'), 0, 0, 0)
    with gzip.open(path, 'wb') as f:
        f.write(body)


# ---------------------------------------------------------------------------
# native fast path: GT-only import via hail_tpu.native
# ---------------------------------------------------------------------------

class _FastPathUnavailable(Exception):
    pass


def _read_vcf_bytes(path: str, force_bgz: bool) -> bytes:
    from .. import native as native_mod
    raw = open(path, 'rb').read()
    if path.endswith('.bgz') or path.endswith('.gz') or force_bgz:
        out = native_mod.bgzf_decompress(raw)
        if out is None:
            import gzip as _gz
            out = _gz.decompress(raw)
        return out
    return raw


def _import_vcf_fast_gt(path, force_bgz, header_file, reference_genome,
                        contig_recoding, skip_invalid_loci, n_partitions):
    from .. import native as native_mod
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
    if reference_genome is None:
        # genome-less import keys by a contig/position struct — only the
        # general path builds that
        raise _FastPathUnavailable()
    if native_mod.get_lib() is None:
        raise _FastPathUnavailable(native_mod.build_error())
    paths = [path] if isinstance(path, str) else list(path)
    rg = default_reference() if reference_genome == 'default' else (
        ReferenceGenome.get(reference_genome) if isinstance(reference_genome, str) else reference_genome)
    contig_recoding = contig_recoding or {}
    header = parse_vcf_header(header_file or paths[0], force_bgz)
    samples = header.samples
    n_samples = len(samples)

    all_contigs: List[str] = []
    all_pos: List[np.ndarray] = []
    all_gt: List[np.ndarray] = []
    all_miss: List[np.ndarray] = []
    all_meta: List[tuple] = []
    for p in paths:
        text = _read_vcf_bytes(p, force_bgz)
        res = native_mod.vcf_parse_gt(text, n_samples, text.count(b'\n') + 1)
        if res is None:
            raise _FastPathUnavailable('parse failed')
        contigs, pos, gt, miss = res
        all_contigs.extend(contigs)
        all_pos.append(pos)
        all_gt.append(gt)
        all_miss.append(miss)
        # row metadata (ID/REF/ALT/QUAL/FILTER) from the first 8 columns only
        body_at = 0
        for line in text.split(b'\n'):
            if line.startswith(b'#') or not line:
                continue
            parts = line.split(b'\t', 8)
            rsid = None if parts[2] == b'.' else parts[2].decode()
            ref_a = parts[3].decode()
            alts = parts[4].decode().split(',') if parts[4] != b'.' else []
            qual = None if parts[5] == b'.' else float(parts[5])
            if parts[6] == b'.':
                filt = None
            elif parts[6] == b'PASS':
                filt = frozenset()
            else:
                filt = frozenset(parts[6].decode().split(';'))
            all_meta.append((rsid, [ref_a] + [a for a in alts if a != '.'], qual, filt))

    pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int32)
    gt = np.concatenate(all_gt) if all_gt else np.zeros((0, n_samples), np.int32)
    miss = np.concatenate(all_miss) if all_miss else np.zeros((0, n_samples), bool)
    m = len(all_contigs)
    cidx = np.zeros(m, dtype=np.int32)
    keep = np.ones(m, dtype=bool)
    for i, c in enumerate(all_contigs):
        c2 = contig_recoding.get(c, c)
        if not rg.has_contig(c2):
            if skip_invalid_loci:
                keep[i] = False
                continue
            raise ValueError(f'invalid contig {c2!r} for {rg.name}')
        cidx[i] = rg.contig_index(c2)
    sel = np.where(keep)[0]
    m2 = len(sel)
    alleles_arr = np.empty(m2, dtype=object)
    rsid_arr = np.empty(m2, dtype=object)
    qual = np.zeros(m2, dtype=np.float64)
    qual_miss = np.zeros(m2, dtype=bool)
    filt_arr = np.empty(m2, dtype=object)
    for j, i in enumerate(sel):
        rsid_arr[j], alleles_arr[j], q, filt_arr[j] = all_meta[i]
        if q is None:
            qual_miss[j] = True
        else:
            qual[j] = q
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr),
                       rsid=ht.tstr, qual=ht.tfloat64, filters=ht.tset(ht.tstr))
    n_partitions = n_partitions or max(1, min(8, m2 // 65536 + 1))
    n_partitions = max(1, min(n_partitions, max(m2, 1)))
    bounds = np.linspace(0, m2, n_partitions + 1).astype(int)
    cidx2 = cidx[sel]
    pos2 = pos[sel]
    gt2 = gt[sel]
    miss2 = miss[sel]

    def pf(ctx):
        s_, e_ = ctx
        R = e_ - s_
        rows = Batch({
            'locus': LocusColumn(ht.tlocus(rg), cidx2[s_:e_], pos2[s_:e_]),
            'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles_arr[s_:e_]),
            'rsid': ObjectColumn(ht.tstr, rsid_arr[s_:e_]),
            'qual': PrimitiveColumn(ht.tfloat64, qual[s_:e_],
                                    qual_miss[s_:e_] if qual_miss[s_:e_].any() else None),
            'filters': ObjectColumn(ht.tset(ht.tstr), filt_arr[s_:e_]),
        }, R)
        mm = miss2[s_:e_]
        return MatrixBatch(rows, {'GT': PrimitiveColumn(
            ht.tcall, gt2[s_:e_], mm if mm.any() else None)})

    contexts = [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_partitions)]
    cols = Batch({'s': C.from_pylist(ht.tstr, samples)}, n_samples)
    g = Batch({}, 1)
    return MatrixTable(MatrixStage(g, cols, ['locus', 'alleles'], ['s'], row_t,
                                   ht.tstruct(s=ht.tstr), ht.tstruct(GT=ht.tcall),
                                   contexts, pf))
