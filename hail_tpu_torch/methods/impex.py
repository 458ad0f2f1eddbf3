"""Import/export: delimited tables, PLINK, GEN, BED, intervals, FAM, lines.

Capability parity with reference `hail/python/hail/methods/impex.py` (VCF
lives in hail_tpu/io/vcf.py; BGEN in hail_tpu/io/bgen.py).
"""

from __future__ import annotations

import gzip
import os
import re
import struct as _struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .. import types as ht
from ..expr import functions as F
from ..expr.expression import to_expr
from ..genetics.call import pack_diploid
from ..genetics.reference_genome import ReferenceGenome, default_reference
from ..ir import columns as C
from ..ir.columns import (Batch, DenseArrayColumn, LocusColumn, ObjectColumn,
                          PrimitiveColumn)
from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
from ..table import Table, TableStage
from ..utils.structs import Interval, Struct

# re-export the VCF entry points
from ..io.vcf import export_vcf as _export_vcf_io  # noqa: F401
from ..io.vcf import get_vcf_metadata, import_vcf  # noqa: F401
from ..utils.misc import warning  # noqa: F401
from ..io.bgen import export_bgen, import_bgen, index_bgen  # noqa: F401
from ..io.avro import import_avro  # noqa: F401


def _open(path: str):
    from ..fs import local_path
    path = local_path(path)
    if path.endswith('.gz') or path.endswith('.bgz'):
        return gzip.open(path, 'rt')
    return open(path, 'rt')


def _resolve_rg(reference_genome):
    if reference_genome is None:
        return None
    if reference_genome == 'default':
        return default_reference()
    if isinstance(reference_genome, str):
        return ReferenceGenome.get(reference_genome)
    return reference_genome


# ---------------------------------------------------------------------------
# text tables
# ---------------------------------------------------------------------------

def import_table(paths, key=None, min_partitions=None, impute: bool = False,
                 no_header: bool = False, comment=(), delimiter: str = '\t',
                 missing='NA', types: Optional[Dict[str, ht.HailType]] = None,
                 quote: Optional[str] = None, skip_blank_lines: bool = False,
                 force_bgz: bool = False, filter: Optional[str] = None,
                 find_replace=None, force: bool = False,
                 source_file_field: Optional[str] = None) -> Table:
    """Import delimited text (reference impex.import_table)."""
    paths = [paths] if isinstance(paths, str) else list(paths)
    types = {k: (ht.dtype(v) if isinstance(v, str) else v)
             for k, v in (types or {}).items()}
    missing_vals = {missing} if isinstance(missing, str) else set(missing)
    comment = [comment] if isinstance(comment, str) else list(comment)
    filter_re = re.compile(filter) if filter else None

    header: Optional[List[str]] = None
    rows: List[List[Optional[str]]] = []
    src_files: List[str] = []
    delim_re = re.compile(delimiter) if len(delimiter) > 1 else None

    def split_line(line: str) -> List[str]:
        if quote:
            out, cur, in_q = [], '', False
            i = 0
            while i < len(line):
                chh = line[i]
                if in_q:
                    if chh == quote:
                        in_q = False
                    else:
                        cur += chh
                elif chh == quote:
                    in_q = True
                elif (delim_re and delim_re.match(line, i)) or (not delim_re and chh == delimiter):
                    out.append(cur)
                    cur = ''
                else:
                    cur += chh
                i += 1
            out.append(cur)
            return out
        if delim_re:
            return delim_re.split(line)
        return line.split(delimiter)

    # single-char comment entries are literal prefixes; longer ones are
    # regexes matched at line start (reference import_table comment semantics)
    comment_pats = [(c if len(c) == 1 else re.compile(c)) for c in comment]

    def _is_comment(line):
        for c in comment_pats:
            if isinstance(c, str):
                if line.startswith(c):
                    return True
            elif c.match(line):
                return True
        return False

    for p in paths:
        with _open(p) as f:
            first = True
            for line in f:
                line = line.rstrip('\n')
                if _is_comment(line):
                    continue
                if skip_blank_lines and not line:
                    continue
                if filter_re and filter_re.search(line):
                    continue
                if find_replace:
                    # Java-style $N group references in the replacement
                    repl = re.sub(r'\$(\d+)', r'\\\1', find_replace[1])
                    line = re.sub(find_replace[0], repl, line)
                parts = split_line(line)
                if first and not no_header:
                    first = False
                    if header is None:
                        header = parts
                        continue
                    # later files: skip the first line only if it repeats
                    # the header (header_per_shard imports)
                    if parts == header:
                        continue
                rows.append([None if x in missing_vals or x == '' else x for x in parts])
                src_files.append(p)

    if header is None and not no_header:
        raise ValueError(
            'Invalid file: no lines remaining after filters\n Files provided: '
            + ', '.join(paths))
    if header is None:
        width = max((len(r) for r in rows), default=0)
        header = [f'f{i}' for i in range(width)]

    ncol = len(header)

    def _row_major_check(field_types):
        # errors surface in row-major order, as the reference's line parser
        from ..utils.misc import HailUserError
        for r in rows:
            if len(r) != ncol:
                plural = '' if len(r) == 1 else 's'
                raise HailUserError(
                    f'Expected {ncol} fields, found {len(r)} field{plural}')
            for i, name in enumerate(header):
                t = field_types.get(name)
                v = r[i]
                if v is None:
                    continue
                if t in (ht.tint32, ht.tint64):
                    try:
                        int(v)
                    except ValueError:
                        raise HailUserError(
                            f'cannot parse {t} from input string {v!r}')
                elif t in (ht.tfloat32, ht.tfloat64):
                    try:
                        float(v)
                    except ValueError:
                        raise HailUserError(
                            f'cannot parse {t} from input string {v!r}')

    col_strs: List[List[Optional[str]]] = [[] for _ in range(ncol)]
    for r in rows:
        for i in range(ncol):
            col_strs[i].append(r[i] if i < len(r) else None)
    if any(len(r) != ncol for r in rows):
        _row_major_check(types)

    def infer(vals: List[Optional[str]]) -> ht.HailType:
        nonnull = [v for v in vals if v is not None]
        if not nonnull:
            return ht.tstr
        def all_match(f):
            for v in nonnull:
                try:
                    f(v)
                except ValueError:
                    return False
            return True
        if all(v.lower() in ('true', 'false') for v in nonnull):
            return ht.tbool
        if all_match(int):
            mx = max(abs(int(v)) for v in nonnull)
            return ht.tint32 if mx < 2**31 else ht.tint64
        if all_match(float):
            return ht.tfloat64
        return ht.tstr

    field_types = {}
    for i, name in enumerate(header):
        if name in types:
            field_types[name] = ht.dtype(types[name])
        elif impute:
            field_types[name] = infer(col_strs[i])
        else:
            field_types[name] = ht.tstr

    def convert(vals, t):
        if t == ht.tstr:
            return C.from_pylist(t, vals)
        def cv(v):
            if v is None:
                return None
            if t == ht.tbool:
                return v.lower() == 'true'
            if t in (ht.tint32, ht.tint64):
                try:
                    return int(v)
                except ValueError:
                    from ..utils.misc import HailUserError
                    raise HailUserError(
                        f'cannot parse {t} from input string {v!r}')
            if t in (ht.tfloat32, ht.tfloat64):
                try:
                    return float(v)
                except ValueError:
                    from ..utils.misc import HailUserError
                    raise HailUserError(
                        f'cannot parse {t} from input string {v!r}')
            if isinstance(t, ht.tlocus):
                from ..genetics.locus import Locus
                return Locus.parse(v, t.reference_genome)
            if t == ht.tcall:
                from ..expr import functions as F
                return F.eval_expr(F.parse_call(v))
            if isinstance(t, ht.tinterval) and isinstance(t.point_type, ht.tlocus):
                from ..expr import functions as F
                return F.eval_expr(F.parse_locus_interval(
                    v, t.point_type.reference_genome))
            if isinstance(t, ht.tndarray):
                import json as _json
                try:
                    return np.asarray(_json.loads(v),
                                      dtype=t.element_type.numpy_dtype)
                except Exception:
                    return None
            if isinstance(t, (ht.tarray, ht.tset, ht.tdict, ht.tstruct, ht.ttuple)):
                import json as _json
                from ..expr.typefuncs import ExpressionException
                try:
                    parsed = _json.loads(v)
                except Exception:
                    return v
                return _conv_json_typed(parsed, t)
            return v
        return C.from_pylist(t, [cv(v) for v in vals])

    try:
        cols = {name: convert(col_strs[i], field_types[name]) for i, name in enumerate(header)}
    except Exception:
        _row_major_check(field_types)
        raise
    if source_file_field:
        cols[source_file_field] = C.from_pylist(ht.tstr, src_files)
        field_types[source_file_field] = ht.tstr
    row_t = ht.tstruct(**{k: field_types[k] for k in cols})
    b = Batch(cols, len(rows))
    if min_partitions and min_partitions > 1:
        # honor the requested minimum partitioning (reference TextTableReader
        # minPartitions) by slicing the in-memory batch
        k = int(min_partitions)
        n = b.length
        base, rem = divmod(n, k)
        sizes = [base + (1 if i < rem else 0) for i in range(k)]
        offs = np.cumsum([0] + sizes)
        batches = [b.slice(int(offs[i]), int(offs[i + 1])) for i in range(k)]
        t = Table(TableStage.from_batches(Batch({}, 1), [], row_t, batches))
    else:
        t = Table(TableStage.from_batches(Batch({}, 1), [], row_t, [b]))
    if key:
        key = [key] if isinstance(key, str) else list(key)
        t = t.key_by(*key)
    return t


def import_lines(paths, min_partitions=None, force_bgz: bool = False,
                 force: bool = False, file_per_partition: bool = False) -> Table:
    paths = [paths] if isinstance(paths, str) else list(paths)
    texts, files = [], []
    for p in paths:
        with _open(p) as f:
            for line in f:
                texts.append(line.rstrip('\n'))
                files.append(p)
    row_t = ht.tstruct(file=ht.tstr, text=ht.tstr)
    b = Batch({'file': C.from_pylist(ht.tstr, files),
               'text': C.from_pylist(ht.tstr, texts)}, len(texts))
    if file_per_partition:
        bs = []
        for p in paths:
            sel = np.asarray([f == p for f in files])
            bs.append(b.compress(sel))
        return Table(TableStage.from_batches(Batch({}, 1), [], row_t, bs))
    k = int(min_partitions or 1)
    if k > 1 and b.length:
        bounds = np.linspace(0, b.length, min(k, b.length) + 1).astype(int)
        bs = [b.slice(int(bounds[i]), int(bounds[i + 1]))
              for i in range(len(bounds) - 1)]
        return Table(TableStage.from_batches(Batch({}, 1), [], row_t, bs))
    return Table(TableStage.from_batches(Batch({}, 1), [], row_t, [b]))


def export_table(table: Table, output: str, types_file: Optional[str] = None,
                 header: bool = True, parallel=None, delimiter: str = '\t') -> None:
    """Table.export (reference table.py export); parallel modes write one
    shard per partition plus shard-manifest.txt."""
    from ..fs import local_path
    output = local_path(output)
    st = table._stage
    fields = list(st.row_type.fields)
    if parallel in ('separate_header', 'header_per_shard'):
        os.makedirs(output, exist_ok=True)
        shard_names = []
        if parallel == 'separate_header' and header:
            with open(os.path.join(output, 'header.tsv'), 'w') as f:
                f.write(delimiter.join(fields) + '\n')
            shard_names.append('header.tsv')
        for i, ctx in enumerate(st.contexts):
            b = st.partition_fn(ctx)
            name = f'part-{i:05d}.tsv'
            shard_names.append(name)
            lists = {k: b.columns[k].to_pylist() for k in fields}
            with open(os.path.join(output, name), 'w') as f:
                if header and parallel == 'header_per_shard':
                    f.write(delimiter.join(fields) + '\n')
                for r in range(b.length):
                    f.write(delimiter.join(_export_str(lists[k][r]) for k in fields) + '\n')
        with open(os.path.join(output, 'shard-manifest.txt'), 'w') as f:
            f.write('\n'.join(shard_names) + '\n')
        return
    batch = st.collect_single()
    opener = gzip.open if output.endswith('.gz') or output.endswith('.bgz') else open
    lists = {k: batch.columns[k].to_pylist() for k in fields}
    with opener(output, 'wt') as f:
        if header:
            f.write(delimiter.join(fields) + '\n')
        for i in range(batch.length):
            f.write(delimiter.join(_export_str(lists[k][i]) for k in fields) + '\n')
    if types_file:
        with open(types_file, 'w') as f:
            f.write(str(batch.row_type))


def _jsonable(v):
    """Hail-style JSON form of a value (dict with non-string keys becomes a
    list of {key, value} pairs; loci/calls render as their string forms)."""
    from ..genetics.locus import Locus as _Locus
    from ..genetics.call import Call as _Call
    from ..utils.structs import Interval as _Interval, frozendict as _fd
    if v is None:
        return None
    if isinstance(v, Struct):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (dict, _fd)) or (hasattr(v, 'items') and not isinstance(v, (Struct,))):
        items = list(v.items())
        if all(isinstance(k, str) for k, _ in items):
            return {k: _jsonable(x) for k, x in items}
        return [{'key': _jsonable(k), 'value': _jsonable(x)} for k, x in items]
    if isinstance(v, (set, frozenset)):
        import functools
        from ..expr.functions import _cmp_values
        return [_jsonable(x) for x in sorted(v, key=functools.cmp_to_key(_cmp_values))]
    from ..utils.structs import frozenlist as _fl
    if isinstance(v, (list, tuple, _fl)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (_Locus, _Call)):
        return str(v)
    if isinstance(v, _Interval):
        return _interval_str(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    return v


def _interval_str(v) -> str:
    lb = '[' if v.includes_start else '('
    rb = ']' if v.includes_end else ')'
    return f'{lb}{v.start}-{v.end}{rb}'


def _conv_json_typed(x, tt):
    """Typed reconstruction of _jsonable output (import side)."""
    from ..genetics.locus import Locus as _Locus
    from ..utils.structs import Interval as _Interval, freeze
    from ..expr import functions as F
    import builtins
    if x is None:
        return None
    if isinstance(tt, ht.tstruct):
        return Struct(**{k2: _conv_json_typed(x.get(k2), ft)
                         for k2, ft in tt.items()})
    if isinstance(tt, ht.ttuple):
        return builtins.tuple(_conv_json_typed(e2, et)
                              for e2, et in zip(x, tt.types))
    if isinstance(tt, ht.tarray):
        return [_conv_json_typed(e2, tt.element_type) for e2 in x]
    if isinstance(tt, ht.tset):
        return builtins.frozenset(freeze(_conv_json_typed(e2, tt.element_type))
                                  for e2 in x)
    if isinstance(tt, ht.tdict):
        if isinstance(x, dict):
            return {freeze(_conv_json_typed(k2, tt.key_type)):
                    _conv_json_typed(v2, tt.value_type) for k2, v2 in x.items()}
        return {freeze(_conv_json_typed(p['key'], tt.key_type)):
                _conv_json_typed(p['value'], tt.value_type) for p in x}
    if isinstance(tt, ht.tlocus):
        return _Locus.parse(x, tt.reference_genome) if isinstance(x, str) else             _Locus(x['contig'], int(x['position']), tt.reference_genome)
    if tt == ht.tcall:
        from ..expr.functions import _parse_call_str
        return _parse_call_str(x)
    if isinstance(tt, ht.tinterval):
        if isinstance(x, str):
            inc_s = x[0] == '['
            inc_e = x[-1] == ']'
            body = x[1:-1] if x[0] in '[(' else x
            a, b = body.rsplit('-', 1)
            pt = tt.point_type
            return _Interval(_conv_json_point(a, pt), _conv_json_point(b, pt),
                             inc_s, inc_e)
        return _Interval(_conv_json_typed(x['start'], tt.point_type),
                         _conv_json_typed(x['end'], tt.point_type),
                         bool(x.get('includeStart', True)),
                         bool(x.get('includeEnd', False)))
    if tt in (ht.tint32, ht.tint64):
        return int(x)
    if tt in (ht.tfloat32, ht.tfloat64):
        return float(x)
    return x


def _conv_json_point(sv, pt):
    from ..genetics.locus import Locus as _Locus
    if isinstance(pt, ht.tlocus):
        return _Locus.parse(sv, pt.reference_genome)
    if pt in (ht.tint32, ht.tint64):
        return int(sv)
    if pt in (ht.tfloat32, ht.tfloat64):
        return float(sv)
    return sv


def _export_str(v) -> str:
    import json as _json
    from ..utils.structs import Interval as _Interval, frozendict as _fd
    if v is None:
        return 'NA'
    if isinstance(v, np.ndarray):
        return _json.dumps(v.tolist())
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, float):
        return f'{v:.5e}' if (abs(v) >= 1e6 or (abs(v) < 1e-4 and v != 0)) else repr(v)
    if isinstance(v, _Interval):
        return _interval_str(v)
    if isinstance(v, (list, tuple, set, frozenset, dict, _fd, Struct)):
        return _json.dumps(_jsonable(v))
    return str(v)


# ---------------------------------------------------------------------------
# FAM / BED / intervals
# ---------------------------------------------------------------------------

def import_fam(path: str, quant_pheno: bool = False, delimiter: str = r'\\s+',
               missing: str = 'NA') -> Table:
    rows = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = re.split(delimiter.replace('\\\\', '\\'), line)
            fam, kid, dad, mom, sex, pheno = parts[:6]
            if quant_pheno:
                ph = None if pheno in (missing, '-9') else float(pheno)
            else:
                ph = {'1': False, '2': True}.get(pheno)
            rows.append(Struct(
                id=kid, fam_id=None if fam == '0' else fam,
                pat_id=None if dad == '0' else dad,
                mat_id=None if mom == '0' else mom,
                is_female={'1': False, '2': True}.get(sex),
                **({'quant_pheno': ph} if quant_pheno else {'is_case': ph})))
    row_t = ht.tstruct(id=ht.tstr, fam_id=ht.tstr, pat_id=ht.tstr, mat_id=ht.tstr,
                       is_female=ht.tbool,
                       **({'quant_pheno': ht.tfloat64} if quant_pheno else {'is_case': ht.tbool}))
    return Table(TableStage.from_batches(Batch({}, 1), ['id'], row_t,
                                         [Batch.from_pylist(row_t, rows)]))


def _interval_point(rg, contig, pos):
    from ..genetics.locus import Locus
    if rg is not None:
        return Locus(contig, pos, rg)
    return Struct(contig=contig, position=pos)


def _interval_valid(rg, contig, start, end, includes_end):
    if rg is None:
        return True
    if not rg.has_contig(contig):
        return False
    ln = rg.contig_length(contig)
    if not (1 <= start <= ln):
        return False
    hi = ln if includes_end else ln + 1
    if not (1 <= end <= hi):
        return False
    if (start, True) > (end, includes_end) and start > end:
        return False
    return start <= end


def import_locus_intervals(path: str, reference_genome='default',
                           skip_invalid_intervals: bool = False,
                           contig_recoding=None, **kwargs) -> Table:
    """UCSC interval_list import (reference impex.import_locus_intervals,
    impex.py:1124): 'contig:start-end' single-column, 3-column
    'contig start end', or 5-column Picard '... strand target' — closed
    intervals; extra kwargs flow to import_table (filter/find_replace)."""
    from ..utils.misc import FatalError
    rg = _resolve_rg(reference_genome)
    contig_recoding = contig_recoding or {}
    t = import_table(path, comment="@", impute=False, no_header=True,
                     types={'f0': ht.tstr, 'f1': ht.tint32, 'f2': ht.tint32,
                            'f3': ht.tstr, 'f4': ht.tstr}, **kwargs)
    nf = len(t.row.dtype)
    recs = t.collect()
    point_t = ht.tlocus(rg) if rg is not None else \
        ht.tstruct(contig=ht.tstr, position=ht.tint32)
    has_target = nf == 5
    if nf not in (1, 3, 5):
        raise FatalError("""invalid interval format.  Acceptable formats:
              'chr:start-end'
              'chr  start  end' (tab-separated)
              'chr  start  end  strand  target' (tab-separated, strand is '+' or '-')""")

    from ..expr.expression import eval_scalar
    interval_re = re.compile(r'([^:]*):(\d+)\-(\d+)')
    rows = []
    for r in recs:
        if nf == 1 and rg is not None:
            # 'chr:start-end' strings go through the full interval parser
            # (reference: hl.parse_locus_interval(f0, rg)), which also
            # understands exported bracket forms
            iv = eval_scalar(F.parse_locus_interval(
                r.f0, rg, invalid_missing=skip_invalid_intervals))
            if iv is None:
                continue
            rows.append(Struct(interval=iv))
            continue
        if nf == 1:
            m = interval_re.fullmatch(r.f0.strip()) if r.f0 is not None else None
            if m is None:
                if skip_invalid_intervals:
                    continue
                raise FatalError(f'invalid interval expression: {r.f0!r}')
            contig, start, end = m.group(1), int(m.group(2)), int(m.group(3))
        else:
            contig, start, end = r.f0, r.f1, r.f2
        contig = contig_recoding.get(contig, contig)
        if rg is not None:
            iv = eval_scalar(F.locus_interval(contig, start, end, True, True,
                                              rg, invalid_missing=skip_invalid_intervals))
            if iv is None:
                continue
        else:
            iv = Interval(_interval_point(rg, contig, start),
                          _interval_point(rg, contig, end), True, True)
        if has_target:
            rows.append(Struct(interval=iv, target=r.f4))
        else:
            rows.append(Struct(interval=iv))
    import functools
    from ..expr.functions import _cmp_values
    rows.sort(key=functools.cmp_to_key(
        lambda x, y: _cmp_values(x.interval, y.interval)))
    row_t = ht.tstruct(interval=ht.tinterval(point_t),
                       **({'target': ht.tstr} if has_target else {}))
    return Table(TableStage.from_batches(Batch({}, 1), ['interval'], row_t,
                                         [Batch.from_pylist(row_t, rows)]))


def import_bed(path: str, reference_genome='default',
               skip_invalid_intervals: bool = False, contig_recoding=None,
               **kwargs) -> Table:
    """UCSC BED import (reference impex.import_bed, impex.py:1195): 0-based
    half-open input → 1-based [start+1, end+1) intervals; a 4th column
    becomes `target`; browser/track/attribute lines are comments; extra
    kwargs flow to import_table (filter/find_replace)."""
    from ..utils.misc import FatalError
    rg = _resolve_rg(reference_genome)
    contig_recoding = contig_recoding or {}
    t = import_table(path, no_header=True, delimiter=r'\s+', impute=False,
                     skip_blank_lines=True,
                     types={'f0': ht.tstr, 'f1': ht.tint32, 'f2': ht.tint32,
                            'f3': ht.tstr, 'f4': ht.tstr},
                     comment=['^browser.*', '^track.*',
                              r'^\w+=("[\w\d ]+"|\d+).*'], **kwargs)
    nf = len(t.row.dtype)
    if nf < 3:
        raise FatalError(
            f'too few fields for BED file: expected 3 or more, but found {nf}')
    has_target = nf >= 4
    recs = t.collect()
    point_t = ht.tlocus(rg) if rg is not None else \
        ht.tstruct(contig=ht.tstr, position=ht.tint32)
    rows = []
    for r in recs:
        contig = contig_recoding.get(r.f0, r.f0)
        if r.f1 is None or r.f2 is None:
            if skip_invalid_intervals:
                continue
            raise FatalError(f'invalid BED line: {r}')
        start, end = r.f1 + 1, r.f2 + 1
        if rg is not None:
            from ..expr.expression import eval_scalar
            iv = eval_scalar(F.locus_interval(contig, start, end, True, False,
                                              rg, invalid_missing=skip_invalid_intervals))
            if iv is None:
                continue
        else:
            iv = Interval(_interval_point(rg, contig, start),
                          _interval_point(rg, contig, end), True, False)
        if has_target:
            rows.append(Struct(interval=iv, target=r.f3))
        else:
            rows.append(Struct(interval=iv))
    import functools
    from ..expr.functions import _cmp_values
    rows.sort(key=functools.cmp_to_key(
        lambda x, y: _cmp_values(x.interval, y.interval)))
    row_t = ht.tstruct(interval=ht.tinterval(point_t),
                       **({'target': ht.tstr} if has_target else {}))
    return Table(TableStage.from_batches(Batch({}, 1), ['interval'], row_t,
                                         [Batch.from_pylist(row_t, rows)]))


# ---------------------------------------------------------------------------
# PLINK
# ---------------------------------------------------------------------------

def import_plink(bed: str, bim: str, fam: str, min_partitions=None,
                 delimiter: str = r'\\s+', missing: str = 'NA',
                 quant_pheno: bool = False, a2_reference: bool = True,
                 reference_genome='default', contig_recoding=None,
                 skip_invalid_loci: bool = False,
                 n_partitions: Optional[int] = None, block_size=None) -> MatrixTable:
    """PLINK .bed/.bim/.fam import (reference impex.import_plink →
    `is/hail/io/plink/LoadPlink`): 2-bit genotype unpacking is a vectorized
    numpy bit op; PLINK's numeric sex-chromosome codes recode per reference
    genome by default."""
    from ..utils.misc import FatalError
    rg = _resolve_rg(reference_genome)
    if contig_recoding is None:
        if rg is None:
            contig_recoding = {}
        elif rg.name == 'GRCh37':
            contig_recoding = {'23': 'X', '24': 'Y', '25': 'X', '26': 'MT'}
        elif rg.name == 'GRCh38':
            contig_recoding = {
                **{str(i): f'chr{i}' for i in range(1, 23)},
                **{'23': 'chrX', '24': 'chrY', '25': 'chrX', '26': 'chrM'},
            }
        else:
            contig_recoding = {}
    # fam
    fam_t = import_fam(fam, quant_pheno=quant_pheno)
    samples = fam_t.collect()
    n = len(samples)
    if n == 0:
        raise FatalError(f'Empty FAM file: {fam}')
    # bim
    variants = []
    with _open(bim) as f:
        for line in f:
            if not line.strip():
                continue
            parts = re.split(r'\s+', line.strip())
            contig, vid, cm, pos, a1, a2 = parts[:6]
            variants.append((contig_recoding.get(contig, contig), int(pos),
                             vid, float(cm), a1, a2))
    m = len(variants)
    if m == 0:
        raise FatalError(f'BIM file does not contain any variants: {bim}')
    # bed: magic 0x6c 0x1b 0x01 then ceil(n/4) bytes per variant
    with open(bed, 'rb') as f:
        magic = f.read(3)
        if magic[:2] != b'\x6c\x1b':
            raise ValueError('bad PLINK .bed magic')
        if magic[2] != 1:
            raise ValueError('only SNP-major .bed supported')
        data = np.frombuffer(f.read(), dtype=np.uint8)
    bpv = (n + 3) // 4
    data = data[:m * bpv].reshape(m, bpv)
    # 2-bit codes per sample: 00 hom a1, 01 missing, 10 het, 11 hom a2
    shifts = np.arange(4, dtype=np.uint8) * 2
    codes = (data[:, :, None] >> shifts[None, None, :]) & 0b11
    codes = codes.reshape(m, bpv * 4)[:, :n]
    # with a2_reference (default): ref=a2 → hom a1 (00) = 2 alts
    miss = codes == 1
    n_alt = np.where(codes == 0, 2, np.where(codes == 2, 1, 0)).astype(np.int32)
    if not a2_reference:
        n_alt = np.where(miss, 0, 2 - n_alt)
    # unphased diploid calls order alleles ascending: het = 0/1
    j = (n_alt == 2).astype(np.int32)
    k = (n_alt >= 1).astype(np.int32)
    packed = pack_diploid(j, k)

    keep = np.ones(m, dtype=bool)
    cidx = np.zeros(m, dtype=np.int32)
    positions = np.zeros(m, dtype=np.int32)
    contigs = np.empty(m, dtype=object)
    alleles_arr = np.empty(m, dtype=object)
    rsids = np.empty(m, dtype=object)
    cms = np.zeros(m, dtype=np.float64)
    for i, (contig, pos, vid, cm, a1, a2) in enumerate(variants):
        if rg is not None and not (rg.has_contig(contig)
                                   and 0 < pos <= rg.contig_length(contig)):
            if skip_invalid_loci:
                keep[i] = False
                continue
            raise FatalError(f"Invalid locus '{contig}:{pos}' found")
        cidx[i] = rg.contig_index(contig) if rg else 0
        contigs[i] = contig
        positions[i] = pos
        alleles_arr[i] = [a2, a1] if a2_reference else [a1, a2]
        rsids[i] = vid
        cms[i] = cm
    sel = np.where(keep)[0]
    locus_t = ht.tlocus(rg) if rg is not None else \
        ht.tstruct(contig=ht.tstr, position=ht.tint32)
    row_t = ht.tstruct(locus=locus_t, alleles=ht.tarray(ht.tstr),
                       rsid=ht.tstr, cm_position=ht.tfloat64)
    mk = len(sel)
    if rg is not None:
        locus_col = LocusColumn(locus_t, cidx[sel], positions[sel])
        order = np.argsort(locus_col.global_position(), kind='stable')
    else:
        from ..ir.columns import StructColumn
        locus_col = StructColumn(locus_t, {
            'contig': ObjectColumn(ht.tstr, contigs[sel]),
            'position': PrimitiveColumn(ht.tint32, positions[sel]),
        }, None, (mk,))
        order = np.asarray(sorted(
            range(mk), key=lambda i: (contigs[sel][i], positions[sel][i])),
            dtype=np.int64)
    rows = Batch({
        'locus': locus_col,
        'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles_arr[sel]),
        'rsid': ObjectColumn(ht.tstr, rsids[sel]),
        'cm_position': PrimitiveColumn(ht.tfloat64, cms[sel]),
    }, mk)
    gt_col = PrimitiveColumn(ht.tcall, packed[sel], miss[sel] if miss[sel].any() else None)
    mb = MatrixBatch(rows, {'GT': gt_col}).gather_rows(order)

    ph_field = 'quant_pheno' if quant_pheno else 'is_case'
    col_t = ht.tstruct(s=ht.tstr, fam_id=ht.tstr, pat_id=ht.tstr, mat_id=ht.tstr,
                       is_female=ht.tbool,
                       **({ph_field: ht.tfloat64 if quant_pheno else ht.tbool}))
    col_rows = [Struct(s=r.id, fam_id=r.fam_id, pat_id=r.pat_id, mat_id=r.mat_id,
                       is_female=r.is_female, **{ph_field: r[ph_field]}) for r in samples]
    cols = Batch.from_pylist(col_t, col_rows)
    n_parts = max(1, min(n_partitions or min_partitions or 1, mk or 1))
    bounds = np.linspace(0, mk, n_parts + 1).astype(int)
    mbs = [mb.gather_rows(np.arange(bounds[i], bounds[i + 1]))
           for i in range(n_parts)]
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t, col_t,
        ht.tstruct(GT=ht.tcall), mbs))


def export_plink(dataset: MatrixTable, output: str, call=None, fam_id=None,
                 ind_id=None, pat_id=None, mat_id=None, is_female=None,
                 pheno=None, varid=None, cm_position=None) -> None:
    """Export to PLINK .bed/.bim/.fam (reference impex.export_plink →
    `is/hail/io/plink/ExportPlink`): A2 = ref allele; fam string fields
    reject embedded whitespace at call time, varid at write time."""
    from ..fs import local_path
    output = local_path(output)
    from ..expr.expression import to_expr as _to_expr
    from ..utils.misc import FatalError
    mt = dataset
    st = mt._stage
    skey = st.col_key[0]
    n = st.n_cols

    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)

    def col_strs(expr, default):
        if expr is None:
            return [default] * n
        e = _to_expr(expr)
        if e._indices.source is None:
            v = str(_eval_py(e))
            return [v] * n
        col = mt._eval_col_expr(e)
        return [default if v is None else str(v) for v in col.to_pylist()]

    def _eval_py(e):
        from ..expr.expression import eval_scalar
        return eval_scalar(e)

    fam_ids = col_strs(fam_id, '0')
    ind_ids = col_strs(ind_id if ind_id is not None else mt[skey], '0')
    pat_ids = col_strs(pat_id, '0')
    mat_ids = col_strs(mat_id, '0')
    for name, vals in (('fam_id', fam_ids), ('ind_id', ind_ids),
                       ('pat_id', pat_ids), ('mat_id', mat_ids)):
        bad = [v for v in vals if any(c.isspace() for c in v)]
        if bad:
            raise TypeError(
                f"parameter '{name}' has spaces in the following values: {bad}")

    def bool_strs(expr, missing_code, true_code='2', false_code='1'):
        if expr is None:
            return [missing_code] * n
        e = _to_expr(expr)
        if e._indices.source is None:
            v = _eval_py(e)
        else:
            col = mt._eval_col_expr(e)
            return [missing_code if v is None
                    else (true_code if v is True else false_code if v is False
                          else str(v)) for v in col.to_pylist()]
        if v is None:
            return [missing_code] * n
        if v is True:
            return [true_code] * n
        if v is False:
            return [false_code] * n
        return [str(v)] * n

    sexes = bool_strs(is_female, '0')
    phenos = bool_strs(pheno, 'NA')

    with open(output + '.fam', 'w') as f:
        for i in range(n):
            f.write(f'{fam_ids[i]}\t{ind_ids[i]}\t{pat_ids[i]}\t{mat_ids[i]}\t'
                    f'{sexes[i]}\t{phenos[i]}\n')

    bim_lines = []
    bed_chunks = [b'\x6c\x1b\x01']
    for i, ctx in enumerate(st.contexts):
        mb = st.partition_fn(ctx)
        if call is not None:
            env = mt._entry_env(mb, i)
            e = _to_expr(call)
            gt = e._ir.evaluate(env)
            if gt.shape != env.shape:
                gt = gt.broadcast_to(env.shape)
        else:
            gt = mb.entries['GT']
        if mb.entry_missing is not None:
            gt = gt.with_missing(mb.entry_missing)
        from ..genetics.call import calls_n_alt_alleles
        packed = np.asarray(gt.values)
        miss = gt.missing_mask()
        na = calls_n_alt_alleles(packed)
        # code: ref=a2 → 2 alt = 00, het = 10, 0 alt = 11, missing = 01
        codes = np.where(miss, 1, np.where(na == 2, 0, np.where(na == 1, 2, 3))).astype(np.uint8)
        if codes.shape[0] == 0:
            loci = []
            continue
        pad = (-codes.shape[1]) % 4
        if pad:
            codes = np.concatenate([codes, np.zeros((codes.shape[0], pad), np.uint8)], axis=1)
        codes = codes.reshape(codes.shape[0], -1, 4)
        byts = (codes[:, :, 0] | (codes[:, :, 1] << 2) | (codes[:, :, 2] << 4)
                | (codes[:, :, 3] << 6)).astype(np.uint8)
        bed_chunks.append(byts.tobytes())
        loci = mb.rows.columns['locus'].to_pylist()
        alleles = mb.rows.columns['alleles'].to_pylist()

        def row_strs(expr, default_fn):
            if expr is None:
                return [default_fn(r) for r in range(mb.n_rows)]
            e = _to_expr(expr)
            if e._indices.source is None:
                v = _eval_py(e)
                return [str(v)] * mb.n_rows
            col = mt._eval_row_expr(e, mb, i)
            return ['' if v is None else str(v) for v in col.to_pylist()]

        def _contig(l):
            return l.contig if hasattr(l, 'contig') else l['contig']

        def _posn(l):
            return l.position if hasattr(l, 'position') else l['position']

        vids = row_strs(varid, lambda r: f'{_contig(loci[r])}:{_posn(loci[r])}'
                                         f':{alleles[r][0]}:{alleles[r][1]}')
        cms = row_strs(cm_position, lambda r: '0.0')
        if cm_position is not None:
            cms = [str(float(v)) for v in cms]
        for r in range(mb.n_rows):
            l = loci[r]
            a = alleles[r]
            if any(c.isspace() for c in vids[r]):
                raise FatalError(f'no white space allowed: {vids[r]!r}')
            bim_lines.append(f'{_contig(l)}\t{vids[r]}\t{cms[r]}\t{_posn(l)}\t'
                             f'{a[1]}\t{a[0]}\n')
    with open(output + '.bim', 'w') as f:
        f.writelines(bim_lines)
    with open(output + '.bed', 'wb') as f:
        for chunk in bed_chunks:
            f.write(chunk)


# ---------------------------------------------------------------------------
# GEN
# ---------------------------------------------------------------------------

def import_gen(path: str, sample_file: str, tolerance: float = 0.2,
               min_partitions=None, chromosome: Optional[str] = None,
               reference_genome='default', contig_recoding=None,
               skip_invalid_loci: bool = False) -> MatrixTable:
    """Oxford GEN import (reference import_gen, impex.py:1355)."""
    from ..utils.misc import FatalError
    rg = _resolve_rg(reference_genome)
    contig_recoding = contig_recoding or {}
    samples = []
    with _open(sample_file) as f:
        lines = [l.strip() for l in f if l.strip()]
    for line in lines[2:]:
        samples.append(line.split()[0])
    n = len(samples)
    rows_meta = []
    gps = []
    with _open(path) as f:
        for line in f:
            parts = line.split()
            if chromosome is not None:
                contig, vid, rsid_, pos, a1, a2 = (chromosome, parts[0],
                                                   parts[1], parts[2],
                                                   parts[3], parts[4])
                probs = parts[5:]
            else:
                contig, vid, rsid_, pos, a1, a2 = parts[:6]
                probs = parts[6:]
            contig = contig_recoding.get(contig, contig)
            pos = int(pos)
            if rg is not None and not (
                    rg.has_contig(contig) and 0 < pos <= rg.contig_length(contig)):
                if skip_invalid_loci:
                    continue
                raise FatalError(f"Invalid locus '{contig}:{pos}' found")
            rows_meta.append((contig, pos, vid, rsid_, a1, a2))
            gps.append([float(x) for x in probs])
    # sorted by key (reference GEN rows land keyed by locus, alleles)
    if rg is not None:
        order = sorted(range(len(rows_meta)),
                       key=lambda i: (rg._global_offsets[rows_meta[i][0]]
                                      + rows_meta[i][1]))
    else:
        order = sorted(range(len(rows_meta)),
                       key=lambda i: (rows_meta[i][0], rows_meta[i][1]))
    rows_meta = [rows_meta[i] for i in order]
    gps = [gps[i] for i in order]
    m = len(rows_meta)
    gp = np.asarray(gps, dtype=np.float64).reshape(m, n, 3)
    tot = gp.sum(axis=2)
    miss = np.abs(tot - 1.0) > tolerance
    gpn = gp / np.maximum(tot[..., None], 1e-300)
    best = np.argmax(gpn, axis=2)
    # unphased diploid calls order alleles ascending: het = 0/1
    j = (best == 2).astype(np.int32)
    k = (best >= 1).astype(np.int32)
    packed = pack_diploid(j, k)
    locus_t = ht.tlocus(rg) if rg is not None else \
        ht.tstruct(contig=ht.tstr, position=ht.tint32)
    row_t = ht.tstruct(locus=locus_t, alleles=ht.tarray(ht.tstr),
                       rsid=ht.tstr, varid=ht.tstr)
    alleles_arr = np.empty(m, dtype=object)
    varids = np.empty(m, dtype=object)
    rsids = np.empty(m, dtype=object)
    cidx = np.zeros(m, np.int32)
    positions = np.zeros(m, np.int32)
    contigs = np.empty(m, dtype=object)
    for i, (contig, pos, vid, rsid_, a1, a2) in enumerate(rows_meta):
        if rg is not None:
            cidx[i] = rg.contig_index(contig)
        contigs[i] = contig
        positions[i] = pos
        alleles_arr[i] = [a1, a2]
        varids[i] = vid
        rsids[i] = rsid_
    if rg is not None:
        locus_col = LocusColumn(locus_t, cidx, positions)
    else:
        from ..ir.columns import StructColumn
        locus_col = StructColumn(locus_t, {
            'contig': ObjectColumn(ht.tstr, contigs),
            'position': PrimitiveColumn(ht.tint32, positions),
        }, None, (m,))
    rows = Batch({
        'locus': locus_col,
        'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles_arr),
        'rsid': ObjectColumn(ht.tstr, rsids),
        'varid': ObjectColumn(ht.tstr, varids),
    }, m)
    ents = {
        'GT': PrimitiveColumn(ht.tcall, packed, miss if miss.any() else None),
        'GP': DenseArrayColumn(ht.tarray(ht.tfloat64), gpn,
                               np.full((m, n), 3, np.int32), None,
                               miss if miss.any() else None),
    }
    cols = Batch({'s': C.from_pylist(ht.tstr, samples)}, n)
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t,
        ht.tstruct(s=ht.tstr), ht.tstruct(GT=ht.tcall, GP=ht.tarray(ht.tfloat64)),
        [MatrixBatch(rows, ents)]))


def export_gen(dataset: MatrixTable, output: str, precision: int = 4,
               gp=None, id1=None, id2=None, missing=None, varid=None,
               rsid=None) -> None:
    from ..fs import local_path
    output = local_path(output)
    """Oxford GEN export (reference impex.export_gen → ExportGen.scala)."""
    from ..expr.expression import to_expr as _to_expr
    mt = dataset
    st = mt._stage
    if gp is None:
        if 'GP' not in st.entry_type.fields or \
                st.entry_type['GP'] != ht.tarray(ht.tfloat64):
            raise ValueError(
                'exporting to GEN requires a GP (genotype probability) '
                'array<float64> field in the entry')
    miss_val = 0.0 if missing is None else float(missing)

    skey = st.col_key[0]

    def eval_col_str(expr):
        col = mt._eval_col_expr(_to_expr(expr))
        return [('' if v is None else str(v)) for v in col.to_pylist()]

    if id1 is not None:
        id1s = eval_col_str(id1)
    else:
        id1s = [str(r[skey]) for r in st.cols.to_pylist()]
    if id2 is not None:
        id2s = eval_col_str(id2)
    else:
        id2s = id1s
    n = len(id1s)
    with open(output + '.sample', 'w') as f:
        f.write('ID_1 ID_2 ID_3\n0 0 0\n')
        for a, b in zip(id1s, id2s):
            f.write(f'{a} {b} 0\n')
    fmt = f'{{:.{precision}f}}'
    with open(output + '.gen', 'w') as f:
        for ictx, ctx in enumerate(st.contexts):
            mb = st.partition_fn(ctx)
            loci = mb.rows.columns['locus'].to_pylist()
            alleles = mb.rows.columns['alleles'].to_pylist()
            R = mb.n_rows

            def row_strs(expr, field, default_fn):
                if expr is not None:
                    col = mt._eval_row_expr(_to_expr(expr), mb, ictx)
                    return [('' if v is None else str(v))
                            for v in col.to_pylist()]
                if field in mb.rows.columns:
                    return [('' if v is None else str(v))
                            for v in mb.rows.columns[field].to_pylist()]
                return [default_fn(r) for r in range(R)]

            vids = row_strs(varid, 'varid',
                            lambda r: f'{loci[r].contig}:{loci[r].position}:'
                                      f'{alleles[r][0]}:{alleles[r][1]}')
            rsids = row_strs(rsid, 'rsid', lambda r: '.')
            if gp is not None:
                env = mt._entry_env(mb, ictx)
                e = _to_expr(gp)
                gp_col = e._ir.evaluate(env)
                if gp_col.shape != env.shape:
                    gp_col = gp_col.broadcast_to(env.shape)
            else:
                gp_col = mb.entries.get('GP')
            if mb.entry_missing is not None:
                gp_col = gp_col.with_missing(mb.entry_missing)
            gp_miss = gp_col.missing_mask()
            gp_vals = getattr(gp_col, 'values', None)
            use_dense = gp_vals is not None and getattr(gp_vals, 'ndim', 0) == 3
            py = None if use_dense else gp_col.to_pylist()
            for r in range(R):
                l = loci[r]
                contig = l.contig if hasattr(l, 'contig') else l['contig']
                posn = l.position if hasattr(l, 'position') else l['position']
                a = alleles[r]
                out = [contig, vids[r], rsids[r], str(posn), a[0], a[1]]
                for ci in range(n):
                    if gp_miss[r, ci]:
                        vals = (miss_val, miss_val, miss_val)
                    elif use_dense:
                        vals = gp_vals[r, ci, :3]
                    else:
                        v = py[r][ci]
                        vals = (miss_val,) * 3 if v is None else tuple(v[:3])
                    out.extend(fmt.format(x) for x in vals)
                f.write(' '.join(out) + '\n')

def import_matrix_table(paths, row_fields=None, row_key=(), entry_type=ht.tint32,
                        missing: str = 'NA', min_partitions=None,
                        no_header: bool = False, force_bgz: bool = False,
                        sep: Optional[str] = None, comment=(),
                        delimiter: str = '\t') -> MatrixTable:
    """Import a dense text matrix (reference impex.import_matrix_table,
    impex.py:1830): row fields taken from the leading columns, entries from
    the rest; `row_id` int64 index added when `row_key` is empty; parse
    errors surface with the reference's messages."""
    from ..utils.misc import HailUserError
    delimiter = sep or delimiter
    paths = [paths] if isinstance(paths, str) else list(paths)
    row_fields = dict(row_fields or {})
    entry_type = ht.dtype(entry_type)
    comment = [comment] if isinstance(comment, str) else list(comment)

    def is_comment(line):
        return any(line.startswith(c) for c in comment)

    n_row_fields = len(row_fields)
    headers = []
    data_rows = []
    for p in paths:
        hdr = None
        with _open(p) as f:
            for line in f:
                line = line.rstrip('\n')
                if comment and is_comment(line):
                    continue
                if hdr is None and not no_header:
                    hdr = line.split(delimiter)
                    continue
                if line or no_header:
                    data_rows.append(line.split(delimiter))
        if not no_header:
            headers.append(hdr if hdr is not None else [])
    if headers:
        h0 = headers[0]
        for h in headers[1:]:
            if len(h) != len(h0):
                raise ValueError(
                    'invalid header: lengths of headers differ. '
                    f'{len(h0)} elements in first file, {len(h)} in another')
            if h != h0:
                raise ValueError(
                    'invalid header: expected elements to be identical for '
                    f'all input paths. {h0} != {h}')
        header = h0
    else:
        header = None

    rf_names = list(row_fields.keys())
    width = len(data_rows[0]) if data_rows else n_row_fields
    num_entries = max(width - n_row_fields, 0)
    if header is None:
        col_ids = list(range(num_entries))
    elif len(header) == num_entries:
        # header carries only the column ids (reference: row-field columns
        # may be unnamed in the header)
        col_ids = header
    else:
        col_ids = header[n_row_fields:]
    n = len(col_ids)
    m = len(data_rows)
    rf_types = {k: ht.dtype(v) for k, v in row_fields.items()}

    def type_name(t):
        return str(t)

    def parse_typed(v, t, err):
        if v == missing:
            return None
        try:
            if t in (ht.tint32, ht.tint64):
                return int(v)
            if t in (ht.tfloat32, ht.tfloat64):
                return float(v)
        except ValueError:
            raise HailUserError(err(v, t))
        return v

    rf_cols = {}
    for i, name in enumerate(rf_names):
        t = rf_types.get(name, ht.tstr)
        vals = []
        for r in data_rows:
            if i >= len(r):
                raise HailUserError(
                    'unexpected end of line while reading row fields')
            vals.append(parse_typed(
                r[i], t,
                lambda v, t: f"error parsing value into {type_name(t)} "
                             f"at row field {name!r}"))
        rf_cols[name] = C.from_pylist(t, vals)

    numeric_entries = entry_type.numpy_dtype is not None
    ent = np.zeros((m, n), dtype=entry_type.numpy_dtype) if numeric_entries \
        else np.empty((m, n), dtype=object)
    emiss = np.zeros((m, n), dtype=bool)
    for r, row in enumerate(data_rows):
        if len(row) < n_row_fields + n:
            raise HailUserError(
                'unexpected end of line while reading entries')
        for c in range(n):
            v = row[n_row_fields + c]
            if v == missing:
                emiss[r, c] = True
                continue
            cid = col_ids[c]
            err = (f"error parsing value into {type_name(entry_type)} "
                   f"at column id {cid!r}")
            try:
                if entry_type in (ht.tint32, ht.tint64):
                    ent[r, c] = int(v)
                elif entry_type in (ht.tfloat32, ht.tfloat64):
                    ent[r, c] = float(v)
                else:
                    ent[r, c] = v
            except ValueError:
                raise HailUserError(err)
    if isinstance(row_key, str):
        row_key = [row_key]
    row_key = list(row_key)
    add_row_id = not row_key
    if add_row_id:
        # the implicit int64 row index key (reference import_matrix_table)
        rf_cols['row_id'] = PrimitiveColumn(ht.tint64, np.arange(m, dtype=np.int64))
        row_t = ht.tstruct(row_id=ht.tint64, **{k: rf_cols[k].typ for k in rf_names})
        rows = Batch({'row_id': rf_cols['row_id'], **{k: rf_cols[k] for k in rf_names}}, m)
        row_key = ['row_id']
    else:
        row_t = ht.tstruct(**{k: rf_cols[k].typ for k in rf_names})
        rows = Batch({k: rf_cols[k] for k in rf_names}, m)
    if header is None:
        # headerless files number their columns (int32 col ids)
        col_col = C.from_pylist(ht.tint32, [int(c) for c in col_ids])
        col_t = ht.tstruct(col_id=ht.tint32)
    else:
        col_col = C.from_pylist(ht.tstr, col_ids)
        col_t = ht.tstruct(col_id=ht.tstr)
    cols = Batch({'col_id': col_col}, n)
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), cols, row_key, ['col_id'], row_t,
        col_t, ht.tstruct(x=entry_type),
        [MatrixBatch(rows, {'x': PrimitiveColumn(entry_type, ent,
                                                 emiss if emiss.any() else None)
                            if numeric_entries else
                            C.ObjectColumn(entry_type,
                                           np.where(emiss, None, ent))})]))

def grep(regex: str, path, max_count: int = 100, *, show: bool = True):
    paths = [path] if isinstance(path, str) else list(path)
    pat = re.compile(regex)
    out = {}
    for p in paths:
        matches = []
        with _open(p) as f:
            for line in f:
                if pat.search(line):
                    matches.append(line.rstrip('\n'))
                    if len(matches) >= max_count:
                        break
        if matches:
            out[p] = matches
    if show:
        for p, ms in out.items():
            for m_ in ms:
                print(f'{p}: {m_}')
        return None
    return out


def import_csv(paths, *, key=None, min_partitions=None, impute: bool = False,
               no_header: bool = False, comment=(), missing='NA', types=None,
               quote='"', skip_blank_lines: bool = False,
               force_bgz: bool = False, filter=None, find_replace=None,
               force: bool = False, source_file_field=None) -> Table:
    """Import a CSV file as a Table (reference impex.py:3392 import_csv —
    import_table with comma delimiter and RFC-4180 quoting)."""
    return import_table(paths, key=key, min_partitions=min_partitions,
                        impute=impute, no_header=no_header, comment=comment,
                        delimiter=',', missing=missing, types=types,
                        quote=quote, skip_blank_lines=skip_blank_lines,
                        force_bgz=force_bgz, filter=filter,
                        find_replace=find_replace, force=force,
                        source_file_field=source_file_field)


def get_vcf_header_info(path, filter=None, find=None, replace=None):
    """Parse a VCF header into a struct of infoFields/formatFields/
    filterAttrs/infoFlagFields/sampleIDs (reference impex.py:3252
    get_vcf_header_info / is/hail/io/vcf getVCFHeader)."""
    from ..io.vcf import parse_vcf_header
    from ..utils.structs import Struct
    h = parse_vcf_header(path)
    info_fields = [Struct(name=n, type=str(h.field_type('info', n)))
                   for n in h.infos]
    format_fields = [Struct(name=n, type=str(h.field_type('format', n)))
                     for n in h.formats]
    flag_fields = [n for n, (num, typ) in h.infos.items() if typ == 'Flag']
    filters = {f: {} for f in h.filters}
    return Struct(infoFields=info_fields,
                  formatFields=format_fields,
                  filtersAttrs=filters,
                  infoFlagFields=flag_fields,
                  sampleIDs=list(h.samples))


def import_gvcf_interval(path, file_num, contig, start, end,
                         header_info=None, call_fields=('PGT',),
                         entry_float_type='float64',
                         array_elements_required=True,
                         reference_genome='default', contig_recoding=None,
                         skip_invalid_loci=False, filter=None, find=None,
                         replace=None):
    """One interval of a GVCF as a Table of localized rows (reference
    impex.py:3091-3130 GVCFPartitionReader, which streams the same rows
    inside the combiner's lowered IR; here an eager Table with fields
    `entries` (one Struct per sample) and `file_num`).

    Only lines on `contig` with start <= POS < end are parsed (text-level
    prefilter with early stop on the position-sorted GVCF), plus the
    reference block immediately before `start` when its INFO END spans into
    the interval (the reference reader's spanning-block behavior)."""
    import re as _re
    import tempfile as _tempfile
    from ..io.vcf import _open_text, import_vcf
    contig = str(contig)
    recoded = (contig_recoding or {})
    end_re = _re.compile(r'(?:^|;)END=(\d+)')
    header_lines = []
    kept = []
    spanning = None  # last block before `start`, kept if END spans into it
    seen_contig = False
    with _open_text(path) as f:
        for line in f:
            if line.startswith('#'):
                header_lines.append(line)
                continue
            tab1 = line.index('\t')
            c = line[:tab1]
            c = recoded.get(c, c)
            if c != contig:
                if seen_contig:
                    break  # sorted: moved past the target contig
                continue
            seen_contig = True
            tab2 = line.index('\t', tab1 + 1)
            pos = int(line[tab1 + 1:tab2])
            if pos < start:
                m = end_re.search(line.split('\t', 8)[7])
                if m is not None and int(m.group(1)) >= start:
                    spanning = line
                else:
                    spanning = None
                continue
            if pos >= end:
                break
            kept.append(line)
    if spanning is not None:
        kept.insert(0, spanning)
    with _tempfile.NamedTemporaryFile('w', suffix='.vcf', delete=False) as tf:
        tf.writelines(header_lines)
        tf.writelines(kept)
        tmp = tf.name
    try:
        mt = import_vcf(tmp, call_fields=list(call_fields),
                        reference_genome=reference_genome,
                        contig_recoding=contig_recoding,
                        skip_invalid_loci=skip_invalid_loci,
                        filter=filter,
                        find_replace=(find, replace) if find is not None else None,
                        array_elements_required=array_elements_required)
        t = mt.localize_entries('entries', 'cols')
        return t.annotate(file_num=file_num)
    finally:
        os.unlink(tmp)


def export_elasticsearch(t, host, port, index, index_type, block_size,
                         config=None, verbose=True):
    """Reference impex.export_elasticsearch ships rows to an Elasticsearch
    cluster via the ES-Hadoop connector. No cluster or egress exists in this
    build."""
    raise NotImplementedError(
        'export_elasticsearch requires a reachable Elasticsearch cluster; '
        'this build has no network egress. Export with t.export(...) or '
        'to_pandas().to_json(...) and bulk-load externally.')

def export_vcf(dataset, output: str, append_to_header=None, parallel=None,
               metadata=None, *, tabix: bool = False) -> None:
    """Reference impex.export_vcf's python-level validation (gz warning,
    sites-only Tables, filters dtype check, invalid INFO names, ignored
    fields) before the writer (io/vcf.py)."""
    from ..table import Table as _Table
    _, ext = os.path.splitext(output)
    if ext == '.gz':
        warning(
            'VCF export with standard gzip compression requested. This is '
            'almost *never* desired and will cause issues with other tools '
            'that consume VCF files. The compression format used for VCF '
            'files is traditionally *block* gzip compression. To use block '
            'gzip compression with hail VCF export, use a path ending in '
            '`.bgz`.')
    if isinstance(dataset, _Table):
        mt = MatrixTable.from_rows_table(dataset)
        dataset = mt.key_cols_by(sample='').filter_cols(False)

    row_t = dataset._stage.row_type
    if 'filters' in row_t.fields and row_t['filters'] != ht.tset(ht.tstr):
        raise ValueError(
            f"'export_vcf': expect the 'filters' field to be set<str>, found "
            f"{row_t['filters']}\n  Either transform this field to set<str> "
            'to export as VCF FILTERS field, or drop it from the dataset.')

    info_fields = (list(row_t['info'].fields) if 'info' in row_t.fields
                   and isinstance(row_t['info'], ht.tstruct) else [])
    invalid_info_fields = [
        f for f in info_fields
        if not re.fullmatch(r"^([A-Za-z_][0-9A-Za-z_.]*|1000G)", f)]
    if invalid_info_fields:
        invalid_info_str = ''.join(f'\n    {f!r}' for f in invalid_info_fields)
        warning('export_vcf: the following info field names are invalid in '
                'VCF 4.3 and may not work with some tools: ' + invalid_info_str)

    row_fields_used = {'rsid', 'info', 'filters', 'qual'}
    key_fields = set(dataset._stage.row_key) | set(dataset._stage.col_key)
    fields_dropped = []
    for f in dataset._stage.globals_type.fields:
        fields_dropped.append((f, 'global'))
    for f in dataset._stage.col_type.fields:
        if f not in key_fields:
            fields_dropped.append((f, 'column'))
    for f in row_t.fields:
        if f not in row_fields_used and f not in key_fields:
            fields_dropped.append((f, 'row'))
    if fields_dropped:
        ignored_str = ''.join(f'\n    {f!r} ({axis})'
                              for f, axis in fields_dropped)
        warning('export_vcf: ignored the following fields:' + ignored_str)
        dataset = dataset.drop(*(f for f, _ in fields_dropped))

    _export_vcf_io(dataset, output, append_to_header=append_to_header,
                   parallel=parallel, metadata=metadata, tabix=tabix)

