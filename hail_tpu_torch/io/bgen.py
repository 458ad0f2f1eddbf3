"""BGEN v1.2 import/export.

Capability parity with reference `is/hail/io/bgen/` (`LoadBgen`,
`StagedBGENReader`'s codegen'd 8-bit probability unpacking, `IndexBgen`):
here the bit-unpack is a vectorized numpy reinterpretation producing dense
(R, N, 3) GP blocks — the same dense-tensor layout the device tier consumes.
Supports layout 2 (v1.2), zlib or uncompressed, unphased diploid, 8/16-bit
probabilities (the standard UK-Biobank shape).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as ht
from ..genetics.call import pack_diploid
from ..genetics.reference_genome import ReferenceGenome, default_reference
from ..ir import columns as C
from ..ir.columns import (Batch, DenseArrayColumn, LocusColumn, ObjectColumn,
                          PrimitiveColumn)
from ..utils.structs import Struct


def _read_header(f):
    offset = struct.unpack('<I', f.read(4))[0]
    lh = struct.unpack('<I', f.read(4))[0]
    m, n = struct.unpack('<II', f.read(8))
    magic = f.read(4)
    if magic not in (b'bgen', b'\x00\x00\x00\x00'):
        raise ValueError('bad BGEN magic')
    free = f.read(lh - 20)
    flags = struct.unpack('<I', f.read(4))[0]
    compression = flags & 0x3
    layout = (flags >> 2) & 0xF
    has_sample_ids = (flags >> 31) & 1
    return offset, m, n, compression, layout, has_sample_ids


def _read_samples(f, n):
    lsi, n2 = struct.unpack('<II', f.read(8))
    samples = []
    for _ in range(n2):
        ln = struct.unpack('<H', f.read(2))[0]
        samples.append(f.read(ln).decode())
    return samples


def _expand_bgen_paths(paths):
    """Directories (parallel-export shards) expand to their data files
    (reference LoadBgen path expansion)."""
    out = []
    for p in paths:
        if os.path.isdir(p) and not p.endswith('.idx2'):
            for e in sorted(os.listdir(p)):
                full = os.path.join(p, e)
                if (e.startswith('_') or e.startswith('.') or e.endswith('.idx')
                        or e.endswith('.idx2') or e == 'shard-manifest.txt'
                        or not os.path.isfile(full)):
                    continue
                out.append(full)
        else:
            out.append(p)
    return out


def import_bgen(path, entry_fields: Sequence[str] = ('GT', 'GP'),
                sample_file: Optional[str] = None, n_partitions: Optional[int] = None,
                block_size: Optional[int] = None, index_file_map: Optional[Dict] = None,
                variants=None, _row_fields: Sequence[str] = ('varid', 'rsid'),
                reference_genome='default', contig_recoding: Optional[Dict[str, str]] = None,
                skip_invalid_loci: bool = False):
    """Import BGEN v1.2 (reference impex.import_bgen → LoadBgen.scala).

    Requires a `.idx2` index per file (run :func:`index_bgen`); the index's
    stored attributes (reference genome, contig recoding, skip_invalid_loci)
    govern the import, exactly as the reference's. Rows decode lazily per
    partition via byte-offset seeks."""
    from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
    from ..utils.misc import FatalError
    paths = _expand_bgen_paths([path] if isinstance(path, str) else list(path))
    for ef in entry_fields:
        if ef not in ('GT', 'GP', 'dosage'):
            raise ValueError(f'unknown entry field {ef!r}')

    # ---- indexes (required) ----
    missing_idx = [p for p in paths
                   if _load_bgen_index(p, index_file_map) is None]
    if missing_idx:
        raise FatalError(
            "The following BGEN files have no .idx2 index file. Use "
            "'index_bgen' to create one: " + ', '.join(missing_idx))
    idxs = {p: _load_bgen_index(p, index_file_map) for p in paths}

    rg_names = {idxs[p].get('reference_genome', 'default') for p in paths}
    if len(rg_names) > 1:
        raise FatalError(
            'Found multiple reference genomes were specified in the BGEN '
            f'index files: {sorted(str(r) for r in rg_names)}')
    idx_rg = rg_names.pop()
    if reference_genome == 'default':
        rg = None if idx_rg is None else ReferenceGenome.get(
            'default' if idx_rg == 'default' else idx_rg)
    elif reference_genome is None:
        rg = None
    else:
        rg = (ReferenceGenome.get(reference_genome)
              if isinstance(reference_genome, str) else reference_genome)

    # ---- per-file variant records ----
    def sort_key(contig, pos):
        if rg is not None and rg.has_contig(contig):
            return (0, rg._global_offsets[contig] + pos)
        return (1, contig, pos)

    file_records = {}
    file_info = {}
    for p in paths:
        idx = idxs[p]
        with open(p, 'rb') as f:
            offset, m, n, compression, layout, has_ids = _read_header(f)
            if layout != 2:
                raise NotImplementedError(
                    f'BGEN layout {layout}; only v1.2 (layout 2) supported')
            if has_ids:
                fsamples = _read_samples(f, n)
            elif sample_file is not None:
                with open(sample_file) as sf:
                    lines = [l.strip() for l in sf if l.strip()]
                fsamples = [l.split()[0] for l in lines[2:]]
            else:
                fsamples = [str(i) for i in range(n)]
        file_info[p] = dict(n_samples=n, compression=compression,
                            samples=fsamples)
        recoding = dict(idx.get('contig_recoding') or {})
        if contig_recoding:
            recoding.update(contig_recoding)
        skip = bool(idx.get('skip_invalid_loci')) or skip_invalid_loci
        if 'variants' in idx:
            scan_vars = [tuple(v) for v in idx['variants']]
        else:
            scan_vars = _scan_variant_index(p)['variants']
        recs = []
        for (chrom, pos, varid, rsid, alleles, voff, goff, clen) in scan_vars:
            contig = recoding.get(chrom, chrom)
            if rg is not None and not _valid_locus(rg, contig, pos):
                if skip:
                    continue
                raise FatalError(f"Invalid locus '{contig}:{pos}' found")
            recs.append((contig, int(pos), varid, rsid, list(alleles),
                         int(goff), int(clen), p))
        recs.sort(key=lambda r: sort_key(r[0], r[1]))
        file_records[p] = recs

    # ---- disjointness across files (reference LoadBgen) ----
    spans = [(p, sort_key(r0[0], r0[1]), sort_key(r1[0], r1[1]))
             for p, (r0, *_mid, r1) in
             ((p, (fr[0], fr[-1])) for p, fr in file_records.items() if fr)]
    spans.sort(key=lambda s: s[1])
    for (p1, _lo1, hi1), (p2, lo2, _hi2) in zip(spans, spans[1:]):
        if lo2 <= hi1:
            raise FatalError(
                'Each BGEN file must contain a region of the genome disjoint '
                f'from other files. Found the following overlapping files: '
                f'{p1}, {p2}')
    records = []
    ordered = [s[0] for s in spans] + [p for p in paths if not file_records[p]]
    for p in ordered:
        records.extend(file_records[p])
    # stable row uids: the global (sorted) record index BEFORE any variant
    # filtering — rand draws are reproducible across n_partitions and
    # variants= subsets (reference test_randomness contract)
    records = [r + (i,) for i, r in enumerate(records)]

    samples = file_info[paths[0]]['samples']
    for p in paths[1:]:
        if file_info[p]['n_samples'] != len(samples):
            raise FatalError('BGEN files must all have the same sample count')

    # ---- variants= filtering (reference import_bgen variants arg forms) ----
    if variants is not None:
        keyset = _normalize_variant_filter(variants)
        records = [r for r in records
                   if (r[0], r[1], tuple(r[4])) in keyset[0]
                   or (r[0], r[1]) in keyset[1]]

    m_tot = len(records)
    n = len(samples)

    # ---- schema ----
    if rg is not None:
        locus_t = ht.tlocus(rg)
    else:
        locus_t = ht.tstruct(contig=ht.tstr, position=ht.tint32)
    row_t_fields = [('locus', locus_t), ('alleles', ht.tarray(ht.tstr))]
    if 'rsid' in _row_fields:
        row_t_fields.append(('rsid', ht.tstr))
    if 'varid' in _row_fields:
        row_t_fields.append(('varid', ht.tstr))
    row_t = ht.tstruct.from_fields(row_t_fields)
    ent_t = {}
    if 'GT' in entry_fields:
        ent_t['GT'] = ht.tcall
    if 'GP' in entry_fields:
        ent_t['GP'] = ht.tarray(ht.tfloat64)
    if 'dosage' in entry_fields:
        ent_t['dosage'] = ht.tfloat64

    n_parts = max(1, min(n_partitions or 1, max(m_tot, 1)))
    bounds = np.linspace(0, m_tot, n_parts + 1).astype(int)
    contexts = [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_parts)]

    def pf(ctx):
        s, e = ctx
        recs = records[s:e]
        R = len(recs)
        if rg is not None:
            locus_col = LocusColumn(
                locus_t,
                np.asarray([rg.contig_index(r[0]) for r in recs], np.int32),
                np.asarray([r[1] for r in recs], np.int32))
        else:
            from ..ir.columns import StructColumn
            locus_col = StructColumn(locus_t, {
                'contig': C.from_pylist(ht.tstr, [r[0] for r in recs]),
                'position': PrimitiveColumn(
                    ht.tint32, np.asarray([r[1] for r in recs], np.int32)),
            }, None, (R,))
        alleles_arr = np.empty(R, dtype=object)
        varids = np.empty(R, dtype=object)
        rsids = np.empty(R, dtype=object)
        for i, r in enumerate(recs):
            alleles_arr[i] = r[4]
            varids[i] = r[2]
            rsids[i] = r[3]
        uids = np.asarray([r[8] for r in recs], dtype=np.int64)
        row_cols = {'locus': locus_col,
                    'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles_arr)}
        if 'rsid' in _row_fields:
            row_cols['rsid'] = ObjectColumn(ht.tstr, rsids)
        if 'varid' in _row_fields:
            row_cols['varid'] = ObjectColumn(ht.tstr, varids)
        rows = Batch(row_cols, R)
        ents: Dict[str, C.Column] = {}
        if ent_t:
            GP = np.zeros((R, n, 3))
            MISS = np.zeros((R, n), dtype=bool)
            handles = {}
            try:
                for i, (contig, pos, varid, rsid, alleles, goff, clen, p,
                        _uid) in \
                        enumerate(recs):
                    f = handles.get(p)
                    if f is None:
                        f = handles[p] = open(p, 'rb')
                    f.seek(goff)
                    comp = file_info[p]['compression']
                    if comp == 1:
                        f.read(4)
                        raw = zlib.decompress(f.read(clen - 4))
                    elif comp == 2:
                        import zstandard
                        f.read(4)
                        raw = zstandard.ZstdDecompressor().decompress(
                            f.read(clen - 4))
                    else:
                        raw = f.read(clen)
                    gp, miss = _decode_probability_block(raw, n, len(alleles))
                    GP[i] = gp
                    MISS[i] = miss
            finally:
                for f in handles.values():
                    f.close()
            mm = MISS if MISS.any() else None
            if 'GT' in ent_t:
                best = np.argmax(GP, axis=2) if R else np.zeros((0, n), np.int64)
                # unphased diploid calls order alleles ascending: het = 0/1
                j = (best == 2).astype(np.int32)
                k2 = (best >= 1).astype(np.int32)
                ents['GT'] = PrimitiveColumn(ht.tcall, pack_diploid(j, k2), mm)
            if 'GP' in ent_t:
                ents['GP'] = DenseArrayColumn(
                    ht.tarray(ht.tfloat64), GP, np.full((R, n), 3, np.int32),
                    None, mm)
            if 'dosage' in ent_t:
                ents['dosage'] = PrimitiveColumn(
                    ht.tfloat64, GP[..., 1] + 2 * GP[..., 2], mm)
        return MatrixBatch(rows, ents, uids=uids)

    part_bounds = None
    if rg is not None and records:
        part_bounds = []
        for (s, e) in contexts:
            if e > s:
                lo = rg._global_offsets[records[s][0]] + records[s][1] - 1
                hi = rg._global_offsets[records[e - 1][0]] + records[e - 1][1] - 1
                part_bounds.append((lo, hi))
            else:
                part_bounds.append(None)
    cols = Batch({'s': C.from_pylist(ht.tstr, samples)}, n)
    return MatrixTable(MatrixStage(
        Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t,
        ht.tstruct(s=ht.tstr), ht.tstruct(**ent_t), contexts, pf, part_bounds))


def _valid_locus(rg, contig, pos):
    return rg.has_contig(contig) and 0 < pos <= rg.contig_length(contig)


def _normalize_variant_filter(variants):
    """→ (exact {(contig,pos,alleles)}, loci-only {(contig,pos)}) sets."""
    from ..table import Table as _Table
    from ..expr.expression import Expression as _Expr, eval_scalar
    from ..genetics.locus import Locus as _Locus
    if isinstance(variants, _Table):
        variants = [r for r in variants.select(*variants.key).collect()]
    elif isinstance(variants, _Expr):
        if variants._indices.source is not None and variants._indices.axes:
            variants = variants.collect()
        else:
            variants = eval_scalar(variants)
            if not isinstance(variants, list):
                variants = [variants]
    exact = set()
    loci = set()
    for v in variants:
        if isinstance(v, _Expr):
            v = eval_scalar(v)
        if isinstance(v, Struct):
            loc = v.get('locus') if hasattr(v, 'get') else v['locus']
            al = None
            try:
                al = v['alleles']
            except (KeyError, AttributeError):
                al = None
            if al is not None:
                exact.add((loc.contig, loc.position, tuple(al)))
            else:
                loci.add((loc.contig, loc.position))
        elif isinstance(v, _Locus):
            loci.add((v.contig, v.position))
        elif v is not None:
            s = str(v)
            c, p = s.rsplit(':', 1)
            loci.add((c, int(p)))
    return exact, loci


def _decode_probability_block(raw: bytes, n: int, k: int):
    """Decode a layout-2 genotype block → ((n, 3) GP float64, (n,) missing)."""
    n2 = struct.unpack('<I', raw[0:4])[0]
    k2 = struct.unpack('<H', raw[4:6])[0]
    pmin, pmax = raw[6], raw[7]
    ploidy_bytes = np.frombuffer(raw[8:8 + n], dtype=np.uint8)
    missing = (ploidy_bytes & 0x80) != 0
    phased = raw[8 + n]
    bits = raw[9 + n]
    body = np.frombuffer(raw[10 + n:], dtype=np.uint8)
    if k2 != 2 or pmin != 2 or pmax != 2:
        raise NotImplementedError('only diploid biallelic BGEN v1.2 supported')
    n_probs = 2  # stored probs per sample for unphased diploid biallelic
    if phased:
        n_probs = 2  # per haplotype 1 stored prob → 2 total
    if bits == 8:
        vals = body[:n * n_probs].reshape(n, n_probs).astype(np.float64) / 255.0
    elif bits == 16:
        vals = np.frombuffer(body.tobytes()[:n * n_probs * 2], dtype='<u2').reshape(
            n, n_probs).astype(np.float64) / 65535.0
    elif bits == 32:
        vals = np.frombuffer(body.tobytes()[:n * n_probs * 4], dtype='<u4').reshape(
            n, n_probs).astype(np.float64) / 4294967295.0
    else:
        # generic bit widths: unpack via bit arithmetic
        total_bits = n * n_probs * bits
        bitarr = np.unpackbits(body, bitorder='little')[:total_bits].reshape(n * n_probs, bits)
        weights = (1 << np.arange(bits, dtype=np.uint64))
        ints = (bitarr.astype(np.uint64) * weights).sum(axis=1)
        vals = (ints / float((1 << bits) - 1)).reshape(n, n_probs)
    if phased:
        # P(hap1=alt), P(hap2=alt) → unphased GP
        a1 = vals[:, 0]
        a2 = vals[:, 1]
        gp = np.stack([(1 - a1) * (1 - a2), a1 * (1 - a2) + (1 - a1) * a2, a1 * a2], axis=1)
    else:
        p0 = vals[:, 0]
        p1 = vals[:, 1]
        gp = np.stack([p0, p1, np.clip(1.0 - p0 - p1, 0, 1)], axis=1)
    gp[missing] = 0.0
    return gp, missing


def _scan_variant_index(p: str):
    """One pass over a BGEN file collecting per-variant metadata + byte
    offsets of each variant block (the seek index; reference
    `io/bgen/IndexBgen.scala` builds the same mapping into a B-tree)."""
    metas = []
    with open(p, 'rb') as f:
        offset, m, n, compression, layout, has_ids = _read_header(f)
        if has_ids:
            _read_samples(f, n)
        f.seek(offset + 4)
        for _ in range(m):
            voff = f.tell()
            ln = struct.unpack('<H', f.read(2))[0]
            varid = f.read(ln).decode()
            ln = struct.unpack('<H', f.read(2))[0]
            rsid = f.read(ln).decode()
            ln = struct.unpack('<H', f.read(2))[0]
            chrom = f.read(ln).decode()
            pos = struct.unpack('<I', f.read(4))[0]
            k = struct.unpack('<H', f.read(2))[0]
            alleles = []
            for _ in range(k):
                ln = struct.unpack('<I', f.read(4))[0]
                alleles.append(f.read(ln).decode())
            clen = struct.unpack('<I', f.read(4))[0]
            goff = f.tell()
            f.seek(clen, 1)
            metas.append((chrom, pos, varid, rsid, alleles, voff, goff, clen))
    return dict(n_variants=m, n_samples=n, layout=layout,
                compression=compression, variants=metas)


_IDX2_META = 'metadata.json'


def index_bgen(path, index_file_map=None, reference_genome='default',
               contig_recoding=None, skip_invalid_loci: bool = False) -> None:
    """Write a `.idx2` index DIRECTORY with per-variant byte offsets plus the
    index-time attributes (reference genome, contig recoding,
    skip_invalid_loci) that govern later imports — reference
    `IndexBgen.scala` stores the same attributes in its B-tree metadata;
    a sorted JSON array plays the B-tree's role here.

    An existing index (including a reference-format `.idx2` dir) is
    replaced. If the default location beside the input is not writable, pass
    `index_file_map={bgen_path: writable_idx2_path}`."""
    import shutil
    from ..utils.misc import FatalError
    paths = _expand_bgen_paths([path] if isinstance(path, str) else list(path))
    for idx_path in (index_file_map or {}).values():
        if not idx_path.endswith('.idx2'):
            raise FatalError(
                f'BGEN index file paths must end in .idx2: {idx_path!r} is '
                'missing a .idx2 file extension')
    if reference_genome is None:
        rg = None
        rg_name = None
    elif isinstance(reference_genome, str):
        rg = ReferenceGenome.get(reference_genome)
        rg_name = rg.name
    else:
        rg = reference_genome
        rg_name = rg.name
    recoding = contig_recoding or {}
    for p in paths:
        idx_path = (index_file_map or {}).get(p, p + '.idx2')
        scan = _scan_variant_index(p)
        kept = []
        for (chrom, pos, varid, rsid, alleles, voff, goff, clen) in scan['variants']:
            contig = recoding.get(chrom, chrom)
            if rg is not None and not _valid_locus(rg, contig, pos):
                if skip_invalid_loci:
                    continue
                raise FatalError(f"Invalid locus '{contig}:{pos}' found")
            kept.append((chrom, pos, varid, rsid, alleles, voff, goff, clen))
        try:
            if os.path.exists(idx_path):
                if os.path.isdir(idx_path):
                    shutil.rmtree(idx_path)
                else:
                    os.unlink(idx_path)
            os.makedirs(idx_path)
            with open(os.path.join(idx_path, _IDX2_META), 'w') as f:
                json.dump({'path': p, 'n_variants': len(kept),
                           'n_samples': scan['n_samples'],
                           'layout': scan['layout'],
                           'compression': scan['compression'],
                           'contig_recoding': recoding,
                           'reference_genome': rg_name,
                           'skip_invalid_loci': bool(skip_invalid_loci),
                           'variants': [list(v) for v in kept]}, f)
        except (PermissionError, OSError) as e:
            raise OSError(
                f'cannot write BGEN index at {idx_path!r} ({e}); pass '
                f'index_file_map={{{p!r}: <writable .idx2 path>}}') from e


def _load_bgen_index(p: str, index_file_map=None):
    """Load a .idx2 for `p`: our JSON format (full seek index) or the
    reference's binary B-tree format (attributes + key count only — variant
    offsets then come from a linear scan). None when absent/unparseable."""
    idx_path = (index_file_map or {}).get(p, p + '.idx2')
    meta_file = os.path.join(idx_path, _IDX2_META)
    if os.path.isfile(meta_file):
        try:
            with open(meta_file) as f:
                meta = json.load(f)
            if 'variants' in meta:
                meta['variants'] = [tuple(v) for v in meta['variants']]
                return meta
        except (json.JSONDecodeError, OSError, KeyError):
            return None
    ref_meta = os.path.join(idx_path, 'metadata.json.gz')
    if os.path.isfile(ref_meta):
        try:
            import gzip as _gzip
            with _gzip.open(ref_meta) as f:
                meta = json.load(f)
            attrs = meta.get('attributes', {})
            return {'n_variants': meta.get('nKeys'),
                    'contig_recoding': attrs.get('contig_recoding') or {},
                    'reference_genome': attrs.get('reference_genome', 'default'),
                    'skip_invalid_loci': bool(attrs.get('skip_invalid_loci'))}
        except (json.JSONDecodeError, OSError, KeyError):
            return None
    return None


def export_bgen(mt, output: str, gp=None, varid=None, rsid=None,
                parallel=None, compression_codec: str = 'zlib') -> None:
    """Export BGEN v1.2, 8-bit probabilities + SAMPLE file (reference
    impex.export_bgen → MatrixBGENWriter). `parallel='header_per_shard'`
    writes a directory of per-partition BGEN files + shard-manifest.txt."""
    from ..fs import local_path
    output = local_path(output)
    from ..expr.expression import Expression
    st = mt._stage
    if gp is None:
        if 'GP' not in st.entry_type.fields or \
                st.entry_type['GP'] != ht.tarray(ht.tfloat64):
            raise ValueError(
                'exporting to BGEN requires a GP (genotype probability) '
                'array<float64> field in the entry')
    if compression_codec not in ('zlib', 'zstd'):
        raise ValueError(f'unknown compression codec {compression_codec!r}')
    comp_flag = 1 if compression_codec == 'zlib' else 2
    if comp_flag == 2:
        import zstandard
        compressor = zstandard.ZstdCompressor().compress
    else:
        compressor = zlib.compress

    skey = st.col_key[0]
    samples = [str(r[skey]) for r in st.cols.to_pylist()]
    n = len(samples)

    outdir = os.path.dirname(os.path.abspath(output))
    os.makedirs(outdir, exist_ok=True)
    with open(output + '.sample', 'w') as f:
        f.write('ID_1 ID_2 missing\n0 0 0\n')
        for s in samples:
            f.write(f'{s} {s} 0\n')

    from ..expr.expression import to_expr as to_expr_f

    def eval_row_str(expr, mb, i):
        col = mt._eval_row_expr(to_expr_f(expr), mb, i)
        return [('' if v is None else str(v)) for v in col.to_pylist()]

    def write_partition(f, mb, i, m_written):
        loci = mb.rows.columns['locus'].to_pylist()
        alleles = mb.rows.columns['alleles'].to_pylist()

        def default_varid(mb):
            return [f'{l.contig}:{l.position}:{a[0]}:{a[1]}'
                    for l, a in zip(loci, alleles)]

        if varid is not None:
            vids = eval_row_str(varid, mb, i)
        elif 'varid' in mb.rows.columns:
            vids = [('' if v is None else str(v))
                    for v in mb.rows.columns['varid'].to_pylist()]
        else:
            vids = default_varid(mb)
        if rsid is not None:
            rsids = eval_row_str(rsid, mb, i)
        elif 'rsid' in mb.rows.columns:
            rsids = [('' if v is None else str(v))
                     for v in mb.rows.columns['rsid'].to_pylist()]
        else:
            rsids = ['.'] * mb.n_rows

        if gp is not None:
            env = mt._entry_env(mb, i)
            e = to_expr_f(gp)
            gp_col = e._ir.evaluate(env)
            if gp_col.shape != env.shape:
                gp_col = gp_col.broadcast_to(env.shape)
        else:
            gp_col = mb.entries.get('GP')
        if mb.entry_missing is not None:
            gp_col = gp_col.with_missing(mb.entry_missing)
        gp_vals = getattr(gp_col, 'values', None)
        gp_miss = gp_col.missing_mask()

        for r in range(mb.n_rows):
            l = loci[r]
            a = alleles[r]
            vid = vids[r].encode()
            rid = rsids[r].encode()
            f.write(struct.pack('<H', len(vid)) + vid)
            f.write(struct.pack('<H', len(rid)) + rid)
            cb = l.contig.encode()
            f.write(struct.pack('<H', len(cb)) + cb)
            f.write(struct.pack('<I', l.position))
            f.write(struct.pack('<H', len(a)))
            for al in a:
                ab = al.encode()
                f.write(struct.pack('<I', len(ab)) + ab)
            if gp_vals is not None and getattr(gp_vals, 'ndim', 0) == 3:
                gpv = np.clip(np.nan_to_num(gp_vals[r]), 0, 1)
            else:
                row_lists = gp_col.to_pylist()[r] if gp_vals is None else None
                gpv = np.zeros((n, 3))
                if row_lists is not None:
                    for ci, v in enumerate(row_lists):
                        if v is not None:
                            gpv[ci, :len(v)] = v[:3]
            miss = gp_miss[r]
            probs8 = np.round(gpv[:, :2] * 255).astype(np.uint8)
            probs8[miss] = 0
            ploidy = np.full(n, 2, np.uint8) | (miss.astype(np.uint8) << 7)
            block = (struct.pack('<IHBB', n, 2, 2, 2) + ploidy.tobytes()
                     + bytes([0, 8]) + probs8.tobytes())
            comp = compressor(block)
            f.write(struct.pack('<I', len(comp) + 4))
            f.write(struct.pack('<I', len(block)))
            f.write(comp)
        return mb.n_rows

    def write_header(f, m):
        sample_block = b''.join(struct.pack('<H', len(s)) + s.encode()
                                for s in samples)
        si_len = 8 + len(sample_block)
        header = struct.pack('<II', m, n) + b'bgen' \
            + struct.pack('<I', comp_flag | (2 << 2) | (1 << 31))
        lh = 20
        f.write(struct.pack('<I', lh + si_len))
        f.write(struct.pack('<I', lh))
        f.write(header)
        f.write(struct.pack('<II', si_len, n))
        f.write(sample_block)

    if parallel in ('header_per_shard', 'separate_header'):
        shard_dir = output + '.bgen'
        os.makedirs(shard_dir, exist_ok=True)
        names = []
        for i, ctx in enumerate(st.contexts):
            mb = st.partition_fn(ctx)
            name = f'part-{i:05d}'
            with open(os.path.join(shard_dir, name), 'wb') as f:
                write_header(f, mb.n_rows)
                write_partition(f, mb, i, 0)
            names.append(name)
        with open(os.path.join(shard_dir, 'shard-manifest.txt'), 'w') as f:
            f.write('\n'.join(names) + '\n')
        with open(os.path.join(shard_dir, '_SUCCESS'), 'w'):
            pass
        return

    m = mt.count_rows()
    with open(output + '.bgen', 'wb') as f:
        write_header(f, m)
        for i, ctx in enumerate(st.contexts):
            mb = st.partition_fn(ctx)
            write_partition(f, mb, i, 0)
