"""External JSON annotators: VEP and Nirvana subprocess drivers.

Capability parity with reference `hail/python/hail/methods/qc.py` `hl.vep` /
`hl.nirvana` (`is/hail/methods/{VEP,Nirvana}.scala`): variants are streamed
to a configured command as VCF lines; the tool's JSON output is joined back
as a row annotation. The binaries are not present in this build — the
drivers gate with a clear error unless a config points at an executable.
"""

from __future__ import annotations

import json as _json
import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

from .. import types as ht
from ..ir import columns as C
from ..ir.columns import Batch, ObjectColumn
from ..matrixtable import MatrixBatch, MatrixTable
from ..table import Table
from ..utils.structs import Struct


def _variant_lines(ds) -> List[str]:
    rows = ds.rows() if isinstance(ds, MatrixTable) else ds
    out = []
    for r in rows.collect():
        loc = r.locus
        als = r.alleles
        out.append(f'{loc.contig}\t{loc.position}\t.\t{als[0]}\t{",".join(als[1:])}\t.\t.\t.')
    return out


def _run_annotator(name: str, ds, config, command_key: str,
                   output_field: str, csq: bool = False):
    if config is None:
        config = os.environ.get(f'HAIL_TPU_{name.upper()}_CONFIG')
    if config is None:
        raise ValueError(
            f'hl.{name} requires a configuration: pass config=<json path> with '
            f'{{"command": [...]}}, or set HAIL_TPU_{name.upper()}_CONFIG. '
            f'The {name} binary is not bundled with this build.')
    with open(config) as f:
        cfg = _json.load(f)
    command = cfg.get(command_key) or cfg.get('command')
    if not command:
        raise ValueError(f'{name} config {config} lacks a "command" entry')
    exe = command[0]
    if shutil.which(exe) is None and not os.path.exists(exe):
        raise ValueError(f'{name} executable {exe!r} not found')
    lines = _variant_lines(ds)
    proc = subprocess.run(command, input='\n'.join(lines), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'{name} failed (exit {proc.returncode}): '
                           f'{proc.stderr[-2000:]}')
    results = [(_json.loads(l) if l.strip() else None)
               for l in proc.stdout.splitlines()]
    while len(results) < len(lines):
        results.append(None)
    ann = C.obj_array([None if r is None else _to_struct(r) for r in results])
    if isinstance(ds, MatrixTable):
        st = ds._stage
        off = [0]
        def f(mb: MatrixBatch, i: int) -> MatrixBatch:
            o = off[0]
            col = ObjectColumn(ht.tstr, ann[o:o + mb.n_rows])
            off[0] += mb.n_rows
            return MatrixBatch(mb.rows.annotate(**{output_field: col}), mb.entries)
        # materialize sequentially to keep offsets aligned
        batches = []
        o = 0
        for ctx in st.contexts:
            mb = st.partition_fn(ctx)
            col = ObjectColumn(ht.tstr, ann[o:o + mb.n_rows])
            o += mb.n_rows
            batches.append(MatrixBatch(mb.rows.annotate(**{output_field: col}),
                                       mb.entries))
        from ..matrixtable import MatrixStage
        return MatrixTable(MatrixStage.from_batches(
            st.globals, st.cols, st.row_key, st.col_key,
            st.row_type._insert_field(output_field, ht.tstr), st.col_type,
            st.entry_type, batches))
    else:
        b = ds._stage.collect_single()
        col = ObjectColumn(ht.tstr, ann[:b.length])
        from ..table import TableStage
        nb = b.annotate(**{output_field: col})
        return Table(TableStage.from_batches(ds._stage.globals, ds._stage.key,
                                             nb.row_type, [nb]))


def _to_struct(v):
    if isinstance(v, dict):
        return _json.dumps(v)
    return _json.dumps(v)


def vep(dataset, config: Optional[str] = None, block_size: int = 1000,
        name: str = 'vep', csq: bool = False, tolerate_parse_error: bool = False):
    """Annotate variants with Ensembl VEP (reference hl.vep). Requires a
    config JSON with the vep command; output stored as a JSON string field."""
    return _run_annotator('vep', dataset, config, 'command', name, csq)


def nirvana(dataset, config: Optional[str] = None, block_size: int = 500,
            name: str = 'nirvana'):
    """Annotate variants with Illumina Nirvana (reference hl.nirvana)."""
    return _run_annotator('nirvana', dataset, config, 'command', name)
