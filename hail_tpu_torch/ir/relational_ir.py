"""Relational lineage nodes (reference `hail/ir/table_ir.py` node classes).

The engine executes through columnar TableStage pipelines rather than a
TableIR interpreter, but each relational operator still RECORDS which logical
node produced it. The lineage supports the reference's IR-introspection
surface (`t._tir.base_search(lambda x: isinstance(x, ir.TableMapRows))`) used
by tests and user tooling to check which operators a pipeline contains.
"""

from __future__ import annotations

from typing import List


class BaseIR:
    """A lineage node: operator tag + child lineages."""

    def __init__(self, *children: 'BaseIR'):
        self.children: List[BaseIR] = [c for c in children if c is not None]

    def base_search(self, f) -> List['BaseIR']:
        out = []
        if f(self):
            out.append(self)
        for c in self.children:
            out.extend(c.base_search(f))
        return out

    def search(self, f):
        return self.base_search(f)

    def __repr__(self):
        if not self.children:
            return type(self).__name__
        return f'{type(self).__name__}({", ".join(map(repr, self.children))})'


def _make(name):
    return type(name, (BaseIR,), {})


TableLiteral = _make('TableLiteral')
TableRange = _make('TableRange')
TableRead = _make('TableRead')
TableParallelize = _make('TableParallelize')
TableGen = _make('TableGen')
TableKeyBy = _make('TableKeyBy')
TableMapRows = _make('TableMapRows')
TableMapGlobals = _make('TableMapGlobals')
TableFilter = _make('TableFilter')
TableExplode = _make('TableExplode')
TableJoin = _make('TableJoin')
TableIntervalJoin = _make('TableIntervalJoin')
TableLeftJoinRightDistinct = _make('TableLeftJoinRightDistinct')
TableUnion = _make('TableUnion')
TableHead = _make('TableHead')
TableTail = _make('TableTail')
TableOrderBy = _make('TableOrderBy')
TableDistinct = _make('TableDistinct')
TableRepartition = _make('TableRepartition')
TableKeyByAndAggregate = _make('TableKeyByAndAggregate')
TableAggregateByKey = _make('TableAggregateByKey')
TableRename = _make('TableRename')
TableMultiWayZipJoin = _make('TableMultiWayZipJoin')
TableFilterIntervals = _make('TableFilterIntervals')
TableMapPartitions = _make('TableMapPartitions')
MatrixRowsTable = _make('MatrixRowsTable')
MatrixColsTable = _make('MatrixColsTable')
MatrixEntriesTable = _make('MatrixEntriesTable')
CastMatrixToTable = _make('CastMatrixToTable')
CastTableToMatrix = _make('CastTableToMatrix')
BlockMatrixToTable = _make('BlockMatrixToTable')
BlockMatrixToTableApply = _make('BlockMatrixToTableApply')

# matrix lineage nodes
MatrixRead = _make('MatrixRead')
MatrixLiteral = _make('MatrixLiteral')
MatrixRangeReader = _make('MatrixRangeReader')
MatrixMapRows = _make('MatrixMapRows')
MatrixMapCols = _make('MatrixMapCols')
MatrixMapEntries = _make('MatrixMapEntries')
MatrixMapGlobals = _make('MatrixMapGlobals')
MatrixFilterRows = _make('MatrixFilterRows')
MatrixFilterCols = _make('MatrixFilterCols')
MatrixFilterEntries = _make('MatrixFilterEntries')
MatrixKeyRowsBy = _make('MatrixKeyRowsBy')
MatrixExplodeRows = _make('MatrixExplodeRows')
MatrixExplodeCols = _make('MatrixExplodeCols')
MatrixAggregateRowsByKey = _make('MatrixAggregateRowsByKey')
MatrixAggregateColsByKey = _make('MatrixAggregateColsByKey')
MatrixUnionRows = _make('MatrixUnionRows')
MatrixUnionCols = _make('MatrixUnionCols')
MatrixDistinctByRow = _make('MatrixDistinctByRow')
MatrixRowsHead = _make('MatrixRowsHead')
MatrixColsHead = _make('MatrixColsHead')
MatrixRowsTail = _make('MatrixRowsTail')
MatrixColsTail = _make('MatrixColsTail')
MatrixRepartition = _make('MatrixRepartition')
MatrixChooseCols = _make('MatrixChooseCols')
MatrixCollectColsByKey = _make('MatrixCollectColsByKey')
MatrixAnnotateRowsTable = _make('MatrixAnnotateRowsTable')
MatrixAnnotateColsTable = _make('MatrixAnnotateColsTable')
MatrixToMatrixApply = _make('MatrixToMatrixApply')
MatrixRename = _make('MatrixRename')
MatrixFilterIntervals = _make('MatrixFilterIntervals')
TableToTableApply = _make('TableToTableApply')


class MatrixVCFReader(BaseIR):
    """Functional reader node (reference ir/matrix_reads MatrixVCFReader):
    holds the import parameters incl. `_partitions_json`; `MatrixTable(
    ir.MatrixRead(reader))` resolves it through io/vcf.import_vcf."""

    def __init__(self, path, call_fields=('PGT',), entry_float_type=None,
                 header_file=None, block_size=None, min_partitions=None,
                 reference_genome='default', contig_recoding=None,
                 array_elements_required=True, skip_invalid_loci=False,
                 force_bgz=False, force_gz=False, filter=None,
                 find_replace=None, n_partitions=None, _partitions_json=None,
                 _partitions_type=None):
        super().__init__()
        self.params = dict(
            path=path, call_fields=tuple(call_fields),
            entry_float_type=entry_float_type, header_file=header_file,
            block_size=block_size, min_partitions=min_partitions,
            reference_genome=reference_genome,
            contig_recoding=contig_recoding,
            array_elements_required=array_elements_required,
            skip_invalid_loci=skip_invalid_loci, force_bgz=force_bgz,
            filter=filter, find_replace=find_replace,
            n_partitions=n_partitions)
        self._partitions_json = _partitions_json
        self._partitions_type = _partitions_type

    def resolve(self):
        import json as _json
        from ..io.vcf import import_vcf
        params = dict(self.params)
        if params.get('entry_float_type') is None:
            from .. import types as _ht
            params['entry_float_type'] = _ht.tfloat64
        parts = None
        if self._partitions_json is not None:
            pt = self._partitions_type
            parts = pt._convert_from_json(_json.loads(self._partitions_json))
        return import_vcf(params.pop('path'), _partitions=parts, **params)
