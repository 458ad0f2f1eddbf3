from . import columns, nodes, arrays, agg
from .nodes import (IR, AggOp, Apply, ApplyBinaryOp, ApplyUnaryOp, ArrayRef,
                    Cast, Coalesce, GetField, GetTupleElement, If, IsMissing,
                    Literal, MakeArray, MakeStruct, MakeTuple, NA, Ref,
                    StreamAgg, StreamAggScan, StreamFlatMap, StreamIota,
                    StreamZip, TableGetGlobals, ToArray, ToStream)
from .arrays import (ArrayFilter, ArrayFold, ArrayMap, ArrayScan)

# reference IR node-name spellings for the stream tier (our evaluator keeps
# streams as arrays; these names let reference-suite introspection
# recognize the tree — test_expr.py test_stream_randomness)
StreamFilter = ArrayFilter
StreamFold = ArrayFold
StreamScan = ArrayScan
StreamMap = ArrayMap
AggExplode = AggOp
from .relational_ir import *  # noqa: F401,F403 — lineage node classes
from . import relational_ir as _rir

__all__ = ['columns', 'nodes', 'arrays', 'agg', 'IR', 'AggOp', 'Apply',
           'ApplyBinaryOp', 'ApplyUnaryOp', 'ArrayRef', 'Cast', 'Coalesce',
           'GetField', 'GetTupleElement', 'If', 'IsMissing', 'Literal',
           'MakeArray', 'MakeStruct', 'MakeTuple', 'NA', 'Ref',
           'StreamAgg', 'StreamAggScan', 'StreamFilter', 'StreamFlatMap',
           'StreamFold', 'StreamIota', 'StreamMap', 'StreamScan',
           'StreamZip', 'TableGetGlobals', 'ToArray', 'ToStream',
           'ArrayFilter', 'ArrayFold', 'ArrayMap', 'ArrayScan',
           'AggExplode']
