from . import expression, functions, aggregators, scans
from .expression import (Expression, ArrayExpression, BooleanExpression,
                         CallExpression, CollectionExpression, DictExpression,
                         Float32Expression, Float64Expression, Int32Expression,
                         Int64Expression, IntervalExpression, LocusExpression,
                         NDArrayExpression, NumericExpression, SetExpression,
                         StringExpression, StructExpression, TupleExpression,
                         Indices, construct_expr, to_expr, impute_type,
                         unify_all)
from .typefuncs import (ExpressionException, Aggregation, expr_any, expr_int32,
                        expr_int64, expr_float32, expr_float64, expr_numeric,
                        expr_bool, expr_str, expr_call, expr_locus, expr_array,
                        expr_set, expr_dict, expr_struct, expr_tuple,
                        expr_interval, expr_ndarray, expr_oneof, hail_type,
                        unify_types, unify_types_limited, types_match,
                        unify_exprs, is_numeric, is_primitive, is_container,
                        is_compound, coercer_from_dtype, matrix_table_source,
                        table_source, raise_unless_row_indexed,
                        raise_unless_column_indexed,
                        raise_unless_entry_indexed, analyze, eval_typed,
                        eval_timed, tint, tfloat, _console_log, _showstr,
                        _sort_by, _compare, _values_similar, _stream_range,
                        _zip_func, _locus_windows_per_contig,
                        hts_entry_schema, tvariable, tstream, ttable, tmatrix,
                        tblockmatrix, construct_variable, construct_reference,
                        apply_expr, cast_expr, get_refs,
                        extract_refs_by_indices, _zip_streams,
                        _zip_join_producers)
from . import builders

# expression-class aliases used downstream (reference typed_expressions)
ArrayNumericExpression = ArrayExpression
ArrayStructExpression = ArrayExpression
NDArrayNumericExpression = NDArrayExpression
StreamExpression = ArrayExpression

__all__ = ['expression', 'functions', 'aggregators', 'scans']
