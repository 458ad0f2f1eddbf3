from .structs import Struct, frozendict, Interval
from .timer import ExecutionTimer, timed
from .misc import (HailUserError, FatalError, error, warning, info,
                   default_handler, wrap_to_list, get_env_or_default, uri_path,
                   local_path_uri, new_temp_file, new_local_temp_dir,
                   new_local_temp_file, with_local_temp_file, run_command,
                   timestamp_path, guess_cloud_spark_provider, chunk, maybe,
                   no_service_backend, storage_level, deduplicate, LinkedList,
                   JSONEncoder, _dumps_partitions, get_1kg, get_hgdp,
                   get_movie_lens, async_to_blocking, secret_alnum_string,
                   sync_check_exec, escape_str, escape_id)
from .utils import (partition, grouped, digits_needed, filter_none, flatten,
                    unzip, url_basename, url_join, url_scheme, url_and_params,
                    parse_docker_image_reference, ParsedDockerImageReference)
from .time import (time_msecs, time_ns, time_msecs_str, parse_timestamp_msecs,
                   humanize_timedelta_msecs)
from .filesize import filesize
from .hadoop import (hadoop_open, hadoop_copy, hadoop_exists, hadoop_is_file,
                     hadoop_is_dir, hadoop_stat, hadoop_ls,
                     hadoop_scheme_supported, TemporaryDirectory,
                     TemporaryFilename)
from ..context import ANY_REGION, copy_log


def range_table(n, n_partitions=None):
    from ..table import range_table as rt
    return rt(n, n_partitions)


def range_matrix_table(n_rows, n_cols, n_partitions=None):
    from ..matrixtable import range_matrix_table as rmt
    return rmt(n_rows, n_cols, n_partitions)


def genomic_range_table(n, n_partitions=None, reference_genome='default'):
    """Table keyed by locus over global positions [0, n) (reference
    hl.utils.genomic_range_table)."""
    from ..expr import functions as F
    t = range_table(n, n_partitions)
    t = t.key_by(locus=F.locus_from_global_position(
        F.int64(t.idx), reference_genome))
    return t.drop('idx')


__all__ = ['Struct', 'frozendict', 'Interval', 'ExecutionTimer', 'timed',
           'range_table', 'range_matrix_table', 'genomic_range_table',
           'HailUserError', 'FatalError', 'error', 'warning', 'info',
           'default_handler', 'wrap_to_list', 'get_env_or_default', 'uri_path',
           'local_path_uri', 'new_temp_file', 'new_local_temp_dir',
           'new_local_temp_file', 'with_local_temp_file', 'run_command',
           'timestamp_path', 'guess_cloud_spark_provider', 'chunk', 'maybe',
           'no_service_backend', 'storage_level', 'deduplicate', 'LinkedList',
           'JSONEncoder', '_dumps_partitions', 'get_1kg', 'get_hgdp',
           'get_movie_lens', 'hadoop_open', 'hadoop_copy', 'hadoop_exists',
           'hadoop_is_file', 'hadoop_is_dir', 'hadoop_stat', 'hadoop_ls',
           'hadoop_scheme_supported', 'TemporaryDirectory',
           'TemporaryFilename', 'ANY_REGION', 'copy_log']
