"""Execution backends.

The single distributed primitive is `map_collect(contexts)(partition_fn)` —
the analogue of the reference's
`DriverRuntimeContext.mapCollectPartitions(globals, contexts)(f)`
(`is/hail/backend/Backend.scala:54-67`). The local backend maps partitions
over a thread pool (numpy/jax release the GIL in kernels); the multihost
backend (hail_tpu/backend/distributed.py) shards contexts across
`jax.process_index()` and merges with collectives.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence


# Deterministic failures re-raise immediately: retrying them wastes compute
# and buries the real stack under attempt noise. The reference draws the same
# line with `is_transient_error` (hailtop/utils/utils.py:790-870): transient =
# network/IO/service flakes; everything else is permanent.
_DETERMINISTIC_ERRORS = (TypeError, ValueError, KeyError, AttributeError,
                         IndexError, NotImplementedError, AssertionError,
                         ZeroDivisionError, ArithmeticError, LookupError,
                         RecursionError, SyntaxError, NameError)


def _is_transient_error(e: BaseException) -> bool:
    """Whether a partition failure is plausibly transient (worth retrying).
    Reference `hailtop/utils/utils.py is_transient_error`."""
    if isinstance(e, _DETERMINISTIC_ERRORS):
        return False
    from ..utils.misc import FatalError, HailUserError
    if isinstance(e, (FatalError, HailUserError)):
        return False
    return True


def _retrying(fn: Callable[[Any], Any], stage_id: int) -> Callable[[Any], Any]:
    """Per-partition retry (Spark's task-retry analogue, reference
    ServiceBackend.scala:290-300 partition re-runs): each partition gets up to
    `max_partition_attempts` tries at transient errors; deterministic errors
    (TypeError, user errors, ...) fail fast. Retries are logged."""
    from ..context import Env
    attempts = 3
    if Env.is_initialized():
        try:
            attempts = max(1, int(Env.hc().flags.get('max_partition_attempts', '3')))
        except (TypeError, ValueError):
            pass
    if attempts <= 1:
        return fn

    def run(ctx):
        for attempt in range(1, attempts + 1):
            try:
                return fn(ctx)
            except Exception as e:
                if attempt == attempts or not _is_transient_error(e):
                    raise
                from ..utils.hail_logging import logger
                logger().warning(
                    'stage %d: partition attempt %d/%d failed (%s: %s); retrying',
                    stage_id, attempt, attempts, type(e).__name__, e)
        raise AssertionError('unreachable')

    return run


class Backend:
    """Template: `map_collect` times every stage and writes a per-stage record
    to the session log (the analogue of the reference's per-stage Spark log
    lines and QoB X-Hail-Timings), then delegates to the subclass's
    `_map_collect_impl`."""

    # Must match the engine's known flags (reference HailFeatureFlags.scala:
    # 16-52 == backend.py:172-201): name -> (env var, default)
    _flags_env_vars_and_defaults = {
        "branching_factor": ("HAIL_BRANCHING_FACTOR", None),
        "cachedir": ("HAIL_CACHE_DIR", None),
        "distributed_scan_comb_op": ("HAIL_DEV_DISTRIBUTED_SCAN_COMB_OP", None),
        "grouped_aggregate_buffer_size": ("HAIL_GROUPED_AGGREGATE_BUFFER_SIZE", "50"),
        "index_branching_factor": ("HAIL_INDEX_BRANCHING_FACTOR", None),
        "jvm_bytecode_dump": ("HAIL_DEV_JVM_BYTECODE_DUMP", None),
        "lower": ("HAIL_DEV_LOWER", None),
        "lower_bm": ("HAIL_DEV_LOWER_BM", None),
        "lower_only": ("HAIL_DEV_LOWER_ONLY", None),
        "max_leader_scans": ("HAIL_DEV_MAX_LEADER_SCANS", "1000"),
        "max_optimizer_iterations": ("HAIL_OPTIMIZER_ITERATIONS", None),
        "method_split_ir_limit": ("HAIL_DEV_METHOD_SPLIT_LIMIT", "16"),
        "no_ir_logging": ("HAIL_DEV_NO_IR_LOG", None),
        "no_whole_stage_codegen": ("HAIL_DEV_NO_WHOLE_STAGE_CODEGEN", None),
        "optimize": ("HAIL_QUERY_OPTIMIZE", "1"),
        "print_inputs_on_worker": ("HAIL_DEV_PRINT_INPUTS_ON_WORKER", None),
        "print_ir_on_worker": ("HAIL_DEV_PRINT_IR_ON_WORKER", None),
        "profile": ("HAIL_PROFILE", None),
        "rng_nonce": ("HAIL_RNG_NONCE", "0x0"),
        "shuffle_cutoff_to_local_sort": ("HAIL_SHUFFLE_CUTOFF", "512000000"),
        "shuffle_max_branch_factor": ("HAIL_SHUFFLE_MAX_BRANCH", "64"),
        "spark_max_stage_parallelism": ("HAIL_SPARK_MAX_STAGE_PARALLELISM", str(2**31 - 1)),
        "strict_invariants": ("HAIL_STRICT_INVARIANTS", None),
        "use_fast_restarts": ("HAIL_USE_FAST_RESTARTS", None),
        "use_new_shuffle": ("HAIL_USE_NEW_SHUFFLE", None),
        "use_ssa_logs": ("HAIL_USE_SSA_LOGS", "1"),
        "use_unstable_encodings": ("HAIL_DEV_USE_UNSTABLE_ENCODINGS", None),
        "write_ir_files": ("HAIL_WRITE_IR_FILES", None),
        # hail_tpu-specific runtime knobs (same flag machinery)
        "jit_threshold_rows": ("HAIL_TPU_JIT_THRESHOLD_ROWS", "4096"),
        "use_device_sort": ("HAIL_TPU_USE_DEVICE_SORT", "1"),
        "max_partition_attempts": ("HAIL_TPU_MAX_PARTITION_ATTEMPTS", "3"),
        "partition_cache_bytes": ("HAIL_TPU_PARTITION_CACHE_BYTES", str(512 * 1024 * 1024)),
        # sized for the H100's 80 GB (ops/devcache.py holds the same default)
        "device_cache_bytes": ("HAIL_TPU_DEVICE_CACHE_BYTES", str(16 * 1024 * 1024 * 1024)),
    }

    _stage_counter = 0

    @property
    def fs(self):
        """Backend filesystem (reference Backend.fs): the scheme-routing FS."""
        from ..fs.router_fs import get_fs
        return get_fs()

    def map_collect(self, contexts: Sequence[Any], fn: Callable[[Any], Any]) -> List[Any]:
        contexts = list(contexts)
        Backend._stage_counter += 1
        stage_id = Backend._stage_counter
        rfn = _retrying(fn, stage_id)
        part_s: List[float] = []
        from ..utils import timer
        with timer.action(), timer.span('stage', partitions=len(contexts)):
            # each partition's pool thread runs in the stage's span context
            stage_ctx = timer.context()
            index = ({id(c): i for i, c in enumerate(contexts)}
                     if stage_ctx.rec else {})

            def timed_fn(ctx):
                p0 = time.perf_counter()
                try:
                    with timer.carried(stage_ctx), \
                            timer.span('partition', index=index.get(id(ctx))):
                        return rfn(ctx)
                finally:
                    part_s.append(time.perf_counter() - p0)

            t0 = time.perf_counter()
            try:
                results = self._map_collect_impl(contexts, timed_fn)
                # one batched d2h for every device output the partitions
                # deferred (ops/fetchgroup.py) — inside the stage timing.
                # Under `fetchgroup.lazy_transfer()` (count-style actions)
                # this only blocks for kernel completion; the transfer
                # happens on the first real data read
                from ..ops import fetchgroup
                fetchgroup.stage_end()
                return results
            finally:
                wall = time.perf_counter() - t0
                from ..utils.hail_logging import logger
                timer.record_stage(f'stage {stage_id} ({type(self).__name__})',
                                   wall, len(contexts), part_s)
                logger().info(
                    'stage %d (%s): %d partition(s) in %.3fs',
                    stage_id, type(self).__name__, len(contexts), wall)

    def _map_collect_impl(self, contexts: Sequence[Any], fn: Callable[[Any], Any]) -> List[Any]:
        raise NotImplementedError

    def stop(self) -> None:
        pass


class LocalBackend(Backend):
    # the engine always executes through the lowered (stage) pipeline
    requires_lowering = False

    """Thread-pool partition execution on one host
    (reference `backend/local/LocalBackend.scala`)."""

    def __init__(self, n_threads: Optional[int] = None):
        if n_threads is None:
            n_threads = min(os.cpu_count() or 4, 16)
        self.n_threads = n_threads
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.n_threads)
        return self._pool

    _in_worker = threading.local()

    def _map_collect_impl(self, contexts, fn):
        if len(contexts) <= 1 or getattr(LocalBackend._in_worker, 'flag', False):
            # nested stages (a partition fn that itself collects, e.g. a
            # lookup-join building its dictionary) run serially in-thread:
            # scheduling them on the same pool can deadlock when every
            # worker is blocked waiting on queued subtasks
            return [fn(c) for c in contexts]

        def run(c):
            LocalBackend._in_worker.flag = True
            try:
                return fn(c)
            finally:
                LocalBackend._in_worker.flag = False
        return list(self.pool.map(run, contexts))

    def stop(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
