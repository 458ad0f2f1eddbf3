"""Query-on-Batch ServiceBackend: execute query partitions as jobs of the
Batch service (reference `is/hail/backend/service/ServiceBackend.scala:196-300`
— each partition of a CDA becomes one Batch job; the driver stages the
serialized function + contexts, submits a batch, waits, and reads
per-partition results; failed partitions are retried by the service).

Single-node shape: the service is `hail_tpu_torch.batch_service.BatchService`
(in-process by default, or a remote URL), jobs are subprocess workers
(`hail_tpu_torch.backend.qob_worker`), and the staging area is a shared local
directory instead of a cloud bucket. The reference's `parallelism` window and
per-partition result reads map to one job + one result file per partition."""

from __future__ import annotations

import os
import sys
import tempfile
import threading
from typing import Any, Callable, List, Optional, Sequence

from .backend import Backend

#: Sliding-window cap on concurrent partition-result reads (reference
#: `ServiceBackend.scala:44` MaxConcurrentPartitionReads = 50: bounds peak
#: memory while results stream back).
MAX_CONCURRENT_PARTITION_READS = 50


class _CarriesDeviceTensor(Exception):
    """Raised while pickling for a worker: the object holds a tensor on the
    card, which a worker, which cannot see the card, could not load."""


def _worker_pickle(obj) -> bytes:
    """cloudpickle's bytes of `obj`, or _CarriesDeviceTensor."""
    import io

    import cloudpickle
    import torch

    class Pickler(cloudpickle.CloudPickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor) and o.device.type != 'cpu':
                raise _CarriesDeviceTensor
            return super().reducer_override(o)

    buf = io.BytesIO()
    Pickler(buf).dump(obj)
    return buf.getvalue()


class ServiceBackend(Backend):
    """Runs `map_collect` partitions as Batch jobs.

    Parameters
    ----------
    url:
        Batch service URL. If None, a private in-process BatchService is
        started (and stopped with the backend).
    n_workers:
        Worker slots for a private service (ignored with `url`).
    n_max_attempts:
        Per-partition attempt budget (reference QoB re-runs failed
        partitions; `ServiceBackend.scala` caps failures per stage).
    inline_threshold:
        Partition counts at or below this run inline on the driver — a
        subprocess round trip per tiny query would swamp the work (the
        reference similarly short-circuits empty/1-partition stages).
    """

    def __init__(self, url: Optional[str] = None, n_workers: int = 4,
                 n_max_attempts: int = 3, staging_dir: Optional[str] = None,
                 inline_threshold: int = 1, billing_project: str = 'local',
                 stage_timeout: float = 600.0, **_unused):
        from ..batch_service.client import BatchServiceClient
        self._own_service = None
        if url is None:
            from ..batch_service import BatchService
            self._own_service = BatchService.start_in_thread(n_workers=n_workers)
            url = f'http://127.0.0.1:{self._own_service.port}'
        self.url = url
        self.client = BatchServiceClient(url)
        self.n_max_attempts = n_max_attempts
        self.inline_threshold = inline_threshold
        # bounds `_collect`'s wait for a stage (hl.init(stage_timeout=...))
        self.stage_timeout = stage_timeout
        self.billing_project = billing_project
        self._staging_root = staging_dir or tempfile.mkdtemp(prefix='hail_tpu_qob_')
        self._counter = 0

    _on_driver = threading.local()

    def map_collect(self, contexts: Sequence[Any], fn: Callable[[Any], Any]) -> List[Any]:
        """A stage whose function names `driver_reads` launches device
        work (methods/statgen.py marks its regressions): it runs here, on
        the driver, which holds the device, after the stage it reads has run
        its partitions as jobs (they are memoized, and the function reads
        them through the memo)."""
        reads = getattr(fn, 'driver_reads', None)
        if reads is None or getattr(self._on_driver, 'flag', False):
            return super().map_collect(contexts, fn)
        reads.collect_batches()      # the host partitions, as jobs
        self._on_driver.flag = True
        try:
            return super().map_collect(contexts, fn)
        finally:
            self._on_driver.flag = False

    def _map_collect_impl(self, contexts: Sequence[Any], fn: Callable[[Any], Any]) -> List[Any]:
        contexts = list(contexts)
        if len(contexts) <= self.inline_threshold or \
                getattr(self._on_driver, 'flag', False):
            return [fn(c) for c in contexts]
        try:
            fn_pkl = _worker_pickle(fn)
            ctx_pkls = [_worker_pickle(c) for c in contexts]
        except _CarriesDeviceTensor:
            return [fn(c) for c in contexts]

        self._counter += 1
        stage = os.path.join(self._staging_root, f'stage-{self._counter}')
        os.makedirs(stage, exist_ok=True)
        fn_path = os.path.join(stage, 'fn.pkl')
        with open(fn_path, 'wb') as f:
            f.write(fn_pkl)
        out_paths = []
        bunch = []
        for i, ctx_pkl in enumerate(ctx_pkls):
            ctx_path = os.path.join(stage, f'ctx-{i}.pkl')
            out_path = os.path.join(stage, f'out-{i}.pkl')
            with open(ctx_path, 'wb') as f:
                f.write(ctx_pkl)
            out_paths.append(out_path)
            bunch.append({
                'job_id': i + 1,
                'n_max_attempts': self.n_max_attempts,
                'process': {
                    'command': [sys.executable, '-m',
                                'hail_tpu_torch.backend.qob_worker',
                                fn_path, ctx_path, out_path],
                    # the driver keeps the device: the workers never see it
                    'env': {'CUDA_VISIBLE_DEVICES': ''},
                },
            })

        bid = self.client.create_batch(
            attributes={'name': f'qob-stage-{self._counter}'},
            billing_project=self.billing_project)
        self.client.create_jobs(bid, bunch)
        self.client.close_batch(bid)
        return self._collect(bid, out_paths, self.stage_timeout)

    def _collect(self, bid: int, out_paths: List[str],
                 timeout: float = 600.0) -> List[Any]:
        """Stream partition results back while the stage runs.

        The reference driver's `collect`/`drain` loop
        (`ServiceBackend.scala:214-300`): while the job group is Running,
        poll for newly-succeeded jobs and read their results through a
        sliding window of at most MAX_CONCURRENT_PARTITION_READS concurrent
        reads; once the group reports Success, re-drain any partitions the
        listings missed (batch does not order completion listings by
        end_time, so a terminal listing can race a just-finished job —
        the "straggler" pass) and assert every partition was read.
        """
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        import cloudpickle

        n = len(out_paths)
        results: List[Any] = [None] * n
        read = [False] * n
        submitted = set()
        self._drain_stats = {'reads_while_running': 0, 'stragglers': 0,
                             'max_inflight': 0}

        def read_result(i):
            with open(out_paths[i], 'rb') as f:
                results[i] = cloudpickle.load(f)
            read[i] = True

        deadline = _time.time() + timeout
        window = min(MAX_CONCURRENT_PARTITION_READS, max(n, 1))
        with ThreadPoolExecutor(max_workers=window,
                                thread_name_prefix='qob-result-read') as pool:
            inflight = {}

            def drain_inflight():
                for i, fut in list(inflight.items()):
                    if fut.done():
                        fut.result()   # re-raise read errors
                        del inflight[i]

            def submit(i):
                # bounded window: wait for a slot before submitting
                while len(inflight) >= window:
                    next(iter(inflight.values())).result()
                    drain_inflight()
                inflight[i] = pool.submit(read_result, i)
                submitted.add(i)
                self._drain_stats['max_inflight'] = max(
                    self._drain_stats['max_inflight'], len(inflight))

            while True:
                status = self.client.get_batch(bid)
                for j in self._list_completed_jobs(bid):
                    i = j['job_id'] - 1
                    if j['state'] == 'Success' and i not in submitted:
                        submit(i)
                        if not status['complete']:
                            self._drain_stats['reads_while_running'] += 1
                drain_inflight()
                if status['complete']:
                    break
                if _time.time() > deadline:
                    raise TimeoutError(f'QoB stage {bid} not complete: {status}')
                _time.sleep(0.05)
            for fut in inflight.values():
                fut.result()

        if status['n_succeeded'] != n:
            # surface the first failed partition's log as the error message
            # (reference: HailBatchFailure with the worker's stack trace)
            for j in self.client.list_jobs(bid):
                if j['state'] in ('Failed', 'Error', 'Cancelled'):
                    log = self.client.get_job_log(bid, j['job_id'])
                    raise RuntimeError(
                        f'QoB stage failed: partition {j["job_id"] - 1} '
                        f'{j["state"]} after {j["attempts"]} attempt(s):\n{log[-4000:]}')
            raise RuntimeError(f'QoB stage failed: {status}')

        # straggler re-drain: the terminal listing can miss jobs that
        # completed during the final poll interval
        stragglers = [i for i in range(n) if not read[i]]
        for i in stragglers:
            with open(out_paths[i], 'rb') as f:
                results[i] = cloudpickle.load(f)
            read[i] = True
        self._drain_stats['stragglers'] = len(stragglers)
        assert all(read), f'read {sum(read)} of {n} partition results'
        return results

    def _list_completed_jobs(self, bid: int) -> List[dict]:
        """Jobs in a terminal state (override point; tests inject listing
        races here to exercise the straggler pass)."""
        return [j for j in self.client.list_jobs(bid)
                if j['state'] in ('Success', 'Failed', 'Error', 'Cancelled')]

    def stop(self) -> None:
        if self._own_service is not None:
            self._own_service.shutdown()
            self._own_service = None
