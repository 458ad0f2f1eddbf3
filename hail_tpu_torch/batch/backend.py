"""Batch backends (reference `hailtop/batch/backend.py:54,130,411`).

LocalBackend executes the DAG with a thread pool in dependency order —
the reference's LocalBackend runs each job in docker/sh; here jobs run as
subprocesses with resource files materialized in a scratch directory
(containerless: this build has no docker). ServiceBackend submits to a batch
service — gated (no cluster in the zero-egress build) with the same
signature, mirroring how QoB gates on a Batch deployment.
"""

from __future__ import annotations

import concurrent.futures
import os
import pickle
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

from .job import BashJob, Job, PythonJob
from .resource import (InputResourceFile, JobResourceFile, PythonResult,
                       Resource, ResourceFile, ResourceGroup)

# reference hailtop/batch/backend.py:38-39 — default images used for
# localization helper jobs; env-overridable.
_PIP_VERSION = '0.2.135'
HAIL_GENETICS_IMAGES = [
    'hailgenetics/hail', 'hailgenetics/hailtop', 'hailgenetics/genetics']
HAIL_GENETICS_HAIL_IMAGE = os.environ.get(
    'HAIL_GENETICS_HAIL_IMAGE', f'hailgenetics/hail:{_PIP_VERSION}')
HAIL_GENETICS_HAILTOP_IMAGE = os.environ.get(
    'HAIL_GENETICS_HAILTOP_IMAGE', f'hailgenetics/hailtop:{_PIP_VERSION}')


class BatchRun:
    """Result handle (the reference returns a bc.Batch handle; this mirrors
    its status surface)."""

    def __init__(self, batch, job_states: Dict[str, str],
                 errors: Dict[str, str], scratch: Optional[str]):
        self._batch = batch
        self._job_states = job_states
        self._errors = errors
        self._scratch = scratch

    def status(self) -> dict:
        # 'Error' is the service's state of a job killed at its timeout
        n_failed = sum(1 for s in self._job_states.values()
                       if s in ('Failed', 'Error'))
        state = 'failure' if n_failed else 'success'
        return {'state': state, 'n_jobs': len(self._job_states),
                'n_failed': n_failed}

    def job_status(self) -> Dict[str, str]:
        return dict(self._job_states)

    def errors(self) -> Dict[str, str]:
        return dict(self._errors)


class Backend:
    def _run(self, batch, **kwargs) -> BatchRun:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    async def async_close(self):
        # reference backend.py async_close: close any async clients
        self.close()

    def close(self):
        pass


def _resolve_resource_paths(batch, scratch: str) -> Dict[str, str]:
    """uid → on-disk path for every resource, with ResourceGroup member files
    resolved against the group root template."""
    paths: Dict[str, str] = {}

    def path_of(r: Resource) -> str:
        if r._uid in paths:
            return paths[r._uid]
        if isinstance(r, InputResourceFile):
            p = r._input_path
        elif isinstance(r, ResourceGroup):
            p = os.path.join(scratch, r._uid.strip('_'))
        else:
            p = os.path.join(scratch, r._uid.strip('_'))
            ext = getattr(r, '_extension', None)
            if ext:
                p += ext
        paths[r._uid] = p
        return p

    for r in batch._all_resources():
        path_of(r)
        if isinstance(r, ResourceGroup):
            root = paths[r._uid]
            for name, f in r._files.items():
                if isinstance(f, InputResourceFile):
                    paths[f._uid] = f._input_path
                else:
                    template = r._templates.get(name, '{root}.' + name)
                    paths[f._uid] = template.format(root=root)
    return paths


def _substitute(text: str, paths: Dict[str, str]) -> str:
    def repl(m):
        return paths.get(m.group(1), m.group(0))
    return re.sub(r'\$\{(__[A-Z_]+_\d+__)\}', repl, text)


def _copy_batch_outputs(batch, paths: Dict[str, str]) -> None:
    for resource, dest in batch._outputs:
        if isinstance(resource, ResourceGroup):
            for name, f in resource._files.items():
                src = paths[f._uid]
                if os.path.exists(src):
                    _copy_out(src, dest + os.path.splitext(src)[1]
                              if '{root}' not in dest else dest)
        else:
            src = paths[resource._uid]
            if os.path.exists(src):
                _copy_out(src, dest)


class LocalBackend(Backend):
    def __init__(self, tmp_dir: Optional[str] = None, gsa_key_file=None,
                 extra_docker_run_flags=None):
        self._tmp_dir = tmp_dir

    def _run(self, batch, dry_run=False, verbose=False,
             delete_scratch_on_exit=True, wait=True, max_parallel_jobs: int = 8,
             **kwargs) -> BatchRun:
        scratch = tempfile.mkdtemp(prefix='hail_tpu_batch_',
                                   dir=self._tmp_dir)
        resource_paths: Dict[str, str] = {}

        def resource_path(r: Resource) -> str:
            if r._uid in resource_paths:
                return resource_paths[r._uid]
            if isinstance(r, InputResourceFile):
                p = r._input_path
            elif isinstance(r, ResourceGroup):
                p = os.path.join(scratch, r._uid.strip('_'))
            else:
                p = os.path.join(scratch, r._uid.strip('_'))
                ext = getattr(r, '_extension', None)
                if ext:
                    p += ext
            resource_paths[r._uid] = p
            return p

        # resource-group member files resolve against the group root template
        input_links = []   # (input_path, localized path) symlinks

        def materialize_paths():
            for r in batch._all_resources():
                resource_path(r)
                if isinstance(r, ResourceGroup):
                    root = resource_paths[r._uid]
                    for name, f in r._files.items():
                        template = r._templates.get(name, '{root}.' + name)
                        p = template.format(root=root)
                        if p == root:   # input groups use the bare '{root}'
                            p = root + '.' + name
                        if isinstance(f, InputResourceFile):
                            # localize so `{group}.name` references resolve
                            # next to the group root (reference LocalBackend
                            # links inputs into the scratch dir)
                            resource_paths[f._uid] = p
                            input_links.append((f._input_path, p))
                        else:
                            resource_paths[f._uid] = p

        materialize_paths()
        for src_p, dst_p in input_links:
            os.makedirs(os.path.dirname(dst_p), exist_ok=True)
            if not os.path.exists(dst_p) and os.path.exists(src_p):
                os.symlink(os.path.abspath(src_p), dst_p)

        def substitute(text: str) -> str:
            import shlex

            def repl(m):
                uid = m.group(1)
                p = resource_paths.get(uid)
                if p is None:
                    return m.group(0)
                # shell-quote: input paths may contain spaces/parens
                # (reference LocalBackend shq-quotes localized paths)
                return shlex.quote(p)
            return re.sub(r'\$\{(__[A-Z_]+_\d+__)\}', repl, text)

        if dry_run:
            for j in batch._jobs:
                if isinstance(j, BashJob):
                    print(f'# Job: {j.name or j._uid}')
                    for cmd in j._commands:
                        print(substitute(cmd))
            return BatchRun(batch, {j._uid: 'DryRun' for j in batch._jobs}, {}, None)

        # topological schedule with a thread pool
        jobs = list(batch._jobs)
        deps = {j._uid: {d._uid for d in j._all_dependencies()} for j in jobs}
        states: Dict[str, str] = {j._uid: 'Pending' for j in jobs}
        errors: Dict[str, str] = {}
        py_results: Dict[str, object] = {}

        def run_job(j: Job):
            try:
                if isinstance(j, BashJob):
                    script = '\n'.join(['set -e'] + [substitute(c) for c in j._commands])
                    env = dict(os.environ)
                    env.update(j._env)
                    # a job that outlives its Job.timeout is killed here
                    r = subprocess.run([j._shell, '-c', script], capture_output=True,
                                       text=True, env=env, cwd=scratch,
                                       timeout=getattr(j, '_timeout', None))
                    if verbose and r.stdout:
                        print(r.stdout, end='')
                    if r.returncode != 0:
                        raise subprocess.CalledProcessError(
                            r.returncode, [j._shell, '-c', script],
                            output=r.stdout, stderr=r.stderr)
                elif isinstance(j, PythonJob):
                    for fn, args, kw, result in j._calls:
                        def resolve(a):
                            if isinstance(a, PythonResult):
                                return py_results[a._uid]
                            if isinstance(a, ResourceFile):
                                return resource_paths[a._uid]
                            return a
                        value = fn(*[resolve(a) for a in args],
                                   **{k: resolve(v) for k, v in kw.items()})
                        py_results[result._uid] = value
                        import json as _json
                        for f, kind in [(result._json_file, 'json'),
                                        (result._str_file, 'str'),
                                        (result._repr_file, 'repr')]:
                            if f is not None:
                                p = resource_paths[f._uid]
                                with open(p, 'w') as fh:
                                    # reference pyjob writers newline-terminate
                                    if kind == 'json':
                                        fh.write(_json.dumps(value) + '\n')
                                    elif kind == 'str':
                                        fh.write(str(value) + '\n')
                                    else:
                                        fh.write(repr(value) + '\n')
                return None
            except Exception as e:
                return e

        pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_parallel_jobs)
        futures: Dict[str, concurrent.futures.Future] = {}
        try:
            remaining = {j._uid: j for j in jobs}
            failed_any = False
            while remaining or futures:
                # launch ready jobs
                ready = [uid for uid, j in list(remaining.items())
                         if all(states.get(d) == 'Success' for d in deps[uid])
                         and uid not in futures]
                blocked_failed = [uid for uid, j in list(remaining.items())
                                  if any(states.get(d) == 'Failed' for d in deps[uid])]
                for uid in blocked_failed:
                    j = remaining.pop(uid)
                    if j._always_run:
                        futures[uid] = pool.submit(run_job, j)
                    else:
                        states[uid] = 'Cancelled'
                for uid in ready:
                    j = remaining.pop(uid)
                    if failed_any and batch._cancel_after_n_failures == 1 and not j._always_run:
                        states[uid] = 'Cancelled'
                        continue
                    states[uid] = 'Running'
                    futures[uid] = pool.submit(run_job, j)
                if not futures:
                    if remaining:
                        # deadlock (cycle?) — cancel the rest
                        for uid in list(remaining):
                            states[uid] = 'Cancelled'
                            remaining.pop(uid)
                    break
                done, _ = concurrent.futures.wait(
                    list(futures.values()),
                    return_when=concurrent.futures.FIRST_COMPLETED)
                for uid, fut in list(futures.items()):
                    if fut in done:
                        err = fut.result()
                        if err is None:
                            states[uid] = 'Success'
                        else:
                            states[uid] = 'Failed'
                            errors[uid] = err
                            failed_any = True
                        futures.pop(uid)
        finally:
            pool.shutdown(wait=True)

        # write requested outputs (even on failure: partial outputs of
        # always_run consumers must land — reference LocalBackend semantics)
        for resource, dest in batch._outputs:
            if isinstance(resource, ResourceGroup):
                for name, f in resource._files.items():
                    src = resource_paths[f._uid]
                    template = resource._templates.get(name, '{root}.' + name)
                    out = template.format(root=dest)
                    if out == dest:  # input groups: '{root}' template
                        out = dest + '.' + name
                    if os.path.exists(src):
                        _copy_out(src, out)
            else:
                src = resource_paths[resource._uid]
                if os.path.exists(src):
                    _copy_out(src, dest)

        run = BatchRun(batch, states, errors, scratch)
        if delete_scratch_on_exit:
            shutil.rmtree(scratch, ignore_errors=True)
            run._scratch = None
        if errors:
            if verbose:
                for uid, e in errors.items():
                    print(f'FAILED {uid}: {e}')
            if kwargs.get('_raise_on_failure', True):
                first = next(iter(errors.values()))
                if isinstance(first, BaseException):
                    raise first
                raise RuntimeError(str(first))
        return run

    def close(self):
        pass


def _copy_out(src: str, dest: str) -> None:
    from .. import fs as hfs
    hfs.copy(src, dest)


class ServiceBackend(Backend):
    """Submit the pipeline DAG to the Batch service over REST (reference
    `hailtop/batch/backend.py:411` ServiceBackend → deployed Batch;
    here: the single-node service in hail_tpu.batch_service).

    `url` points at a running service; with no url, a private in-process
    service is started on demand (and stopped on close) so the REST path is
    exercised even on one machine."""

    def __init__(self, billing_project: Optional[str] = None,
                 remote_tmpdir: Optional[str] = None,
                 url: Optional[str] = None, **kwargs):
        self.billing_project = billing_project or 'local'
        self.remote_tmpdir = remote_tmpdir
        self._url = url
        self._own_service = None

    def _client(self):
        from ..batch_service import BatchService, BatchServiceClient
        if self._url is None:
            if self._own_service is None:
                self._own_service = BatchService.start_in_thread()
            self._url = f'http://127.0.0.1:{self._own_service.port}'
        return BatchServiceClient(self._url)

    def _run(self, batch, dry_run=False, verbose=False,
             delete_scratch_on_exit=True, wait=True, **kwargs) -> BatchRun:
        client = self._client()
        scratch = tempfile.mkdtemp(prefix='hail_tpu_batch_svc_run_',
                                   dir=self.remote_tmpdir)
        paths = _resolve_resource_paths(batch, scratch)

        if dry_run:
            for j in batch._jobs:
                if isinstance(j, BashJob):
                    print(f'# Job: {j.name or j._uid}')
                    for cmd in j._commands:
                        print(_substitute(cmd, paths))
            return BatchRun(batch, {j._uid: 'DryRun' for j in batch._jobs},
                            {}, None)

        job_ids: Dict[str, int] = {}
        bunch = []
        for i, j in enumerate(batch._jobs, start=1):
            job_ids[j._uid] = i
            env = dict(j._env)
            if isinstance(j, BashJob):
                script = '\n'.join(['set -e']
                                   + [_substitute(c, paths) for c in j._commands])
            elif isinstance(j, PythonJob):
                script = self._python_job_script(j, paths, scratch, i)
                # pickle references functions by module: make their source
                # dirs importable in the worker process (the reference ships
                # dill closures into containers instead)
                import inspect
                dirs = []
                for fn, *_ in j._calls:
                    try:
                        d = os.path.dirname(os.path.abspath(inspect.getfile(fn)))
                        if d not in dirs:
                            dirs.append(d)
                    except TypeError:
                        pass
                repo_root = os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))))
                dirs.append(repo_root)
                pp = os.pathsep.join(dirs + [os.environ.get('PYTHONPATH', '')])
                env.setdefault('PYTHONPATH', pp.rstrip(os.pathsep))
            else:
                raise NotImplementedError(type(j).__name__)
            bunch.append({
                'job_id': i,
                # the service's worker kills the job at its Job.timeout
                'spec': {'command': script, 'env': env,
                         'timeout': getattr(j, '_timeout', None)},
                'parent_ids': [job_ids[d._uid] for d in j._all_dependencies()
                               if d._uid in job_ids],
                'always_run': j._always_run,
                'n_max_attempts': max(1, getattr(j, '_n_max_attempts', 1) or 1),
            })
        bid = client.create_batch(
            attributes={'name': batch.name} if batch.name else {},
            billing_project=self.billing_project,
            cancel_after_n_failures=batch._cancel_after_n_failures)
        client.create_jobs(bid, bunch)
        client.close_batch(bid)
        if not wait:
            return BatchRun(batch, {j._uid: 'Running' for j in batch._jobs},
                            {}, scratch)
        # run(timeout=...) bounds the wait for the batch
        client.wait(bid, timeout=kwargs.get('timeout', 300.0))
        states: Dict[str, str] = {}
        errors: Dict[str, str] = {}
        for job in client.list_jobs(bid):
            uid = next(u for u, i in job_ids.items() if i == job['job_id'])
            states[uid] = job['state']
            if job['state'] in ('Failed', 'Error'):
                errors[uid] = client.get_job_log(bid, job['job_id'])[-2000:]
        _copy_batch_outputs(batch, paths)
        run = BatchRun(batch, states, errors, scratch)
        if delete_scratch_on_exit:
            shutil.rmtree(scratch, ignore_errors=True)
            run._scratch = None
        return run

    def _python_job_script(self, j: PythonJob, paths: Dict[str, str],
                           scratch: str, idx: int) -> str:
        """PythonJob via pickled calls executed by a generated runner (the
        reference ships dill-pickled closures into containers)."""
        payload = os.path.join(scratch, f'pyjob_{idx}.pkl')

        def encode(a):
            # self-contained markers so the runner needs no hail_tpu imports
            if isinstance(a, PythonResult):
                return ('__result__', paths[a._uid])
            if isinstance(a, ResourceFile):
                return ('__path__', paths[a._uid])
            return ('__value__', a)

        spec = []
        for fn, args, kw, result in j._calls:
            out_files = {kind: paths[f._uid] for kind, f in
                         [('json', result._json_file), ('str', result._str_file),
                          ('repr', result._repr_file)] if f is not None}
            # every result value is also pickled to its resource path so
            # downstream jobs (and this job's later calls) can read it
            spec.append((fn, [encode(a) for a in args],
                         {k: encode(v) for k, v in kw.items()},
                         paths[result._uid], out_files))
        with open(payload, 'wb') as f:
            pickle.dump(spec, f)
        runner = os.path.join(os.path.dirname(__file__), '_pyjob_runner.py')
        return f'exec {shutil.which("python3") or "python3"} {runner} {payload}'

    def close(self):
        if self._own_service is not None:
            self._own_service.shutdown()
            self._own_service = None
