"""Minimal CI service: a build.yaml-style step DAG executed on the
single-node Batch service.

The reference's in-cluster CI (`ci/ci/build.py`, 137-step build.yaml) watches
PRs and runs a DAG of buildImage2/runImage/deploy/createDatabase steps as
Batch jobs. This is the same shape at single-node scale: parse a build.yaml,
topologically submit one Batch job per step with `parent_ids` carrying the
`dependsOn` edges, and report per-step status over REST.

Step kinds:
- runImage: `script` runs under bash (the reference runs it in the step's
  container image; images are out of scope in a zero-egress single node —
  the `image` attribute is recorded in the job spec for parity).
- buildImage2 / deploy / createDatabase: recorded no-op shell steps (their
  cloud/k8s side effects don't exist here); `script`/`publishAs` are kept in
  the job attributes so the DAG and statuses match the reference's shapes.
"""

from __future__ import annotations

import json
import re
import shlex
from typing import Dict, List, Optional

import yaml

from ..batch_service.client import BatchServiceClient

_RUNNABLE = {'runImage'}
_KNOWN = {'runImage', 'buildImage2', 'buildImage', 'deploy', 'createDatabase',
          'createDatabase2'}


class BuildConfigurationError(Exception):
    pass


def parse_build_yaml(text: str) -> List[dict]:
    """build.yaml → ordered list of step dicts (reference ci/ci/build.py
    BuildConfiguration: steps have kind/name/dependsOn + kind params)."""
    doc = yaml.safe_load(text)
    raw_steps = doc.get('steps', doc) if isinstance(doc, dict) else doc
    if not isinstance(raw_steps, list):
        raise BuildConfigurationError('build.yaml must contain a steps list')
    steps = []
    seen = set()
    for s in raw_steps:
        kind = s.get('kind')
        name = s.get('name')
        if not name or not kind:
            raise BuildConfigurationError(f'step missing kind/name: {s}')
        if kind not in _KNOWN:
            raise BuildConfigurationError(f'unknown step kind {kind!r}')
        if name in seen:
            raise BuildConfigurationError(f'duplicate step name {name!r}')
        for dep in s.get('dependsOn', []) or []:
            if dep not in seen:
                raise BuildConfigurationError(
                    f'step {name!r} depends on undefined step {dep!r}')
        seen.add(name)
        steps.append(s)
    return steps


class CIRunner:
    """Submit a parsed step DAG to a Batch service and track it
    (reference ci/ci/ci.py drives build.yaml batches the same way)."""

    def __init__(self, batch_url: str, token: Optional[str] = None):
        self.client = BatchServiceClient(batch_url, token=token)

    def submit(self, steps: List[dict], attributes: Optional[dict] = None,
               workdir: Optional[str] = None) -> int:
        bid = self.client.create_batch(
            attributes={'name': 'ci-build', **(attributes or {})})
        name_to_jid: Dict[str, int] = {}
        bunch = []
        for i, s in enumerate(steps):
            jid = i + 1
            name_to_jid[s['name']] = jid
            if s['kind'] in _RUNNABLE:
                command = s.get('script') or 'true'
                if workdir is not None:
                    # the reference runs each step in a container with the
                    # repo checked out; here the step cds into the build's
                    # persistent merge checkout
                    # quoted: the workdir is named from the branch's name
                    command = f'cd {shlex.quote(workdir)} && ({command})'
            else:
                # non-runnable kinds are recorded no-ops (see module doc)
                command = f'echo "[ci] {s["kind"]} {s["name"]}"'
            bunch.append({
                'job_id': jid,
                'process': {
                    'command': command,
                    'env': {'HAIL_CI_STEP': s['name']},
                    'attributes': {'kind': s['kind'], 'name': s['name'],
                                   'image': s.get('image'),
                                   'publishAs': s.get('publishAs')},
                },
                'parent_ids': [name_to_jid[d]
                               for d in (s.get('dependsOn') or [])],
                'n_max_attempts': int(s.get('numSplits', 1)) and 1,
            })
        self.client.create_jobs(bid, bunch)
        self.client.close_batch(bid)
        return bid

    def status(self, batch_id: int) -> dict:
        b = self.client.get_batch(batch_id)
        jobs = self.client.list_jobs(batch_id)
        return {
            'batch_id': batch_id,
            'complete': b['complete'],
            'state': b.get('state'),
            'steps': [{'job_id': j['job_id'],
                       'name': j.get('name') or (j.get('spec', {}) or {}).get(
                           'attributes', {}).get('name'),
                       'state': j['state']} for j in jobs],
        }

    def run(self, build_yaml_text: str, timeout: float = 300.0,
            attributes: Optional[dict] = None) -> dict:
        steps = parse_build_yaml(build_yaml_text)
        bid = self.submit(steps, attributes)
        self.client.wait(bid, timeout=timeout)
        return self.status(bid)


class PRWatcher:
    """PR watcher + merge queue over a LOCAL git repo (scoped analogue of
    the reference's in-cluster CI, `ci/ci/github.py`: per-PR merge-commit
    builds, then the approved+green candidate merges into the watched
    branch).

    "PRs" are branches matching `pr_prefix` (default `pr/`). For each new
    head, the watcher builds the PR *merged into the target branch* (the
    reference tests the merge commit, not the head), runs the repo's
    build.yaml through CIRunner, and records the result. `merge_ready()`
    merges, oldest-first, every PR whose build is green AND whose tip
    commit message carries an `Approved-by:` trailer (the scoped stand-in
    for GitHub review approval)."""

    def __init__(self, repo_path: str, runner: 'CIRunner',
                 target: str = 'main', pr_prefix: str = 'pr/',
                 build_file: str = 'build.yaml'):
        import tempfile
        self.repo = repo_path
        self.runner = runner
        self.target = target
        self.pr_prefix = pr_prefix
        self.build_file = build_file
        # merge checkouts live until the watcher closes: batch jobs run
        # asynchronously in them
        self._build_root = tempfile.mkdtemp(prefix='hail-ci-builds-')
        # branch -> {'sha', 'state' (pending|success|failure|merge_conflict),
        #            'batch_id', 'approved', 'merged', 'workdir'}
        self.prs: Dict[str, dict] = {}

    def close(self) -> None:
        import shutil
        for rec in self.prs.values():
            wd = rec.get('workdir')
            if wd:
                self._git('worktree', 'remove', '--force', wd, check=False)
        shutil.rmtree(self._build_root, ignore_errors=True)

    def _git(self, *args, check=True):
        import subprocess
        r = subprocess.run(['git', '-C', self.repo, *args],
                           capture_output=True, text=True)
        if check and r.returncode != 0:
            raise RuntimeError(f'git {args}: {r.stderr.strip()}')
        return r.stdout.strip()

    def _pr_branches(self) -> Dict[str, str]:
        out = self._git('for-each-ref', '--format=%(refname:short) %(objectname)',
                        f'refs/heads/{self.pr_prefix}*')
        return dict(line.split() for line in out.splitlines() if line)

    def _is_approved(self, sha: str) -> bool:
        msg = self._git('log', '-1', '--format=%B', sha)
        return 'Approved-by:' in msg

    def poll(self) -> Dict[str, dict]:
        """One watch loop: build every new/updated PR head (merge commit of
        head into target), refresh running build states."""
        import os
        import subprocess
        for branch, sha in self._pr_branches().items():
            rec = self.prs.get(branch)
            # a stale PR (the target moved under it, merge_ready) rebuilds
            if rec is not None and rec['sha'] == sha and \
                    rec['state'] != 'stale':
                if rec['state'] == 'pending':     # refresh a running build
                    st = self.runner.status(rec['batch_id'])
                    if st['complete']:
                        rec['state'] = ('success' if st['state'] == 'success'
                                        else 'failure')
                continue
            if rec is not None and rec.get('workdir'):   # superseded head
                self._git('worktree', 'remove', '--force', rec['workdir'],
                          check=False)
            rec = {'sha': sha, 'state': 'pending', 'batch_id': None,
                   'approved': self._is_approved(sha), 'merged': False,
                   'workdir': None}
            self.prs[branch] = rec
            self._n_builds = getattr(self, '_n_builds', 0) + 1
            # a branch name may hold `$`, `(` and backquotes: kept out of paths
            wt_dir = os.path.join(
                self._build_root,
                f"{re.sub(r'[^A-Za-z0-9._-]', '_', branch)}-{sha[:10]}-"
                f"{self._n_builds}")
            self._git('worktree', 'add', '--detach', wt_dir, self.target)
            rec['workdir'] = wt_dir
            r = subprocess.run(
                ['git', '-C', wt_dir, 'merge', '--no-edit', sha],
                capture_output=True, text=True)
            if r.returncode != 0:
                rec['state'] = 'merge_conflict'
                continue
            build_path = os.path.join(wt_dir, self.build_file)
            if not os.path.exists(build_path):
                rec['state'] = 'failure'
                continue
            with open(build_path) as f:
                steps = parse_build_yaml(f.read())
            rec['batch_id'] = self.runner.submit(
                steps, attributes={'pr': branch, 'sha': sha},
                workdir=wt_dir)
        return self.prs

    def wait_builds(self, timeout: float = 300.0) -> None:
        for rec in self.prs.values():
            if rec['state'] == 'pending' and rec['batch_id'] is not None:
                self.runner.client.wait(rec['batch_id'], timeout=timeout)
                st = self.runner.status(rec['batch_id'])
                rec['state'] = ('success' if st['state'] == 'success'
                                else 'failure')

    def merge_ready(self) -> List[str]:
        """Merge the oldest approved+green PR into the target: one per call
        (reference ci/ci/github.py: the top merge candidate lands, and the
        others retest against the new target before they may merge). The
        other unmerged PRs become 'stale', and the next poll rebuilds them.
        A PR whose merge conflicts with the target is marked
        'merge_conflict', and the next candidate is tried."""
        for branch in sorted(self.prs):
            rec = self.prs[branch]
            if rec['merged'] or rec['state'] != 'success' or not rec['approved']:
                continue
            if not self._merge_into_target(rec['sha']):
                rec['state'] = 'merge_conflict'
                continue
            rec['merged'] = True
            for other in self.prs.values():
                if not other['merged']:
                    other['state'] = 'stale'
            return [branch]
        return []

    def _merge_into_target(self, sha: str) -> bool:
        """Merge `sha` into the target in a worktree of its own, then move
        the target to the merge: the watched repo's checkout is left as it
        is, but for a fast-forward of its files when it has the target
        checked out. On a conflict the merge is aborted, nothing moves, and
        this returns False."""
        import subprocess
        import tempfile
        base = self._git('rev-parse', f'refs/heads/{self.target}')
        wt = tempfile.mkdtemp(prefix='merge-', dir=self._build_root)
        self._git('worktree', 'add', '--detach', wt, base)
        try:
            r = subprocess.run(['git', '-C', wt, 'merge', '--no-edit', sha],
                               capture_output=True, text=True)
            if r.returncode != 0:
                subprocess.run(['git', '-C', wt, 'merge', '--abort'],
                               capture_output=True, text=True)
                return False
            head = subprocess.run(['git', '-C', wt, 'rev-parse', 'HEAD'],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip()
        finally:
            self._git('worktree', 'remove', '--force', wt, check=False)
        checked_out = self._git('symbolic-ref', '-q', 'HEAD', check=False)
        if checked_out == f'refs/heads/{self.target}':
            # the target is the watched checkout's branch: move it with its
            # files (a fast-forward, which refuses to overwrite local edits)
            self._git('merge', '--ff-only', head)
        else:
            self._git('update-ref', f'refs/heads/{self.target}', head, base)
        return True


class CIService:
    """REST surface: POST /api/v1alpha/ci/build (yaml body) → {batch_id};
    GET /api/v1alpha/ci/builds/{batch_id} → step statuses."""

    def __init__(self, batch_url: str, port: int = 0,
                 token: Optional[str] = None):
        self.runner = CIRunner(batch_url, token=token)
        self.port = port
        self._runner_thread = None
        self._site = None

    def _build_app(self):
        from aiohttp import web
        app = web.Application()
        r = app.router
        r.add_get('/healthcheck', self._healthcheck)
        r.add_post('/api/v1alpha/ci/build', self._build)
        r.add_get('/api/v1alpha/ci/builds/{batch_id}', self._status)
        return app

    async def _healthcheck(self, req):
        from aiohttp import web
        return web.json_response({'status': 'ok'})

    async def _build(self, req):
        from aiohttp import web
        text = await req.text()
        try:
            steps = parse_build_yaml(text)
        except BuildConfigurationError as e:
            raise web.HTTPBadRequest(reason=str(e))
        import asyncio
        bid = await asyncio.get_running_loop().run_in_executor(
            None, self.runner.submit, steps)
        return web.json_response({'batch_id': bid, 'n_steps': len(steps)})

    async def _status(self, req):
        from aiohttp import web
        import asyncio
        bid = int(req.match_info['batch_id'])
        st = await asyncio.get_running_loop().run_in_executor(
            None, self.runner.status, bid)
        return web.json_response(st)

    def start(self) -> str:
        """Start in a background thread; returns the base URL."""
        import asyncio
        import threading
        from aiohttp import web
        started = threading.Event()
        url_holder = {}

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)

            async def go():
                app = self._build_app()
                runner = web.AppRunner(app)
                await runner.setup()
                site = web.TCPSite(runner, '127.0.0.1', self.port)
                await site.start()
                url_holder['url'] = \
                    f'http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}'
                self._site = runner
                started.set()
                while not getattr(self, '_stop', False):
                    await asyncio.sleep(0.05)
                await runner.cleanup()

            loop.run_until_complete(go())

        self._runner_thread = threading.Thread(target=run, daemon=True)
        self._runner_thread.start()
        started.wait(10)
        return url_holder['url']

    def stop(self):
        self._stop = True
        if self._runner_thread is not None:
            self._runner_thread.join(5)
