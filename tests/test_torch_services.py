"""The port's platform services (hail_tpu_torch.services: the auth service
and its client, gear's middleware, metrics, the Database, the CI service
and the docs site): the counterparts of tests/test_platform_services.py,
test_ci_service.py and test_docs_site.py, run against the port, then the
faults of the reference that the port repairs (in services/ci_service.py
and services/database.py), each with a
test that the port is right where it differs.

HOME and XDG_CONFIG_HOME point at a temporary directory in every test, so
that the token store (~/.hail_tpu/tokens.json) and the user config are the
test's own. Services bind port 0; every wait has its own time limit."""

import json
import os
import subprocess
import textwrap
import urllib.error
import urllib.request

import pytest

import hail_tpu_torch as hlt
from hail_tpu_torch.batch_service import BatchService, BatchServiceClient
from hail_tpu_torch.services import AuthService
from hail_tpu_torch.services import auth_client, metrics
from hail_tpu_torch.services.ci_service import (BuildConfigurationError,
                                                CIRunner, CIService,
                                                parse_build_yaml)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120.0


@pytest.fixture(autouse=True)
def private_home(tmp_path, monkeypatch):
    home = tmp_path / 'home'
    home.mkdir()
    monkeypatch.setenv('HOME', str(home))
    monkeypatch.setenv('XDG_CONFIG_HOME', str(home / '.config'))
    monkeypatch.delenv('HAIL_TOKENS_FILE', raising=False)
    # the CI's merges commit: give them an author, as a CI host has one
    for k in ('AUTHOR', 'COMMITTER'):
        monkeypatch.setenv(f'GIT_{k}_NAME', 'ci')
        monkeypatch.setenv(f'GIT_{k}_EMAIL', 'ci@x')


def _get(url, token=None, expect_json=True):
    headers = {}
    if token:
        headers['Authorization'] = f'Bearer {token}'
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=10) as resp:
        body = resp.read()
    return json.loads(body) if expect_json else body.decode()


@pytest.fixture(scope='module')
def auth_svc():
    svc = AuthService.start_in_thread(initial_developer='dev')
    yield svc
    svc.shutdown()


@pytest.fixture()
def dev_token(auth_svc, tmp_path, monkeypatch):
    monkeypatch.setenv('HAIL_TOKENS_FILE', str(tmp_path / 'tokens.json'))
    return auth_client.login(f'http://127.0.0.1:{auth_svc.port}', 'dev')


def test_login_and_userinfo(auth_svc, dev_token):
    url = f'http://127.0.0.1:{auth_svc.port}'
    info = auth_client.get_userinfo(url, dev_token)
    assert info['username'] == 'dev'
    assert info['is_developer'] is True


def test_userinfo_requires_token(auth_svc):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f'http://127.0.0.1:{auth_svc.port}/api/v1alpha/userinfo')
    assert e.value.code == 401


def test_user_management(auth_svc, dev_token):
    url = f'http://127.0.0.1:{auth_svc.port}'
    req = urllib.request.Request(
        f'{url}/api/v1alpha/users/alice/create', method='POST',
        data=json.dumps({'is_developer': False}).encode(),
        headers={'Authorization': f'Bearer {dev_token}',
                 'Content-Type': 'application/json'})
    urllib.request.urlopen(req, timeout=10)
    users = _get(f'{url}/api/v1alpha/users', dev_token)['users']
    assert {u['username'] for u in users} >= {'dev', 'alice'}
    # non-developer may not list users
    alice_token = auth_client._req(f'{url}/api/v1alpha/login', 'POST',
                                   {'username': 'alice'})['token']
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f'{url}/api/v1alpha/users', alice_token)
    assert e.value.code == 403


def test_copy_paste_token_exchange(auth_svc, dev_token, tmp_path, monkeypatch):
    monkeypatch.setenv('HAIL_TOKENS_FILE', str(tmp_path / 't2.json'))
    url = f'http://127.0.0.1:{auth_svc.port}'
    cp = auth_client._req(f'{url}/api/v1alpha/copy-paste-token', 'POST', {},
                          token=dev_token)['token']
    session = auth_client.copy_paste_login(url, cp)
    assert auth_client.get_userinfo(url, session)['username'] == 'dev'
    # single-use: the copy-paste token is consumed
    with pytest.raises(urllib.error.HTTPError):
        auth_client._req(f'{url}/api/v1alpha/copy-paste-login', 'POST',
                         {'token': cp})


def test_metrics_endpoint(auth_svc):
    text = _get(f'http://127.0.0.1:{auth_svc.port}/metrics', expect_json=False)
    assert '# TYPE http_request_count counter' in text
    assert 'http_request_latency_seconds_sum' in text


def test_batch_service_with_auth(auth_svc, dev_token, tmp_path):
    svc = BatchService.start_in_thread(
        n_workers=2, data_dir=str(tmp_path / 'svc'),
        auth_url=f'http://127.0.0.1:{auth_svc.port}')
    try:
        url = f'http://127.0.0.1:{svc.port}'
        # unauthenticated API calls are rejected
        unauth = BatchServiceClient(url, token='')
        with pytest.raises(urllib.error.HTTPError) as e:
            unauth.create_batch()
        assert e.value.code == 401
        # authenticated client runs a job end-to-end
        client = BatchServiceClient(url, token=dev_token)
        bid = client.create_batch()
        client.create_jobs(bid, [{'job_id': 1, 'command': 'echo hello-auth'}])
        client.close_batch(bid)
        st = client.wait(bid, timeout=60)
        assert st['n_succeeded'] == 1
        assert 'hello-auth' in client.get_job_log(bid, 1)
        # batch /metrics exposes job-state gauges
        text = _get(f'{url}/metrics', expect_json=False)
        assert 'batch_jobs_success' in text
        # HTML UI pages render (authenticated; unauthenticated UI GETs
        # now redirect to /login like the reference)
        page = _get(f'{url}/batches', token=dev_token, expect_json=False)
        assert f'/batches/{bid}' in page
        page = _get(f'{url}/batches/{bid}', token=dev_token,
                    expect_json=False)
        assert 'state-Success' in page
    finally:
        svc.shutdown()


def test_metrics_primitives():
    c = metrics.Counter('test_widget_total', 'widgets', ['kind'])
    c.labels(kind='a').inc()
    c.labels(kind='a').inc(2)
    c.labels(kind='b').inc()
    g = metrics.Gauge('test_depth', 'depth')
    g.set(5)
    g.dec()
    s = metrics.Summary('test_latency', 'lat')
    with s.time():
        pass
    text = metrics.render_metrics()
    assert 'test_widget_total{kind="a"} 3.0' in text
    assert 'test_widget_total{kind="b"} 1.0' in text
    assert 'test_depth 4.0' in text
    assert 'test_latency_count 1.0' in text


# ---------------------------------------------------------------------------
# gear middleware primitives (reference gear/gear/{csrf,session,
# time_limited_max_size_cache,database}.py)
# ---------------------------------------------------------------------------

def test_csrf_token_and_cookie_sessions():
    import asyncio
    from hail_tpu_torch.services import gear

    t = gear.new_csrf_token()
    assert len(t) > 60 and t != gear.new_csrf_token()

    cs = gear.CookieSessions(b'secret-key')
    cookie = cs.encode({'user': 'dev', 'is_developer': True})
    assert cs.decode(cookie) == {'user': 'dev', 'is_developer': True}
    # tampering invalidates
    assert cs.decode(cookie[:-4] + 'AAAA') is None
    assert cs.decode('garbage') is None
    assert gear.CookieSessions(b'other-key').decode(cookie) is None


def test_csrf_middleware_rejects_mismatched_tokens():
    import asyncio
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer
    from hail_tpu_torch.services import gear

    async def run():
        app = web.Application(middlewares=[gear.csrf_middleware])

        async def post(request):
            return web.json_response({'ok': True})
        app.router.add_post('/mutate', post)
        async with TestClient(TestServer(app)) as client:
            # no cookies at all: csrf check does not apply (token auth path)
            r = await client.post('/mutate')
            assert r.status == 200
            tok = gear.new_csrf_token()
            client.session.cookie_jar.update_cookies({'_csrf': tok})
            r = await client.post('/mutate')          # cookie but no header
            assert r.status == 401
            r = await client.post('/mutate', headers={'X-CSRF-Token': 'wrong'})
            assert r.status == 401
            r = await client.post('/mutate', headers={'X-CSRF-Token': tok})
            assert r.status == 200
    asyncio.run(run())


def test_time_limited_max_size_cache():
    import asyncio
    from hail_tpu_torch.services.gear import TimeLimitedMaxSizeCache

    async def run():
        loads = []

        async def load(k):
            loads.append(k)
            await asyncio.sleep(0.01)
            return k * 2

        c = TimeLimitedMaxSizeCache(load, lifetime_ns=50_000_000_000,
                                    num_slots=2, cache_name='t')
        # coalescing: two concurrent lookups -> one load
        a, b = await asyncio.gather(c.lookup(1), c.lookup(1))
        assert a == b == 2 and loads == [1]
        assert await c.lookup(1) == 2 and c.hits == 1
        # eviction at capacity
        await c.lookup(2)
        await c.lookup(3)
        assert c.evictions == 1 and len(c._cache) == 2
        await c.shutdown()
        with pytest.raises(ValueError):
            await c.lookup(9)
    asyncio.run(run())


def test_database_transaction_and_retry():
    import asyncio
    import sqlite3
    from hail_tpu_torch.services.database import Database, retry_transient_db_errors

    async def run():
        db = await Database().async_init()
        await db.just_execute('CREATE TABLE t (k TEXT PRIMARY KEY, v INT)')
        async with db.transaction() as tx:
            await tx.execute_insertone('INSERT INTO t VALUES (?, ?)', ('a', 1))
            await tx.just_execute('UPDATE t SET v = v + 1 WHERE k = ?', ('a',))
        row = await db.execute_and_fetchone('SELECT v FROM t WHERE k = ?', ('a',))
        assert row['v'] == 2
        # rollback on error
        try:
            async with db.transaction() as tx:
                await tx.just_execute('UPDATE t SET v = 99 WHERE k = ?', ('a',))
                raise RuntimeError('boom')
        except RuntimeError:
            pass
        row = await db.execute_and_fetchone('SELECT v FROM t WHERE k = ?', ('a',))
        assert row['v'] == 2

        calls = []

        async def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise sqlite3.OperationalError('database is locked')
            return 'ok'
        assert await retry_transient_db_errors(flaky)() == 'ok'
        assert len(calls) == 3

        async def fatal():
            raise sqlite3.OperationalError('syntax error')
        with pytest.raises(sqlite3.OperationalError):
            await retry_transient_db_errors(fatal)()
        await db.async_close()
    asyncio.run(run())

BUILD_YAML = textwrap.dedent('''
    steps:
      - kind: buildImage2
        name: base_image
        dockerFile: Dockerfile.base
        publishAs: base
      - kind: runImage
        name: check_lint
        image: base
        script: |
          echo lint-ok
        dependsOn:
          - base_image
      - kind: runImage
        name: run_tests
        image: base
        script: |
          echo tests-ok
        dependsOn:
          - base_image
      - kind: deploy
        name: deploy_batch
        dependsOn:
          - check_lint
          - run_tests
''')


@pytest.fixture(scope='module')
def svc():
    service = BatchService.start_in_thread(n_workers=4)
    yield service
    service.shutdown()


def test_parse_build_yaml():
    steps = parse_build_yaml(BUILD_YAML)
    assert [s['name'] for s in steps] == [
        'base_image', 'check_lint', 'run_tests', 'deploy_batch']
    assert steps[3]['dependsOn'] == ['check_lint', 'run_tests']


def test_parse_rejects_bad_configs():
    with pytest.raises(BuildConfigurationError):
        parse_build_yaml('steps:\n  - kind: runImage\n')   # no name
    with pytest.raises(BuildConfigurationError):
        parse_build_yaml(
            'steps:\n  - {kind: runImage, name: a, dependsOn: [missing]}\n')
    with pytest.raises(BuildConfigurationError):
        parse_build_yaml('steps:\n  - {kind: nope, name: a}\n')


def test_ci_runner_executes_dag(svc):
    runner = CIRunner(f'http://127.0.0.1:{svc.port}')
    status = runner.run(BUILD_YAML, timeout=60)
    assert status['complete']
    states = {s['name']: s['state'] for s in status['steps']}
    assert states == {'base_image': 'Success', 'check_lint': 'Success',
                      'run_tests': 'Success', 'deploy_batch': 'Success'}


def test_ci_failure_blocks_dependents(svc):
    bad = BUILD_YAML.replace('echo tests-ok', 'exit 1')
    runner = CIRunner(f'http://127.0.0.1:{svc.port}')
    steps = parse_build_yaml(bad)
    bid = runner.submit(steps)
    runner.client.wait(bid, timeout=60)
    states = {s['name']: s['state'] for s in runner.status(bid)['steps']}
    assert states['run_tests'] == 'Failed'
    assert states['deploy_batch'] in ('Cancelled', 'Failed')
    assert states['check_lint'] == 'Success'


def test_ci_rest_surface(svc):
    import json
    import urllib.request
    ci = CIService(f'http://127.0.0.1:{svc.port}')
    try:
        url = ci.start()
        req = urllib.request.Request(f'{url}/api/v1alpha/ci/build',
                                     data=BUILD_YAML.encode(), method='POST')
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        assert out['n_steps'] == 4
        bid = out['batch_id']
        runner = CIRunner(f'http://127.0.0.1:{svc.port}')
        runner.client.wait(bid, timeout=60)
        with urllib.request.urlopen(
                f'{url}/api/v1alpha/ci/builds/{bid}', timeout=30) as resp:
            st = json.loads(resp.read())
        assert st['complete'] and len(st['steps']) == 4
    finally:
        ci.stop()


def test_pr_watcher_merge_queue(svc, tmp_path):
    """PR watcher over a local git repo: merge-commit builds, approval
    gating, merge queue (reference ci/ci/github.py at single-node scale).
    Where the port differs from hail_tpu: after a merge the other PRs are
    stale, and the next poll rebuilds them against the new main."""
    from hail_tpu_torch.services.ci_service import PRWatcher

    repo = tmp_path / 'repo'
    repo.mkdir()

    def git(*args, env_extra=None):
        env = {'GIT_AUTHOR_NAME': 'ci', 'GIT_AUTHOR_EMAIL': 'ci@x',
               'GIT_COMMITTER_NAME': 'ci', 'GIT_COMMITTER_EMAIL': 'ci@x',
               'HOME': str(tmp_path), 'PATH': '/usr/bin:/bin:/usr/local/bin'}
        subprocess.run(['git', '-C', str(repo), *args], check=True,
                       capture_output=True, env=env, timeout=60)

    git('init', '-b', 'main')
    (repo / 'build.yaml').write_text(textwrap.dedent('''
        steps:
          - kind: runImage
            name: test
            script: test -f ok.txt
    '''))
    (repo / 'ok.txt').write_text('base\n')
    git('add', '-A')
    git('commit', '-m', 'base')

    # approved PR that passes the build
    git('checkout', '-b', 'pr/1-good')
    (repo / 'feature.txt').write_text('x\n')
    git('add', '-A')
    git('commit', '-m', 'feature\n\nApproved-by: dev')
    git('checkout', 'main')

    # PR that breaks the build (deletes ok.txt), also "approved"
    git('checkout', '-b', 'pr/2-bad')
    git('rm', '-q', 'ok.txt')
    git('commit', '-m', 'break it\n\nApproved-by: dev')
    git('checkout', 'main')

    # green but unapproved PR
    git('checkout', '-b', 'pr/3-unapproved')
    (repo / 'other.txt').write_text('y\n')
    git('add', '-A')
    git('commit', '-m', 'no review yet')
    git('checkout', 'main')

    runner = CIRunner(f'http://127.0.0.1:{svc.port}')
    w = PRWatcher(str(repo), runner)
    w.poll()
    w.wait_builds(timeout=120)
    assert w.prs['pr/1-good']['state'] == 'success'
    assert w.prs['pr/1-good']['approved']
    assert w.prs['pr/2-bad']['state'] == 'failure'
    assert w.prs['pr/3-unapproved']['state'] == 'success'
    assert not w.prs['pr/3-unapproved']['approved']

    merged = w.merge_ready()
    assert merged == ['pr/1-good']
    # the merge landed on main, and the checkout on main moved with it
    out = subprocess.run(['git', '-C', str(repo), 'log', '--oneline', 'main'],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    assert 'feature' in out and (repo / 'feature.txt').exists()
    assert subprocess.run(['git', '-C', str(repo), 'status', '--porcelain'],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout == ''
    # the other PRs were built against the old main: stale until rebuilt
    assert {b: r['state'] for b, r in w.prs.items() if not r['merged']} == {
        'pr/2-bad': 'stale', 'pr/3-unapproved': 'stale'}
    assert w.merge_ready() == []
    before = {b: r['batch_id'] for b, r in w.prs.items()}
    w.poll()
    rebuilt = {b for b, r in w.prs.items() if r['batch_id'] != before[b]}
    assert rebuilt == {'pr/2-bad', 'pr/3-unapproved'}
    w.wait_builds(timeout=120)
    assert w.prs['pr/2-bad']['state'] == 'failure'
    assert w.prs['pr/3-unapproved']['state'] == 'success'
    assert w.merge_ready() == []
    # unchanged heads are not rebuilt
    before = {b: r['batch_id'] for b, r in w.prs.items()}
    w.poll()
    assert {b: r['batch_id'] for b, r in w.prs.items()} == before

def test_guide_pages_exist():
    from hail_tpu_torch.services.docs_site import DOCS_ROOT
    guide = os.path.join(DOCS_ROOT, 'guide')
    pages = [f for f in os.listdir(guide) if f.endswith('.md')]
    assert len(pages) >= 10
    for f in pages:
        text = open(os.path.join(guide, f)).read()
        assert text.startswith('#'), f


def test_api_reference_served():
    """The docs site of the port serves the generated API pages (docs/api,
    which `docs build` of hail_tpu writes), and the names they document
    are the port's too."""
    from hail_tpu_torch.services.docs_site import DOCS_ROOT
    assert DOCS_ROOT == os.path.join(REPO, 'docs')
    api = os.path.join(DOCS_ROOT, 'api')
    assert os.path.isfile(os.path.join(api, 'index.md'))
    methods = open(os.path.join(api, 'methods.md')).read()
    for name in ('linear_regression_rows', 'hwe_normalized_pca'):
        assert name in methods and callable(getattr(hlt, name))
    table = open(os.path.join(api, 'Table.md')).read()
    assert 'Table.annotate' in table and callable(hlt.Table.annotate)


def test_markdown_renders():
    from hail_tpu_torch.services.docs_site import render_markdown
    html = render_markdown('# T\n\n```python\nx = 1\n```\n\n| a | b |\n'
                           '|---|---|\n| 1 | 2 |\n')
    assert '<h1>' in html and '<code' in html and '<table>' in html


def test_docs_site_serves():
    import asyncio

    from hail_tpu_torch.services.docs_site import build_app

    async def run():
        from aiohttp import web
        from aiohttp.test_utils import TestClient, TestServer
        app = build_app()
        async with TestClient(TestServer(app)) as client:
            r = await client.get('/')
            assert r.status == 200
            body = await r.text()
            assert 'User guide' in body
            r = await client.get('/guide/01-getting-started.md')
            assert r.status == 200
            assert 'hail_tpu' in await r.text()
            r = await client.get('/api/index.md')
            assert r.status == 200
            r = await client.get('/../secrets')
            assert r.status in (403, 404)

    asyncio.run(run())


# ---------------------------------------------------------------------------
# faults of the reference that the port does not copy
# ---------------------------------------------------------------------------

def _git_env(tmp_path):
    return {'GIT_AUTHOR_NAME': 'ci', 'GIT_AUTHOR_EMAIL': 'ci@x',
            'GIT_COMMITTER_NAME': 'ci', 'GIT_COMMITTER_EMAIL': 'ci@x',
            'HOME': str(tmp_path), 'PATH': os.environ['PATH']}


def _new_repo(tmp_path):
    """A git repo on `main` with a build.yaml whose one step checks that
    ok.txt exists; returns (path, git)."""
    repo = tmp_path / 'repo'
    repo.mkdir()

    def git(*args):
        return subprocess.run(['git', '-C', str(repo), *args], check=True,
                              capture_output=True, text=True,
                              env=_git_env(tmp_path), timeout=60).stdout.strip()

    git('init', '-q', '-b', 'main')
    (repo / 'build.yaml').write_text(
        'steps:\n  - kind: runImage\n    name: test\n'
        '    script: test -f ok.txt\n')
    (repo / 'ok.txt').write_text('base\n')
    git('add', '-A')
    git('commit', '-q', '-m', 'base')
    return repo, git


def _pr(repo, git, branch, path, text, approved=True):
    git('checkout', '-q', '-b', branch, 'main')
    (repo / path).write_text(text)
    git('add', '-A')
    git('commit', '-q', '-m', f'{branch}' + ('\n\nApproved-by: dev'
                                             if approved else ''))
    git('checkout', '-q', 'main')


def test_merge_ready_merges_one_pr_per_call(svc, tmp_path):
    """Two approved, green PRs: the first call merges the oldest and marks
    the other stale (its build tested a main that has moved); it merges
    only after a rebuild against the new main."""
    from hail_tpu_torch.services.ci_service import PRWatcher
    repo, git = _new_repo(tmp_path)
    _pr(repo, git, 'pr/1', 'a.txt', 'a\n')
    _pr(repo, git, 'pr/2', 'b.txt', 'b\n')
    w = PRWatcher(str(repo), CIRunner(f'http://127.0.0.1:{svc.port}'))
    try:
        w.poll()
        w.wait_builds(timeout=WAIT)
        assert {b: r['state'] for b, r in w.prs.items()} == {
            'pr/1': 'success', 'pr/2': 'success'}
        assert w.merge_ready() == ['pr/1']
        assert w.prs['pr/2']['state'] == 'stale'
        assert w.merge_ready() == []
        w.poll()
        w.wait_builds(timeout=WAIT)
        assert w.prs['pr/2']['state'] == 'success'
        assert w.merge_ready() == ['pr/2']
        assert {'pr/1', 'pr/2'} <= set(git('log', '--format=%s',
                                           'main').split('\n'))
        assert (repo / 'a.txt').exists() and (repo / 'b.txt').exists()
    finally:
        w.close()


def test_conflicting_merge_leaves_the_checkout_alone(svc, tmp_path):
    """A green, approved PR that conflicts with a commit made on main after
    its build: merge_ready merges nothing, marks it 'merge_conflict', and
    the watched checkout keeps its branch, its uncommitted edit and no
    merge in progress; main does not move."""
    from hail_tpu_torch.services.ci_service import PRWatcher
    repo, git = _new_repo(tmp_path)
    _pr(repo, git, 'pr/1', 'ok.txt', 'from the PR\n')
    w = PRWatcher(str(repo), CIRunner(f'http://127.0.0.1:{svc.port}'))
    try:
        w.poll()
        w.wait_builds(timeout=WAIT)
        assert w.prs['pr/1']['state'] == 'success'
        (repo / 'ok.txt').write_text('from main\n')
        git('commit', '-q', '-am', 'main moves')
        git('checkout', '-q', '-b', 'work')
        (repo / 'notes.txt').write_text('uncommitted\n')
        main_before = git('rev-parse', 'main')
        assert w.merge_ready() == []
        assert w.prs['pr/1']['state'] == 'merge_conflict'
        assert git('symbolic-ref', 'HEAD') == 'refs/heads/work'
        assert git('rev-parse', 'main') == main_before
        assert git('status', '--porcelain') == '?? notes.txt'
        assert (repo / 'notes.txt').read_text() == 'uncommitted\n'
        assert not (repo / '.git' / 'MERGE_HEAD').exists()
    finally:
        w.close()


def test_shell_metacharacters_in_branch_and_workdir(svc, tmp_path):
    """A branch whose name holds `$(...)` builds, and nothing in its name
    runs: the build's workdir keeps only [A-Za-z0-9._-] and the step's `cd`
    quotes it. A workdir with `$(...)` in its own name is quoted too. (Had
    either run, it would have made a file beside $HOME.)"""
    from hail_tpu_torch.services.ci_service import PRWatcher
    repo, git = _new_repo(tmp_path)
    branch = 'pr/x$(touch${IFS}${HOME}-branch)'
    _pr(repo, git, branch, 'c.txt', 'c\n')
    runner = CIRunner(f'http://127.0.0.1:{svc.port}')
    w = PRWatcher(str(repo), runner)
    try:
        w.poll()
        w.wait_builds(timeout=WAIT)
        assert w.prs[branch]['state'] == 'success'
        assert '$' not in w.prs[branch]['workdir']
    finally:
        w.close()
    odd = tmp_path / 'w$(touch${IFS}${HOME}-workdir)'
    odd.mkdir()
    (odd / 'ok.txt').write_text('x\n')
    bid = runner.submit(parse_build_yaml(
        'steps:\n  - {kind: runImage, name: t, script: test -f ok.txt}\n'),
        workdir=str(odd))
    assert runner.client.wait(bid, timeout=WAIT)['state'] == 'success'
    home = os.environ['HOME']
    assert not os.path.exists(home + '-branch')
    assert not os.path.exists(home + '-workdir')


def test_database_call_inside_a_transaction(tmp_path):
    """A plain db.* call awaited inside `async with db.transaction()` joins
    the transaction and finishes (the reference's waited forever on a lock
    the transaction held); a call from another task waits for the
    transaction to end, and a rollback takes the joined write with it."""
    import asyncio
    from hail_tpu_torch.services.database import Database

    async def run():
        db = await Database().async_init(str(tmp_path / 'db.sqlite'))
        await db.just_execute('CREATE TABLE t (k TEXT PRIMARY KEY, v INT)')
        seen = []

        async def other():
            seen.append(await db.execute_and_fetchone(
                'SELECT COUNT(*) AS n FROM t'))

        async with db.transaction() as tx:
            await tx.execute_insertone('INSERT INTO t VALUES (?, ?)', ('a', 1))
            task = asyncio.create_task(other())
            await asyncio.wait_for(db.just_execute(
                'UPDATE t SET v = v + 1 WHERE k = ?', ('a',)), timeout=5)
            row = await asyncio.wait_for(db.execute_and_fetchone(
                'SELECT v FROM t WHERE k = ?', ('a',)), timeout=5)
            assert row['v'] == 2
            rows = [r async for r in db.execute_and_fetchall(
                'SELECT k FROM t')]
            assert rows == [{'k': 'a'}]
            await asyncio.sleep(0.05)
            assert seen == []            # the other task waits for the end
        await asyncio.wait_for(task, timeout=5)
        assert seen == [{'n': 1}]
        with pytest.raises(RuntimeError):
            async with db.transaction():
                await db.execute_insertone('INSERT INTO t VALUES (?, ?)',
                                           ('b', 5))
                raise RuntimeError('roll back')
        row = await db.execute_and_fetchone('SELECT COUNT(*) AS n FROM t')
        assert row['n'] == 1
        await db.async_close()

    asyncio.run(asyncio.wait_for(run(), timeout=30))
