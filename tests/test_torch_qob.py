"""Query-on-Batch in the port (backend/service_backend.py and
backend/qob_worker.py): partitions run as jobs of the single-node Batch
service in workers that run `hail_tpu_torch.backend.qob_worker` on the CPU,
with per-partition retry and failure surfacing, while the driver keeps the
device. The counterparts of tests/test_qob_backend.py's seven cases, then
parity: `linear_regression_rows` under `hl.init(backend='service')` against
the port's local run (equal) and hail_tpu's (rtol 1e-10), a DSL pipeline of
per-partition GWAS jobs against one call (equal), and workers that load
neither jax nor hail_tpu.

Functions that run in a worker are defined inside the tests: cloudpickle
ships those by value, while a function of a test module would be pickled by
reference to a module the worker cannot import. Every stage and wait has
its own time limit (STAGE_TIMEOUT)."""

import os

import numpy as np
import pytest

import hail_tpu as hr
import hail_tpu_torch as hlt
from hail_tpu_torch.backend.service_backend import (
    MAX_CONCURRENT_PARTITION_READS, ServiceBackend, _CarriesDeviceTensor,
    _worker_pickle)
from test_torch_slice import build_mt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_TIMEOUT = 120.0
RTOL = 1e-10


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


@pytest.fixture(scope='module')
def backend():
    b = ServiceBackend(n_workers=4, stage_timeout=STAGE_TIMEOUT)
    yield b
    b.stop()


@pytest.fixture
def service_session():
    """hl.init(backend='service') on the CPU for one test, then the local
    backend again."""
    hlt.init(backend='service', device='cpu', global_seed=0, quiet=True,
             stage_timeout=STAGE_TIMEOUT)
    yield hlt.current_backend()
    hlt.init(device='cpu', global_seed=0, quiet=True)


def test_map_collect_subprocess(backend):
    out = backend.map_collect(list(range(6)), lambda c: c * c)
    assert out == [0, 1, 4, 9, 16, 25]


def test_failure_injection_retry(backend, tmp_path):
    """The first attempt of partition 2 crashes; the service runs it again
    (n_max_attempts=3) and the stage completes."""
    marker = str(tmp_path / 'attempted')

    def fn(c):
        if c == 2 and not os.path.exists(marker):
            open(marker, 'w').close()
            raise RuntimeError('injected transient failure')
        return c + 100

    assert backend.map_collect([0, 1, 2, 3], fn) == [100, 101, 102, 103]
    assert os.path.exists(marker)


def test_permanent_failure_surfaces_log(backend):
    def fn(c):
        if c == 1:
            raise ValueError('partition is cursed')
        return c

    with pytest.raises(RuntimeError, match='partition is cursed'):
        backend.map_collect([0, 1, 2], fn)


def test_inline_threshold(backend):
    # a stage of one partition runs on the driver, in this process
    assert backend.map_collect([41], lambda c: (c + 1, os.getpid())) == [
        (42, os.getpid())]


def test_query_pipeline_on_qob(service_session):
    assert isinstance(service_session, ServiceBackend)
    t = hlt.utils.range_table(60, 6)
    t = t.annotate(y=t.idx % 5)
    g = t.group_by(t.y).aggregate(n=hlt.agg.count())
    assert sorted((r.y, r.n) for r in g.collect()) == [(i, 12)
                                                        for i in range(5)]


def test_streaming_drain_bounded_window(backend):
    """Results are read while the stage runs, through a window of at most
    MAX_CONCURRENT_PARTITION_READS reads."""
    out = backend.map_collect(list(range(12)), lambda c: c * c)
    assert out == [c * c for c in range(12)]
    stats = backend._drain_stats
    assert stats['max_inflight'] <= MAX_CONCURRENT_PARTITION_READS
    # 12 jobs on 4 workers: some results come back before the batch ends
    assert stats['reads_while_running'] > 0


def test_straggler_redrain(backend):
    """A completion listing that misses jobs loses no partition: the pass
    after Success reads whatever the listings missed."""
    real = backend._list_completed_jobs
    dropped = set()

    def racy_listing(bid):
        out = []
        for j in real(bid):
            if j['job_id'] in (2, 5):
                dropped.add(j['job_id'])
                continue
            out.append(j)
        return out

    backend._list_completed_jobs = racy_listing
    try:
        out = backend.map_collect(list(range(8)), lambda c: c + 7)
    finally:
        backend._list_completed_jobs = real
    assert out == [c + 7 for c in range(8)]
    assert dropped == {2, 5}
    assert backend._drain_stats['stragglers'] == 2


# ---------------------------------------------------------------------------
# the port's worker, its session and the driver's device stages
# ---------------------------------------------------------------------------

def test_worker_command_names_the_port(backend):
    """The job runs the port's worker module with the card hidden, in
    another process that did not load jax or hail_tpu."""
    bunches = []
    real = backend.client.create_jobs

    def spy(bid, bunch):
        bunches.append(bunch)
        return real(bid, bunch)

    def probe(c):
        import sys as s
        import torch
        return (os.getpid(), torch.cuda.is_available(),
                os.environ.get('CUDA_VISIBLE_DEVICES'),
                sorted(m for m in ('jax', 'hail_tpu') if m in s.modules))

    backend.client.create_jobs = spy
    try:
        out = backend.map_collect([0, 1], probe)
    finally:
        backend.client.create_jobs = real
    cmds = [job['process']['command'] for job in bunches[0]]
    assert all(c[1:3] == ['-m', 'hail_tpu_torch.backend.qob_worker']
               for c in cmds), cmds
    assert all(job['process']['env'] == {'CUDA_VISIBLE_DEVICES': ''}
               for job in bunches[0])
    assert all(pid != os.getpid() for pid, *_ in out)
    assert [rest for _, *rest in out] == [[False, '', []]] * 2


def test_stage_timeout(tmp_path):
    """`stage_timeout` bounds the wait for a stage (the reference waits
    600 s whatever the caller wants)."""
    b = ServiceBackend(n_workers=2, stage_timeout=1.0)
    try:
        assert b.stage_timeout == 1.0

        def slow(c):
            import time
            time.sleep(30)
            return c

        with pytest.raises(TimeoutError, match='not complete'):
            b.map_collect([0, 1], slow)
    finally:
        b.stop()


def test_device_tensor_stage_runs_on_the_driver(backend):
    """A stage whose function carries a tensor off the CPU (a `meta` tensor
    here; a CUDA one on the card) cannot load in a worker: it runs on the
    driver, and no job is made for it."""
    import torch
    t = torch.empty(3, device='meta')
    with pytest.raises(_CarriesDeviceTensor):
        _worker_pickle(lambda c: t.shape)
    assert _worker_pickle(lambda c: torch.zeros(2)) != b''
    counter = backend._counter
    out = backend.map_collect([0, 1, 2], lambda c: (c, tuple(t.shape),
                                                    os.getpid()))
    assert out == [(c, (3,), os.getpid()) for c in range(3)]
    assert backend._counter == counter


def _gwas(hl_mod, mt):
    res = hl_mod.linear_regression_rows(
        y=mt.pheno, x=mt.GT.n_alt_alleles(), covariates=[1.0, mt.c0, mt.c1])
    return np.array([[r.beta, r.standard_error, r.t_stat, r.p_value]
                     for r in res.collect()])


def test_linreg_on_qob_equals_local_and_reference(tmp_path, monkeypatch):
    """linear_regression_rows over a 4-partition MatrixTable read from
    disk: under the service backend the reads run as four jobs and the
    regression on the driver (its entry pairs are shipped to the device in
    this process); its rows equal the port's local run and hail_tpu's at
    rtol 1e-10."""
    from hail_tpu_torch.methods import statgen
    shipped = []
    real = statgen._ship_gt_pair
    monkeypatch.setattr(statgen, '_ship_gt_pair',
                        lambda *a: shipped.append(os.getpid()) or real(*a))
    path = str(tmp_path / 'g.mt')
    build_mt('hail_tpu_torch', seed=3, rows=40, parts=4).write(path)
    local = _gwas(hlt, hlt.read_matrix_table(path))
    ref = _gwas(hr, build_mt('hail_tpu', seed=3, rows=40, parts=4))
    hlt.init(backend='service', device='cpu', global_seed=0, quiet=True,
             stage_timeout=STAGE_TIMEOUT)
    try:
        be = hlt.current_backend()
        stages = be._counter
        shipped.clear()
        got = _gwas(hlt, hlt.read_matrix_table(path))
        n_jobs = sum(len(be.client.list_jobs(bid))
                     for bid in range(stages + 1, be._counter + 1))
    finally:
        hlt.init(device='cpu', global_seed=0, quiet=True)
    assert be._counter == stages + 1 and n_jobs == 4
    assert shipped == [os.getpid()] * 4
    assert got.shape == (160, 4) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, local)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_workers_load_neither_jax_nor_reference(tmp_path, monkeypatch):
    """Workers that cannot import jax or hail_tpu (a sitecustomize on their
    PYTHONPATH blocks both; the service passes its environment on) still
    read the partitions of a GWAS and answer a probe."""
    site = tmp_path / 'site'
    site.mkdir()
    (site / 'sitecustomize.py').write_text(
        "import sys\nsys.modules['jax'] = None\n"
        "sys.modules['hail_tpu'] = None\n")
    monkeypatch.setenv('PYTHONPATH', os.pathsep.join(
        [str(site), REPO, os.environ.get('PYTHONPATH', '')]).rstrip(os.pathsep))
    path = str(tmp_path / 'g.mt')
    build_mt('hail_tpu_torch', seed=5, rows=24, parts=4).write(path)
    local = _gwas(hlt, hlt.read_matrix_table(path))

    def probe(c):
        import sys as s
        import jax  # noqa: F401  (the sitecustomize makes this fail)
        return s.modules

    hlt.init(backend='service', device='cpu', global_seed=0, quiet=True,
             stage_timeout=STAGE_TIMEOUT)
    try:
        got = _gwas(hlt, hlt.read_matrix_table(path))
        with pytest.raises(RuntimeError, match='import of jax halted'):
            hlt.current_backend().map_collect([0, 1], probe)
    finally:
        hlt.init(device='cpu', global_seed=0, quiet=True)
    np.testing.assert_array_equal(got, local)


def test_init_batch_and_backend_names():
    """init(backend='batch') and init_batch() start the service backend;
    an unknown backend names the three it knows."""
    for start in (lambda: hlt.init(backend='batch', device='cpu', quiet=True,
                                   stage_timeout=STAGE_TIMEOUT),
                  lambda: hlt.init_batch(device='cpu')):
        start()
        try:
            assert isinstance(hlt.current_backend(), ServiceBackend)
            assert hlt.current_device().type == 'cpu'
        finally:
            hlt.init(device='cpu', global_seed=0, quiet=True)
    with pytest.raises(ValueError, match='local, multihost, or service'):
        hlt.init(backend='spark-cluster', device='cpu')
    hlt.init(device='cpu', global_seed=0, quiet=True)


def test_dsl_pipeline_of_gwas_jobs_equals_one_call(tmp_path):
    """A `batch` pipeline on its LocalBackend: four PythonJobs, each a GWAS
    over one partition's rows, run in threads of this process; a BashJob
    reads the file one of them wrote; a gathering job depends on all of
    them. The gathered rows equal one call over every row."""
    mt = build_mt('hail_tpu_torch', seed=7, rows=32, parts=4)
    whole = _gwas(hlt, mt)

    def gwas_part(i, out_path=None):
        part = mt._filter_partitions([i])
        rows = _gwas(hlt, part)
        if out_path is not None:
            with open(out_path, 'w') as f:
                f.write(f'{rows.shape[0]}\n')
        return rows

    b = hlt.batch.Batch(name='gwas')
    jobs = [b.new_python_job(f'part{i}') for i in range(4)]
    results = [j.call(gwas_part, i, j.ofile if i == 0 else None)
               for i, j in enumerate(jobs)]
    bash = b.new_job('count')
    bash.command(f'cat {jobs[0].ofile} > {bash.ofile}')
    gather = b.new_python_job('gather')
    gathered = {}

    def gather_rows(n_rows_file, *parts):
        with open(n_rows_file) as f:
            assert int(f.read()) == parts[0].shape[0]
        gathered['rows'] = np.concatenate(parts)
        return gathered['rows'].shape

    shape = gather.call(gather_rows, bash.ofile, *results)
    dest = str(tmp_path / 'shape.json')
    b.write_output(shape.as_json(), dest)
    run = b.run()
    assert run.status() == {'state': 'success', 'n_jobs': 6, 'n_failed': 0}
    assert set(gather._all_dependencies()) == set(jobs) | {bash}
    with open(dest) as f:
        assert f.read() == '[128, 4]\n'
    np.testing.assert_array_equal(gathered['rows'], whole)
