"""The port's device cache (ops/devcache.py) and batched device-to-host
fetch groups (ops/fetchgroup.py), on CPU tensors."""

import gc

import numpy as np
import pytest
import torch

from hail_tpu_torch.ir import columns as C
from hail_tpu_torch import types as ht
from hail_tpu_torch.ops import devcache, fetchgroup


class Anchor:
    pass


@pytest.fixture(autouse=True)
def _fresh_cache():
    devcache.clear()
    yield
    devcache.clear()


def test_hit_and_miss_by_fingerprint():
    a = Anchor()
    calls = []

    def build():
        calls.append(1)
        return torch.zeros(10)

    b1 = devcache.get(a, ('x',), build)
    b2 = devcache.get(a, ('x',), build)
    assert b2 is b1 and len(calls) == 1
    devcache.get(a, ('y',), build)
    assert len(calls) == 2
    st = devcache.stats()
    assert (st['hits'], st['misses'], st['entries']) == (1, 2, 2)
    assert st['bytes'] == 2 * 10 * 4


def test_anchor_death_evicts():
    a = Anchor()
    devcache.get(a, ('x',), lambda: (torch.zeros(100, dtype=torch.int8),
                                     torch.ones(100, dtype=torch.int8)))
    assert devcache.stats()['entries'] == 1
    assert devcache.stats()['bytes'] == 200
    del a
    gc.collect()
    assert devcache.stats()['entries'] == 0
    assert devcache.stats()['bytes'] == 0


def test_lru_budget_eviction(monkeypatch):
    monkeypatch.setenv('HAIL_TPU_DEVICE_CACHE_BYTES', '4000')
    anchors = [Anchor() for _ in range(4)]
    for i, a in enumerate(anchors):
        devcache.get(a, (i,), lambda: torch.zeros(300, dtype=torch.float64))
    st = devcache.stats()
    assert st['bytes'] <= 4000 and st['entries'] == 1
    # the newest entry survived: a hit, no rebuild
    calls = []
    devcache.get(anchors[3], (3,), lambda: calls.append(1))
    assert not calls
    # the oldest was evicted: a rebuild
    devcache.get(anchors[0], (0,), lambda: calls.append(1))
    assert calls == [1]


def test_zero_budget_disables(monkeypatch):
    monkeypatch.setenv('HAIL_TPU_DEVICE_CACHE_BYTES', '0')
    a = Anchor()
    calls = []

    def build():
        calls.append(1)
        return torch.zeros(5)

    devcache.get(a, ('x',), build)
    devcache.get(a, ('x',), build)
    assert len(calls) == 2 and devcache.stats()['entries'] == 0


def test_unweakrefable_anchor_falls_through():
    out = devcache.get(42, ('x',), lambda: torch.zeros(3))
    assert out.shape == (3,)
    assert devcache.stats()['entries'] == 0


def test_default_cap_sized_for_the_card(monkeypatch):
    monkeypatch.delenv('HAIL_TPU_DEVICE_CACHE_BYTES', raising=False)
    import hail_tpu_torch as hl
    hl.init(device='cpu', quiet=True)
    try:
        assert devcache.stats()['cap'] == 16 * 1024 ** 3
    finally:
        hl.stop()
    assert devcache._cap() == devcache._DEFAULT_CAP == 16 * 1024 ** 3


def test_fetchgroup_one_flush_per_group(monkeypatch):
    cats = []
    real_cat = torch.cat

    def counting_cat(ts, dim=0):
        cats.append(len(ts))
        return real_cat(ts, dim=dim)

    monkeypatch.setattr(torch, 'cat', counting_cat)
    a = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    b = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 100
    c = torch.arange(4, dtype=torch.float32)            # another dtype group
    d = torch.arange(5, dtype=torch.float32) + 7
    s1, s2, s3, s4 = (fetchgroup.defer(t) for t in (a, b, c, d))
    assert fetchgroup.pending_count() == 4
    fetchgroup.flush()
    assert fetchgroup.pending_count() == 0
    assert sorted(cats) == [2, 2]                       # one cat per group
    np.testing.assert_array_equal(s1.get(), np.arange(12.).reshape(4, 3))
    np.testing.assert_array_equal(s2.get(), np.arange(6.).reshape(2, 3) + 100)
    np.testing.assert_array_equal(s3.get(), np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(s4.get(), np.arange(5, dtype=np.float32) + 7)
    assert all(s.dev is None for s in (s1, s2, s3, s4))


def test_slot_get_triggers_flush():
    s = fetchgroup.defer(torch.ones((3, 2)))
    np.testing.assert_array_equal(s.get(), np.ones((3, 2)))
    assert fetchgroup.pending_count() == 0


def test_deferred_primitive_column():
    slot = fetchgroup.defer(torch.arange(10.).reshape(5, 2))
    col = C.DeferredPrimitiveColumn(
        ht.tfloat64, 5, slot, lambda a: (a[:, 1], None))
    assert isinstance(col, C.PrimitiveColumn)
    np.testing.assert_array_equal(col.values, np.arange(10.).reshape(5, 2)[:, 1])
    assert col.missing is None


def test_lazy_transfer_keeps_live_slots_fetchable():
    held = fetchgroup.defer(torch.arange(6, dtype=torch.float64) * 2)
    dropped = fetchgroup.defer(torch.ones(4))
    with fetchgroup.lazy_transfer():
        fetchgroup.stage_end()
    assert held.host is None            # waited for, not transferred
    del dropped
    gc.collect()
    assert fetchgroup.pending_count() == 1
    np.testing.assert_array_equal(held.get(), np.arange(6.) * 2)
    assert fetchgroup.pending_count() == 0


def test_stage_end_flushes_outside_lazy_transfer():
    s = fetchgroup.defer(torch.arange(3.))
    fetchgroup.stage_end()
    assert s.host is not None and s.dev is None
    np.testing.assert_array_equal(s.get(), np.arange(3.))


def test_init_device_selection():
    import hail_tpu_torch as hl
    hl.init(device='cpu', quiet=True)
    try:
        assert hl.current_device() == torch.device('cpu')
        info = hl.debug_info()
        assert info['device'] == 'cpu' and info['torch_version']
        with pytest.raises(ValueError, match='unsupported device'):
            hl.init(device='meta', quiet=True)
        if not torch.cuda.is_available():
            # no card: 'cuda' raises, and so does naming no device; the CPU
            # is only ever the caller's explicit choice
            with pytest.raises(RuntimeError, match='is_available'):
                hl.init(device='cuda', quiet=True)
            with pytest.raises(RuntimeError, match='is_available'):
                hl.init(device=None, quiet=True)
            with pytest.raises(RuntimeError, match='is_available'):
                hl.init(quiet=True)
            assert not hl.context.Env.is_initialized()
    finally:
        hl.stop()


@pytest.fixture
def warmup(monkeypatch):
    """A clean warm-up state: no thread started yet, no kept error, the
    disabling variable unset."""
    from hail_tpu_torch import context
    from hail_tpu_torch.ops import _kernels
    monkeypatch.setattr(context, '_warmup_thread', None)
    monkeypatch.setattr(_kernels, '_warmup_error', None)
    monkeypatch.delenv('HAIL_TPU_NO_WARMUP', raising=False)
    return context, _kernels


def test_warmup_runs_once_on_a_card_and_surfaces_its_failure(warmup,
                                                             monkeypatch):
    """On a card, `hl.init` starts one daemon thread that builds and loads
    the kernels' library; a failure there is not swallowed: the next launch
    raises it, once (the one after it builds again)."""
    context, _kernels = warmup
    built = []

    def broken_build():
        built.append(1)
        raise RuntimeError('nvcc failed (1): broken source')

    monkeypatch.setattr(_kernels, 'library', broken_build)
    dev = torch.device('cuda', 0)
    context._start_device_warmup(dev)
    thread = context._warmup_thread
    assert thread is not None and thread.daemon
    thread.join(30)
    context._start_device_warmup(dev)             # once per process
    assert context._warmup_thread is thread and built == [1]
    with pytest.raises(RuntimeError, match='warm-up at hl.init failed') as e:
        _kernels.launch('hail_unpack_gt_2bit')
    assert 'nvcc failed' in str(e.value.__cause__)
    assert _kernels._warmup_error is None


def test_warmup_does_nothing_on_the_cpu_or_when_disabled(warmup,
                                                         monkeypatch):
    import hail_tpu_torch as hl
    context, _kernels = warmup
    monkeypatch.setattr(_kernels, 'library',
                        lambda: pytest.fail('the warm-up built the kernels'))
    hl.init(device='cpu', quiet=True)
    hl.stop()
    assert context._warmup_thread is None
    monkeypatch.setenv('HAIL_TPU_NO_WARMUP', '1')
    context._start_device_warmup(torch.device('cuda', 0))
    assert context._warmup_thread is None


@pytest.mark.parametrize('method', ['linear_regression_rows',
                                    'logistic_regression_rows',
                                    'poisson_regression_rows',
                                    'identity_by_descent'])
def test_method_without_init_needs_a_card(method):
    """A method called in a process that never chose a device initialises
    Hail itself, on the card: without one it raises what
    `init(device='cuda')` raises and computes nothing on the CPU."""
    import hail_tpu_torch as hl
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the method would run on it')
    hl.init(device='cpu', global_seed=0, quiet=True)
    try:
        mt = hl.balding_nichols_model(2, 12, 10, n_partitions=1)
        mt = mt.annotate_cols(y=hl.rand_unif(0, 1, seed=1))
        mt = mt.annotate_cols(yb=hl.float64(mt.y > 0.5))
        x = mt.GT.n_alt_alleles()
    finally:
        hl.stop()
    calls = {
        'linear_regression_rows': lambda: hl.linear_regression_rows(
            y=mt.y, x=x, covariates=[1.0]),
        'logistic_regression_rows': lambda: hl.logistic_regression_rows(
            'wald', y=mt.yb, x=x, covariates=[1.0]),
        'poisson_regression_rows': lambda: hl.poisson_regression_rows(
            'wald', y=mt.yb, x=x, covariates=[1.0]),
        'identity_by_descent': lambda: hl.identity_by_descent(mt),
    }
    try:
        with pytest.raises(RuntimeError, match='is_available'):
            calls[method]().collect()
        assert not hl.context.Env.is_initialized()
    finally:
        hl.stop()


@pytest.mark.parametrize('N,k,P', [(12, 2, 2), (10000, 4, 1), (33, 3, 5),
                                   (100, 5, 3)])
def test_exact_consts_carry_the_kernel_layout(N, k, P):
    """`exact_consts` builds K3's operand once: Wdig transposed, a row of
    ones after it (the row sums ride along as one more column), zero
    padding to whole 8-column tiles and 16-byte rows."""
    from hail_tpu_torch.ops import linreg_i8 as li
    rng = np.random.default_rng(N)
    Q = np.linalg.qr(rng.normal(size=(N, k)))[0]
    Ys = rng.normal(size=(N, P))
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(0) - (Qty * Qty).sum(0)
    W = li.exact_consts(Q, Ys, Qty, yyp, N - k - 1, 'cpu')[0]
    assert isinstance(W, li.ExactOperand)
    Wdig, WT = W
    C = 7 * (k + P)
    assert tuple(Wdig.shape) == (N, C)
    Cp, ldw = (C // 8 + 1) * 8, -(-N // 16) * 16
    assert WT.dtype == torch.int8 and tuple(WT.shape) == (Cp, ldw)
    assert WT.is_contiguous() and Cp > C and Cp % 8 == 0
    want = np.zeros((Cp, ldw), np.int8)
    want[:C, :N] = Wdig.numpy().T
    want[C, :N] = 1
    np.testing.assert_array_equal(WT.numpy(), want)
    # the reference's constants get the same layout where they enter
    from hail_tpu_torch import interop
    W2 = interop.consts_from_reference(Wdig.numpy(), np.ones((7, k + P)),
                                       Qty, yyp, N - k - 1, 'cpu')[0]
    np.testing.assert_array_equal(W2.WT.numpy(), want)


@pytest.fixture
def cpu_session():
    import hail_tpu_torch as hl
    hl.init(device='cpu', quiet=True)
    yield
    hl.stop()


def _host_column_plane(Cs, Ys):
    """A numpy column plane: the oracle of `_column_plane_device`."""
    Q = np.linalg.qr(Cs)[0] if Cs.shape[1] else np.zeros((Cs.shape[0], 0))
    Qty = Q.T @ Ys
    return Q, Qty, (Ys * Ys).sum(0) - (Qty * Qty).sum(0)


@pytest.mark.parametrize('N,k,P', [(64, 0, 2), (300, 1, 1), (257, 3, 2),
                                   (1003, 26, 16)])
def test_column_plane_device_matches_the_host_route(N, k, P, cpu_session):
    """`statgen._column_plane_device` on CPU tensors (torch.linalg.qr, f64)
    gives the numpy route's projection and yyp, and the statistics made
    from its tensors (`exact_consts` on tensors: `_digit_planes_plain`,
    then the exact pass, or the f64 route's `linreg_stats`) equal those of
    numpy's at rtol 1e-10; k = 0 has no QR at all."""
    from hail_tpu_torch.methods.statgen import _column_plane_device
    from hail_tpu_torch.ops import linreg_i8 as li
    from hail_tpu_torch.ops.regression import linreg_stats
    rng = np.random.default_rng(N + k + P)
    Cs = np.concatenate([np.ones((N, min(k, 1))),
                         rng.normal(size=(N, max(k - 1, 0)))], axis=1)
    Ys = rng.normal(size=(N, P))
    Qh, Qtyh, yyph = _host_column_plane(Cs, Ys)
    Q, Ysd, Qty, yyp = _column_plane_device(Cs, Ys, 'cpu')
    for t in (Q, Ysd, Qty, yyp):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
    assert Q.is_contiguous() and tuple(Q.shape) == (N, k)
    assert tuple(Qty.shape) == (k, P) and tuple(yyp.shape) == (P,)
    assert np.array_equal(Ysd.numpy(), Ys)
    # Q's columns may differ from LAPACK's in sign: compare QQᵀ·Ys
    np.testing.assert_allclose((Q @ Qty).numpy(), Qh @ Qtyh, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(yyp.numpy(), yyph, rtol=1e-10)
    R, d = 40, N - k - 1
    G8 = rng.integers(0, 3, size=(R, N)).astype(np.int8)
    G8[rng.random((R, N)) < 0.05] = -1
    G8 = torch.from_numpy(G8)
    want = li._linreg_block_i8_exact_packed(
        G8, *li.exact_consts(Qh, Ys, Qtyh, yyph, d, 'cpu'), k)
    got = li._linreg_block_i8_exact_packed(
        G8, *li.exact_consts(Q, Ysd, Qty, yyp, d, 'cpu'), k)
    assert np.isfinite(want.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
    G, M = G8.numpy().astype(np.float64), G8.numpy() < 0
    want = linreg_stats(G, M, None, Qh, Ys, Qtyh, yyph, d)
    got = linreg_stats(G, M, None, Q, Ysd, Qty, yyp, d)
    for f, v in want.items():
        np.testing.assert_allclose(got[f], v, rtol=1e-10, err_msg=f)


def test_exact_consts_of_tensors_bypass_the_cache():
    """The constants are made at every call from the column plane's
    tensors, in one `linreg.consts` span each: nothing is kept between
    calls, and nothing of Qty and yyp is copied."""
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.utils import timer
    rng = np.random.default_rng(7)
    Q, Ys, Qty, yyp = statgen._column_plane_device(
        np.concatenate([np.ones((50, 1)), rng.normal(size=(50, 2))], axis=1),
        rng.normal(size=(50, 2)), 'cpu')
    timer.clear()
    with timer.recording(), timer.action():
        a = statgen._exact_consts_cached(Q, Ys, Qty, yyp, 46, 'cpu')
        b = statgen._exact_consts_cached(Q, Ys, Qty, yyp, 46, 'cpu')
    spans = timer.spans()
    timer.clear()
    assert b is not a and b[0].WT is not a[0].WT
    assert torch.equal(a[0].WT, b[0].WT) and a[2] is Qty and a[3] is yyp
    assert [s.attrs for s in spans if s.name == 'linreg.consts'] == [{}, {}]
    assert {s.name for s in spans} == {'linreg.consts', 'consts.planes',
                                       'consts.copy'}
    assert [s.attrs['bytes'] for s in spans if s.name == 'consts.copy'] \
        == [a[1].nbytes] * 2
