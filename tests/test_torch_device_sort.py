"""The device tier of the port's distributed sort (`ops/device_sort.py`)
against numpy and hail_tpu, on the CPU: the reference on its 8 virtual
devices, the port on a mesh of `[cpu] * 8` installed in the default mesh's
cache (and on 2 and 3 slots).

`device_range_sort` equals `np.argsort(kind='stable')` for int32, int64,
float32 and float64 keys in both directions, with ties; `Table.order_by`
on one numeric key gives the rows and the partitions (one per slot) of the
reference's device tier and the rows of the port's host tier
(`use_device_sort=0`); the fallback cases of tests/test_device_sort.py
return None; an error of the device tier reaches the caller.
"""

import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt
from hail_tpu_torch.ops import device_sort
from hail_tpu_torch.ops.device_sort import device_range_sort
from hail_tpu_torch.parallel import mesh as port_mesh

from test_torch_sort import plain

CPU = torch.device('cpu')


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


@pytest.fixture(autouse=True)
def eight(monkeypatch):
    """The default mesh: 8 slots on the CPU, as the reference's tests have
    8 virtual devices."""
    mesh = port_mesh.get_mesh([CPU] * 8)
    monkeypatch.setattr(port_mesh, '_mesh_cache', mesh)
    return mesh


@pytest.fixture
def ref(hl):
    """The reference, its device sort on (the default) for the test."""
    old = hl._get_flags('use_device_sort')['use_device_sort']
    hl._set_flags(use_device_sort='1')
    yield hl
    hl._set_flags(use_device_sort=old)


def _want(keys, asc):
    if asc:
        return np.argsort(keys, kind='stable')
    return np.argsort(-keys if keys.dtype.kind == 'f' else ~keys,
                      kind='stable')


@pytest.mark.parametrize('dtype', [np.int32, np.int64, np.float32, np.float64])
@pytest.mark.parametrize('asc', [True, False])
@pytest.mark.parametrize('n', [8, 13, 1000, 10_007])
def test_device_range_sort_is_numpys_stable_argsort(dtype, asc, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-40, 40, n).astype(dtype)        # many ties
    if dtype in (np.float32, np.float64):
        keys = keys * np.asarray(0.37, dtype)
        keys[::5] = -0.0                                 # -0.0 ties 0.0
    order = device_range_sort(keys, asc)
    assert order.dtype == np.int64
    np.testing.assert_array_equal(order, _want(keys, asc))


@pytest.mark.parametrize('slots', [2, 3])
def test_device_range_sort_on_other_meshes(monkeypatch, slots):
    monkeypatch.setattr(port_mesh, '_mesh_cache',
                        port_mesh.get_mesh([CPU] * slots))
    keys = np.random.default_rng(1).integers(0, 50, 5_000).astype(np.int64)
    for asc in (True, False):
        np.testing.assert_array_equal(device_range_sort(keys, asc),
                                      _want(keys, asc))
    extreme = np.array([np.iinfo(np.int64).min, -1, 0, 5,
                        np.iinfo(np.int64).max - 1] * 3)
    np.testing.assert_array_equal(device_range_sort(extreme, True),
                                  _want(extreme, True))


def test_device_range_sort_samples_pivots_past_n_samples():
    keys = np.random.default_rng(2).normal(size=20_000)
    np.testing.assert_array_equal(device_range_sort(keys, True, n_samples=64),
                                  _want(keys, True))


def test_device_sort_fallbacks(monkeypatch):
    """None exactly where the reference's returns None."""
    from hail_tpu.ops.device_sort import device_range_sort as ref_sort
    big = np.iinfo(np.int32).max
    cases = [
        (np.array([1.0, np.nan, 3.0] * 50), True),          # NaN
        (np.array([1, big, 3] * 5, np.int32), True),        # the sentinel
        (np.array([1, -big - 1, 3] * 5, np.int32), False),  # ~x is the sentinel
        (np.arange(20, dtype=np.uint16), True),             # not int or float
        (np.array([True, False] * 8), True),
        (np.arange(7, dtype=np.int64), True),               # fewer keys than slots
    ]
    for keys, asc in cases:
        assert device_range_sort(keys, asc) is None
        assert ref_sort(keys, asc) is None
    monkeypatch.setattr(port_mesh, '_mesh_cache', port_mesh.get_mesh([CPU]))
    assert device_range_sort(np.arange(100), True) is None   # one device


def _table(pkg, dtype):
    t = pkg.utils.range_table(1000, n_partitions=7)
    if dtype == 'int':
        return t.annotate(k=pkg.int32((t.idx * 2654435761) % 10007 - 5000))
    if dtype == 'ties':
        return t.annotate(k=t.idx % 7)
    return t.annotate(k=(pkg.float64(t.idx) * 0.37) % 11.0 - 5.0)


def _partitions(t):
    return [plain(b.columns['idx'].values.tolist())
            for b in t._stage.collect_batches()]


@pytest.mark.parametrize('dtype', ['int', 'float', 'ties'])
@pytest.mark.parametrize('asc', [True, False])
def test_order_by_equals_reference_device_tier(ref, monkeypatch, dtype, asc):
    calls = []
    real = device_sort.device_range_sort
    monkeypatch.setattr(device_sort, 'device_range_sort',
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def sort(pkg):
        t = _table(pkg, dtype)
        return t.order_by(t.k if asc else pkg.desc(t.k))
    got = sort(hlt)
    got_parts = _partitions(got)
    assert calls and len(got_parts) == 8
    want = sort(ref)
    assert got_parts == _partitions(want)
    assert plain(got.collect()) == plain(want.collect())
    hlt._set_flags(use_device_sort='0')
    try:
        host = sort(hlt).collect()
    finally:
        hlt._set_flags(use_device_sort='1')
    assert plain(got.collect()) == plain(host)


def test_order_by_keeps_the_host_tier_where_it_does_not_apply(ref):
    """Missing keys and two keys sort on the host, as in the reference."""
    def cases(pkg):
        t = pkg.utils.range_table(100, n_partitions=4)
        t = t.annotate(k=pkg.if_else(t.idx % 10 == 0, pkg.missing('int32'),
                                     t.idx))
        t2 = pkg.utils.range_table(50, n_partitions=3)
        t2 = t2.annotate(a=t2.idx % 3, b=-t2.idx)
        return [t.order_by(t.k), t2.order_by(t2.a, t2.b)]
    for got, want in zip(cases(hlt), cases(ref)):
        assert plain(got.collect()) == plain(want.collect())


def test_device_tier_errors_reach_the_caller(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError('exchange failed')
    monkeypatch.setattr(device_sort, 'device_range_sort', broken)
    t = _table(hlt, 'int')
    with pytest.raises(RuntimeError, match='exchange failed'):
        t.order_by(t.k).collect()
