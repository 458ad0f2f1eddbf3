"""The port's device mesh (`hail_tpu_torch.parallel.mesh`) against
hail_tpu's on the CPU: the reference on its 8 virtual devices, the port on
meshes of `[cpu] * k`. `pick_2d_spec` equals the reference's for a grid of
shapes on meshes of 1, 2, 4 and 8; the meshes have the same shapes; and
`shard_2d`, `replicate` and `shard_rows` put on each slot exactly the
block the reference puts on the matching device, each a copy, which
reassemble to the input bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt
from hail_tpu.parallel import mesh as ref_mesh
from hail_tpu_torch.parallel import mesh as port_mesh

CPU = torch.device('cpu')
SIZES = [1, 2, 4, 8]
SHAPES = [(1, 1), (2, 3), (3, 7), (4, 4), (6, 10), (7, 11), (8, 8), (8, 12),
          (12, 8), (16, 5), (5, 16), (9, 9), (10, 4), (64, 48), (100, 3)]


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def meshes(k):
    return (port_mesh.get_mesh([CPU] * k),
            ref_mesh.get_mesh(jax.devices()[:k]))


@pytest.mark.parametrize('k', SIZES)
def test_mesh_shape_equals_reference(k):
    port, ref = meshes(k)
    assert port.devices.shape == ref.devices.shape
    assert port.size == k and port.flat == [CPU] * k


@pytest.mark.parametrize('k', SIZES)
def test_pick_2d_spec_equals_reference(k):
    port, ref = meshes(k)
    for shape in SHAPES:
        got = port_mesh.pick_2d_spec(shape, port)
        want = ref_mesh.pick_2d_spec(shape, ref)
        assert tuple(got) == tuple(want), (shape, got, want)


def _blocks_equal_reference(got, want, x, k):
    """Each slot's block is the reference device's shard, bit for bit."""
    assert isinstance(got, port_mesh.Sharded)
    devs = jax.devices()[:k]
    for shard in want.addressable_shards:
        s = devs.index(shard.device)
        r0, r1, c0, c1 = got.span(s)
        rs, cs = shard.index
        assert (r0, r1) == rs.indices(x.shape[0])[:2]
        assert (c0, c1) == cs.indices(x.shape[1])[:2]
        assert got.shards[s].device == CPU
        np.testing.assert_array_equal(got.shards[s].numpy(),
                                      np.asarray(shard.data))
    ptrs = [t.data_ptr() for t in got.shards if t.numel()]
    assert len(set(ptrs)) == len(ptrs)          # no two slots alias
    np.testing.assert_array_equal(got.to_numpy(), x)
    np.testing.assert_array_equal(got.assemble().numpy(), x)


@pytest.mark.parametrize('k', [2, 4, 8])
@pytest.mark.parametrize('fn', ['shard_2d', 'replicate', 'shard_rows'])
def test_layouts_equal_reference(k, fn):
    port, ref = meshes(k)
    rng = np.random.default_rng(k)
    for shape in [(8, 8), (16, 24), (6, 10), (3, 7)]:
        if fn == 'shard_rows' and shape[0] % k:
            continue                   # jax refuses an uneven committed split
        x = rng.normal(size=shape)
        got = getattr(port_mesh, fn)(torch.from_numpy(x), port)
        want = getattr(ref_mesh, fn)(x, ref)
        _blocks_equal_reference(got, want, x, k)
        if fn == 'shard_2d':
            assert tuple(got.spec) == tuple(want.sharding.spec)


def test_one_device_mesh_gives_a_plain_tensor():
    port, _ = meshes(1)
    x = np.arange(12.0).reshape(3, 4)
    for fn in ('shard_2d', 'replicate', 'shard_rows'):
        got = getattr(port_mesh, fn)(x, port)
        assert isinstance(got, torch.Tensor) and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), x)
    held = port_mesh.shard_2d(x, port)
    x[0, 0] = 99.0                     # a host array is copied in
    assert held[0, 0] == 0.0


def test_default_mesh_is_cached_and_reset(monkeypatch):
    port_mesh.reset_mesh()
    m = port_mesh.get_mesh()
    assert m.flat == [CPU] and port_mesh.get_mesh() is m
    assert port_mesh.n_devices() == 1
    eight = port_mesh.get_mesh([CPU] * 8)
    monkeypatch.setattr(port_mesh, '_mesh_cache', eight)
    assert port_mesh.get_mesh() is eight and port_mesh.n_devices() == 8
    port_mesh.reset_mesh()
    assert port_mesh.get_mesh() is not eight


def test_sharded_transpose_region_and_write():
    port, _ = meshes(8)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 24))
    s = port_mesh.shard_2d(x, port)
    t = s.T
    assert tuple(t.spec) == ('y', 'x') and t.shape == (24, 16)
    np.testing.assert_array_equal(t.to_numpy(), x.T)
    np.testing.assert_array_equal(s.region(3, 13, 5, 22, CPU).numpy(),
                                  x[3:13, 5:22])
    e = port_mesh.Sharded.empty((16, 24), s.spec, port, torch.float64)
    e.write(0, 0, torch.from_numpy(x[:5]))
    e.write(5, 0, torch.from_numpy(x[5:]))
    np.testing.assert_array_equal(e.to_numpy(), x)
