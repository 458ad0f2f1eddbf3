"""Device mesh and sharding helpers (port of hail_tpu/parallel/mesh.py).

The reference lays a 2-D `jax.sharding.Mesh` over its devices and lets XLA
move the shards. Here a mesh is a 2-D grid of explicit `torch.device`s
with axes ('x', 'y'), and a sharded matrix is a `Sharded` value: one block
per mesh slot, each a tensor on that slot's device, laid out by the same
`pick_2d_spec` the reference uses. Work on the shards is torch ops on each
block's device, and a block moves between devices by `.to(device)`
(NVLink between cards).

A device list may repeat a device: `[torch.device('cpu')] * 8` plays the
part of the reference's eight virtual CPU devices, and `[cuda:0] * 4` runs
the sharded code on one card. Slots that hold the same device still hold
blocks of their own (no two alias).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """How a 2-D array's axes map onto mesh axes, as jax's PartitionSpec:
    each entry is None (not split), a mesh axis name, or a tuple of names
    (split over their product, the first the major). Equal to the
    reference's spec for the same layout, since both are tuples."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return 'PartitionSpec' + tuple.__repr__(self)


P = PartitionSpec


class Mesh:
    """A 2-D grid of torch devices with axes ('x', 'y'). Slot s is the s-th
    device in row-major order (`flat`)."""

    axis_names = ('x', 'y')

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[torch.device]:
        return list(self.devices.ravel())

    def __repr__(self):
        return f'Mesh({self.devices.shape}, {self.flat})'


_mesh_cache: Optional[Mesh] = None


def _factor2(n: int) -> Tuple[int, int]:
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def _default_devices() -> List[torch.device]:
    """Every CUDA device of the process when the session runs on a card, the
    CPU when it runs there. Under a multi-process backend each process keeps
    to its own device: a mesh spanning processes is not ported."""
    from ..context import current_device
    dev = current_device()
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return [dev]
    if dev.type == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def get_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ('x', 'y') mesh over the session's devices (or the given ones;
    a device may repeat). The default mesh is cached until `reset_mesh`."""
    global _mesh_cache
    if devices is None and _mesh_cache is not None:
        return _mesh_cache
    devs = [torch.device(d) for d in
            (devices if devices is not None else _default_devices())]
    a, b = _factor2(len(devs))
    grid = np.empty((a, b), dtype=object)
    for i, d in enumerate(devs):
        grid[i // b, i % b] = d
    mesh = Mesh(grid)
    if devices is None:
        _mesh_cache = mesh
    return mesh


def reset_mesh() -> None:
    global _mesh_cache
    _mesh_cache = None


def n_devices() -> int:
    return get_mesh().size


def pick_2d_spec(shape: Tuple[int, int], mesh: Mesh) -> P:
    """Most-parallel PartitionSpec whose mesh dims divide the array dims.
    Preference order: full 2-D grid, 1-D over all devices, 1-D over one mesh
    axis, replicated (the reference's order, hail_tpu/parallel/mesh.py)."""
    mx, my = (int(mesh.devices.shape[0]), int(mesh.devices.shape[1]))
    n, m = int(shape[0]), int(shape[1])
    for spec, (dn, dm) in (
        (P('x', 'y'), (mx, my)),
        (P('y', 'x'), (my, mx)),
        (P(('x', 'y'), None), (mx * my, 1)),
        (P(None, ('x', 'y')), (1, mx * my)),
        (P('x', None), (mx, 1)),
        (P('y', None), (my, 1)),
        (P(None, 'y'), (1, my)),
        (P(None, 'x'), (1, mx)),
    ):
        if dn <= n and dm <= m and n % dn == 0 and m % dm == 0:
            return spec
    return P()


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _bounds(n: int, k: int) -> List[int]:
    """k blocks of ceil(n / k) (the last ones shorter or empty), as jax
    splits an axis."""
    step = -(-n // k) if n else 0
    return [min(i * step, n) for i in range(k + 1)]


def _layout(shape, spec, mesh: Mesh):
    """(row bounds, column bounds, block (i, j) of each slot). A mesh axis
    that the spec does not name repeats the blocks along it."""
    sizes = dict(zip(Mesh.axis_names, mesh.devices.shape))
    entries = tuple(spec) + (None,) * (2 - len(spec))
    row_axes, col_axes = _axes(entries[0]), _axes(entries[1])
    gr = math.prod(sizes[a] for a in row_axes)
    gc = math.prod(sizes[a] for a in col_axes)

    def block(axes, coord):
        k = 0
        for a in axes:
            k = k * sizes[a] + coord[a]
        return k

    index = []
    for cx in range(sizes['x']):
        for cy in range(sizes['y']):
            coord = {'x': cx, 'y': cy}
            index.append((block(row_axes, coord), block(col_axes, coord)))
    return _bounds(int(shape[0]), gr), _bounds(int(shape[1]), gc), index


class Sharded:
    """A 2-D tensor laid out over a mesh by `spec`: `shards[s]` is the block
    that mesh slot s holds, on that slot's device; `index[s]` is its (row,
    column) block. Only `write`, while a value is being filled, writes
    into blocks; every other operation makes new ones."""

    __slots__ = ('shape', 'spec', 'mesh', 'rows', 'cols', 'index', 'shards')

    def __init__(self, shape, spec, mesh, shards):
        self.shape = (int(shape[0]), int(shape[1]))
        self.spec = P(*spec)
        self.mesh = mesh
        self.rows, self.cols, self.index = _layout(self.shape, spec, mesh)
        self.shards = list(shards)

    @staticmethod
    def plan(shape, spec, mesh):
        """((i, j), r0, r1, c0, c1, device) of each block of the layout,
        with the device of the first slot that holds it."""
        rows, cols, index = _layout(shape, spec, mesh)
        seen = set()
        for (i, j), dev in zip(index, mesh.flat):
            if (i, j) not in seen:
                seen.add((i, j))
                yield (i, j), rows[i], rows[i + 1], cols[j], cols[j + 1], dev

    @classmethod
    def from_blocks(cls, shape, spec, mesh, blocks) -> 'Sharded':
        """`blocks[(i, j)]`, made on the device `plan` gave it, on the first
        slot that holds it; the other slots holding it get copies."""
        _, _, index = _layout(shape, spec, mesh)
        placed = set()
        shards = []
        for ij, dev in zip(index, mesh.flat):
            shards.append(blocks[ij] if ij not in placed
                          else blocks[ij].to(dev, copy=True))
            placed.add(ij)
        return cls(shape, spec, mesh, shards)

    @classmethod
    def build(cls, shape, spec, mesh, fn) -> 'Sharded':
        """`fn(r0, r1, c0, c1, device)` makes each block once, on the first
        slot that holds it; the other slots holding it get copies."""
        return cls.from_blocks(shape, spec, mesh, {
            ij: fn(r0, r1, c0, c1, dev)
            for ij, r0, r1, c0, c1, dev in cls.plan(shape, spec, mesh)})

    @classmethod
    def empty(cls, shape, spec, mesh, dtype) -> 'Sharded':
        return cls.build(shape, spec, mesh, lambda r0, r1, c0, c1, dev:
                         torch.empty((r1 - r0, c1 - c0), dtype=dtype,
                                     device=dev))

    def span(self, s: int) -> Tuple[int, int, int, int]:
        i, j = self.index[s]
        return self.rows[i], self.rows[i + 1], self.cols[j], self.cols[j + 1]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def replicated(self) -> bool:
        return len(set(self.index)) == 1

    def _distinct(self):
        """One slot for each block."""
        seen = set()
        for s, ij in enumerate(self.index):
            if ij not in seen:
                seen.add(ij)
                yield s

    def same_layout(self, other: 'Sharded') -> bool:
        return (self.shape == other.shape and self.spec == other.spec
                and self.mesh is other.mesh)

    def map(self, fn) -> 'Sharded':
        """`fn(block)` on every slot, on its device."""
        return Sharded(self.shape, self.spec, self.mesh,
                       [fn(t) for t in self.shards])

    def map_span(self, fn) -> 'Sharded':
        """`fn(block, r0, r1, c0, c1)` on every slot, on its device."""
        return Sharded(self.shape, self.spec, self.mesh,
                       [fn(t, *self.span(s)) for s, t in enumerate(self.shards)])

    def zip(self, other: 'Sharded', fn) -> 'Sharded':
        """`fn(block, other's block)` on every slot of two alike layouts."""
        return Sharded(self.shape, self.spec, self.mesh,
                       [fn(a, b) for a, b in zip(self.shards, other.shards)])

    @property
    def T(self) -> 'Sharded':
        """The transpose: block (i, j) becomes block (j, i) on the same
        slot, as jax's transpose of a sharded array keeps its shards."""
        entries = tuple(self.spec) + (None,) * (2 - len(self.spec))
        spec = self.spec if self.replicated else P(entries[1], entries[0])
        return Sharded((self.shape[1], self.shape[0]), spec, self.mesh,
                       [t.T for t in self.shards])

    def write(self, r0: int, c0: int, block: torch.Tensor) -> None:
        """Copy `block` into rows r0.. and columns c0.. of every slot it
        meets (used while a matrix is built, before anyone reads it)."""
        r1, c1 = r0 + block.shape[0], c0 + block.shape[1]
        for s, t in enumerate(self.shards):
            a0, a1, b0, b1 = self.span(s)
            lo, hi = max(r0, a0), min(r1, a1)
            left, right = max(c0, b0), min(c1, b1)
            if lo < hi and left < right:
                t[lo - a0:hi - a0, left - b0:right - b0] = \
                    block[lo - r0:hi - r0, left - c0:right - c0].to(t.device)

    def region(self, r0: int, r1: int, c0: int, c1: int,
               device: torch.device) -> torch.Tensor:
        """Rows r0:r1 and columns c0:c1 as one new tensor on `device`,
        gathered from the blocks that hold them."""
        out = torch.empty((r1 - r0, c1 - c0), dtype=self.dtype, device=device)
        for s in self._distinct():
            a0, a1, b0, b1 = self.span(s)
            lo, hi = max(r0, a0), min(r1, a1)
            left, right = max(c0, b0), min(c1, b1)
            if lo < hi and left < right:
                out[lo - r0:hi - r0, left - c0:right - c0] = \
                    self.shards[s][lo - a0:hi - a0, left - b0:right - b0] \
                    .to(device)
        return out

    def assemble(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole matrix as one tensor on `device` (the first slot's by
        default)."""
        if device is None:
            device = self.mesh.flat[0]
        return self.region(0, self.shape[0], 0, self.shape[1], device)

    def to_numpy(self) -> np.ndarray:
        """The whole matrix on the host, block by block."""
        out = np.empty(self.shape, dtype=torch.empty(
            0, dtype=self.dtype).numpy().dtype)
        for s in self._distinct():
            a0, a1, b0, b1 = self.span(s)
            out[a0:a1, b0:b1] = self.shards[s].cpu().numpy()
        return out

    def __repr__(self):
        return (f'Sharded({self.shape}, {self.spec}, '
                f'{len(self.shards)} shards)')


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; anything else copied into a new CPU tensor, so
    that later writes to a host array do not reach what was made of it."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def shard(x, spec, mesh: Mesh):
    """A 2-D array laid out over `mesh` by `spec` (copies of its blocks on
    the slots' devices). On a one-device mesh: a plain tensor there."""
    x = _as_tensor(x)
    if mesh.size == 1:
        return x.to(mesh.flat[0])
    if x.ndim != 2:
        raise ValueError(f'a sharded array is 2-D, found shape {tuple(x.shape)}')
    return Sharded.build(tuple(x.shape), spec, mesh,
                         lambda r0, r1, c0, c1, dev:
                         x[r0:r1, c0:c1].to(dev, copy=True))


def shard_2d(x, mesh: Optional[Mesh] = None):
    """Shard a 2-D array over the ('x', 'y') mesh in the most-parallel
    divisible layout (`pick_2d_spec`). On a one-device mesh: a plain tensor
    on that device."""
    mesh = mesh or get_mesh()
    x = _as_tensor(x)
    return shard(x, pick_2d_spec(tuple(x.shape), mesh) if mesh.size > 1
                 else P(), mesh)


def replicate(x, mesh: Optional[Mesh] = None):
    """A copy of a 2-D array on every slot of the mesh."""
    return shard(x, P(), mesh or get_mesh())


def shard_rows(x, mesh: Optional[Mesh] = None):
    """Axis 0 split over all slots ('x' and 'y' flattened)."""
    return shard(x, P(('x', 'y'),), mesh or get_mesh())
