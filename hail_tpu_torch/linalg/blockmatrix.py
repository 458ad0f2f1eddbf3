"""BlockMatrix: dense f64 linear algebra sharded over the device mesh.

Port of hail_tpu/linalg/blockmatrix.py (capability parity with reference
`hail/python/hail/linalg/blockmatrix.py:75`). The matrix is stored at rest
over `parallel.mesh.get_mesh()`, laid out by the reference's
`pick_2d_spec`: on a mesh of more than one slot a `Sharded` value (one
float64 block per slot, each on its slot's device), on a one-device mesh
one float64 tensor on that device. Constructors, the elementwise
operators, `sparsify_*`, `T` and `@` (`_sharded_matmul`: output block
(i, j) is A's row block i times B's column block j on the slot that holds
it) work block by block; the other methods read `_data`, the matrix
assembled on the mesh's first device, and shard their result again.
Sparsify ops apply element masks, as the reference's do. `write` / `read`
keep the reference's on-disk format (`data.npy` + `metadata.json`), so a
matrix written by either package is read by the other.

The torch default dtype is float32: every tensor made here is float64
explicitly (the reference turns on jax x64 for the whole process).
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import Sharded, get_mesh, pick_2d_spec, shard_2d

DEFAULT_BLOCK_SIZE = 4096  # API parity: reference BlockMatrix.scala:107


def _device() -> torch.device:
    from ..context import current_device
    return current_device()


def _shard_at_rest(data):
    """Commit a matrix to float64 storage over the mesh. A `Sharded` value
    over more than one slot and not replicated is kept in place (op results
    come out laid out already); anything else is copied in (a host array
    always, so later writes to it do not reach the matrix)."""
    if isinstance(data, Sharded):
        if data.mesh.size > 1 and not data.replicated:
            return data
        data = data.shards[0]
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(np.asarray(data, dtype=np.float64))
    return shard_2d(data.to(torch.float64))


def _empty(shape: Tuple[int, int]):
    """Uninitialized float64 storage for a matrix of `shape` on the mesh,
    filled with `_write` before any read."""
    mesh = get_mesh()
    if mesh.size == 1:
        return torch.empty(shape, dtype=torch.float64, device=mesh.flat[0])
    return Sharded.empty(shape, pick_2d_spec(shape, mesh), mesh,
                         torch.float64)


def _write(store, r0: int, c0: int, block: torch.Tensor) -> None:
    if isinstance(store, Sharded):
        store.write(r0, c0, block)
    else:
        store[r0:r0 + block.shape[0], c0:c0 + block.shape[1]] = \
            block.to(store.device)


def _region(x, r0, r1, c0, c1, device) -> torch.Tensor:
    """Rows r0:r1, columns c0:c1 of a tensor or a `Sharded` on `device`."""
    if isinstance(x, Sharded):
        return x.region(r0, r1, c0, c1, device)
    return x[r0:r1, c0:c1].to(device)


def _piece(o, r0, r1, c0, c1, device):
    """The part of an operand `o` that meets block rows r0:r1, columns c0:c1
    under numpy broadcasting, on `device` (a Python number as it is)."""
    if not isinstance(o, torch.Tensor):
        return o
    if o.ndim == 2 and o.shape[0] != 1:
        o = o[r0:r1]
    if o.ndim >= 1 and o.shape[-1] != 1:
        o = o[..., c0:c1]
    return o.to(device)


class BlockMatrix:
    """Storage (`_store`) is sharded over the mesh at construction, one
    float64 tensor on a one-device mesh; every operation returns a new
    matrix (no method writes into the storage)."""

    def __init__(self, data, block_size: int = DEFAULT_BLOCK_SIZE,
                 _sparse: bool = False):
        self._store = _shard_at_rest(data)
        self._block_size = block_size
        # storage stays dense (zeroed dropped blocks); the flag tracks the
        # logical state, as in the reference
        self._sparse = _sparse

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_numpy(cls, ndarray: np.ndarray, block_size: int = DEFAULT_BLOCK_SIZE) -> 'BlockMatrix':
        arr = np.asarray(ndarray, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        return cls(arr, block_size)

    @classmethod
    def fill(cls, n_rows: int, n_cols: int, value: float,
             block_size: int = DEFAULT_BLOCK_SIZE) -> 'BlockMatrix':
        mesh = get_mesh()
        shape = (n_rows, n_cols)

        def full(r0, r1, c0, c1, dev):
            return torch.full((r1 - r0, c1 - c0), float(value),
                              dtype=torch.float64, device=dev)
        if mesh.size == 1:
            return cls(full(0, n_rows, 0, n_cols, mesh.flat[0]), block_size)
        return cls(Sharded.build(shape, pick_2d_spec(shape, mesh), mesh, full),
                   block_size)

    @classmethod
    def _create(cls, n_rows: int, n_cols: int, data, block_size: int = DEFAULT_BLOCK_SIZE) -> 'BlockMatrix':
        """Build from a row-major flat list (reference BlockMatrix._create)."""
        arr = np.asarray(list(data), dtype=np.float64).reshape(n_rows, n_cols)
        return cls(arr, block_size)

    def _sparsify_blocks(self, blocks) -> 'BlockMatrix':
        """Keep only the listed blocks (COLUMN-major block indexing like the
        reference GridPartitioner: block b = (b % n_block_rows,
        b // n_block_rows)); dropped blocks are zeroed in dense storage."""
        n, m = self.shape
        bs = self._block_size
        nbr = math.ceil(n / bs)
        mask = np.zeros((n, m), dtype=bool)
        for b in blocks:
            bi, bj = b % nbr, b // nbr
            mask[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = True
        return self._masked(_host_mask(mask), sparse=True)

    def _map_dense(self, f) -> 'BlockMatrix':
        """Apply an expression-level function elementwise, including to
        zeroed blocks (reference BlockMatrix._map_dense)."""
        from ..expr import functions as F
        arr = self.to_numpy()
        flat = F.literal([float(v) for v in arr.ravel()])
        out = F.eval_expr(flat.map(f))
        return BlockMatrix(np.asarray(out, dtype=np.float64).reshape(arr.shape),
                           self._block_size)

    _map_sparse = _map_dense

    @classmethod
    def random(cls, n_rows: int, n_cols: int, block_size: int = DEFAULT_BLOCK_SIZE,
               seed: Optional[int] = None, gaussian: bool = True) -> 'BlockMatrix':
        """Standard normal (or uniform on [0, 1)) entries from a
        torch.Generator on the mesh's first device, seeded by `seed` or, if
        None, by the session's seed sequence, then sharded: equal seeds give
        equal matrices on every mesh. The values are torch's, not
        jax.random's."""
        if seed is None:
            from ..context import Env
            seed = Env.next_seed()
        dev = get_mesh().flat[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        draw = torch.randn if gaussian else torch.rand
        return cls(draw((n_rows, n_cols), generator=gen, dtype=torch.float64,
                        device=dev), block_size)

    @classmethod
    def from_entry_expr(cls, entry_expr, mean_impute: bool = False, center: bool = False,
                        normalize: bool = False, block_size: int = DEFAULT_BLOCK_SIZE) -> 'BlockMatrix':
        """Build an (n_rows, n_cols) matrix from a MatrixTable entry expression
        (reference `blockmatrix.py` from_entry_expr → `entries_to_bm`).

        STREAMS partitions into the mesh's blocks: a first pass records the
        per-partition row counts, then each partition is evaluated,
        imputed/centered/normalized (all row-local) on the host, copied into
        the blocks its rows meet (on their devices) and released — peak
        host memory is one partition, never the full f64 matrix."""
        from ..expr.expression import to_expr
        from ..matrixtable import MatrixTable
        from ..methods.statgen import _eval_entry_f64

        e = to_expr(entry_expr)
        mt = e._indices.source
        if mt is None or not isinstance(mt, MatrixTable):
            raise ValueError('entry expression must come from a MatrixTable')
        st = mt._stage

        def process(G, M):
            if mean_impute:
                cnt = (~M).sum(axis=1)
                s = np.where(M, 0, G).sum(axis=1)
                mean = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
                G = np.where(M, mean[:, None], G)
            elif M.any():
                raise ValueError('Cannot construct an ndarray with missing values: use mean_impute=True or filter first')
            if center:
                G = G - G.mean(axis=1, keepdims=True)
            if normalize:
                norms = np.sqrt((G * G).sum(axis=1, keepdims=True))
                G = np.where(norms > 0, G / norms, 0.0)
            return G

        # pass 1: per-partition row counts (partitions memoized by
        # ir/memcache where they fit)
        n_parts = len(st.contexts)
        counts = [st.materialize_partition(i).n_rows for i in range(n_parts)]
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        out = _empty((int(starts[-1]), st.n_cols))
        for i in range(n_parts):
            mb = st.materialize_partition(i)
            G, M = _eval_entry_f64(mt, e, mb, i)
            G = process(np.asarray(G, dtype=np.float64), M)
            _write(out, int(starts[i]), 0,
                   torch.from_numpy(np.ascontiguousarray(G)))
            del G
        return cls(out, block_size)

    @classmethod
    def read(cls, path: str) -> 'BlockMatrix':
        from ..fs import local_path
        path = local_path(path)
        with open(os.path.join(path, 'metadata.json')) as f:
            meta = json.load(f)
        arr = np.load(os.path.join(path, 'data.npy'))
        return cls(arr, meta.get('block_size', DEFAULT_BLOCK_SIZE))

    def write(self, path: str, overwrite: bool = False, force_row_major: bool = False,
              stage_locally: bool = False) -> None:
        from ..fs import local_path
        path = local_path(path)
        if os.path.exists(path):
            if not overwrite:
                from ..utils.misc import FatalError
                raise FatalError(f'path exists: {path}')
            import shutil
            shutil.rmtree(path)
        os.makedirs(path)
        # C order, as the reference's host copy always is: a transposed
        # tensor's host view is Fortran-ordered, and np.save would say so
        np.save(os.path.join(path, 'data.npy'),
                np.ascontiguousarray(self.to_numpy()))
        with open(os.path.join(path, 'metadata.json'), 'w') as f:
            json.dump({'shape': list(self.shape), 'block_size': self._block_size}, f)

    @staticmethod
    def write_from_entry_expr(entry_expr, path: str, overwrite: bool = False,
                              mean_impute: bool = False, center: bool = False,
                              normalize: bool = False,
                              block_size: int = DEFAULT_BLOCK_SIZE) -> None:
        BlockMatrix.from_entry_expr(entry_expr, mean_impute, center, normalize,
                                    block_size).write(path, overwrite)

    # -- properties --------------------------------------------------------
    @property
    def _data(self) -> torch.Tensor:
        """The whole matrix as one tensor: the storage itself on a one-device
        mesh, else assembled on the mesh's first device (a new tensor)."""
        s = self._store
        if isinstance(s, Sharded):
            return s.shards[0] if s.replicated else s.assemble()
        return s

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self._store.shape)

    @property
    def n_rows(self) -> int:
        return self._store.shape[0]

    @property
    def n_cols(self) -> int:
        return self._store.shape[1]

    @property
    def is_sparse(self) -> bool:
        return self._sparse

    @property
    def T(self) -> 'BlockMatrix':
        return BlockMatrix(self._store.T, self._block_size)

    def transpose(self) -> 'BlockMatrix':
        return self.T

    # -- element-wise ops --------------------------------------------------
    def _coerce(self, other):
        """An operand as a `Sharded`, a float64 tensor or a Python number."""
        if isinstance(other, BlockMatrix):
            return other._store
        if isinstance(other, np.ndarray):
            if other.dtype.kind not in 'ifbu':
                raise TypeError(
                    f'BlockMatrix operand must be numeric, found dtype '
                    f'{other.dtype}')
            return torch.tensor(other, dtype=torch.float64)
        if isinstance(other, torch.Tensor):
            return other.to(torch.float64)
        return other

    def _map(self, fn) -> 'BlockMatrix':
        s = self._store
        return BlockMatrix(s.map(fn) if isinstance(s, Sharded) else fn(s),
                           self._block_size)

    def _elementwise(self, other, fn) -> 'BlockMatrix':
        """`fn(self's entries, other's)` entry by entry (numpy broadcasting):
        block by block where the result keeps this matrix's shape, on the
        assembled matrices where broadcasting widens it."""
        o = self._coerce(other)
        s = self._store
        if isinstance(s, Sharded):
            if isinstance(o, Sharded) and o.same_layout(s):
                return BlockMatrix(s.zip(o, fn), self._block_size)
            if isinstance(o, Sharded):
                o = o.assemble()
            oshape = tuple(o.shape) if isinstance(o, torch.Tensor) else ()
            if torch.broadcast_shapes(s.shape, oshape) == s.shape:
                return BlockMatrix(s.map_span(
                    lambda t, r0, r1, c0, c1:
                    fn(t, _piece(o, r0, r1, c0, c1, t.device))),
                    self._block_size)
            s = s.assemble()
        if isinstance(o, Sharded):
            o = o.assemble()
        if isinstance(o, torch.Tensor):
            o = o.to(s.device)
        return BlockMatrix(fn(s, o), self._block_size)

    def __add__(self, other):
        return self._elementwise(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._elementwise(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._elementwise(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._elementwise(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._elementwise(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._elementwise(other, lambda a, b: b / a)

    def __pow__(self, x):
        return self._map(lambda t: t ** x)

    def __neg__(self):
        return self._map(lambda t: -t)

    def __pos__(self):
        return self

    def abs(self):
        return self._map(torch.abs)

    def sqrt(self):
        return self._map(torch.sqrt)

    def log(self):
        return self._map(torch.log)

    # -- matmul ------------------------------------------------------------
    def __matmul__(self, other) -> 'BlockMatrix':
        o = self._coerce(other)
        if getattr(o, 'ndim', 2) == 2 and self.shape[1] != o.shape[0]:
            raise ValueError(
                f'matmul: inner dimensions mismatch: {self.shape} @ '
                f'{tuple(o.shape)}')
        return BlockMatrix(_sharded_matmul(self._store, o), self._block_size)

    dot = __matmul__

    def tree_matmul(self, other, splits: Optional[int] = None,
                    path_prefix: Optional[str] = None) -> 'BlockMatrix':
        """API parity with reference tree_matmul (inner-dimension
        splitting); `_sharded_matmul` reads whole row and column panels, so
        no tree."""
        return self @ other

    # -- reductions --------------------------------------------------------
    def sum(self, axis: Optional[int] = None):
        if axis is None:
            return float(torch.sum(self._data))
        s = torch.sum(self._data, dim=axis, keepdim=True)
        return BlockMatrix(s, self._block_size)

    def diagonal(self) -> 'BlockMatrix':
        return BlockMatrix(torch.diagonal(self._data).reshape(1, -1),
                           self._block_size)

    # -- indexing / slicing ------------------------------------------------
    @staticmethod
    def _pos_index(i, size, name, allow_size=False):
        """Validate/normalize an index with negative wrap (reference
        BlockMatrix._pos_index)."""
        if 0 <= i < size or (i == size and allow_size):
            return i
        if 0 <= i + size < size:
            return i + size
        raise ValueError(f'invalid {name} {i} for axis of size {size}')

    @staticmethod
    def _range_to_keep(idx, size):
        if isinstance(idx, int):
            p = BlockMatrix._pos_index(idx, size, 'index')
            return slice(p, p + 1, 1)
        if not isinstance(idx, slice):
            raise TypeError('BlockMatrix indices must be int or slice')
        if idx.step is not None and idx.step <= 0:
            raise ValueError(f'slice step must be positive, found {idx.step}')
        start = 0 if idx.start is None else \
            BlockMatrix._pos_index(idx.start, size, 'start index')
        stop = size if idx.stop is None else \
            BlockMatrix._pos_index(idx.stop, size, 'stop index', allow_size=True)
        step = 1 if idx.step is None else idx.step
        if start >= stop:
            raise ValueError(f'slice {start}:{stop}:{step} is empty')
        return slice(start, stop, step)

    def __getitem__(self, idx) -> Union[float, 'BlockMatrix']:
        if not (isinstance(idx, tuple) and len(idx) == 2):
            raise ValueError('tuple of indices or slices must have length two')
        r, c = idx
        n, m = self.shape
        if isinstance(r, int) and isinstance(c, int):
            i = BlockMatrix._pos_index(r, n, 'row index')
            j = BlockMatrix._pos_index(c, m, 'col index')
            return float(_region(self._store, i, i + 1, j, j + 1,
                                 torch.device('cpu')))
        rs = BlockMatrix._range_to_keep(r, n)
        cs = BlockMatrix._range_to_keep(c, m)
        return BlockMatrix(self._data[rs, cs], self._block_size)

    def filter_rows(self, rows: Sequence[int]) -> 'BlockMatrix':
        rows = list(rows)
        n = self.shape[0]
        for i in rows:
            if not (0 <= i < n):
                raise ValueError(f'filter_rows: index {i} out of range for {n} rows')
        data = self._data
        return BlockMatrix(data[_index(rows, data.device)], self._block_size)

    def filter_cols(self, cols: Sequence[int]) -> 'BlockMatrix':
        cols = list(cols)
        m = self.shape[1]
        for j in cols:
            if not (0 <= j < m):
                raise ValueError(f'filter_cols: index {j} out of range for {m} cols')
        data = self._data
        return BlockMatrix(data[:, _index(cols, data.device)], self._block_size)

    def filter(self, rows: Sequence[int], cols: Sequence[int]) -> 'BlockMatrix':
        return self.filter_rows(rows).filter_cols(cols)

    # -- sparsify (element masks; reference zeroes blocks) -----------------
    def _masked(self, mask_of, sparse: bool = False) -> 'BlockMatrix':
        """Entries zeroed where `mask_of(r0, r1, c0, c1, device)`, the mask
        of rows r0:r1 and columns c0:c1, is False, block by block."""
        def keep(t, r0, r1, c0, c1):
            return torch.where(mask_of(r0, r1, c0, c1, t.device), t, 0.0)
        s = self._store
        out = (s.map_span(keep) if isinstance(s, Sharded)
               else keep(s, 0, s.shape[0], 0, s.shape[1]))
        return BlockMatrix(out, self._block_size, _sparse=sparse)

    def sparsify_band(self, lower: int = 0, upper: int = 0,
                      blocks_only: bool = False) -> 'BlockMatrix':
        bs = self._block_size

        def mask_of(r0, r1, c0, c1, dev):
            i = torch.arange(r0, r1, device=dev).reshape(-1, 1)
            j = torch.arange(c0, c1, device=dev).reshape(1, -1)
            if blocks_only:
                bi, bj = i // bs, j // bs
                lo = (bj * bs) - (bi * bs + bs - 1)
                hi = (bj * bs + bs - 1) - (bi * bs)
                return (hi >= lower) & (lo <= upper)
            d = j - i
            return (d >= lower) & (d <= upper)
        return self._masked(mask_of)

    def sparsify_triangle(self, lower: bool = False, blocks_only: bool = False) -> 'BlockMatrix':
        n, m = self.shape
        if lower:
            return self.sparsify_band(lower=-(n + m), upper=0, blocks_only=blocks_only)
        return self.sparsify_band(lower=0, upper=n + m, blocks_only=blocks_only)

    def sparsify_row_intervals(self, starts: Sequence[int], stops: Sequence[int],
                               blocks_only: bool = False) -> 'BlockMatrix':
        n, m = self.shape
        starts_a = np.asarray(list(starts), dtype=np.int64)
        stops_a = np.asarray(list(stops), dtype=np.int64)
        if blocks_only:
            # keep whole blocks touched by any row's interval (reference
            # sparsify_row_intervals blocks_only semantics)
            j = np.arange(m).reshape(1, -1)
            mask = (j >= starts_a[:, None]) & (j < stops_a[:, None])
            return self._masked(_host_mask(self._block_hull(mask)),
                                sparse=True)

        def mask_of(r0, r1, c0, c1, dev):
            j = torch.arange(c0, c1, device=dev).reshape(1, -1)
            lo = torch.from_numpy(starts_a[r0:r1]).to(dev).reshape(-1, 1)
            hi = torch.from_numpy(stops_a[r0:r1]).to(dev).reshape(-1, 1)
            return (j >= lo) & (j < hi)
        return self._masked(mask_of, sparse=True)

    def _block_hull(self, mask: np.ndarray) -> np.ndarray:
        """Expand an element mask to whole (block_size x block_size) blocks:
        a block is kept if any of its elements is kept."""
        n, m = self.shape
        bs = self._block_size
        nb, mb = math.ceil(n / bs), math.ceil(m / bs)
        em = np.zeros((nb * bs, mb * bs), dtype=bool)
        em[:n, :m] = mask
        blocks = em.reshape(nb, bs, mb, bs).any(axis=(1, 3))
        return np.repeat(np.repeat(blocks, bs, axis=0), bs, axis=1)[:n, :m]

    def sparsify_rectangles(self, rectangles: Sequence[Sequence[int]]) -> 'BlockMatrix':
        """Keep blocks overlapping any rectangle — block granularity, like
        the reference (blockmatrix.py sparsify_rectangles)."""
        n, m = self.shape
        mask = np.zeros((n, m), dtype=bool)
        for (r0, r1, c0, c1) in rectangles:
            mask[r0:r1, c0:c1] = True
        return self._masked(_host_mask(self._block_hull(mask)), sparse=True)

    densify = lambda self: self

    # -- conversions -------------------------------------------------------
    def to_numpy(self, _force_blocking: bool = False) -> np.ndarray:
        s = self._store
        if isinstance(s, Sharded):
            return s.to_numpy()
        a = s.cpu().numpy()
        # on the CPU that is a view of the storage: copy it, so that a
        # caller's writes cannot reach the matrix
        return a.copy() if s.device.type == 'cpu' else a

    def to_ndarray(self):
        return self.to_numpy()

    def cache(self) -> 'BlockMatrix':
        self._store = _shard_at_rest(self._store)
        return self

    def persist(self, storage_level: str = 'MEMORY_AND_DISK') -> 'BlockMatrix':
        return self.cache()

    def unpersist(self) -> 'BlockMatrix':
        return self

    def checkpoint(self, path: str, overwrite: bool = False) -> 'BlockMatrix':
        self.write(path, overwrite)
        return BlockMatrix.read(path)

    def entries(self, keyed: bool = True):
        """Table (i, j, entry) of all entries (reference `entries()`)."""
        from .. import types as httypes
        from ..ir.columns import Batch, PrimitiveColumn
        from ..table import Table, TableStage
        n, m = self.shape
        arr = self.to_numpy()
        i = np.repeat(np.arange(n, dtype=np.int64), m)
        j = np.tile(np.arange(m, dtype=np.int64), n)
        b = Batch({
            'i': PrimitiveColumn(httypes.tint64, i),
            'j': PrimitiveColumn(httypes.tint64, j),
            'entry': PrimitiveColumn(httypes.tfloat64, arr.ravel()),
        }, n * m)
        out = Table(TableStage.from_batches(Batch({}, 1), ['i', 'j'],
                                            b.row_type, [b]))
        from ..ir import relational_ir as _rir
        out._stage.tir = _rir.BlockMatrixToTable()
        return out

    def to_table_row_major(self, n_partitions=None, maximum_cache_memory_in_bytes=None):
        from .. import types as httypes
        from ..ir.columns import Batch, DenseArrayColumn, PrimitiveColumn
        from ..table import Table, TableStage
        n, m = self.shape
        arr = self.to_numpy()
        b = Batch({
            'row_idx': PrimitiveColumn(httypes.tint64, np.arange(n, dtype=np.int64)),
            'entries': DenseArrayColumn(httypes.tarray(httypes.tfloat64), arr,
                                        np.full(n, m, dtype=np.int32)),
        }, n)
        return Table(TableStage.from_batches(Batch({}, 1), ['row_idx'], b.row_type, [b]))

    # -- linalg ------------------------------------------------------------
    def svd(self, compute_uv: bool = True, complexity_bound: int = 8192):
        """SVD with the reference's complexity split (`BlockMatrix.svd`,
        `linalg/BlockMatrix.scala`): below the bound, localize and run
        driver-side LAPACK; above it, the device product builds the smaller
        gramian and the eigendecomposition runs on the host."""
        n, m = self.shape
        if min(n, m) <= 0:
            raise ValueError('svd of empty matrix')
        # reference bound: k*k*min(n,m) complexity heuristic; we localize
        # whenever the full matrix is driver-sized.
        if max(n, m) <= complexity_bound:
            A = self.to_numpy()
            if compute_uv:
                u, s, vt = np.linalg.svd(A, full_matrices=False)
                return u, s, vt
            return np.linalg.svd(A, compute_uv=False)
        # gramian route: the device product builds the small k x k gramian,
        # host eigendecomposition, and the LARGE factor stays a BlockMatrix
        # (reference _svd_gramian contract)
        left = n <= m
        a = (self @ self.T if left else self.T @ self).to_numpy()
        if not compute_uv:
            e = np.linalg.eigvalsh(a)
            e[:np.searchsorted(e, 0.0)] = 0
            return np.flip(np.sqrt(e), axis=0)
        e, w = np.linalg.eigh(a)
        e[:np.searchsorted(e, 0.0)] = 0
        s = np.flip(np.sqrt(e), axis=0)
        w = np.fliplr(w)
        with np.errstate(all='ignore'):
            ws = w / s
        if left:
            return w, s, BlockMatrix.from_numpy(ws.T) @ self
        return self @ BlockMatrix.from_numpy(ws), s, w.T

    # -- export ------------------------------------------------------------
    class _HybridExport:
        """`BlockMatrix.export(path_in, path_out, ...)` is STATIC in the
        reference (linalg/blockmatrix.py:1868, reads a stored matrix);
        called on an instance, it exports the instance."""

        def __get__(self, obj, objtype=None):
            import functools
            return functools.partial(BlockMatrix._export_impl, obj)

    export = _HybridExport()

    def _export_impl(self, *args, path_in: str = None, path_out: str = None,
                     delimiter: str = '\t', header: Optional[str] = None,
                     add_index: bool = False, parallel: Optional[str] = None,
                     partition_size: Optional[int] = None,
                     entries: str = 'full') -> None:
        from ..fs import local_path
        args = list(args)
        if self is None and path_in is None:
            path_in = args.pop(0)
        if args:
            path_out = args.pop(0)
        if args:
            raise TypeError('export: too many positional arguments')
        if path_in is not None:
            bm = BlockMatrix.read(path_in)
            return bm.export(path_out=path_out, delimiter=delimiter,
                             header=header, add_index=add_index,
                             parallel=parallel,
                             partition_size=partition_size, entries=entries)
        path = local_path(path_out)
        arr = self.to_numpy()
        n, m = arr.shape
        import gzip
        op = gzip.open if path.endswith(('.bgz', '.gz')) else open
        with op(path, 'wt') as f:
            if header:
                f.write(header + '\n')
            for i in range(n):
                row = arr[i]
                if entries == 'lower':
                    row = row[:i]
                elif entries == 'strict_lower':
                    row = row[:i]
                elif entries == 'upper':
                    row = row[i:]
                elif entries == 'strict_upper':
                    row = row[i + 1:]
                vals = delimiter.join(repr(float(v)) for v in row)
                if add_index:
                    f.write(f'{i}{delimiter}{vals}\n')
                else:
                    f.write(vals + '\n')

    @staticmethod
    def rectangles_to_numpy(path: str, binary: bool = False):
        """Assemble an ndarray from files written by export_rectangles /
        export_blocks: each `rect-<i>_<r0>-<r1>-<c0>-<c1>` file is placed at
        its bounds; uncovered entries are 0; the result's shape is the max
        upper bound per dimension (reference blockmatrix.py
        rectangles_to_numpy:2292-2363)."""
        import re as _re
        rects = []
        for fname in sorted(os.listdir(path)):
            if fname.endswith('.crc') or fname.startswith(('.', '_')):
                continue
            nums = [int(x) for x in _re.findall(r'\d+', fname)]
            if len(nums) != 5:
                raise ValueError(f'Invalid rectangle file name: {fname}')
            rects.append((nums, os.path.join(path, fname)))
        if not rects:
            return np.zeros((0, 0))
        n_rows = max(r[0][2] for r in rects)
        n_cols = max(r[0][4] for r in rects)
        nd = np.zeros((n_rows, n_cols))
        for (_, r0, r1, c0, c1), fpath in rects:
            if binary:
                data = np.fromfile(fpath).reshape(r1 - r0, c1 - c0)
            else:
                data = np.loadtxt(fpath, ndmin=2)
            nd[r0:r1, c0:c1] = data
        return nd

    def __repr__(self):
        return f'<BlockMatrix {self.n_rows}x{self.n_cols}, block_size={self._block_size}>'

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def element_type(self):
        from .. import types as ht
        return ht.tfloat64

    @staticmethod
    def default_block_size() -> int:
        return DEFAULT_BLOCK_SIZE

    def ceil(self) -> 'BlockMatrix':
        return self._map(torch.ceil)

    def floor(self) -> 'BlockMatrix':
        return self._map(torch.floor)

    def pad(self, n_rows: int, n_cols: int, value: float = 0.0) -> 'BlockMatrix':
        """Pad to (n_rows, n_cols) with `value` (used by blocked algorithms)."""
        r, c = self.shape
        data = self._data
        out = torch.full((n_rows, n_cols), float(value), dtype=torch.float64,
                         device=data.device)
        out[:r, :c] = data
        return BlockMatrix(out, self._block_size)

    @classmethod
    def from_ndarray(cls, nd, block_size: int = None) -> 'BlockMatrix':
        """Build from an ndarray expression or host array (reference
        blockmatrix.py from_ndarray)."""
        from ..expr.expression import Expression
        if isinstance(nd, Expression):
            from ..expr import functions as F
            nd = F.eval_expr(nd)
        return cls.from_numpy(np.asarray(nd, dtype=np.float64),
                              block_size or DEFAULT_BLOCK_SIZE)

    def tofile(self, uri: str) -> None:
        """Write raw row-major float64 data (reference blockmatrix.py
        tofile; readable by numpy.fromfile)."""
        np.asarray(self.to_numpy(), dtype=np.float64).tofile(uri)

    @classmethod
    def fromfile(cls, uri: str, n_rows: int, n_cols: int,
                 block_size: int = None, *, _assert_type=None) -> 'BlockMatrix':
        arr = np.fromfile(uri, dtype=np.float64).reshape(n_rows, n_cols)
        return cls.from_numpy(arr, block_size or DEFAULT_BLOCK_SIZE)

    def export_blocks(self, path_out: str, delimiter: str = '\t',
                      binary: bool = False) -> None:
        """Export each block as its own rect-named file under `path_out` — a
        special case of export_rectangles, same file naming as the reference
        (reference blockmatrix.py export_blocks)."""
        bs = self._block_size
        n_r = (self.n_rows + bs - 1) // bs
        n_c = (self.n_cols + bs - 1) // bs
        rects = [[bi * bs, min((bi + 1) * bs, self.n_rows),
                  bj * bs, min((bj + 1) * bs, self.n_cols)]
                 for bi in range(n_r) for bj in range(n_c)]
        self.export_rectangles(path_out, rects, delimiter, binary)

    def export_rectangles(self, path_out: str, rectangles,
                          delimiter: str = '\t', binary: bool = False) -> None:
        """Export sub-rectangles [r0, r1, c0, c1] as files (reference
        blockmatrix.py export_rectangles)."""
        from ..fs import local_path
        path_out = local_path(path_out)
        os.makedirs(path_out, exist_ok=True)
        arr = self.to_numpy()
        for i, (r0, r1, c0, c1) in enumerate(rectangles):
            blk = arr[r0:r1, c0:c1]
            name = f'rect-{i}_{r0}-{r1}-{c0}-{c1}'
            if binary:
                blk.astype(np.float64).tofile(os.path.join(path_out, name))
            else:
                np.savetxt(os.path.join(path_out, name), blk, delimiter=delimiter)

    def to_matrix_table_row_major(self, n_partitions=None, maximum_cache_memory_in_bytes=None):
        """Entries as a MatrixTable with row_idx/col_idx keys (reference
        blockmatrix.py to_matrix_table_row_major)."""
        from ..matrixtable import MatrixTable, MatrixStage, MatrixBatch
        from ..ir.columns import Batch, PrimitiveColumn
        from .. import types as ht
        arr = self.to_numpy()
        R, Cn = arr.shape
        row_t = ht.tstruct(row_idx=ht.tint64)
        col_t = ht.tstruct(col_idx=ht.tint64)
        ent_t = ht.tstruct(element=ht.tfloat64)
        rows = Batch({'row_idx': PrimitiveColumn(ht.tint64, np.arange(R, dtype=np.int64))}, R)
        cols = Batch({'col_idx': PrimitiveColumn(ht.tint64, np.arange(Cn, dtype=np.int64))}, Cn)
        ents = {'element': PrimitiveColumn(ht.tfloat64, arr)}
        batches = [MatrixBatch(rows, ents)]
        return MatrixTable(MatrixStage.from_batches(
            Batch({}, 1), cols, ['row_idx'], ['col_idx'], row_t, col_t, ent_t,
            batches))

    def join_dim(self, other: 'BlockMatrix') -> int:
        """Shared inner dimension for a matmul with `other`."""
        assert self.shape[1] == other.shape[0]
        return self.shape[1]


def _index(ix: Sequence[int], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(list(ix), dtype=torch.long, device=device)


def _host_mask(mask: np.ndarray):
    """`mask_of` for `BlockMatrix._masked` from a whole host mask."""
    def mask_of(r0, r1, c0, c1, dev):
        return torch.from_numpy(np.ascontiguousarray(mask[r0:r1, c0:c1])) \
            .to(dev)
    return mask_of


def _sharded_matmul(a, b, mesh=None):
    """A @ B laid out over the mesh (the default one unless given) by
    `pick_2d_spec` of the product's shape: output block (i, j) is A's row
    block i times B's column block j, both copied to the device of the slot
    that holds the block and multiplied there (the reference lets XLA
    schedule a SUMMA product over the same at-rest layout). On a one-device
    mesh, one product."""
    mesh = mesh or get_mesh()
    if mesh.size == 1 or getattr(b, 'ndim', 2) != 2:
        if isinstance(a, Sharded):
            a = a.assemble()
        if isinstance(b, Sharded):
            b = b.assemble()
        return a @ (b.to(a.device) if isinstance(b, torch.Tensor) else b)
    k = a.shape[1]
    shape = (a.shape[0], b.shape[1])
    spec = pick_2d_spec(shape, mesh)
    # every panel is gathered before any product is queued: a copy between
    # two cards waits for the work queued on both, so a product queued
    # between two blocks' copies would hold the next card back
    panels = {ij: (_region(a, r0, r1, 0, k, dev), _region(b, 0, k, c0, c1, dev))
              for ij, r0, r1, c0, c1, dev in Sharded.plan(shape, spec, mesh)}
    return Sharded.from_blocks(shape, spec, mesh, {
        ij: pa @ pb for ij, (pa, pb) in panels.items()})


# module-level helpers mirroring hail.linalg utilities
def _jarray_from_ndarray(a):
    """Reference ships the ndarray through a Java array; here the host array
    itself is the exchange format."""
    return np.ascontiguousarray(a).ravel()


def _breeze_from_ndarray(a):
    """Reference converts to a Breeze DenseMatrix; a tensor on the session's
    device is the native dense matrix here (dtype kept)."""
    return torch.as_tensor(np.asarray(a), device=_device())


def _svd(a, full_matrices=True, compute_uv=True, overwrite_a=False,
         check_finite=True):
    """LAPACK-selecting SVD wrapper (reference blockmatrix.py:2658): gesdd,
    falling back to the slower gesvd when the fast driver fails to converge."""
    import scipy.linalg as sla
    try:
        return sla.svd(a, full_matrices=full_matrices, compute_uv=compute_uv,
                       overwrite_a=overwrite_a, check_finite=check_finite,
                       lapack_driver='gesdd')
    except np.linalg.LinAlgError:
        return sla.svd(a, full_matrices=full_matrices, compute_uv=compute_uv,
                       overwrite_a=False, check_finite=check_finite,
                       lapack_driver='gesvd')


def _eigh(a):
    """Symmetric eigendecomposition, lower triangle (reference
    blockmatrix.py:2688). Returns (eigenvalues, eigenvectors) ascending."""
    return np.linalg.eigh(a)
