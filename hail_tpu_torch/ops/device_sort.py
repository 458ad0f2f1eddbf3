"""Device tier of the distributed sort: a sample-pivot range exchange over
the mesh (port of hail_tpu/ops/device_sort.py).

The reference runs it as a `shard_map` with `lax.all_to_all` over the
default jax mesh (reference `lowering/LowerDistributedSort.scala:161,320-464`:
sample pivots, range-partition, per-range local sort). Here it runs in one
process over the default mesh's slots (`parallel.mesh.get_mesh()`): the
keys are split into one shard per slot, each shard buckets its keys by the
pivots and scatters them into an (nd, cap) send buffer on its device, the
all-to-all is a `.to(device)` copy of each bucket to the slot that owns it,
and each slot sorts what it received stably by key.

The device computes the sorted PERMUTATION, not the row payload motion:
keys and global row ids ride the exchange; the host applies the resulting
id order to the row columns with one gather per output partition. Total
order matches the host sample sort exactly: (key, row id), i.e. a stable
sort in input order.

Applicability (else the caller falls back to the host tier): >1 slot in the
default mesh, a single sort key of a primitive numeric dtype, no missing
values, no NaNs, and no key equal to the padding sentinel.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def device_range_sort(keys: np.ndarray, ascending: bool,
                      n_samples: int = 4096, mesh=None) -> Optional[np.ndarray]:
    """Sorted order of `keys` (global row ids, stable) computed by a range
    exchange over the slots of `mesh` (the default mesh unless given).
    Returns None when the device tier does not apply."""
    from ..parallel.mesh import get_mesh

    devs = (mesh or get_mesh()).flat
    nd = len(devs)
    n = int(keys.shape[0])
    if nd < 2 or n < nd:
        return None
    if keys.dtype.kind == 'f':
        if np.isnan(keys).any():
            return None
        sentinel = np.inf
        k = keys if ascending else -keys
    elif keys.dtype.kind == 'i':
        info = np.iinfo(keys.dtype)
        k = keys if ascending else ~keys     # ~x: exact order reversal
        if (k == info.max).any():
            return None
        sentinel = info.max
    else:
        return None

    # sample pivots on host (plan time, like the reference's samplePartition)
    if n > n_samples:
        rng = np.random.default_rng(0)
        sample = np.sort(k[rng.choice(n, n_samples, replace=False)])
    else:
        sample = np.sort(k)
    pivots = torch.from_numpy(np.asarray(
        [sample[(i + 1) * len(sample) // nd] for i in range(nd - 1)],
        dtype=k.dtype))

    # per shard: a stable bucket assignment, the keys and ids in bucket order
    k_host = torch.from_numpy(np.ascontiguousarray(k))
    local_n = -(-n // nd)
    shards = []
    for s, dev in enumerate(devs):
        lo, hi = min(s * local_n, n), min((s + 1) * local_n, n)
        lk = k_host[lo:hi].to(dev)
        bucket = torch.searchsorted(pivots.to(dev), lk, right=True)
        order = torch.argsort(bucket, stable=True)   # keeps id order in-bucket
        ids = torch.arange(lo, hi, device=dev)
        shards.append((lk[order], ids[order], bucket[order],
                       torch.bincount(bucket, minlength=nd)))
    counts = torch.stack([c.cpu() for *_, c in shards])    # (source, dest)
    cap = max(int(counts.max()), 1)

    # scatter each shard into its (nd, cap) send buffer
    sends = []
    for (sk, si, sb, cnt), dev in zip(shards, devs):
        first = torch.cumsum(cnt, 0) - cnt
        pos = torch.arange(sk.shape[0], device=dev) - first[sb]
        send_k = torch.full((nd, cap), sentinel, dtype=sk.dtype, device=dev)
        send_i = torch.full((nd, cap), -1, dtype=torch.int64, device=dev)
        send_k[sb, pos] = sk
        send_i[sb, pos] = si
        sends.append((send_k, send_i))
    del shards

    # the exchange: slot d receives bucket d of every source, in source
    # order (so ids arrive ascending within equal keys), then sorts stably
    out = []
    for d, dev in enumerate(devs):
        rk = torch.cat([sk[d, :int(counts[s, d])].to(dev)
                        for s, (sk, _) in enumerate(sends)])
        ri = torch.cat([si[d, :int(counts[s, d])].to(dev)
                        for s, (_, si) in enumerate(sends)])
        o = torch.sort(rk, stable=True).indices
        out.append(ri[o].cpu())
    order = torch.cat(out).numpy()
    if order.shape[0] != n:
        raise RuntimeError('device range exchange lost rows')
    return order


def sortable_single_key(batches, specs) -> Optional[Tuple[np.ndarray, bool]]:
    """(concatenated key values, ascending) when `specs` is one primitive
    numeric key with no missing values across `batches`, else None."""
    from ..ir import columns as C
    from .. import types as ht
    if len(specs) != 1:
        return None
    field, asc = specs[0]
    numeric = (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64)
    vals: List[np.ndarray] = []
    for b in batches:
        col = b.columns.get(field)
        if (not isinstance(col, C.PrimitiveColumn) or col.typ not in numeric
                or col.missing is not None):
            return None
        vals.append(col.values)
    return np.concatenate(vals), asc
