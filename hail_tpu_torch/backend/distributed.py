"""Multihost backend: shard partitions across processes under
`torch.distributed` (port of hail_tpu/backend/distributed.py).

The reference runs under `jax.distributed`; here every process joins one
`torch.distributed` process group. Every process runs the same program;
partition contexts are assigned round-robin by rank; per-partition results
are exchanged as padded uint8 tensors through the group's collectives
(`all_gather`, `all_to_all_single`). The group's backend follows the
session's device: NCCL between cards, each process on its own card, and
gloo between CPU processes. It never switches when one of them fails.

Start one process per rank, each with the same coordinator address:

    hl.init(backend='multihost', coordinator_address='10.0.0.1:29500',
            num_processes=2, process_id=rank)

On a single process this degrades to the thread-pool LocalBackend path,
so the same code runs everywhere.
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .backend import Backend, LocalBackend


class Owned:
    """A partition context pinned to an explicit owner process. Shuffled
    stages ship partitions by ownership rather than round-robin index
    arithmetic: any downstream map_collect routes the partition to the
    process that holds its data."""

    __slots__ = ('owner', 'inner')

    def __init__(self, owner: int, inner):
        self.owner = owner
        self.inner = inner

    def __repr__(self):
        return f'Owned(owner={self.owner}, inner={self.inner!r})'


class MultihostBackend(Backend):
    def __init__(self, coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self._owns_group = False
        if num_processes is not None and num_processes > 1 \
                and not dist.is_initialized():
            if coordinator_address is None or process_id is None:
                raise ValueError('MultihostBackend: num_processes > 1 needs '
                                 'coordinator_address and process_id')
            if device is None:
                from ..context import current_device
                device = current_device()
            dist.init_process_group(
                backend='nccl' if device.type == 'cuda' else 'gloo',
                init_method='tcp://' + coordinator_address,
                world_size=num_processes, rank=process_id)
            self._owns_group = True
        self._local = LocalBackend()

    @property
    def process_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    def _map_collect_impl(self, contexts, fn):
        contexts = list(contexts)
        n_proc = self.process_count
        if n_proc == 1:
            return self._local._map_collect_impl(contexts, fn)
        idxs, local_results = self.map_local(contexts, fn)
        # serialize and allgather across hosts: in the SPMD driver model
        # every process continues the same program, so each needs the merged
        # result (the reference has ONE driver reading per-partition files,
        # ServiceBackend.scala:211-300; here all hosts are the driver).
        payload = pickle.dumps(dict(zip(idxs, local_results)),
                               protocol=pickle.HIGHEST_PROTOCOL)
        gathered = _allgather_bytes(payload)
        merged = {}
        for blob in gathered:
            merged.update(pickle.loads(blob))
        return [merged[i] for i in range(len(contexts))]

    def map_local(self, contexts, fn):
        """Execute only this process's round-robin share of the contexts;
        returns (global indices, results) without any cross-host exchange —
        the building block for shuffles that must NOT centralize data."""
        contexts = list(contexts)
        n_proc = self.process_count
        pid = self.process_index

        def owner(i, c):
            return c.owner if isinstance(c, Owned) else i % n_proc
        mine = [(i, c) for i, c in enumerate(contexts) if owner(i, c) == pid]
        results = self._local._map_collect_impl([c for _, c in mine], fn)
        return [i for i, _ in mine], results

    def owns(self, index: int, ctx=None) -> bool:
        if isinstance(ctx, Owned):
            return ctx.owner == self.process_index
        return index % self.process_count == self.process_index

    def stop(self):
        self._local.stop()
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: this process's
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _gather_lengths(lens: Sequence[int]) -> torch.Tensor:
    """(n_processes, len(lens)) int64: every process's `lens`."""
    dev = _comm_device()
    mine = torch.tensor(list(lens), dtype=torch.int64, device=dev)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return torch.stack(out).cpu()


def alltoall_bytes(payloads: Sequence[bytes]) -> List[bytes]:
    """Per-destination exchange of variable-length byte strings:
    `payloads[j]` is delivered to process j; returns what each process sent
    to *this* one. The lengths are gathered first, then one padded
    (n, max length) uint8 tensor per process rides `all_to_all_single`
    (point-to-point over the collective fabric, not allgather-everything)."""
    n = dist.get_world_size()
    assert len(payloads) == n, (len(payloads), n)
    pid = dist.get_rank()
    all_lens = _gather_lengths([len(p) for p in payloads])     # (src, dst)
    maxlen = max(int(all_lens.max()), 1)
    local = torch.zeros((n, maxlen), dtype=torch.uint8)
    for j, p in enumerate(payloads):
        if p:
            local[j, :len(p)] = torch.frombuffer(bytearray(p), dtype=torch.uint8)
    dev = _comm_device()
    recv = torch.empty((n, maxlen), dtype=torch.uint8, device=dev)
    dist.all_to_all_single(recv, local.to(dev))
    recv = recv.cpu().numpy()
    return [recv[i, :int(all_lens[i, pid])].tobytes() for i in range(n)]


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """All-gather variable-length byte strings across processes: the
    lengths first, then one padded uint8 tensor per process."""
    lens = _gather_lengths([len(payload)])[:, 0]
    max_len = max(int(lens.max()), 1)
    buf = torch.zeros(max_len, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    dev = _comm_device()
    buf = buf.to(dev)
    out = [torch.empty_like(buf) for _ in range(len(lens))]
    dist.all_gather(out, buf)
    return [out[i][:int(lens[i])].cpu().numpy().tobytes()
            for i in range(len(lens))]
