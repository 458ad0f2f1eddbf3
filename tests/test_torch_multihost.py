"""The port's multihost backend in two real `torch.distributed` processes on
the CPU (gloo), with the four checks of tests/multihost_worker.py:
`alltoall_bytes`, `map_collect`, an aggregation, and a distributed
`order_by` whose range exchange is point-to-point.

This file is its own worker:

    python tests/test_torch_multihost.py <host:port> <n_processes> <rank> [cuda]

With `cuda` each process takes the card of its rank and the group runs on
NCCL (chip_smoke.py runs it so on a host of two cards or more).
"""

import os
import socket
import subprocess
import sys

TIMEOUT_S = 120


def worker(coord: str, n_proc: int, pid: int, device: str = 'cpu') -> None:
    import hail_tpu_torch as hl
    from hail_tpu_torch.backend.distributed import (MultihostBackend,
                                                     alltoall_bytes)
    from hail_tpu_torch.context import Env
    import torch.distributed as dist

    hl.init(backend='multihost', device=device, global_seed=0, quiet=True,
            coordinator_address=coord, num_processes=n_proc, process_id=pid)
    be = Env.backend()
    assert isinstance(be, MultihostBackend) and be.process_count == n_proc
    assert be.process_index == pid
    assert dist.get_backend() == ('nccl' if device == 'cuda' else 'gloo')
    if device == 'cuda':
        assert Env.device().index == pid

    # 1. per-destination byte exchange
    payloads = [f'from{pid}to{j}'.encode() * (j + 1) for j in range(n_proc)]
    got = alltoall_bytes(payloads)
    for i, blob in enumerate(got):
        assert blob == f'from{i}to{pid}'.encode() * (pid + 1), (i, blob)
    print(f'[p{pid}] alltoall ok', flush=True)

    # 2. map_collect merges results from both processes
    res = be.map_collect(list(range(10)), lambda c: c * c)
    assert res == [c * c for c in range(10)], res
    print(f'[p{pid}] map_collect ok', flush=True)

    # 3. aggregation over a partitioned table
    t = hl.utils.range_table(1000, n_partitions=8)
    total = t.aggregate(hl.agg.sum(t.idx))
    assert total == 499500, total
    print(f'[p{pid}] aggregate ok', flush=True)

    # 4. distributed order_by: descending sort via range exchange; the
    # sorted partitions live on their owners
    t2 = t.annotate(neg=999 - t.idx)
    s = t2.order_by('neg')
    rows = s.collect()
    negs = [r.neg for r in rows]
    assert negs == sorted(negs), 'order_by result not sorted'
    assert len(rows) == 1000
    assert [r.idx for r in rows[:3]] == [999, 998, 997], rows[:3]
    print(f'[p{pid}] order_by ok', flush=True)

    hl.stop()
    assert not dist.is_initialized()
    print(f'[p{pid}] ALL OK', flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_two_process_backend():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f'127.0.0.1:{_free_port()}'
    env = dict(os.environ)
    env['PYTHONPATH'] = repo + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, '2', str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=repo)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {i} failed:\n{out}'
        assert f'[p{i}] ALL OK' in out, out


if __name__ == '__main__':
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])
