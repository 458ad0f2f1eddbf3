"""In-memory partition memo: amortizes re-execution of lazy partition
chains across actions.

The reference amortizes repeated work per-request via lowering + compile
caching and relies on Spark block caching / explicit .persist for data
(`ir/Compile.scala:26-77`, TableIR persist). Here every action walks a
Python-closure partition chain, so without a memo a pipeline with N actions
re-evaluates its shared prefix N times. This module memoizes materialized
partitions per (stage, partition) under a global byte budget with LRU
eviction (flag `partition_cache_bytes`, 0 disables). Storage is a global
WeakKeyDictionary — never pickled with stages shipped to service workers,
and a stage's memo dies with the stage."""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

_DEFAULT_CAP = 512 * 1024 * 1024

_lock = threading.RLock()
_memos: 'weakref.WeakKeyDictionary[Any, Dict[int, Any]]' = weakref.WeakKeyDictionary()
# LRU accounting: (stage-ref, part) -> nbytes; OrderedDict end = most recent
_lru: 'OrderedDict[Tuple[int, int], Tuple[weakref.ref, int]]' = OrderedDict()
_total = 0


def _cap() -> int:
    from ..context import Env
    if not Env.is_initialized():
        return _DEFAULT_CAP
    try:
        return int(Env.hc().flags.get('partition_cache_bytes', _DEFAULT_CAP))
    except (TypeError, ValueError):
        return _DEFAULT_CAP


def nbytes_of(obj: Any) -> int:
    """Rough resident size of a Batch / MatrixBatch / column tree."""
    import numpy as np
    seen_bytes = 0
    cols = []
    cls = type(obj).__name__
    if cls == 'MatrixBatch':
        cols.extend(obj.rows.columns.values())
        cols.extend(obj.entries.values())
    elif hasattr(obj, 'columns'):
        cols.extend(obj.columns.values())
    else:
        cols.append(obj)
    while cols:
        c = cols.pop()
        if getattr(c, '_build', None) is not None:
            # an unbuilt DeferredObjectColumn: sized as an object array,
            # not built (reading `values` would build it)
            # (else every memoized partition builds the GLM fit structs)
            seen_bytes += int(np.prod(c.shape)) * 64
            continue
        fields = getattr(c, 'fields', None)
        if fields:
            cols.extend(fields.values())
        for attr in ('values', 'missing', 'contig_idx', 'position',
                     'lengths', 'elem_missing'):
            a = getattr(c, attr, None)
            if isinstance(a, np.ndarray):
                if a.dtype == object:
                    seen_bytes += a.size * 64
                else:
                    seen_bytes += a.nbytes
    return seen_bytes


def _evict_to(cap: int) -> None:
    global _total
    while _total > cap and _lru:
        (_sid, part), (sref, nb) = _lru.popitem(last=False)
        _total -= nb
        stage = sref()
        if stage is not None:
            memo = _memos.get(stage)
            if memo is not None:
                memo.pop(part, None)


def peek(stage: Any, part: int) -> Optional[Any]:
    """The memoized partition, or None."""
    if _cap() <= 0:
        return None
    with _lock:
        memo = _memos.get(stage)
        if memo is not None and part in memo:
            _lru.move_to_end((id(stage), part))
            return memo[part]
    return None


def store(stage: Any, part: int, value: Any) -> None:
    """Insert an already-computed partition into the memo."""
    memoized(stage, part, lambda: value)


def memoized(stage: Any, part: int, compute: Callable[[], Any]) -> Any:
    """Partition `part` of `stage`, via the memo. compute() runs outside the
    lock (partitions materialize concurrently on the backend pool)."""
    cap = _cap()
    if cap <= 0:
        return compute()
    key = (id(stage), part)
    with _lock:
        memo = _memos.get(stage)
        if memo is not None and part in memo:
            _lru.move_to_end(key)
            return memo[part]
    value = compute()
    nb = nbytes_of(value)
    if nb > cap:
        return value
    global _total
    with _lock:
        memo = _memos.get(stage)
        if memo is None:
            memo = {}
            _memos[stage] = memo
        if part not in memo:
            memo[part] = value
            _lru[key] = (weakref.ref(stage, _on_stage_dead(id(stage))), nb)
            _total += nb
            _evict_to(cap)
        return memo[part]


def _on_stage_dead(sid: int):
    def cb(ref):
        global _total
        with _lock:
            for key in [k for k in _lru if k[0] == sid]:
                _, nb = _lru.pop(key)
                _total -= nb
    return cb


def clear() -> None:
    global _total
    with _lock:
        _memos.clear()
        _lru.clear()
        _total = 0


def stats() -> Dict[str, int]:
    with _lock:
        return {'entries': len(_lru), 'bytes': _total}
