"""Semantic hashing of IR trees + the fast-restarts execution cache.

Reference: `is/hail/expr/ir/analyses/SemanticHash.scala` (structural
fingerprint of a lowered IR, used by the `use_fast_restarts` flag to skip
recomputation across driver restarts) and `backend/ExecuteContext` cache
wiring. Here the fingerprint walks the Python IR: node class, scalar
attributes (names, literal values, types), and children, in preorder. Two
expressions with the same semantics-by-construction hash equal; anything
unhashable (closures, tables) poisons the hash and disables caching for that
query, never producing a false hit.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

from .. import types as ht


class Unhashable(Exception):
    pass


def _update(h, *parts):
    for p in parts:
        h.update(str(p).encode())
        h.update(b'\x00')


def semhash(ir) -> Optional[str]:
    """Hex digest of the IR's structural fingerprint, or None when the tree
    contains nodes without stable semantic identity (e.g. host closures)."""
    h = hashlib.blake2b(digest_size=16)
    try:
        _walk(ir, h)
    except Unhashable:
        return None
    return h.hexdigest()


_SCALAR_ATTRS = ('name', 'var', 'accum_var', 'elem_var', 'op', 'field',
                 'fields', 'idx', 'i', 'n')


def _walk(node, h):
    _update(h, type(node).__name__, getattr(node, 'typ', ''))
    # literal values participate directly
    if hasattr(node, 'value'):
        v = node.value
        try:
            _update(h, repr(v))
        except Exception:
            raise Unhashable
    for attr in _SCALAR_ATTRS:
        if hasattr(node, attr):
            a = getattr(node, attr)
            if isinstance(a, (str, int, float, bool, tuple, list)):
                _update(h, attr, a)
    # Apply nodes carry host impls; their registered name is the semantic
    # identity — unnamed/anonymous impls are unhashable
    if type(node).__name__ == 'Apply':
        nm = getattr(node, 'name', None)
        if not nm or nm in ('rand_unif', 'row_index', 'loop'):
            raise Unhashable
    if type(node).__name__ in ('JoinLookup',):
        raise Unhashable  # closes over a table
    children = getattr(node, 'children', ())
    for c in children:
        _walk(c, h)


class ExecutionCache:
    """On-disk memo of evaluated results keyed by semantic hash (reference
    fast-restarts cache). Enabled by the `use_fast_restarts` flag; location
    from the `cachedir` flag (default ~/.cache/hail_tpu_exec)."""

    def __init__(self, cachedir: str):
        self.cachedir = cachedir
        os.makedirs(cachedir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.cachedir, key + '.pkl')

    def lookup(self, key: str):
        p = self._path(key)
        if os.path.exists(p):
            try:
                with open(p, 'rb') as f:
                    return True, pickle.load(f)
            except Exception:
                return False, None
        return False, None

    def put(self, key: str, value) -> None:
        try:
            with open(self._path(key), 'wb') as f:
                pickle.dump(value, f)
        except Exception:
            pass


_cache: Optional[ExecutionCache] = None


def execution_cache() -> Optional[ExecutionCache]:
    """The active cache, or None when fast restarts are disabled."""
    from ..context import Env
    if not Env.is_initialized():
        return None
    flags = Env.hc().flags
    if flags.get('use_fast_restarts', '0') not in ('1', 'true', 'True'):
        return None
    global _cache
    cachedir = flags.get('cachedir') or os.path.expanduser('~/.cache/hail_tpu_exec')
    if _cache is None or _cache.cachedir != cachedir:
        _cache = ExecutionCache(cachedir)
    return _cache
