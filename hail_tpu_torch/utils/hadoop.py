"""hadoop_* filesystem helpers and temporary-path context managers.

Reference: `hail/python/hail/utils/hadoop_utils.py` (hadoop_open/copy/...)
and `hail/python/hailtop/utils/__init__.py` (TemporaryDirectory,
TemporaryFilename). Here they are thin wrappers over the local/router fs
layer — the zero-egress build has no HDFS/cloud buckets, but the API shape
(and scheme routing hooks in `hail_tpu.fs.router_fs`) is preserved.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, List

from .. import fs as _fs


def hadoop_open(path: str, mode: str = 'r', buffer_size: int = 8192):
    """Open a file through the fs layer; `.gz` paths are transparently
    (de)compressed like the reference."""
    if path.endswith(('.gz', '.bgz')):
        binary = 'b' in mode
        gz_mode = mode if binary else mode.replace('t', '') + 't'
        return gzip.open(path, gz_mode)
    return _fs.open(path, mode, buffer_size)


def hadoop_copy(src: str, dest: str) -> None:
    _fs.copy(src, dest)


def hadoop_exists(path: str) -> bool:
    return _fs.exists(path)


def hadoop_is_file(path: str) -> bool:
    return _fs.is_file(path)


def hadoop_is_dir(path: str) -> bool:
    return _fs.is_dir(path)


def hadoop_stat(path: str) -> Dict[str, Any]:
    st = _fs.stat(path)
    return {
        'path': getattr(st, 'path', path),
        'size_bytes': getattr(st, 'size', None),
        'size': str(getattr(st, 'size', '')),
        'is_dir': _fs.is_dir(path),
        'modification_time': getattr(st, 'modification_time', None),
        'owner': getattr(st, 'owner', None),
    }


def hadoop_ls(path: str) -> List[Dict[str, Any]]:
    entries = _fs.ls(path)
    out = []
    for e in entries:
        p = getattr(e, 'path', e)
        out.append(hadoop_stat(p))
    return out


def hadoop_scheme_supported(scheme: str) -> bool:
    """Only local file access is available in this build."""
    return scheme in ('', 'file')


class TemporaryFilename:
    """Async-style context manager yielding a fresh temporary file path,
    removed on exit (reference hailtop.TemporaryFilename). Usable both as a
    sync and an async context manager."""

    def __init__(self, prefix: str = '', suffix: str = '', dir: str = None):
        d = dir or tempfile.gettempdir()
        self.name = os.path.join(d, f'{prefix}{uuid.uuid4().hex}{suffix}')

    def __enter__(self) -> str:
        return self.name

    def __exit__(self, *exc) -> None:
        try:
            if os.path.exists(self.name):
                os.remove(self.name)
        except OSError:
            pass

    async def __aenter__(self) -> str:
        return self.name

    async def __aexit__(self, *exc) -> None:
        self.__exit__()


class TemporaryDirectory:
    """Context manager yielding a fresh temporary directory path, recursively
    removed on exit (reference hailtop.TemporaryDirectory)."""

    def __init__(self, prefix: str = '', suffix: str = '', dir: str = None,
                 ensure_exists: bool = True):
        d = dir or tempfile.gettempdir()
        self.name = os.path.join(d, f'{prefix}{uuid.uuid4().hex}{suffix}')
        if ensure_exists:
            os.makedirs(self.name, exist_ok=True)

    def __enter__(self) -> str:
        return self.name

    def __exit__(self, *exc) -> None:
        shutil.rmtree(self.name, ignore_errors=True)

    async def __aenter__(self) -> str:
        return self.name

    async def __aexit__(self, *exc) -> None:
        self.__exit__()
