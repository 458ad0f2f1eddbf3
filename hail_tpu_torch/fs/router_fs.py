"""Filesystem abstraction: FS ABC + LocalFS + RouterFS (scheme dispatch).

Capability parity with the reference's two FS stacks — Scala
`is/hail/io/fs/{FS,RouterFS}.scala` and Python
`hailtop/aiotools/router_fs.py:13` / `hailtop/fs/fs_utils.py` — collapsed to
one host-side layer. Cloud schemes (gs://, s3://, https://) route through
fsspec when the relevant driver is installed; the zero-egress build supports
file:// and bare paths natively.
"""

from __future__ import annotations

import glob as _glob
import os
import shutil
import time
from dataclasses import dataclass
from typing import IO, List, Optional


class _BoolFlag(int):
    """A bool usable both as a value (`if st.is_dir`) and a method
    (`st.is_dir()`) — the reference's FileListEntry exposes is_dir() as a
    method while older call sites read it as an attribute."""

    def __call__(self) -> bool:
        return bool(self)

    def __repr__(self) -> str:
        return repr(bool(self))


@dataclass
class FileStatus:
    path: str
    size: int
    is_dir: bool
    modification_time: Optional[float] = None

    def __post_init__(self):
        self.is_dir = _BoolFlag(bool(self.is_dir))

    # reference FileListEntry API
    def is_file(self) -> bool:
        return not self.is_dir

    async def url(self) -> str:
        """Async accessor (reference FileListEntry.url)."""
        return self.path

    @property
    def typ(self) -> str:
        return 'dir' if self.is_dir else 'file'


class FS:
    """Abstract filesystem (reference `io/fs/FS.scala` trait)."""

    def open(self, path: str, mode: str = 'r', buffer_size: int = 8192) -> IO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def is_file(self, path: str) -> bool:
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        raise NotImplementedError

    def stat(self, path: str) -> FileStatus:
        raise NotImplementedError

    def ls(self, path: str) -> List[FileStatus]:
        raise NotImplementedError

    def mkdir(self, path: str) -> None:
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def rmtree(self, path: str) -> None:
        raise NotImplementedError

    def copy(self, src: str, dest: str) -> None:
        with self.open(src, 'rb') as f_in, self.open(dest, 'wb') as f_out:
            shutil.copyfileobj(f_in, f_out)


class LocalFS(FS):
    @staticmethod
    def _strip(path: str) -> str:
        if path.startswith('file://'):
            return path[7:]
        return path

    def open(self, path: str, mode: str = 'r', buffer_size: int = 8192) -> IO:
        path = self._strip(path)
        if 'w' in mode or 'a' in mode:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or '.', exist_ok=True)
        if path.endswith('.gz') or path.endswith('.bgz'):
            import gzip
            return gzip.open(path, mode if 'b' in mode else mode + 't')
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def is_file(self, path: str) -> bool:
        return os.path.isfile(self._strip(path))

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(self._strip(path))

    def stat(self, path: str) -> FileStatus:
        p = self._strip(path)
        st = os.stat(p)
        return FileStatus(path, st.st_size, os.path.isdir(p), st.st_mtime)

    def ls(self, path: str) -> List[FileStatus]:
        p = self._strip(path)
        if _glob.has_magic(p):
            return [self.stat(m) for m in sorted(_glob.glob(p))]
        if os.path.isdir(p):
            return [self.stat(os.path.join(p, name)) for name in sorted(os.listdir(p))]
        return [self.stat(p)]

    def mkdir(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def remove(self, path: str) -> None:
        os.remove(self._strip(path))

    def rmtree(self, path: str) -> None:
        p = self._strip(path)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)

    def copy(self, src: str, dest: str) -> None:
        s, d = self._strip(src), self._strip(dest)
        os.makedirs(os.path.dirname(os.path.abspath(d)) or '.', exist_ok=True)
        if os.path.isdir(s):
            shutil.copytree(s, d, dirs_exist_ok=True)
        else:
            shutil.copyfile(s, d)


class FsspecFS(FS):
    """Cloud schemes via fsspec (gs://, s3://, https://) — available when the
    matching fsspec driver is installed; gated in the zero-egress build."""

    def __init__(self, protocol: str):
        import fsspec
        self._fs = fsspec.filesystem(protocol)
        self.protocol = protocol

    def open(self, path, mode='r', buffer_size=8192):
        return self._fs.open(path, mode)

    def exists(self, path):
        return self._fs.exists(path)

    def is_file(self, path):
        return self._fs.isfile(path)

    def is_dir(self, path):
        return self._fs.isdir(path)

    def stat(self, path):
        info = self._fs.info(path)
        return FileStatus(path, info.get('size', 0), info.get('type') == 'directory',
                          info.get('mtime'))

    def ls(self, path):
        return [FileStatus(p if isinstance(p, str) else p['name'],
                           0 if isinstance(p, str) else p.get('size', 0),
                           False if isinstance(p, str) else p.get('type') == 'directory')
                for p in self._fs.ls(path, detail=True)]

    def mkdir(self, path):
        self._fs.mkdirs(path, exist_ok=True)

    def remove(self, path):
        self._fs.rm(path)

    def rmtree(self, path):
        self._fs.rm(path, recursive=True)


class RouterFS(FS):
    """Scheme-dispatching FS (reference `io/fs/RouterFS.scala`,
    `hailtop/aiotools/router_fs.py:13`)."""

    def __init__(self):
        self._local = LocalFS()
        self._cache = {}

    def _route(self, path: str) -> FS:
        if '://' not in path or path.startswith('file://'):
            return self._local
        scheme = path.split('://', 1)[0]
        if scheme not in self._cache:
            if scheme == 's3' and os.environ.get('HAIL_TPU_S3_ENDPOINT'):
                # native S3-compatible driver (fs/s3_fs.py) — works against
                # AWS/minio/the in-repo mock, no SDK or fsspec needed
                from .s3_fs import S3FS
                self._cache[scheme] = S3FS()
                return self._cache[scheme]
            if not os.environ.get('HAIL_TPU_ENABLE_CLOUD_FS'):
                raise ValueError(
                    f'scheme {scheme!r} is not available in this build: cloud '
                    f'filesystems require network egress (set '
                    f'HAIL_TPU_ENABLE_CLOUD_FS=1 to route {scheme}:// through '
                    f'fsspec in a connected environment)')
            try:
                self._cache[scheme] = FsspecFS(scheme)
            except Exception as e:
                raise ValueError(
                    f'scheme {scheme!r} is not available in this build '
                    f'(no egress / missing fsspec driver): {e}') from None
        return self._cache[scheme]

    def open(self, path, mode='r', buffer_size=8192):
        return self._route(path).open(path, mode, buffer_size)

    def exists(self, path):
        return self._route(path).exists(path)

    def is_file(self, path):
        return self._route(path).is_file(path)

    def is_dir(self, path):
        return self._route(path).is_dir(path)

    def stat(self, path):
        return self._route(path).stat(path)

    def ls(self, path):
        return self._route(path).ls(path)

    def mkdir(self, path):
        return self._route(path).mkdir(path)

    def remove(self, path):
        return self._route(path).remove(path)

    def rmtree(self, path):
        return self._route(path).rmtree(path)

    def copy(self, src: str, dest: str):
        sfs, dfs = self._route(src), self._route(dest)
        if sfs is dfs:
            return sfs.copy(src, dest)
        with sfs.open(src, 'rb') as f_in, dfs.open(dest, 'wb') as f_out:
            shutil.copyfileobj(f_in, f_out)


_router: Optional[RouterFS] = None


def get_fs() -> RouterFS:
    global _router
    if _router is None:
        _router = RouterFS()
    return _router


def local_path(path) -> str:
    """Validate a user path for direct (locally-materialized) IO and return
    the OS path.

    Writers/readers that build directory trees (native format, BGEN index,
    exports) operate on local paths; any URI scheme must route through the
    RouterFS, which raises for schemes unavailable in this build — matching
    reference `io/fs/RouterFS.scala` semantics, where an unconfigured scheme
    is an error rather than a silent local write.
    """
    if not isinstance(path, str) or '://' not in path:
        return path
    if path.startswith('file://'):
        return path[len('file://'):]
    fs = get_fs()._route(path)  # raises ValueError when the scheme is unavailable
    raise ValueError(
        f'path {path!r} routes to the non-local filesystem {fs!r}: this '
        f'operation materializes a local directory tree and does not support '
        f'direct cloud IO; write locally and copy with hailtop.fs')
