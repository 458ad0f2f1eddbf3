"""`hail_tpu.fs` — the `hailtop.fs` sync facade (reference
`hailtop/fs/fs_utils.py`): hfs.open/copy/exists/ls/stat/mkdir/remove over the
RouterFS."""

from .router_fs import FS, FileStatus, LocalFS, RouterFS, get_fs, local_path
from .aio import (AsyncFS, LocalAsyncFS, RouterAsyncFS, copy_files,
                  copy_sync, delete_files, delete_sync)


def open(path: str, mode: str = 'r', buffer_size: int = 8192):
    return get_fs().open(path, mode, buffer_size)


def copy(src: str, dest: str) -> None:
    get_fs().copy(src, dest)


def exists(path: str) -> bool:
    return get_fs().exists(path)


def is_file(path: str) -> bool:
    return get_fs().is_file(path)


def is_dir(path: str) -> bool:
    return get_fs().is_dir(path)


def stat(path: str) -> FileStatus:
    return get_fs().stat(path)


def ls(path: str):
    return get_fs().ls(path)


def mkdir(path: str) -> None:
    get_fs().mkdir(path)


def remove(path: str) -> None:
    get_fs().remove(path)


def rmtree(path: str) -> None:
    get_fs().rmtree(path)


__all__ = ['FS', 'FileStatus', 'LocalFS', 'RouterFS', 'get_fs', 'open', 'copy',
           'AsyncFS', 'LocalAsyncFS', 'RouterAsyncFS', 'copy_files', 'copy_sync',
           'delete_files', 'delete_sync',
           'exists', 'is_file', 'is_dir', 'stat', 'ls', 'mkdir', 'remove',
           'rmtree']
