"""Async filesystem layer (reference `hailtop/aiotools/`):
AsyncFS ABC (`aiotools/fs/fs.py:254`) with ranged-read streams and
multi-part creates, LocalAsyncFS, RouterAsyncFS (`router_fs.py:13`), and the
bounded-parallelism transfer engine (`aiotools/fs/copier.py`, `delete.py`)
that powers `hailctl fs` and the batch workers.

As in the reference's LocalAsyncFS, local disk IO runs in the default
executor (`blocking_to_async`) — the async value is in the orchestration:
files split into parts copied concurrently under a shared semaphore, many
files in flight, progress accounting."""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

from .router_fs import FS, FileStatus, RouterFS, get_fs, local_path

# part size for multi-part copies (reference AsyncFS.copy_part_size; local
# files use fixed-size parts — cloud FSes override per store)
COPY_PART_SIZE = 8 * 1024 * 1024


class ReadableStream:
    """Async chunked reader over a byte range (reference
    aiotools/fs/stream.py ReadableStream)."""

    def __init__(self, fileobj, length: Optional[int] = None,
                 chunk_size: int = 1 << 20):
        self._f = fileobj
        self._remaining = length
        self._chunk = chunk_size
        self._closed = False

    async def read(self, n: int = -1) -> bytes:
        loop = asyncio.get_running_loop()
        if self._remaining is not None:
            if self._remaining <= 0:
                return b''
            if n < 0 or n > self._remaining:
                n = self._remaining
        data = await loop.run_in_executor(None, self._f.read, n)
        if self._remaining is not None:
            self._remaining -= len(data)
        return data

    async def close(self):
        if not self._closed:
            self._closed = True
            await asyncio.get_running_loop().run_in_executor(None, self._f.close)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()
        return False


class WritableStream:
    """Async chunked writer (reference stream.py WritableStream)."""

    def __init__(self, fileobj):
        self._f = fileobj
        self._closed = False

    async def write(self, data: bytes) -> int:
        return await asyncio.get_running_loop().run_in_executor(
            None, self._f.write, data)

    async def close(self):
        if not self._closed:
            self._closed = True
            await asyncio.get_running_loop().run_in_executor(None, self._f.close)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()
        return False


class MultiPartCreate:
    """Concurrent part-writes assembled into one destination file (reference
    AsyncFS.multi_part_create → MultiPartCreate): the file is created once,
    then each part writes at its own offset with positioned writes, so parts
    proceed in parallel without coordination."""

    def __init__(self, sema: asyncio.Semaphore, path: str, num_parts: int):
        self._sema = sema
        self._path = local_path(path)
        self._num_parts = num_parts
        self._fd: Optional[int] = None

    async def __aenter__(self):
        def make():
            d = os.path.dirname(os.path.abspath(self._path))
            os.makedirs(d, exist_ok=True)
            return os.open(self._path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        self._fd = await asyncio.get_running_loop().run_in_executor(None, make)
        return self

    async def create_part(self, number: int, start: int,
                          size_hint: Optional[int] = None):
        assert self._fd is not None
        fd = self._fd
        offset = start

        class _PartStream:
            async def write(self, data: bytes) -> int:
                nonlocal offset
                n = await asyncio.get_running_loop().run_in_executor(
                    None, os.pwrite, fd, data, offset)
                offset += n
                return n

            async def close(self):
                pass

            async def __aenter__(self):
                return self

            async def __aexit__(self, *exc):
                return False

        return _PartStream()

    async def __aexit__(self, *exc):
        if self._fd is not None:
            await asyncio.get_running_loop().run_in_executor(None, os.close, self._fd)
            self._fd = None
        return False


class AsyncFS:
    """Async facade over a (sync) FS with ranged-read streams and multi-part
    creates. Blocking IO offloads to the default executor, matching the
    reference LocalAsyncFS's blocking_to_async."""

    def __init__(self, fs: Optional[FS] = None):
        self._fs = fs or get_fs()

    @staticmethod
    def copy_part_size(url: str) -> int:
        return COPY_PART_SIZE

    async def _run(self, f, *args):
        return await asyncio.get_running_loop().run_in_executor(None, f, *args)

    async def open(self, path: str, mode: str = 'rb'):
        if mode == 'rb':
            f = await self._run(self._fs.open, path, 'rb')
            return ReadableStream(f)
        return await self._run(self._fs.open, path, mode)

    async def open_from(self, path: str, start: int, *,
                        length: Optional[int] = None) -> ReadableStream:
        """Ranged read stream (reference AsyncFS.open_from)."""
        def opener():
            f = self._fs.open(path, 'rb')
            f.seek(start)
            return f
        f = await self._run(opener)
        return ReadableStream(f, length)

    async def create(self, path: str) -> WritableStream:
        return WritableStream(await self._run(self._fs.open, path, 'wb'))

    async def multi_part_create(self, sema: asyncio.Semaphore, path: str,
                                num_parts: int) -> MultiPartCreate:
        return MultiPartCreate(sema, path, num_parts)

    async def read(self, path: str) -> bytes:
        def r():
            with self._fs.open(path, 'rb') as f:
                return f.read()
        return await self._run(r)

    async def write(self, path: str, data: bytes) -> None:
        def w():
            with self._fs.open(path, 'wb') as f:
                f.write(data)
        await self._run(w)

    async def exists(self, path: str) -> bool:
        return await self._run(self._fs.exists, path)

    async def isfile(self, path: str) -> bool:
        return await self._run(self._fs.is_file, path)

    async def isdir(self, path: str) -> bool:
        return await self._run(self._fs.is_dir, path)

    async def statfile(self, path: str) -> FileStatus:
        return await self._run(self._fs.stat, path)

    async def listfiles(self, path: str):
        """Async iterator of FileListEntry-likes (the reference's AsyncFS
        contract is `async for x in await fs.listfiles(p)`)."""
        entries = await self._run(self._fs.ls, path)

        async def gen():
            for e in entries:
                yield e
        return gen()

    async def mkdir(self, path: str) -> None:
        await self._run(self._fs.mkdir, path)

    async def remove(self, path: str) -> None:
        await self._run(self._fs.remove, path)

    async def rmtree(self, sema, path: str) -> None:
        await self._run(self._fs.rmtree, path)

    async def copy_file(self, src: str, dest: str) -> None:
        await self._run(self._fs.copy, src, dest)

    async def close(self) -> None:
        pass

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()
        return False


class LocalAsyncFS(AsyncFS):
    def __init__(self):
        from .router_fs import LocalFS
        super().__init__(LocalFS())


class RouterAsyncFS(AsyncFS):
    def __init__(self, filesystems=None, **kwargs):
        super().__init__(RouterFS())


class SourceReport:
    """Per-transfer progress accounting (reference copier.py SourceReport)."""

    def __init__(self, source: str):
        self.source = source
        self.files_started = 0
        self.files_finished = 0
        self.files_failed = 0
        self.bytes_copied = 0
        self.exception: Optional[Exception] = None

    def start_files(self, n: int):
        self.files_started += n

    def finish_files(self, n: int, failed: bool = False):
        if failed:
            self.files_failed += n
        else:
            self.files_finished += n

    def finish_bytes(self, n: int):
        self.bytes_copied += n


class Transfer:
    """A copy plan: one or many sources into a destination (reference
    copier.py Transfer). `treat_dest_as` follows the reference: 'dir' forces
    dest to be a directory, 'file' a file, default infers."""

    DEST_DIR = 'dir'
    DEST_IS_TARGET = 'file'
    INFER_DEST = 'infer'

    def __init__(self, src, dest: str, *, treat_dest_as: str = INFER_DEST):
        self.src = src if isinstance(src, list) else [src]
        self.dest = dest
        self.treat_dest_as = treat_dest_as


class Copier:
    """Bounded-parallelism transfer engine (reference copier.py Copier):
    directories expand to their files, large files split into
    `copy_part_size` parts, and every part/file copy runs under one shared
    semaphore so total IO concurrency is capped across the whole plan."""

    def __init__(self, fs: Optional[AsyncFS] = None, *, parallelism: int = 16,
                 part_size: Optional[int] = None):
        self.fs = fs or AsyncFS()
        self.sema = asyncio.Semaphore(parallelism)
        self.part_size = part_size or COPY_PART_SIZE

    async def copy(self, transfers) -> List[SourceReport]:
        if isinstance(transfers, Transfer):
            transfers = [transfers]
        reports: List[SourceReport] = []
        tasks = []
        for t in transfers:
            for src in t.src:
                rep = SourceReport(src)
                reports.append(rep)
                tasks.append(self._copy_source(t, src, rep))
        await asyncio.gather(*tasks)
        for rep in reports:
            if rep.exception is not None:
                raise rep.exception
        return reports

    async def _copy_source(self, t: Transfer, src: str, rep: SourceReport):
        try:
            if await self.fs.isdir(src):
                base = os.path.basename(src.rstrip('/'))
                dest_dir = (t.dest if t.treat_dest_as == Transfer.DEST_IS_TARGET
                            else os.path.join(t.dest, base)
                            if t.treat_dest_as == Transfer.INFER_DEST and len(t.src) > 1
                            else t.dest)
                await self._copy_dir(src, dest_dir, rep)
            else:
                if t.treat_dest_as == Transfer.DEST_DIR or (
                        t.treat_dest_as == Transfer.INFER_DEST
                        and await self.fs.isdir(t.dest)):
                    dest = os.path.join(t.dest, os.path.basename(src))
                else:
                    dest = t.dest
                await self._copy_one(src, dest, rep)
        except Exception as e:  # surfaced after the full gather
            rep.exception = e

    async def _copy_dir(self, src: str, dest: str, rep: SourceReport):
        entries = [e async for e in await self.fs.listfiles(src)]
        tasks = []
        for e in entries:
            name = os.path.basename(e.path.rstrip('/'))
            if getattr(e, 'is_dir', False) or await self.fs.isdir(e.path):
                tasks.append(self._copy_dir(e.path, os.path.join(dest, name), rep))
            else:
                tasks.append(self._copy_one(e.path, os.path.join(dest, name), rep))
        await asyncio.gather(*tasks)

    async def _copy_one(self, src: str, dest: str, rep: SourceReport):
        rep.start_files(1)
        try:
            st = await self.fs.statfile(src)
            size = st.size
            d = os.path.dirname(local_path(dest))
            if d:
                await asyncio.get_running_loop().run_in_executor(
                    None, os.makedirs, d, 0o777, True)
            if size > self.part_size:
                await self._copy_parts(src, dest, size, rep)
            else:
                async with self.sema:
                    data = await self.fs.read(src)
                    await self.fs.write(dest, data)
                    rep.finish_bytes(len(data))
            rep.finish_files(1)
        except Exception:
            rep.finish_files(1, failed=True)
            raise

    async def _copy_parts(self, src: str, dest: str, size: int,
                          rep: SourceReport):
        num_parts = (size + self.part_size - 1) // self.part_size
        async with await self.fs.multi_part_create(
                self.sema, dest, num_parts) as mpc:
            async def one(i: int):
                start = i * self.part_size
                length = min(self.part_size, size - start)
                async with self.sema:
                    async with await self.fs.open_from(
                            src, start, length=length) as rs:
                        part = await mpc.create_part(i, start, size_hint=length)
                        while True:
                            chunk = await rs.read(1 << 20)
                            if not chunk:
                                break
                            await part.write(chunk)
                            rep.finish_bytes(len(chunk))
            await asyncio.gather(*[one(i) for i in range(num_parts)])


async def copy_files(src_dest_pairs, parallelism: int = 16) -> None:
    """Parallel multi-file copy riding the Copier (reference
    `aiotools/copy.py` main engine)."""
    copier = Copier(parallelism=parallelism)
    await copier.copy([Transfer(s, d, treat_dest_as=Transfer.DEST_IS_TARGET)
                       for s, d in src_dest_pairs])


async def delete_files(paths, parallelism: int = 16) -> None:
    """Parallel delete (reference `aiotools/delete.py`)."""
    fs = AsyncFS()
    sem = asyncio.Semaphore(parallelism)

    async def one(p):
        async with sem:
            if await fs.isdir(p):
                await fs.rmtree(None, p)
            elif await fs.exists(p):
                await fs.remove(p)

    await asyncio.gather(*[one(p) for p in paths])


def copy_sync(src_dest_pairs, parallelism: int = 16) -> None:
    asyncio.run(copy_files(src_dest_pairs, parallelism))


def delete_sync(paths, parallelism: int = 16) -> None:
    asyncio.run(delete_files(paths, parallelism))
