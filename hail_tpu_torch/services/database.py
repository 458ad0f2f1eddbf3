"""Async Database over sqlite with the reference's call surface
(gear/gear/database.py — there an asyncio MySQL pool with retry; here
sqlite3 driven through the loop's default executor, same method names:
async_init / just_execute / execute_and_fetchall / execute_and_fetchone /
execute_insertone / execute_update / execute_many / async_close)."""

from __future__ import annotations

import asyncio
import sqlite3
import threading
from typing import Any, AsyncIterator, List, Optional, Sequence


class Database:
    def __init__(self):
        self._conn: Optional[sqlite3.Connection] = None
        # one statement at a time on the connection (executor threads)
        self._lock = threading.Lock()
        # the open transaction's lock and the task that holds it
        # (a threading.Lock held across awaits deadlocked a nested db call)
        self._tx_lock = asyncio.Lock()
        self._tx_task: Optional[asyncio.Task] = None

    async def async_init(self, path: str = ':memory:') -> 'Database':
        def connect():
            conn = sqlite3.connect(path, check_same_thread=False)
            conn.row_factory = sqlite3.Row
            return conn
        self._conn = await asyncio.get_running_loop().run_in_executor(None, connect)
        return self

    async def _run(self, fn, commit: bool = False):
        """Run fn on an executor thread with the connection's lock held for
        it alone. Inside the transaction of the calling task, fn joins that
        transaction; otherwise it waits for any open transaction to end and
        then commits if `commit`."""
        loop = asyncio.get_running_loop()
        if self._tx_task is not None and \
                self._tx_task is asyncio.current_task():
            def joined():
                with self._lock:
                    return fn()
            return await loop.run_in_executor(None, joined)

        def alone():
            with self._lock:
                out = fn()
                if commit:
                    self._conn.commit()
                return out
        async with self._tx_lock:
            return await loop.run_in_executor(None, alone)

    async def just_execute(self, sql: str, args: Sequence[Any] = ()) -> None:
        await self._run(lambda: self._conn.execute(sql, args), commit=True)

    async def execute_script(self, script: str) -> None:
        await self._run(lambda: self._conn.executescript(script), commit=True)

    async def execute_and_fetchall(self, sql: str,
                                   args: Sequence[Any] = ()) -> AsyncIterator[dict]:
        for row in await self._run(
                lambda: self._conn.execute(sql, args).fetchall()):
            yield dict(row)

    async def execute_and_fetchone(self, sql: str,
                                   args: Sequence[Any] = ()) -> Optional[dict]:
        def go():
            r = self._conn.execute(sql, args).fetchone()
            return None if r is None else dict(r)
        return await self._run(go)

    async def execute_insertone(self, sql: str, args: Sequence[Any] = ()) -> int:
        return await self._run(
            lambda: self._conn.execute(sql, args).lastrowid, commit=True)

    async def execute_update(self, sql: str, args: Sequence[Any] = ()) -> int:
        return await self._run(
            lambda: self._conn.execute(sql, args).rowcount, commit=True)

    async def execute_many(self, sql: str,
                           args_list: List[Sequence[Any]]) -> None:
        await self._run(lambda: self._conn.executemany(sql, args_list),
                        commit=True)

    async def async_close(self) -> None:
        if self._conn is not None:
            conn, self._conn = self._conn, None
            await self._run(conn.close)

    def transaction(self) -> 'Transaction':
        """Async context manager running statements atomically (reference
        Database.start(): MySQL transaction with commit/rollback)."""
        return Transaction(self)


class Transaction:
    def __init__(self, db: Database):
        self._db = db

    async def __aenter__(self):
        db = self._db
        await db._tx_lock.acquire()
        db._tx_task = asyncio.current_task()
        try:
            await db._run(lambda: db._conn.execute('BEGIN'))
        except BaseException:
            db._tx_task = None
            db._tx_lock.release()
            raise
        return self

    async def __aexit__(self, exc_type, exc, tb):
        db = self._db
        try:
            await db._run(db._conn.commit if exc_type is None
                          else db._conn.rollback)
        finally:
            db._tx_task = None
            db._tx_lock.release()
        return False

    async def just_execute(self, sql: str, args: Sequence[Any] = ()) -> None:
        await self._db._run(lambda: self._db._conn.execute(sql, args))

    async def execute_and_fetchone(self, sql: str,
                                   args: Sequence[Any] = ()) -> Optional[dict]:
        def go():
            r = self._db._conn.execute(sql, args).fetchone()
            return None if r is None else dict(r)
        return await self._db._run(go)

    async def execute_insertone(self, sql: str, args: Sequence[Any] = ()) -> int:
        def go():
            return self._db._conn.execute(sql, args).lastrowid
        return await self._db._run(go)


def retry_transient_db_errors(f, max_attempts: int = 5,
                              base_delay_s: float = 0.05):
    """Reference gear.database.retry_transient_mysql_errors: retry the
    retryable error class with exponential backoff — here sqlite's
    'database is locked' / 'database table is locked' OperationalErrors."""
    import functools

    @functools.wraps(f)
    async def wrapped(*args, **kwargs):
        delay = base_delay_s
        for attempt in range(max_attempts):
            try:
                return await f(*args, **kwargs)
            except sqlite3.OperationalError as e:
                if 'locked' not in str(e) or attempt == max_attempts - 1:
                    raise
                await asyncio.sleep(delay)
                delay *= 2
    return wrapped
