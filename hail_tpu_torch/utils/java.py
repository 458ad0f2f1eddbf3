"""Shim of the reference's `hail.utils.java` surface (reference
`hail/python/hail/utils/java.py`): the pieces its own test harness imports
(`test/hail/helpers.py:10`, `conftest.py:12`). There is no JVM here — `Env`
maps onto the session singleton in hail_tpu.context."""

from __future__ import annotations

import logging
import os
import sys


# single error hierarchy shared with hail_tpu.utils (the reference's
# FatalError lives here in utils/java.py; ours is defined in utils.misc and
# re-exported so `except FatalError` catches regardless of import path)
from .misc import FatalError, HailUserError  # noqa: F401


def choose_backend(backend: str | None = None) -> str:
    """Reference resolution order: explicit arg → HAIL_QUERY_BACKEND env →
    config → default. The default is 'spark' exactly as in the reference:
    hl.init maps 'spark' onto the thread-pool local backend, and the
    reference test harness's backend-conditional xfails/skips (e.g.
    `fails_local_backend`) then apply the same way they do upstream."""
    return (backend
            or os.environ.get('HAIL_QUERY_BACKEND')
            or 'spark')


def info(msg: str) -> None:
    logging.getLogger('hail').info(msg)
    print(msg, file=sys.stderr)


def warning(msg: str) -> None:
    logging.getLogger('hail').warning(msg)
    print(msg, file=sys.stderr)


def error(msg: str) -> None:
    logging.getLogger('hail').error(msg)
    print(msg, file=sys.stderr)


def __getattr__(name):
    if name == 'Env':
        from ..context import Env
        return Env
    raise AttributeError(name)


class _CodecSpec:
    """A named buffer/codec spec (reference is.hail.io.BufferSpec JVM
    objects surfaced through scala_object). Our native format compresses
    every partition with numpy's deflate; the names are accepted by
    write(_codec_spec=...) for API parity and all decode identically."""

    def __init__(self, name: str):
        self._name = name

    def toString(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return self._name


class _BufferSpecs:
    def specs(self):
        return [_CodecSpec('{"name":"LEB128BufferSpec","child":'
                           '{"name":"BlockingBufferSpec","blockSize":32768,'
                           '"child":{"name":"ZstdBlockBufferSpec",'
                           '"blockSize":32768}}}'),
                _CodecSpec('{"name":"LEB128BufferSpec","child":'
                           '{"name":"BlockingBufferSpec","blockSize":32768,'
                           '"child":{"name":"LZ4FastBlockBufferSpec",'
                           '"blockSize":32768}}}'),
                _CodecSpec('{"name":"StreamBufferSpec"}')]


def scala_object(jpackage, name):
    """JVM object accessor (reference utils/java.py scala_object). There is
    no JVM here; the known objects tests touch are emulated."""
    if name == 'BufferSpec':
        return _BufferSpecs()
    raise NotImplementedError(f'scala_object: no JVM in hail_tpu ({name})')
