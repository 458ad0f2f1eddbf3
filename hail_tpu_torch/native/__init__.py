"""Native (C++) host kernels: BGZF codec + fast VCF GT parser.

Compiled on first use with g++ (cached as a .so next to the source) and
loaded via ctypes — the framework's equivalent of the reference's prebuilt
`libhail.so` (`hail/c/Makefile`, `methods/IBSFFI.scala:21`): host-side native
code where python can't keep the chips fed; device kernels stay in
jax/pallas.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'hail_native.cpp')
_SO = os.path.join(_HERE, '_hail_native.so')
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', '-pthread',
           _SRC, '-o', _SO, '-lz']
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            return r.stderr[:2000]
        return None
    except Exception as e:  # pragma: no cover
        return str(e)


def get_lib():
    """The loaded native library, or None if unavailable (python fallback)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            _build_error = str(e)
            return None
        lib.bgzf_uncompressed_size.restype = ctypes.c_longlong
        lib.bgzf_uncompressed_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.bgzf_decompress.restype = ctypes.c_longlong
        lib.bgzf_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        lib.bgzf_block_table.restype = ctypes.c_longlong
        lib.bgzf_block_table.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.vcf_parse_gt.restype = ctypes.c_longlong
        lib.vcf_parse_gt.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_long, ctypes.c_long,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    return _build_error


def bgzf_decompress(data: bytes, n_threads: int = 4) -> Optional[bytes]:
    """Parallel BGZF decompression; None if data is not BGZF or lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    size = lib.bgzf_uncompressed_size(data, len(data))
    if size < 0:
        return None
    out = ctypes.create_string_buffer(int(size))
    written = lib.bgzf_decompress(data, len(data), out, int(size), n_threads)
    if written < 0:
        return None
    return out.raw[:written]


def bgzf_block_table(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(compressed_offsets, uncompressed_offsets) per BGZF block — the
    virtual-offset index used for seekable access (reference
    BGzipInputStream virtual file offsets)."""
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) // 28 + 2
    in_offs = np.zeros(cap, dtype=np.uint64)
    out_offs = np.zeros(cap, dtype=np.uint64)
    n = lib.bgzf_block_table(data, len(data),
                             in_offs.ctypes.data_as(ctypes.c_void_p),
                             out_offs.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return in_offs[:n], out_offs[:n]


def vcf_parse_gt(text: bytes, n_samples: int, max_lines: int):
    """Fast path: (contigs list, positions int32[n], packed_gt int32[n, s],
    missing bool[n, s]) from an uncompressed VCF body. None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    line_start = np.zeros(max_lines, dtype=np.int64)
    contig_len = np.zeros(max_lines, dtype=np.int64)
    pos = np.zeros(max_lines, dtype=np.int64)
    gt = np.zeros((max_lines, max(n_samples, 1)), dtype=np.int32)
    n = lib.vcf_parse_gt(text, len(text), n_samples, max_lines,
                         line_start.ctypes.data_as(ctypes.c_void_p),
                         contig_len.ctypes.data_as(ctypes.c_void_p),
                         pos.ctypes.data_as(ctypes.c_void_p),
                         gt.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        return None
    n = int(n)
    contigs = [text[line_start[i]:line_start[i] + contig_len[i]].decode()
               for i in range(n)]
    gt = gt[:n]
    missing = gt < 0
    return contigs, pos[:n].astype(np.int32), np.where(missing, 0, gt), missing
