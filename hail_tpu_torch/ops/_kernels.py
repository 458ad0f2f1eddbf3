"""Build, load and launch the port's hand-written CUDA kernels.

The sources under `hail_tpu_torch/csrc/` compile with `nvcc` for `sm_90a`
(one nvcc per source, started together, then one link) into one shared
library with a plain C interface, built at first use into
`hail_tpu_torch/_build/<hash of the sources>/` and loaded with ctypes.
Nothing here runs at import: the CPU tests import every module on a
machine without `nvcc` or a card.

Each C entry point returns `cudaGetLastError()` after its launch;
`launch()` raises on a non-zero value, so a refused launch is an error at
the call, not a silent no-op. `launches` counts the launches of each kernel
(the wrappers add one where they launch and nowhere else), so a run can
show that its main path went through the kernels; each launch is also a
`kernel` span on the host (utils/timer.py), with the shape it was given.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

from ..utils import timer

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')
_LIB_NAME = 'libhail_kernels.so'

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C entry point -> argument types (every pointer and the stream last as
# c_void_p, so ctypes never narrows them to 32 bits)
_SIGNATURES = {
    'hail_linreg_exact_pass': [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                               _P, _P, _P],
    'hail_unpack_gt_2bit': [_P, _LL, _I, _I, _P, _P, _P],
    'hail_ibs_counts': [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
    'hail_linreg_i8_sums': [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    'hail_variant_qc': [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P, _P],
    'hail_decode_packed_gt': [_P, _P, _LL, _P, _P, _I, _P],
    'hail_digit_amax': [_P, _I, _P, _I, _I, _P, _P],
    'hail_digit_planes': [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P],
}

launches: Dict[str, int] = {name: 0 for name in _SIGNATURES}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the background warm-up (`warm_up`) raised, kept for the next launch
_warmup_error: Optional[Exception] = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith(('.cu', '.cuh')))


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'hail_tpu_torch/csrc with the CUDA toolkit')


def _build() -> str:
    """Compile the sources (if this hash is not built yet) and return the
    library path. The build writes to a temporary name and renames, so
    concurrent builders never load a half-written library."""
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, 'rb') as f:
            h.update(f.read())
    out_dir = os.path.join(_BUILD, h.hexdigest()[:16])
    lib = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tag = f'{os.getpid()}.tmp'
    tmp = f'{lib}.{tag}'
    nvcc = _nvcc()
    # one nvcc per source, all started together, then one link
    jobs = []
    for p in srcs:
        if p.endswith('.cu'):
            obj = os.path.join(out_dir, f'{os.path.basename(p)}.{tag}.o')
            cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                   '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
                   '-c', '-o', obj, p]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    steps = [(cmd, proc.communicate()[0], proc.returncode)
             for cmd, _, proc in jobs]
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, '-shared', '-o', tmp] + [obj for _, obj, _ in jobs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        steps.append((cmd, res.stdout, res.returncode))
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(out_dir, 'nvcc.log'), 'w') as f:
        for cmd, out, _ in steps:
            f.write(' '.join(cmd) + '\n' + out)
    failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError(f'nvcc failed ({rc}): {" ".join(cmd)}\n{out}')
    os.replace(tmp, lib)
    return lib


def run_bench(name: str) -> list:
    """Build `csrc/bench/<name>.cu` (a program of its own that measures the
    card, not a kernel of the library) and run it: its output lines. Raises
    if it does not build or exits with another code than 0."""
    src = os.path.join(_CSRC, 'bench', f'{name}.cu')
    os.makedirs(_BUILD, exist_ok=True)
    exe = os.path.join(_BUILD, f'{name}.{os.getpid()}')
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-o', exe, src]
    try:
        for step in (cmd, [exe]):
            res = subprocess.run(step, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f'{name}: {" ".join(step)} failed '
                                   f'({res.returncode})\n{res.stdout}')
        return res.stdout.strip().splitlines()
    finally:
        if os.path.exists(exe):
            os.remove(exe)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def warm_up(device) -> None:
    """Pay the card's first-use costs before the first launch: build the
    library if this hash is not built yet, load it, and create `device`'s
    CUDA context. `hl.init` runs it on a thread; what it raises is kept and
    raised by the next `launch`, so a broken build cannot hide."""
    global _warmup_error
    try:
        library()
        import torch
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    except Exception as e:      # a thread's boundary: kept for the launch
        with _lock:
            _warmup_error = e


def launch(name: str, *args, **shape) -> None:
    """Call C entry point `name` on torch's current CUDA stream (appended as
    the last argument) and raise if the launch was refused, or if the
    warm-up failed since the last launch. `shape` (rows, samples, cols):
    the attributes of the launch's `kernel` span."""
    global _warmup_error
    with _lock:
        failed, _warmup_error = _warmup_error, None
    if failed is not None:
        raise RuntimeError('the device warm-up at hl.init failed: '
                           f'{failed!r}') from failed
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    with timer.span('kernel', name=name, **shape):
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')
    with _lock:      # partitions launch from the backend's threads
        launches[name] += 1


def check(t, name: str, dtype, shape=None) -> None:
    """Validate a tensor handed to a kernel: on CUDA, of `dtype`, C-contiguous
    and, when given, of `shape`."""
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
