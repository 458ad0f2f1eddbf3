"""Session context: `hl.init`, the Env singleton, flags.

Parity with reference `hail/python/hail/context.py` + `utils/java.py:38` (Env)
+ `HailFeatureFlags` — a fresh, JVM-free implementation. The backend is
local, or multihost over `torch.distributed`; device work runs on the torch
device chosen at `init(device=...)` (`current_device()`), a CUDA card or,
for the tests, the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from .backend.backend import Backend, LocalBackend


# Must match knownFlags in the reference's HailFeatureFlags.scala:16-52 /
# backend.py:172-201 (name -> (env var, default)); a flag's live value is its
# env override, else the default — `hl._get_flags(name)` surfaces None for
# unset defaultless flags, exactly like the reference.

FLAGS_ENV_VARS_AND_DEFAULTS = Backend._flags_env_vars_and_defaults

DEFAULT_FLAGS: Dict[str, str] = {
    name: os.environ.get(env_var, default)
    for name, (env_var, default) in FLAGS_ENV_VARS_AND_DEFAULTS.items()
}


class HailContext:
    def __init__(self, backend: Backend, log: str, quiet: bool, append: bool,
                 tmp_dir: str, local_tmpdir: str, default_reference: str,
                 global_seed: Optional[int], branching_factor: int):
        self.backend = backend
        self.log = log
        self.quiet = quiet
        from .utils.hail_logging import configure
        configure(log, quiet, append)
        self.tmp_dir = tmp_dir
        self.local_tmpdir = local_tmpdir
        # reference context.py:131 exposes these as properties on HailContext
        self._tmpdir = tmp_dir
        self._local_tmpdir = local_tmpdir
        self.branching_factor = branching_factor
        self.flags = dict(DEFAULT_FLAGS)
        from .ir import columns as _columns
        _columns.set_strict_invariants(
            (self.flags.get('strict_invariants') or '0')
            not in ('0', '', 'false'))
        self._seed_counter = global_seed if global_seed is not None else 0
        from .genetics.reference_genome import set_default_reference
        set_default_reference(default_reference)


class Env:
    _hc: Optional[HailContext] = None
    _device: Optional[torch.device] = None

    @classmethod
    def device(cls) -> torch.device:
        """The torch device that methods put their tensors on."""
        if cls._device is None:
            init()
        return cls._device

    @classmethod
    def hc(cls) -> HailContext:
        if cls._hc is None:
            init()
        return cls._hc

    @classmethod
    def backend(cls) -> Backend:
        return cls.hc().backend

    @classmethod
    def next_seed(cls) -> int:
        hc = cls.hc()
        hc._seed_counter += 1
        return hc._seed_counter

    _static_rng_uid = 0

    @classmethod
    def next_static_rng_uid(cls) -> int:
        # reference utils/java.py:118: sequential static uids for seeded
        # functions, rewound by reset_global_randomness
        result = cls._static_rng_uid
        cls._static_rng_uid += 1
        return result

    _uid_counter = 0

    @classmethod
    def get_uid(cls, base=None) -> str:
        # reference utils/java.py Env.get_uid: fresh identifier strings
        cls._uid_counter += 1
        return f'__uid_{base}_{cls._uid_counter}' if base else f'__uid_{cls._uid_counter}'

    @classmethod
    def hail(cls):
        # reference Env.hail(): the JVM is.hail package object; here a stub
        # namespace that utils.java.scala_object understands, plus a
        # scala-Map-shaped view of the flag table so the reference's
        # test_flags_same_in_scala_and_python can verify both sides agree
        class _ScalaTuple2:
            def __init__(self, a, b):
                self._a, self._b = a, b

            def _1(self):
                return self._a

            def _2(self):
                return self._b

        class _ScalaMapIterator:
            def __init__(self, items):
                self._items = items
                self._i = 0

            def hasNext(self):
                return self._i < len(self._items)

            def next(self):
                kv = self._items[self._i]
                self._i += 1
                return kv

        class _ScalaMap:
            def __init__(self, d):
                self._items = [_ScalaTuple2(k, _ScalaTuple2(v[0], v[1]))
                               for k, v in d.items()]

            def iterator(self):
                return _ScalaMapIterator(self._items)

        class _HailFeatureFlags:
            @staticmethod
            def defaults():
                return _ScalaMap(Backend._flags_env_vars_and_defaults)

        class _pkg:
            io = 'is.hail.io'
            HailFeatureFlags = _HailFeatureFlags
        return _pkg

    @classmethod
    def fs(cls):
        # reference Env.fs() (utils/java.py): the session filesystem handle
        from .fs.router_fs import RouterFS
        return RouterFS()

    @classmethod
    def is_fully_initialized(cls) -> bool:
        # reference Env.is_fully_initialized (utils/java.py): session + backend up
        return cls._hc is not None

    @classmethod
    def reset_global_randomness(cls) -> None:
        # reference Env.reset_global_randomness: rewind the session rng
        import hail_tpu_torch
        hail_tpu_torch.reset_global_randomness()

    @classmethod
    def is_initialized(cls) -> bool:
        return cls._hc is not None


def _resolve_device(device) -> torch.device:
    """'cuda' (or 'cuda:N') needs a card and raises without one; 'cpu' runs
    every kernel's plain torch version and is only ever the caller's
    explicit choice (the tests make it). None means 'cuda': an `init` that
    names no device never carries on on the CPU."""
    if device is None:
        device = 'cuda'
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'hl.init(device={device!r}): torch.cuda.is_available() is '
                'False')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {device!r} (cuda or cpu)')
    return dev


def init(backend: str = 'local',
         sc=None,
         app_name: Optional[str] = None,
         master: Optional[str] = None,
         local: str = 'local[*]',
         log: Optional[str] = None,
         quiet: bool = False,
         append: bool = False,
         min_block_size: int = 0,
         branching_factor: int = 50,
         tmp_dir: Optional[str] = None,
         default_reference: str = 'GRCh37',
         idempotent: bool = False,
         global_seed: Optional[int] = None,
         local_tmpdir: Optional[str] = None,
         n_threads: Optional[int] = None,
         device=None,
         **kwargs) -> None:
    """Initialize the session (cf. reference hl.init, context.py:159-290).
    `backend` is 'local' ('spark' is accepted as its alias) or
    'multihost': one process of a `torch.distributed` group, joined with
    the keyword arguments `coordinator_address` ('host:port' of rank 0),
    `num_processes` and `process_id` (its rank), unless the group exists
    already (backend/distributed.py). `device` is 'cuda', 'cpu' or None
    (see `_resolve_device`); a multihost process given 'cuda' or None
    takes the card of its rank on this host."""
    if Env._hc is not None:
        if idempotent:
            return
        Env._hc.backend.stop()
        Env._hc = None
    from .parallel.mesh import reset_mesh
    reset_mesh()
    if backend in ('local', 'spark'):
        dev = _resolve_device(device)
        b: Backend = LocalBackend(n_threads)
    elif backend == 'multihost':
        from .backend.distributed import MultihostBackend
        rank = kwargs.pop('process_id', None)
        if device in (None, 'cuda') and rank is not None:
            device = f'cuda:{rank % max(torch.cuda.device_count(), 1)}'
        dev = _resolve_device(device)
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        b = MultihostBackend(kwargs.pop('coordinator_address', None),
                             kwargs.pop('num_processes', None), rank, dev)
    else:
        raise ValueError(
            f'unknown backend {backend!r} (expected local or multihost)')
    tmp = tmp_dir or os.environ.get('TMPDIR', '/tmp')
    if log is None:
        # reference default is hail-<timestamp>.log in cwd; keep the session
        # log out of user working trees by defaulting to the tmp dir
        log = os.path.join(tmp, f'hail_tpu_torch-{os.getpid()}.log')
    Env._hc = HailContext(
        b, log, quiet, append, tmp, local_tmpdir or tmp,
        default_reference, global_seed, branching_factor)
    Env._device = dev


def stop() -> None:
    if Env._hc is not None:
        Env._hc.backend.stop()
        Env._hc = None
    Env._device = None
    from .parallel.mesh import reset_mesh
    reset_mesh()
    from .ir import memcache
    memcache.clear()


def default_reference():
    from .genetics.reference_genome import default_reference as dr
    return dr()


def get_reference(name: str):
    from .genetics.reference_genome import ReferenceGenome
    return ReferenceGenome.get(name)


def set_global_seed(seed: int) -> None:
    Env.hc()._seed_counter = seed


def _sync_flag_caches() -> None:
    """Push flag values consumed on hot paths into module-level caches (Batch
    construction must not do a dict lookup through Env per call)."""
    from .ir import columns as _columns
    v = Env.hc().flags.get('strict_invariants', '0')
    _columns.set_strict_invariants(v not in ('0', '', 'false', 'False', None))


def _set_flags(**flags) -> None:
    Env.hc().flags.update({k: v for k, v in flags.items()})
    _sync_flag_caches()


def _get_flags(*names):
    # reference context.py:951 → backend.get_flags(*flags): a dict over the
    # REQUESTED names only ({} for no names); unset/defaultless flags are None
    f = Env.hc().flags
    return {n: f.get(n) for n in names}


def current_backend() -> Backend:
    return Env.backend()


def current_device() -> torch.device:
    """The torch device the session's device work runs on."""
    return Env.device()


def tmp_dir() -> str:
    return Env.hc().tmp_dir


# ---------------------------------------------------------------------------
# session variants, citation, diagnostics
# (reference hail/context.py init_local/init_batch/init_spark, citation et al.)
# ---------------------------------------------------------------------------

#: Accepted anywhere a cloud region list is required (reference
#: hailtop.batch_client ANY_REGION sentinel).
ANY_REGION = ['any_region']


def init_local(log=None, quiet=False, append=False, branching_factor=50,
               tmpdir=None, default_reference='GRCh37', global_seed=None,
               skip_logging_configuration=False, gcs_requester_pays_configuration=None,
               **kwargs) -> None:
    """Initialize with the local (single-host) backend."""
    init(backend='local', log=log, quiet=quiet, append=append,
         branching_factor=branching_factor, tmp_dir=tmpdir,
         default_reference=default_reference, global_seed=global_seed)


def init_spark(sc=None, app_name=None, master=None, local='local[*]',
               log=None, quiet=False, append=False, min_block_size=0,
               branching_factor=50, tmp_dir=None, default_reference='GRCh37',
               idempotent=False, global_seed=None, **kwargs) -> None:
    """Reference: initialize the Spark backend. There is no JVM/Spark here —
    the local backend provides the same API surface."""
    init(backend='local', log=log, quiet=quiet, append=append,
         branching_factor=branching_factor, tmp_dir=tmp_dir,
         default_reference=default_reference, idempotent=idempotent,
         global_seed=global_seed)


def spark_context():
    """Reference returns the underlying pyspark SparkContext; this build has
    none."""
    raise NotImplementedError(
        'hail_tpu_torch has no Spark backend: computation runs on torch. '
        'Use hl.current_backend() for the active backend object.')


def version() -> str:
    from . import __version__
    return __version__


def citation(*, bibtex=False) -> str:
    v = version()
    if bibtex:
        return (
            '@misc{Hail-TPU,'
            '  author = {Hail-TPU Team},'
            f'  title = {{Hail-TPU {v}}},'
            f'  howpublished = {{\\url{{https://github.com/hail-is/hail}}}}'
            '}'
        )
    return f'Hail-TPU Team. Hail-TPU {v}.'


def cite_hail() -> str:
    return citation(bibtex=False)


def cite_hail_bibtex() -> str:
    return citation(bibtex=True)


def copy_log(path: str) -> None:
    """Copy the current session log to `path` (reference utils.hadoop_copy of
    Env.hc().log)."""
    import shutil as _shutil
    hc = Env.hc()
    src = hc.log
    if os.path.isdir(path):
        path = os.path.join(path, os.path.basename(src))
    if os.path.exists(src):
        _shutil.copy(src, path)
    else:
        with open(path, 'w') as f:
            f.write('')


def debug_info() -> dict:
    """Environment/debug summary (reference context.debug_info)."""
    import sys
    info = {
        'version': version(),
        'python_version': sys.version,
        'backend': type(Env.backend()).__name__ if Env.is_initialized() else None,
        'flags': dict(Env.hc().flags) if Env.is_initialized() else {},
    }
    info['torch_version'] = torch.__version__
    info['cuda_version'] = torch.version.cuda
    info['cuda_available'] = torch.cuda.is_available()
    dev = Env._device
    info['device'] = str(dev) if dev is not None else None
    info['device_name'] = (torch.cuda.get_device_name(dev)
                           if dev is not None and dev.type == 'cuda' else None)
    return info


class _with_flags:
    """Context manager temporarily setting session flags (reference
    hl._with_flags)."""

    def __init__(self, **flags):
        self.flags = flags
        self._saved = {}

    def __enter__(self):
        f = Env.hc().flags
        self._saved = {k: f.get(k) for k in self.flags}
        f.update(self.flags)
        _sync_flag_caches()
        return self

    def __exit__(self, *exc):
        f = Env.hc().flags
        for k, v in self._saved.items():
            if v is None:
                f.pop(k, None)
            else:
                f[k] = v
        _sync_flag_caches()


def _get_local_tmpdir(local_tmpdir=None) -> str:
    """Resolve the local scratch dir (reference `hail/context.py`
    _get_local_tmpdir): explicit arg > initialized context > /tmp."""
    if local_tmpdir:
        return local_tmpdir
    if Env._hc is not None:
        return Env.hc().local_tmpdir
    import tempfile
    return tempfile.gettempdir()


# re-exported for the reference import path `from hail.context import
# TemporaryFilename` (reference context.py defines it there)
from .utils import TemporaryDirectory, TemporaryFilename  # noqa: E402,F401
