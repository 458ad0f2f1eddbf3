"""Copy the jax-free host plane of `hail_tpu` into `hail_tpu_torch`.

The MatrixTable/Table/expression machinery is numpy host code that both
packages share in substance. This script copies the modules the port's
methods import, renames their `hail_tpu` imports to `hail_tpu_torch`, and
applies the few edits the port needs, each with its reason (mostly where
the reference reaches jax or its device code). Re-running it reproduces the
committed copies exactly; an edit whose anchor text is not found once fails
the run.

    python3 hail_tpu_torch/copy_host_plane.py
"""

from __future__ import annotations

import os
import re
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, 'hail_tpu')
DST = os.path.join(ROOT, 'hail_tpu_torch')

# files and whole directories, relative to the package root
COPIED = [
    'types.py', 'utils', 'genetics', 'expr', 'fs',
    'ir/__init__.py', 'ir/columns.py', 'ir/nodes.py', 'ir/arrays.py',
    'ir/agg.py', 'ir/relational_ir.py', 'ir/memcache.py', 'ir/semhash.py',
    'ir/random.py', 'ir/simplify.py', 'ir/interval_filters.py',
    'backend/__init__.py', 'backend/backend.py',
    'matrixtable.py', 'table.py',
    'stats/__init__.py', 'stats/rmath.py', 'stats/_fdlibm.py',
    'stats/toms708.py', 'stats/exact_tests.py', 'stats/hwe.py',
    'stats/genchisq.py', 'stats/glmfit.py',
    'linalg/utils/__init__.py', 'linalg/utils/misc.py',
    'resources/reference',
    'io/__init__.py', 'io/native.py', 'io/hail_format.py', 'io/vcf.py',
    'io/bgen.py', 'io/avro.py',
    'native/__init__.py', 'native/hail_native.cpp',
    'methods/impex.py', 'methods/qc.py', 'nd/__init__.py',
    'experimental', 'resources/datasets.json',
    'methods/misc.py', 'methods/family_methods.py', 'methods/annotators.py',
    'vds',
]

# `import`/`from` statements and the by-name imports `__import__('…')`,
# `_imp('…')` and `importlib.import_module('…')`
_IMPORT_RE = re.compile(
    r"""(\bimport |\bfrom |__import__\(['"]|_imp\(['"]"""
    r"""|\bimport_module\(['"])hail_tpu\b""")

# the device sort's output partitions: one per slot of the port's mesh
_DEVICE_SORT_ND_OLD = '''    import jax
    nd = len(jax.devices())
'''
_DEVICE_SORT_ND_NEW = '''    from .parallel.mesh import get_mesh
    nd = get_mesh().size
'''

# ld_score's r = Z·Zᵀ, its r² adjustment and the window sums run on the
# session's device, in row strips, so that only the m scores come back
_LD_SCORE_OLD = '''    n = G.shape[1]
    import jax.numpy as jnp
    r = np.asarray(jnp.asarray(Z) @ jnp.asarray(Z).T)
    r2 = r * r
    # adjusted r2 (unbiased): r2_adj = r2 - (1 - r2)/(n - 2)
    r2 = r2 - (1 - r2) / max(n - 2, 1)
    mask = np.abs(gp[:, None] - gp[None, :]) <= radius
    scores = (r2 * mask).sum(axis=1)
'''
_LD_SCORE_NEW = '''    from ..ops.ldscore import ld_scores
    scores = ld_scores(Z, gp, G.shape[1], radius)
'''

# Object columns are pickled. Files of both packages name their value
# classes by module; reading maps `hail_tpu` to `hail_tpu_torch` (so a read
# imports no jax), and writing names each `hail_tpu_torch` class or function
# as an `importlib.import_module` + `getattr` of its `hail_tpu` twin, which
# the reference resolves to its own classes and this reader maps back.
_PICKLE_IMPORTS_OLD = '''import json
import os
import pickle
'''
_PICKLE_IMPORTS_NEW = '''import importlib
import io
import json
import os
import pickle
import types as _pytypes
'''
_PICKLE_HELPERS_OLD = '''FORMAT_VERSION = 1
'''
_PICKLE_HELPERS_NEW = '''FORMAT_VERSION = 1

_PORT, _REF = 'hail_tpu_torch', 'hail_tpu'


def _port_module(name: str) -> str:
    if name == _REF or name.startswith(_REF + '.'):
        return _PORT + name[len(_REF):]
    return name


def _ref_module(name: str) -> str:
    if name == _PORT or name.startswith(_PORT + '.'):
        return _REF + name[len(_PORT):]
    return name


def _import_port_module(name: str):
    return importlib.import_module(_port_module(name))


class _RefModule:
    """Pickles as `importlib.import_module(name)` of a reference module."""

    def __init__(self, name: str):
        self.name = name

    def __reduce__(self):
        return importlib.import_module, (self.name,)


class _Pickler(pickle.Pickler):
    """Writes each class or function of this package as a `getattr` on its
    reference module imported by name, so the reference reads its own
    classes back without this package installed."""

    def reducer_override(self, obj):
        if isinstance(obj, (type, _pytypes.FunctionType)):
            mod = obj.__module__ or ''
            if _ref_module(mod) != mod and '.' not in obj.__qualname__:
                return getattr, (_RefModule(_ref_module(mod)), obj.__qualname__)
        return NotImplemented


class _Unpickler(pickle.Unpickler):
    """Reads the reference's object columns and this package's as this
    package's classes: `hail_tpu` modules are looked up as `hail_tpu_torch`."""

    def find_class(self, module, name):
        if (module, name) == ('importlib', 'import_module'):
            return _import_port_module
        return super().find_class(_port_module(module), name)


def _dumps(values) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(values)
    return buf.getvalue()


def _loads(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()
'''
_PICKLE_DUMP_OLD = '''np.frombuffer(pickle.dumps(list(col.values.ravel())), dtype=np.uint8)'''
_PICKLE_DUMP_NEW = '''np.frombuffer(_dumps(list(col.values.ravel())), dtype=np.uint8)'''
_PICKLE_LOAD_OLD = '''vals = pickle.loads(arrs[f'{name}.obj'].tobytes())'''
_PICKLE_LOAD_NEW = '''vals = _loads(arrs[f'{name}.obj'].tobytes())'''

# the device cache's default budget is sized for the H100's 80 GB, not the
# reference's 16 GiB TPU (ops/devcache.py holds the same default)
_CACHE_FLAG_OLD = '''str(8 * 1024 * 1024 * 1024)),'''
_CACHE_FLAG_NEW = '''str(16 * 1024 * 1024 * 1024)),'''

# a fault of the reference's memo sizing (ROADMAP queue 3): reading
# `values` builds a DeferredObjectColumn, so every partition memoized by
# collect_batches built the GLM fit structs (an n-long mu per variant)
# that the column exists to defer
_MEMO_SIZE_OLD = '''        c = cols.pop()
        fields = getattr(c, 'fields', None)
'''
_MEMO_SIZE_NEW = '''        c = cols.pop()
        if getattr(c, '_build', None) is not None:
            # an unbuilt DeferredObjectColumn: sized as an object array,
            # not built (reading `values` would build it)
            seen_bytes += int(np.prod(c.shape)) * 64
            continue
        fields = getattr(c, 'fields', None)
'''

# a fault of the reference's vds.filter_variants: its keys hold the
# alleles list, so hashing them for the set lookup raised TypeError on any
# variant data; keys are frozen (table._hashable_key), and a table keyed by
# locus alone matches on that prefix of the row key
_FILTER_VARIANTS_OLD = '''    keyset = {tuple(r[k] for k in variants_table._stage.key)
              for r in variants_table.collect()}
    vd = vds.variant_data
    keys = [tuple(r[k] for k in vd._stage.row_key) for r in vd.rows().collect()]
'''
_FILTER_VARIANTS_NEW = '''    from ..table import _hashable_key
    tkey = list(variants_table._stage.key)
    keyset = {_hashable_key(tuple(r[k] for k in tkey))
              for r in variants_table.collect()}
    vd = vds.variant_data
    keys = [_hashable_key(tuple(r[k] for k in vd._stage.row_key[:len(tkey)]))
            for r in vd.rows().collect()]
'''

# (file, anchor, replacement): each anchor must occur exactly once
EDITS = [
    ('backend/backend.py', _CACHE_FLAG_OLD, _CACHE_FLAG_NEW),
    ('ir/memcache.py', _MEMO_SIZE_OLD, _MEMO_SIZE_NEW),
    ('table.py', _DEVICE_SORT_ND_OLD, _DEVICE_SORT_ND_NEW),
    ('io/native.py', _PICKLE_IMPORTS_OLD, _PICKLE_IMPORTS_NEW),
    ('io/native.py', _PICKLE_HELPERS_OLD, _PICKLE_HELPERS_NEW),
    ('io/native.py', _PICKLE_DUMP_OLD, _PICKLE_DUMP_NEW),
    ('io/native.py', _PICKLE_LOAD_OLD, _PICKLE_LOAD_NEW),
    ('experimental/__init__.py', _LD_SCORE_OLD, _LD_SCORE_NEW),
    ('vds/__init__.py', _FILTER_VARIANTS_OLD, _FILTER_VARIANTS_NEW),
]


def _copy_file(src: str, dst: str) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if not src.endswith('.py'):
        shutil.copyfile(src, dst)
        return
    with open(src, encoding='utf-8') as f:
        text = f.read()
    with open(dst, 'w', encoding='utf-8') as f:
        f.write(_IMPORT_RE.sub(r'\1hail_tpu_torch', text))


def copy_all(dst: str = DST) -> None:
    """Copy into `dst` (the port's package; a test copies elsewhere and
    compares)."""
    for rel in COPIED:
        src = os.path.join(SRC, rel)
        if os.path.isdir(src):
            for dirpath, dirnames, filenames in os.walk(src):
                dirnames[:] = [d for d in dirnames if d != '__pycache__']
                for fn in filenames:
                    if fn.endswith('.pyc'):
                        continue
                    s = os.path.join(dirpath, fn)
                    _copy_file(s, os.path.join(dst, os.path.relpath(s, SRC)))
        else:
            _copy_file(src, os.path.join(dst, rel))
    for rel, old, new in EDITS:
        path = os.path.join(dst, rel)
        with open(path, encoding='utf-8') as f:
            text = f.read()
        n = text.count(old)
        if n != 1:
            sys.exit(f'{rel}: edit anchor found {n} times, expected 1')
        with open(path, 'w', encoding='utf-8') as f:
            f.write(text.replace(old, new))


if __name__ == '__main__':
    copy_all()
