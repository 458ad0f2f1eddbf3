"""The port's host plane (types, expressions, Table, MatrixTable, I/O, the
services and the drop-in's alias packages) is the port's own code: no
module of it imports `hail_tpu` (and with it jax) in any way a module can
be imported, and the places where it departs from the reference hold what
the port needs."""

import ast
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'hail_tpu_torch')

# the by-name imports `__import__('…')`, `_imp('…')` and
# `importlib.import_module('…')` of a reference module, and a command that
# runs one (`-m hail_tpu.…`, as a string or as an argument list)
_BY_NAME_RE = re.compile(
    r"""(__import__\(|\b_imp\(|\bimport_module\()['"]hail_tpu\b(?!_torch)""")
_RUN_RE = re.compile(r"""-m['"]?,?\s*['"]?hail_tpu\.""")


def _read(rel):
    with open(os.path.join(PORT, rel), encoding='utf-8') as f:
        return f.read()


def _port_modules():
    return sorted(os.path.relpath(os.path.join(d, f), PORT)
                  for d, _, fs in os.walk(PORT) for f in fs
                  if f.endswith('.py') and '__pycache__' not in d)


def _imports_of(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_no_copy_imports_the_reference_by_name():
    """No module of the package imports `hail_tpu` through `import`,
    `from`, `__import__`, `_imp` or `import_module`, nor names a command
    that runs one of its modules."""
    modules = _port_modules()
    assert 'table.py' in modules and 'dropin/hail/__init__.py' in modules
    for rel in modules:
        text = _read(rel)
        for name in _imports_of(ast.parse(text, rel)):
            assert name.split('.')[0] != 'hail_tpu', (rel, name)
        assert not _BY_NAME_RE.search(text), rel
        assert not _RUN_RE.search(text), rel
    # the patterns reach each form, and leave this package's names alone
    assert _BY_NAME_RE.search("m = __import__('hail_tpu.types')")
    assert _BY_NAME_RE.search('at = _imp("hail_tpu.genetics.allele_type")')
    assert _BY_NAME_RE.search("importlib.import_module('hail_tpu.ops')")
    assert not _BY_NAME_RE.search("importlib.import_module('hail_tpu_torch')")
    assert _RUN_RE.search("[sys.executable, '-m', 'hail_tpu.backend.w']")
    assert _RUN_RE.search('python -m hail_tpu.dropin x.py')
    assert not _RUN_RE.search('python -m hail_tpu_torch.dropin x.py')
    assert list(_imports_of(ast.parse(
        'import hail_tpu.ops\nfrom hail_tpu.expr import f\nfrom . import g'))) \
        == ['hail_tpu.ops', 'hail_tpu.expr']


def test_edits():
    """`stats/__init__.py` exports LinearMixedModel, which the port has,
    and `ld_score` computes its scores on the session's device
    (ops/ldscore.py) with no jax."""
    assert 'LinearMixedModel' in _read('stats/__init__.py')
    text = _read('experimental/__init__.py')
    assert 'jax' not in text and 'ld_scores(Z, gp, G.shape[1], radius)' in text
    assert "__import__('hail_tpu_torch.utils.misc'" in \
        _read('experimental/extras.py')


def test_sort_edits():
    """The device sort counts the port's mesh slots in place of
    `jax.devices()`, and `_sample_sort` keeps its multihost prologue."""
    text = _read('table.py')
    assert text.count('''    from .parallel.mesh import get_mesh
    nd = get_mesh().size
''') == 1 and 'import jax' not in text
    assert text.count('return _multihost_sample_sort(stage, specs, be, '
                      'samples_per_partition)') == 1
    assert text.count('order = device_range_sort(keys, asc)') == 1


def test_vds_and_methods_copies():
    """The VariantDataset package imports the port lazily in its seven
    places, and `filter_variants` freezes the keys it hashes; the method
    modules reach no jax."""
    for rel in ('methods/misc.py', 'methods/family_methods.py',
                'methods/annotators.py', 'vds/functions.py',
                'vds/combiner/combine.py',
                'vds/combiner/variant_dataset_combiner.py'):
        assert 'jax' not in _read(rel), rel
    text = _read('vds/__init__.py')
    assert text.count('import hail_tpu_torch as hl') == 7
    assert 'import hail_tpu as' not in text and 'jax' not in text
    assert text.count('''    keyset = {_hashable_key(tuple(r[k] for k in tkey))
              for r in variants_table.collect()}''') == 1


_QOB_SLICE = ('typecheck', 'config.py', 'cli.py', '__main__.py', 'batch',
              'services', 'batch_service', 'backend/qob_worker.py',
              'backend/service_backend.py')


def test_qob_slice_copies():
    """The Query-on-Batch slice imports neither the reference, jax nor the
    `hailtop` alias (which imports the reference); the resource parsers are
    the port's own copy."""
    files = []
    for rel in _QOB_SLICE:
        path = os.path.join(PORT, rel)
        if os.path.isdir(path):
            files += [os.path.relpath(os.path.join(d, f), PORT)
                      for d, _, fs in os.walk(path) for f in fs
                      if f.endswith('.py')]
        else:
            files.append(rel)
    assert len(files) == 38 and 'batch_service/parse.py' in files
    for rel in files:
        port = _read(rel)
        assert 'import hail_tpu\n' not in port and 'import jax' not in port
        assert 'from hailtop' not in port and 'import hailtop' not in port
    assert 'from .parse import (' in _read('batch_service/front_end.py')


def test_qob_slice_edits():
    """The worker and its command, the lazy aiohttp imports, and the
    reference faults the port repairs."""
    sb = _read('backend/service_backend.py')
    assert "'hail_tpu_torch.backend.qob_worker'" in sb
    assert 'hail_tpu.backend' not in sb and 'JAX_PLATFORM_NAME' not in sb
    assert "'env': {'CUDA_VISIBLE_DEVICES': ''}" in sb
    assert 'self._collect(bid, out_paths, self.stage_timeout)' in sb
    worker = _read('backend/qob_worker.py')
    assert 'jax' not in worker.split('"""', 2)[-1]
    assert "hl.init(device='cpu', quiet=True)" in worker
    assert 'shlex.quote(workdir)' in _read('services/ci_service.py')
    assert "prog='hail_tpu_torch.batch_service'" in \
        _read('batch_service/__main__.py')
    for rel, name in (('services/__init__.py', 'AuthService'),
                      ('batch_service/__init__.py', 'BatchService')):
        text = _read(rel)
        assert f"if name == '{name}':" in text, rel
    assert "timeout=getattr(j, '_timeout', None)" in _read('batch/backend.py')


def test_dropin_copies():
    """The drop-in holds a module for every file of the repo's alias
    packages `hail`, `hailtop`, `pyspark` and `avro`; none imports
    `hail_tpu` or names it as what it forwards to."""
    alias = sorted(os.path.relpath(os.path.join(d, f), ROOT)
                   for pkg in ('hail', 'hailtop', 'pyspark', 'avro')
                   for d, _, fs in os.walk(os.path.join(ROOT, pkg))
                   for f in fs if f.endswith('.py'))
    dropin = sorted(rel[len('dropin/'):] for rel in _port_modules()
                    if rel.startswith('dropin/') and rel != 'dropin/__init__.py'
                    and rel != 'dropin/__main__.py')
    assert dropin == alias
    for rel in dropin:
        for line in _read('dropin/' + rel).splitlines():
            assert 'hail_tpu.' not in line.replace('hail_tpu_torch', ''), \
                (rel, line)
            assert not line.rstrip().endswith(' hail_tpu'), (rel, line)
