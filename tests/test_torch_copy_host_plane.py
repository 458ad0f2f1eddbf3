"""`hail_tpu_torch/copy_host_plane.py` run again reproduces the committed
copies of the host plane byte for byte, and its import renaming reaches
every way a module of the reference is imported by name, so that no copy
imports `hail_tpu` (and with it jax) when it runs."""

import filecmp
import os

from hail_tpu_torch import copy_host_plane as cp


def test_copies_are_reproduced(tmp_path):
    cp.copy_all(str(tmp_path))
    copied = [os.path.relpath(os.path.join(d, f), tmp_path)
              for d, _, files in os.walk(tmp_path) for f in files]
    for rel in ('methods/qc.py', 'matrixtable.py', 'stats/__init__.py',
                'experimental/__init__.py', 'experimental/extras.py',
                'experimental/datasets.py', 'experimental/ldscsim.py',
                'experimental/time.py', 'resources/datasets.json',
                'methods/misc.py', 'methods/family_methods.py',
                'methods/annotators.py', 'vds/__init__.py', 'vds/functions.py',
                'vds/combiner/__init__.py', 'vds/combiner/combine.py',
                'vds/combiner/variant_dataset_combiner.py'):
        assert rel in copied, rel
    differ = [rel for rel in copied if not filecmp.cmp(
        os.path.join(tmp_path, rel), os.path.join(cp.DST, rel), shallow=False)]
    assert differ == []


def test_by_name_imports_are_renamed():
    src = '\n'.join([
        'import hail_tpu.ops',
        'from hail_tpu.expr import functions',
        "m = __import__('hail_tpu.types')",
        'at = _imp("hail_tpu.genetics.allele_type")',
        "at = importlib.import_module('hail_tpu.genetics.allele_type')",
        "_REF = 'hail_tpu'",
        'import hail_tpu_torch',
    ])
    out = cp._IMPORT_RE.sub(r'\1hail_tpu_torch', src).split('\n')
    assert out == [
        'import hail_tpu_torch.ops',
        'from hail_tpu_torch.expr import functions',
        "m = __import__('hail_tpu_torch.types')",
        'at = _imp("hail_tpu_torch.genetics.allele_type")',
        "at = importlib.import_module('hail_tpu_torch.genetics.allele_type')",
        "_REF = 'hail_tpu'",
        'import hail_tpu_torch',
    ]


def test_no_copy_imports_the_reference_by_name():
    for d, _, files in os.walk(cp.DST):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(d, f), encoding='utf-8') as fh:
                    text = fh.read()
                assert "import_module('hail_tpu." not in text, f
                assert '_imp("hail_tpu.' not in text, f


def test_edits():
    """`stats/__init__.py` is copied unedited (it exports LinearMixedModel,
    which the port has), and `ld_score`'s device block is the one edit of
    `experimental/__init__.py`."""
    assert 'stats/__init__.py' not in [rel for rel, _, _ in cp.EDITS]
    assert [rel for rel, _, _ in cp.EDITS].count('experimental/__init__.py') == 1
    with open(os.path.join(cp.SRC, 'stats/__init__.py'), encoding='utf-8') as f:
        ref = f.read()
    with open(os.path.join(cp.DST, 'stats/__init__.py'), encoding='utf-8') as f:
        assert f.read() == ref
    with open(os.path.join(cp.DST, 'experimental/__init__.py'),
              encoding='utf-8') as f:
        text = f.read()
    assert 'jax' not in text and 'ld_scores(Z, gp, G.shape[1], radius)' in text
    with open(os.path.join(cp.DST, 'experimental/extras.py'),
              encoding='utf-8') as f:
        assert "__import__('hail_tpu_torch.utils.misc'" in f.read()


def test_sort_edits():
    """The device sort and the multihost sort run as copied: the one edit
    of `_device_sample_sort` counts the port's mesh slots in place of
    `jax.devices()`, and `_sample_sort` keeps its multihost prologue."""
    table_edits = [(old, new) for rel, old, new in cp.EDITS
                   if rel == 'table.py']
    assert table_edits == [(cp._DEVICE_SORT_ND_OLD, cp._DEVICE_SORT_ND_NEW)]
    assert not hasattr(cp, '_DEVICE_SORT_OLD')
    assert not hasattr(cp, '_MULTIHOST_SORT_OLD')
    with open(os.path.join(cp.DST, 'table.py'), encoding='utf-8') as f:
        text = f.read()
    assert text.count(cp._DEVICE_SORT_ND_NEW) == 1 and 'import jax' not in text
    assert text.count('return _multihost_sample_sort(stage, specs, be, '
                      'samples_per_partition)') == 1
    assert text.count('order = device_range_sort(keys, asc)') == 1


def test_vds_and_methods_copies():
    """The VariantDataset package and the three method modules are copied
    with their imports renamed, the seven lazy `import hail_tpu as hl` of
    vds/__init__.py among them; `filter_variants` is the one edit of
    vds/__init__.py, and the method modules are copied unedited."""
    rels = [rel for rel, _, _ in cp.EDITS]
    assert rels.count('vds/__init__.py') == 1
    for rel in ('methods/misc.py', 'methods/family_methods.py',
                'methods/annotators.py', 'vds/functions.py',
                'vds/combiner/combine.py',
                'vds/combiner/variant_dataset_combiner.py'):
        assert rel not in rels
        with open(os.path.join(cp.SRC, rel), encoding='utf-8') as f:
            ref = f.read()
        with open(os.path.join(cp.DST, rel), encoding='utf-8') as f:
            assert f.read() == cp._IMPORT_RE.sub(r'\1hail_tpu_torch', ref), rel
    with open(os.path.join(cp.SRC, 'vds/__init__.py'), encoding='utf-8') as f:
        ref = f.read()
    with open(os.path.join(cp.DST, 'vds/__init__.py'), encoding='utf-8') as f:
        text = f.read()
    assert ref.count('import hail_tpu as hl') == 7
    assert text.count('import hail_tpu_torch as hl') == 7
    assert 'import hail_tpu as' not in text and 'jax' not in text
    assert text.count(cp._FILTER_VARIANTS_NEW) == 1
    assert text == cp._IMPORT_RE.sub(r'\1hail_tpu_torch', ref).replace(
        cp._FILTER_VARIANTS_OLD, cp._FILTER_VARIANTS_NEW)
