"""File I/O of the port against hail_tpu, on the CPU: VCF, PLINK, BGEN and
GEN export and import, table export and import, and the native Table and
MatrixTable format written by either package and read by the other.

Inputs come from `balding_nichols_model` with `reset_global_randomness()`
in both packages (the same calls in both), and from small tables with
`array<struct>`, interval, dict and set fields. Every comparison is exact:
the files are text or integers, and the values read back are compared with
`plain` (each package has its own Struct, Interval, Locus and Call
classes). A subprocess with jax and hail_tpu blocked reads a table the
reference wrote. Every test that reaches `hail_tpu_torch.native` (the C++
VCF and BGZF helpers, built by g++ at first use) is in this file, so one
test worker builds it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import hail_tpu_torch as hlt
from test_torch_sort import plain


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def _bn(pkg, n_samples=8, n_variants=20, n_partitions=2):
    pkg.reset_global_randomness()
    return pkg.balding_nichols_model(2, n_samples, n_variants,
                                     n_partitions=n_partitions)


def _entries(mt, *fields):
    return plain([tuple(r[f] for f in fields) for r in mt.entries().collect()])


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _rich_table(pkg):
    """A table with array<struct>, interval, dict, set and locus fields."""
    t = pkg.range_table(9, n_partitions=3)
    return t.annotate(
        a=pkg.array([pkg.struct(x=t.idx, y=pkg.str(t.idx)),
                     pkg.struct(x=t.idx * 2, y='b')]),
        iv=pkg.interval(t.idx, t.idx + 3, includes_end=t.idx % 2 == 0),
        li=pkg.locus_interval('1', t.idx + 1, t.idx + 5),
        dd=pkg.dict({pkg.str(t.idx): t.idx, 'k': 7}),
        ss=pkg.set([t.idx, t.idx + 1]),
        loc=pkg.array([pkg.locus('1', t.idx + 1)]),
        f=pkg.float64(t.idx) / 3)


def _rich_mt(pkg):
    mt = _bn(pkg, n_samples=5, n_variants=6)
    mt = mt.annotate_rows(ra=pkg.array([pkg.struct(p=mt.locus.position)]),
                          rd=pkg.dict({'a': mt.locus.position}))
    mt = mt.annotate_cols(cs=pkg.set([mt.sample_idx]),
                          ci=pkg.interval(mt.sample_idx, mt.sample_idx + 1))
    return mt.annotate_entries(es=pkg.struct(n=mt.GT.n_alt_alleles()))


def test_export_vcf_same_file_and_round_trip(hl, tmp_path):
    mt_p, mt_r = _bn(hlt), _bn(hl)
    hlt.export_vcf(mt_p, str(tmp_path / 'p.vcf'))
    hl.export_vcf(mt_r, str(tmp_path / 'r.vcf'))
    assert _read(tmp_path / 'p.vcf') == _read(tmp_path / 'r.vcf')
    back_p = hlt.import_vcf(str(tmp_path / 'p.vcf'))
    back_r = hl.import_vcf(str(tmp_path / 'p.vcf'))
    assert _entries(back_p, 'locus', 's', 'GT') == \
        _entries(back_r, 'locus', 's', 'GT')
    assert [plain(e.GT) for e in back_p.entries().collect()] == \
        [plain(e.GT) for e in mt_p.entries().collect()]


@pytest.mark.parametrize('bgzip', [False, True])
def test_import_vcf_gt_native_route_matches_reference(hl, tmp_path, bgzip,
                                                       monkeypatch):
    """A GT-only import (`entry_fields=['GT']`: the C++ line parser
    `native.vcf_parse_gt`, with BGZF decompression for .bgz) reads as the
    reference reads it."""
    from hail_tpu_torch import native
    assert native.get_lib() is not None, native.build_error()
    calls = []
    parse = native.vcf_parse_gt
    monkeypatch.setattr(native, 'vcf_parse_gt',
                        lambda *a: calls.append(1) or parse(*a))
    name = 'g.vcf.bgz' if bgzip else 'g.vcf'
    hl.export_vcf(_bn(hl, n_samples=12, n_variants=40), str(tmp_path / name))
    got = hlt.import_vcf(str(tmp_path / name), n_partitions=2,
                         entry_fields=['GT'])
    want = hl.import_vcf(str(tmp_path / name), n_partitions=2,
                         entry_fields=['GT'])
    assert calls
    assert got.count() == want.count() == (40, 12)
    assert _entries(got, 'locus', 'alleles', 's', 'GT') == \
        _entries(want, 'locus', 'alleles', 's', 'GT')


def test_plink_same_files_and_round_trip(hl, tmp_path):
    hlt.export_plink(_bn(hlt), str(tmp_path / 'p'))
    hl.export_plink(_bn(hl), str(tmp_path / 'r'))
    for ext in ('bed', 'bim', 'fam'):
        assert _read(tmp_path / f'p.{ext}') == _read(tmp_path / f'r.{ext}')
    paths = [str(tmp_path / f'p.{e}') for e in ('bed', 'bim', 'fam')]
    got = hlt.import_plink(*paths)
    want = hl.import_plink(*paths)
    assert _entries(got, 'locus', 'alleles', 's', 'GT') == \
        _entries(want, 'locus', 'alleles', 's', 'GT')


def test_bgen_and_gen_round_trips_match_reference(hl, tmp_path):
    out = {}
    for tag, pkg in (('p', hlt), ('r', hl)):
        mt = _bn(pkg)
        gp = pkg.map(lambda i: pkg.if_else(mt.GT.n_alt_alleles() == i, 1.0, 0.0),
                     pkg.range(0, 3))
        base = str(tmp_path / tag)
        pkg.export_bgen(mt, base, gp=gp)
        pkg.index_bgen(base + '.bgen')
        back = pkg.import_bgen(base + '.bgen',
                               entry_fields=['GT', 'GP', 'dosage'])
        pkg.export_gen(back, str(tmp_path / f'g{tag}'))
        gen = pkg.import_gen(str(tmp_path / f'g{tag}.gen'),
                             str(tmp_path / f'g{tag}.sample'))
        out[tag] = (_entries(back, 'locus', 'GT', 'GP', 'dosage'),
                    _entries(gen, 'locus', 'GT', 'GP'))
    assert _read(tmp_path / 'p.bgen') == _read(tmp_path / 'r.bgen')
    assert out['p'] == out['r']


def test_export_and_import_table_match_reference(hl, tmp_path):
    for tag, pkg in (('p', hlt), ('r', hl)):
        t = pkg.range_table(10, n_partitions=2)
        t = t.annotate(x=t.idx * 0.5, s=pkg.str(t.idx) + 'a',
                       m=pkg.or_missing(t.idx % 3 == 0, t.idx))
        t.export(str(tmp_path / f'{tag}.tsv'))
    assert _read(tmp_path / 'p.tsv') == _read(tmp_path / 'r.tsv')
    got = hlt.import_table(str(tmp_path / 'p.tsv'), impute=True)
    want = hl.import_table(str(tmp_path / 'p.tsv'), impute=True)
    assert str(got.row.dtype) == str(want.row.dtype)
    assert plain(got.collect()) == plain(want.collect())


@pytest.mark.parametrize('writer', ['port', 'reference'])
def test_table_files_read_by_either_package(hl, tmp_path, writer):
    path = str(tmp_path / 't.ht')
    (_rich_table(hlt) if writer == 'port' else _rich_table(hl)).write(path)
    got = hlt.read_table(path)
    want = hl.read_table(path)
    assert str(got.row.dtype) == str(want.row.dtype)
    assert got.key.dtype.fields.keys() == want.key.dtype.fields.keys()
    rows, ref_rows = got.collect(), want.collect()
    assert plain(rows) == plain(ref_rows) == plain(_rich_table(hl).collect())
    # each package reads the values as its own classes
    assert type(rows[0].a[0]) is hlt.Struct and type(rows[0].iv) is hlt.Interval
    assert type(ref_rows[0].a[0]) is hl.Struct and type(ref_rows[0].iv) is hl.Interval


@pytest.mark.parametrize('writer', ['port', 'reference'])
def test_matrix_table_files_read_by_either_package(hl, tmp_path, writer):
    path = str(tmp_path / 'm.mt')
    (_rich_mt(hlt) if writer == 'port' else _rich_mt(hl)).write(path)
    got = hlt.read_matrix_table(path)
    want = hl.read_matrix_table(path)
    assert got.count() == want.count() == (6, 5)
    for part in ('rows', 'cols', 'entries'):
        assert plain(getattr(got, part)().collect()) == \
            plain(getattr(want, part)().collect()), part
    assert plain(got.entries().collect()) == \
        plain(_rich_mt(hl).entries().collect())


def test_checkpoint_and_query_table(hl, tmp_path):
    t = _rich_table(hlt)
    back = t.checkpoint(str(tmp_path / 'c.ht'))
    assert plain(back.collect()) == plain(t.collect())
    got = hlt.eval(hlt.query_table(str(tmp_path / 'c.ht'), 4))
    want = hl.eval(hl.query_table(str(tmp_path / 'c.ht'), 4))
    assert plain(got) == plain(want) and len(got) == 1


_BLOCKED_READ = r'''
import sys


class Block:
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'hail_tpu'):
            raise ImportError('blocked: ' + name)


sys.meta_path.insert(0, Block())
import hail_tpu_torch as hl
hl.init(device='cpu', quiet=True)
rows = hl.read_table(sys.argv[1]).collect()
print(repr([(type(r.a[0]).__module__, type(r.iv).__module__) for r in rows[:1]]))
print(repr(rows))
'''


def test_reference_table_read_with_jax_blocked(hl, tmp_path):
    path = str(tmp_path / 'r.ht')
    _rich_table(hl).write(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, '-c', _BLOCKED_READ, path],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    modules, rows = res.stdout.strip().splitlines()
    assert modules == repr([('hail_tpu_torch.utils.structs',
                             'hail_tpu_torch.utils.structs')])
    assert rows == repr(hlt.read_table(path).collect())


def test_nd_matches_reference(hl):
    a = np.arange(12.0).reshape(3, 4)
    for pkg in (hlt, hl):
        x = pkg.nd.array(a)
        out = pkg.eval(pkg.struct(
            mm=x @ x.T, inv=pkg.nd.inv(x @ x.T + pkg.nd.eye(3)),
            qr=pkg.nd.qr(x)[1], t=x.T.reshape((2, 6)), s=x.sum()))
        if pkg is hlt:
            got = out
    want = out
    for f in ('mm', 'inv', 'qr', 't'):
        np.testing.assert_array_equal(got[f], want[f])
    assert got.s == want.s
