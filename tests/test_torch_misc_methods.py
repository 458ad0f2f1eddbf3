"""The misc and annotator methods of the port against hail_tpu on the same
inputs, on the CPU: `filter_intervals` (on MatrixTables and Tables, keep
and remove, and the partition pruning of a table or MatrixTable read from
disk), `rename_duplicates`, `segment_intervals`, `compute_charr`,
`concordance` (global, per-sample and per-variant), the `require_*`
errors, and `vep` / `nirvana` driving a stub command that echoes JSON.

Inputs are made here from a seed with numpy; `entries_mt` builds the same
MatrixTable in either package (tests/test_torch_family_methods.py and
tests/test_torch_vds.py import it). Floats are held at rtol 1e-12.
"""

import json
import math
import stat
import sys

import numpy as np
import pytest

import hail_tpu as hr
import hail_tpu_torch as hlt
from test_torch_qc import _close
from test_torch_sort import plain


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def entries_mt(pkg, loci, alleles, samples, entries, n_parts=1,
               col_fields=None, filtered=None):
    """A MatrixTable of `pkg` (hail_tpu or hail_tpu_torch) keyed by locus
    (GRCh37) and alleles, columns keyed by `s`: `loci` (contig, position)
    pairs in order, `entries` {name: (type string, (R, C) nested list, None
    for missing)}, `col_fields` {name: (type string, list)}, `filtered` an
    (R, C) bool mask of absent entries; rows split into `n_parts`
    partitions."""
    ht, C, M = pkg.types, pkg.ir.columns, pkg.matrixtable
    rg = pkg.get_reference('GRCh37')
    R, n = len(loci), len(samples)
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    ent_t = ht.tstruct(**{k: ht.dtype(t) for k, (t, _) in entries.items()})
    col_fields = col_fields or {}
    col_t = ht.tstruct(s=ht.tstr, **{k: ht.dtype(t)
                                     for k, (t, _) in col_fields.items()})
    cols = C.Batch.from_pylist(col_t, [
        pkg.Struct(s=s, **{k: v[i] for k, (_, v) in col_fields.items()})
        for i, s in enumerate(samples)])
    bounds = np.linspace(0, R, n_parts + 1).astype(int)
    mbs = []
    for p in range(n_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        rows = C.Batch.from_pylist(row_t, [
            pkg.Struct(locus=pkg.Locus(c, q, rg), alleles=list(a))
            for (c, q), a in zip(loci[lo:hi], alleles[lo:hi])])
        ents = {k: C.from_pylist(ent_t[k], [v for row in vals[lo:hi]
                                            for v in row]).reshape((hi - lo, n))
                for k, (_, vals) in entries.items()}
        filt = None if filtered is None else np.asarray(filtered[lo:hi])
        if filt is not None:
            ents = {k: c.with_missing(c.missing_mask() | filt)
                    for k, c in ents.items()}
        mbs.append(M.MatrixBatch(rows, ents, filt))
    return M.MatrixTable(M.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t, col_t,
        ent_t, mbs))


def random_calls(rng, R, C, missing=0.1, n_alleles=None):
    """(R, C) nested lists of Call-like (j, k) pairs (None where missing)
    with alleles below each row's count (2 by default)."""
    n_alleles = n_alleles if n_alleles is not None else [2] * R
    out = []
    for r in range(R):
        row = []
        for _ in range(C):
            if rng.random() < missing:
                row.append(None)
            else:
                a = sorted(rng.integers(0, n_alleles[r], 2).tolist())
                row.append(tuple(a))
        out.append(row)
    return out


def as_calls(pkg, pairs):
    return [[None if p is None else pkg.Call(list(p)) for p in row]
            for row in pairs]


def both(fn):
    """fn(pkg) for the reference and the port."""
    return fn(hr), fn(hlt)


def same(a, b):
    """Values of the two packages hold the same data (floats at rtol
    1e-12)."""
    return _close(plain(a), plain(b))


# ---------------------------------------------------------------------------
# filter_intervals
# ---------------------------------------------------------------------------

def _chr20_mt(pkg, n_parts=3):
    rng = np.random.default_rng(1)
    pos = np.sort(rng.choice(np.arange(10_000_000, 14_000_000), 60,
                             replace=False)).tolist()
    loci = [('20', p) for p in pos]
    alleles = [['A', 'C']] * 60
    gt = as_calls(pkg, random_calls(rng, 60, 5))
    return entries_mt(pkg, loci, alleles, [f's{i}' for i in range(5)],
                      {'GT': ('call', gt)}, n_parts=n_parts)


@pytest.mark.parametrize('keep', [True, False])
def test_filter_intervals_matrix(keep):
    """tests/test_vcf.py's filter_intervals on a 20-contig MatrixTable:
    rows in [10019093, 13e6] kept (or removed), both packages equal."""
    def run(pkg):
        mt = _chr20_mt(pkg)
        iv = pkg.eval(pkg.parse_locus_interval('20:10019093-20:13e6'))
        f = pkg.filter_intervals(mt, [iv], keep=keep)
        return f.count_rows(), f.rows().collect(), f.entries().collect()
    ref, port = both(run)
    assert 0 < port[0] < 60
    assert same(ref, port)
    for r in port[1]:
        inside = 10019093 <= r.locus.position <= 13_000_000
        assert inside == keep


def test_filter_intervals_table_and_expressions():
    """Intervals given as expressions and as Interval values, several at
    once, on a Table keyed by locus."""
    def run(pkg):
        t = pkg.utils.range_table(100, n_partitions=4)
        t = t.annotate(locus=pkg.locus('1', t.idx * 7 + 1, 'GRCh37'),
                       v=t.idx * 3).key_by('locus').drop('idx')
        ivs = [pkg.parse_locus_interval('1:50-120'),
               pkg.Interval(pkg.Locus('1', 300, 'GRCh37'),
                            pkg.Locus('1', 400, 'GRCh37'), True, True)]
        return pkg.filter_intervals(t, ivs).collect()
    ref, port = both(run)
    assert len(port) > 0 and same(ref, port)
    assert all(50 <= r.locus.position < 120 or 300 <= r.locus.position <= 400
               for r in port)


def test_filter_intervals_prunes_table_partitions(tmp_path):
    """tests/test_projection_pruning.py: filter_intervals on a table read
    from disk reads only the partitions that overlap the interval."""
    t = hlt.utils.range_table(400, n_partitions=8)
    t = t.annotate(locus=hlt.locus('20', t.idx + 1, 'GRCh37'), v=t.idx * 2)
    t = t.key_by('locus').drop('idx')
    p = str(tmp_path / 'loci.ht')
    t.write(p)
    t2 = hlt.read_table(p)
    assert t2._stage.n_partitions == 8
    iv = hlt.utils.Interval(hlt.genetics.Locus('20', 10, 'GRCh37'),
                            hlt.genetics.Locus('20', 60, 'GRCh37'))
    f = hlt.filter_intervals(t2, [iv])
    assert f._stage.n_partitions <= 2, f._stage.n_partitions
    got = f.collect()
    assert len(got) == 50
    assert all(10 <= r.locus.position < 60 for r in got)
    ref = hr.read_table(p)
    riv = hr.utils.Interval(hr.genetics.Locus('20', 10, 'GRCh37'),
                            hr.genetics.Locus('20', 60, 'GRCh37'))
    assert same(hr.filter_intervals(ref, [riv]).collect(), got)


def test_filter_intervals_prunes_matrix_partitions(tmp_path):
    """The same on a MatrixTable written by the port and read back."""
    mt = _chr20_mt(hlt, n_parts=8)
    p = str(tmp_path / 'm.mt')
    mt.write(p)
    mt2 = hlt.read_matrix_table(p)
    assert len(mt2._stage.contexts) == 8
    iv = hlt.eval(hlt.parse_locus_interval('20:10000000-10500000'))
    f = hlt.filter_intervals(mt2, [iv])
    want = [r for r in mt.rows().collect()
            if 10_000_000 <= r.locus.position < 10_500_000]
    assert len(f._stage.contexts) < 8
    assert same(f.rows().collect(), want)


# ---------------------------------------------------------------------------
# rename_duplicates, segment_intervals, require_*
# ---------------------------------------------------------------------------

def test_rename_duplicates():
    samples = ['a', 'b', 'a', 'a_1', 'a', 'b', 'c']

    def run(pkg):
        mt = entries_mt(pkg, [('1', 1)], [['A', 'T']], samples,
                        {'x': ('int32', [list(range(len(samples)))])})
        return [r.unique_id for r in pkg.rename_duplicates(mt).cols().collect()]
    ref, port = both(run)
    assert port == ref
    assert len(set(port)) == len(samples)


def test_segment_intervals():
    def run(pkg):
        t = pkg.Table.parallelize(
            [{'interval': pkg.Interval(pkg.Locus('1', 10, 'GRCh37'),
                                       pkg.Locus('1', 100, 'GRCh37'),
                                       True, False), 'x': 1},
             {'interval': pkg.Interval(pkg.Locus('1', 200, 'GRCh37'),
                                       pkg.Locus('1', 300, 'GRCh37'),
                                       True, True), 'x': 2}],
            pkg.dtype('struct{interval: interval<locus<GRCh37>>, x: int32}'),
            key='interval')
        pts = [pkg.Locus('1', p, 'GRCh37') for p in (50, 75, 250, 500)]
        return pkg.segment_intervals(t, pts).collect()
    ref, port = both(run)
    assert len(port) == 5 and same(ref, port)


def test_require_errors():
    def errors(pkg):
        mt = entries_mt(pkg, [('1', 1), ('1', 2)],
                        [['A', 'T'], ['A', 'T', 'C']], ['s0'],
                        {'x': ('int32', [[1], [2]])})
        out = []
        with pytest.raises(Exception) as e:
            pkg.methods.misc.require_biallelic(mt, 'my_method').rows().collect()
        out.append((type(e.value).__name__, str(e.value)))
        t = pkg.utils.range_table(3)
        with pytest.raises(Exception) as e:
            pkg.methods.misc.require_row_key_variant(t, 'other')
        out.append((type(e.value).__name__, str(e.value)))
        ok = pkg.methods.misc.require_biallelic(
            mt.filter_rows(pkg.len(mt.alleles) == 2), 'm')
        out.append(ok.count_rows())
        return out
    ref, port = both(errors)
    assert port == ref
    assert "'my_method' expects biallelic" in port[0][1]


# ---------------------------------------------------------------------------
# compute_charr and concordance
# ---------------------------------------------------------------------------

def test_compute_charr():
    rng = np.random.default_rng(3)
    R, C = 40, 6
    pairs = random_calls(rng, R, C, missing=0.05)
    ad = [[[int(x) for x in rng.integers(0, 40, 2)] for _ in range(C)]
          for _ in range(R)]
    dp = [[int(rng.integers(5, 120)) for _ in range(C)] for _ in range(R)]
    gq = [[int(rng.integers(0, 99)) for _ in range(C)] for _ in range(R)]
    raf = rng.uniform(0.01, 0.99, R).tolist()
    loci = [('1' if r < 30 else 'X', 1000 + r) for r in range(R)]
    alleles = [['A', 'T'] if r % 5 else ['A', 'TT'] for r in range(R)]

    def run(pkg):
        mt = entries_mt(pkg, loci, alleles, [f's{i}' for i in range(C)],
                        {'GT': ('call', as_calls(pkg, pairs)),
                         'AD': ('array<int32>', ad), 'DP': ('int32', dp),
                         'GQ': ('int32', gq)})
        mt = mt.annotate_rows(raf=pkg.literal(raf)[pkg.int32(
            mt.locus.position - 1000)])
        return pkg.compute_charr(mt, ref_AF=mt.raf).collect()
    ref, port = both(run)
    assert same(ref, port)
    # numpy: hom-var calls with DP in [10, 100], GQ >= 20, on autosomal
    # biallelic SNVs with ref AF in (0.05, 0.95)
    for i, r in enumerate(port):
        num = den = 0
        for row in range(R):
            p = pairs[row][i]
            if (p is None or p[0] != p[1] or p[0] == 0 or row >= 30
                    or row % 5 == 0 or not 10 <= dp[row][i] <= 100
                    or gq[row][i] < 20 or not 0.05 < raf[row] < 0.95):
                continue
            a0, a1 = ad[row][i]
            num += a0 / max(a0 + a1, 1) / raf[row]
            den += 1
        assert math.isclose(r.charr, num / max(den, 1), rel_tol=1e-12,
                            abs_tol=0)


def test_compute_charr_needs_fields_or_reference_af():
    def errors(pkg):
        mt = entries_mt(pkg, [('1', 1)], [['A', 'T']], ['s0'],
                        {'GT': ('call', [[pkg.Call([1, 1])]])})
        with pytest.raises(ValueError) as e1:
            pkg.compute_charr(mt)
        mt = entries_mt(pkg, [('1', 1)], [['A', 'T']], ['s0'],
                        {'GT': ('call', [[pkg.Call([1, 1])]]),
                         'AD': ('array<int32>', [[[1, 9]]]),
                         'GQ': ('int32', [[30]])})
        with pytest.raises(ValueError) as e2:
            pkg.compute_charr(mt)
        return str(e1.value), str(e2.value)
    ref, port = both(errors)
    assert port == ref


def _concordance_inputs(pkg, rng_seed):
    rng = np.random.default_rng(rng_seed)
    loci_l = [('1', 100 + 3 * i) for i in range(30)]
    loci_r = [('1', 100 + 3 * i) for i in range(10, 40)]
    s_l = [f's{i}' for i in range(7)]
    s_r = [f's{i}' for i in range(2, 9)]
    filt_l = rng.random((30, 7)) < 0.1
    left = entries_mt(pkg, loci_l, [['A', 'T']] * 30, s_l,
                      {'GT': ('call', as_calls(pkg, random_calls(rng, 30, 7)))},
                      n_parts=2, filtered=filt_l)
    right = entries_mt(pkg, loci_r, [['A', 'T']] * 30, s_r,
                       {'GT': ('call', as_calls(pkg, random_calls(rng, 30, 7)))},
                       n_parts=3)
    return left, right


def test_concordance():
    """Global, per-sample and per-variant tables of two MatrixTables that
    share 20 variants and 5 samples, with filtered entries on one side."""
    def run(pkg):
        g, cols, rows = pkg.concordance(*_concordance_inputs(pkg, 4))
        return g, cols.collect(), rows.collect()
    ref, port = both(run)
    assert same(ref, port)
    g, cols, rows = port
    assert len(cols) == 5 and len(rows) == 30
    assert sum(map(sum, g)) == 40 * 5
    for r in cols:
        off = sum(r.concordance[i][j] for i in range(2, 5)
                  for j in range(2, 5) if i != j)
        assert r.n_discordant == off


def test_concordance_golden():
    """tests/test_golden_parity.py's exact matrices, on the port."""
    rows1 = [(100, '1', (0, 0)), (100, '2', (0, 0)), (100, '3', (1, 1)),
             (100, '4', (1, 1)), (101, '1', (1, 1))]
    rows2 = [(100, '1', None), (100, '2', (0, 1)), (100, '3', (0, 1)),
             (100, '4', (1, 1))]

    def make_mt(rows):
        return hlt.Table.parallelize(
            [{'locus': hlt.Locus('1', p), 'alleles': ['A', 'T'], 's': s,
              'GT': None if c is None else hlt.Call(list(c))}
             for p, s, c in rows],
            hlt.dtype('struct{locus:locus<GRCh37>,alleles:array<str>,s:str,'
                      'GT:call}')).to_matrix_table(['locus', 'alleles'], ['s'])
    g, cols, rows_t = hlt.concordance(make_mt(rows1), make_mt(rows2))
    assert g == [[3, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 1, 0, 1, 0],
                 [0, 0, 0, 0, 0], [1, 0, 0, 1, 1]]
    n_disc = {r.s: r.n_discordant for r in cols.collect()}
    assert n_disc == {'1': 0, '2': 1, '3': 1, '4': 0}
    rc = {r.locus.position: r for r in rows_t.collect()}
    assert rc[100].concordance == [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
                                   [0, 1, 0, 1, 0], [0, 0, 0, 0, 0],
                                   [0, 0, 0, 1, 1]]
    mt = make_mt(rows1)
    g2, _, _ = hlt.concordance(mt, mt)
    assert sum(map(sum, g2)) == mt.count_rows() * mt.count_cols()
    assert all(g2[i][j] == 0 for i in range(5) for j in range(5) if i != j)


# ---------------------------------------------------------------------------
# vep and nirvana
# ---------------------------------------------------------------------------

_STUB = '''import json, sys
for line in sys.stdin:
    f = line.rstrip('\\n').split('\\t')
    if len(f) < 5:
        continue
    print(json.dumps({'tool': sys.argv[1], 'input': ' '.join(f[:5]),
                      'most_severe_consequence': 'missense_variant'
                      if len(f[3]) == len(f[4]) else 'frameshift_variant'}))
'''


@pytest.fixture
def stub_config(tmp_path):
    """A config whose command is a Python script that echoes one JSON object
    per VCF line it reads."""
    script = tmp_path / 'annotate.py'
    script.write_text(_STUB)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)

    def config(tool):
        p = tmp_path / f'{tool}.json'
        p.write_text(json.dumps({'command': [sys.executable, str(script),
                                             tool]}))
        return str(p)
    return config


def _annotator_mt(pkg):
    return entries_mt(pkg, [('1', 10), ('1', 20), ('2', 5)],
                      [['A', 'T'], ['C', 'CTT'], ['G', 'A', 'C']],
                      ['s0', 's1'], {'x': ('int32', [[1, 2], [3, 4], [5, 6]])},
                      n_parts=2)


@pytest.mark.parametrize('tool', ['vep', 'nirvana'])
def test_annotator_with_stub_command(stub_config, tool):
    """hl.vep / hl.nirvana run the configured command over the variants and
    join its JSON back: equal annotations in both packages, on a MatrixTable
    and on a Table."""
    cfg = stub_config(tool)

    def run(pkg):
        mt = _annotator_mt(pkg)
        fn = getattr(pkg, tool)
        a = fn(mt, config=cfg)
        t = fn(mt.rows(), config=cfg)
        return a.rows().collect(), t.collect(), a.entries().collect()
    ref, port = both(run)
    assert same(ref, port)
    rows = port[0]
    got = [json.loads(r[tool]) for r in rows]
    assert [g['input'] for g in got] == ['1 10 . A T', '1 20 . C CTT',
                                         '2 5 . G A,C']
    assert got[1]['most_severe_consequence'] == 'frameshift_variant'
    assert all(g['tool'] == tool for g in got)


@pytest.mark.parametrize('tool', ['vep', 'nirvana'])
def test_annotator_config_from_environment(stub_config, tool, monkeypatch):
    """Without `config`, the path is read from HAIL_TPU_<TOOL>_CONFIG, as in
    the reference."""
    monkeypatch.setenv(f'HAIL_TPU_{tool.upper()}_CONFIG', stub_config(tool))
    ref, port = both(lambda pkg: getattr(pkg, tool)(
        _annotator_mt(pkg)).rows().collect())
    assert same(ref, port) and len(port) == 3


@pytest.mark.parametrize('tool', ['vep', 'nirvana'])
def test_annotator_without_config_raises(tool, monkeypatch):
    """tests/test_methods.py's gate: no config, the reference's ValueError."""
    monkeypatch.delenv(f'HAIL_TPU_{tool.upper()}_CONFIG', raising=False)

    def err(pkg):
        with pytest.raises(ValueError, match='requires a configuration') as e:
            getattr(pkg, tool)(_annotator_mt(pkg))
        return str(e.value)
    ref, port = both(err)
    assert port == ref


def test_annotator_missing_executable(tmp_path):
    p = tmp_path / 'cfg.json'
    p.write_text(json.dumps({'command': [str(tmp_path / 'no_such_tool')]}))

    def err(pkg):
        with pytest.raises(ValueError, match='not found') as e:
            pkg.vep(_annotator_mt(pkg), config=str(p))
        return str(e.value)
    ref, port = both(err)
    assert port == ref
