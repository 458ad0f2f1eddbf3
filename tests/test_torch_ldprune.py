"""The port's ld_prune tier against hail_tpu on the same inputs, on the CPU:
`ops/ldprune.standardize_rows_device` and `banded_r2_hits`, and
`hl.ld_prune` on a MatrixTable with planted LD, a duplicate row key, a
second contig, an all-missing and a monomorphic row, over three partitions,
by both routes (packed GT calls through the cached (gz8, m8) pair, and a
float entry evaluated on the host).

Tolerances: the per-variant means and the `ok` flags equal (integer sums
and one division); Z at rtol 1e-14 (its row norm is a sum of squares taken
in another order); the bit-packed bands and the kept keys equal. Two f64
products in different orders can flip a pair whose r² lies within
roundoff of the threshold, so every test asserts first that no r² of its
windows lies within 1e-9 of it.
"""

import importlib

import numpy as np
import pytest

import hail_tpu_torch as hlt

N_SAMPLES = 200
PARTS = (40, 40, 45)
CONTIG_SPLIT = 100          # rows from here on lie on the second contig
DUPLICATE_ROW = 55          # same key as the row before it
MONOMORPHIC_ROW, MISSING_ROW = 5, 9
MARGIN = 1e-9


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def ld_genotypes(m, n, rng):
    """n_alt (m, n) with planted LD: about 70% of the rows copy the row
    before them with 10% of the calls drawn again (r² ~ 0.8 to it, less to
    the rows before), the others are drawn afresh (r² ~ 1/n)."""
    nalt = np.empty((m, n), np.int32)
    for i in range(m):
        if i and rng.random() < 0.7:
            row = nalt[i - 1].copy()
            redraw = rng.random(n) < 0.1
            row[redraw] = rng.integers(0, 3, int(redraw.sum()))
        else:
            row = rng.integers(0, 3, n)
        nalt[i] = row
    return nalt


def build_ld_mt(pkg: str, seed: int = 0, n_samples=N_SAMPLES, parts=PARTS):
    """A MatrixTable in package `pkg`: packed GT calls (5% missing) with
    planted LD, a float entry X = n_alt (missing where GT is), a phenotype,
    and row keys (locus, alleles) ascending over two contigs with one
    duplicate. Returns (mt, nalt, missing, contig index, position)."""
    ht = importlib.import_module(f'{pkg}.types')
    call = importlib.import_module(f'{pkg}.genetics.call')
    cols_mod = importlib.import_module(f'{pkg}.ir.columns')
    mtm = importlib.import_module(f'{pkg}.matrixtable')
    rg = importlib.import_module(f'{pkg}.genetics.reference_genome')
    Batch, PC, OC = cols_mod.Batch, cols_mod.PrimitiveColumn, cols_mod.ObjectColumn
    ref = rg.default_reference()
    rng = np.random.default_rng(seed)
    m = sum(parts)
    nalt = ld_genotypes(m, n_samples, rng)
    nalt[MONOMORPHIC_ROW] = 1
    miss = rng.random((m, n_samples)) < 0.05
    miss[MISSING_ROW] = True
    cidx = (np.arange(m) >= CONTIG_SPLIT).astype(np.int32)
    gaps = rng.integers(1, 4, m)
    gaps[DUPLICATE_ROW] = 0
    pos = np.empty(m, np.int32)
    for c in (0, 1):
        on = cidx == c
        pos[on] = 1000 + np.cumsum(gaps[on])
    mbs, lo = [], 0
    for r in parts:
        sl = slice(lo, lo + r)
        gt = call.pack_diploid((nalt[sl] == 2).astype(np.int32),
                               (nalt[sl] >= 1).astype(np.int32))
        alleles = np.empty(r, dtype=object)
        alleles[:] = [['A', 'T']] * r
        rows = Batch({
            'locus': cols_mod.LocusColumn(ht.tlocus(ref), cidx[sl], pos[sl]),
            'alleles': OC(ht.tarray(ht.tstr), alleles)}, r)
        mbs.append(mtm.MatrixBatch(rows, {
            'GT': PC(ht.tcall, gt, miss[sl]),
            'X': PC(ht.tfloat64, nalt[sl].astype(np.float64), miss[sl])}))
        lo += r
    cols = {'s': OC(ht.tstr, np.asarray([f's{i}' for i in range(n_samples)],
                                        object)),
            'pheno': PC(ht.tfloat64, rng.normal(size=n_samples))}
    row_t = ht.tstruct(locus=ht.tlocus(ref), alleles=ht.tarray(ht.tstr))
    mt = mtm.MatrixTable(mtm.MatrixStage.from_batches(
        Batch({}, 1), Batch(cols, n_samples), ['locus', 'alleles'], ['s'],
        row_t, ht.tstruct(s=ht.tstr, pheno=ht.tfloat64),
        ht.tstruct(GT=ht.tcall, X=ht.tfloat64), mbs))
    return mt, nalt, miss, cidx, pos


def standardized(nalt, miss):
    """The ld_prune normalization in numpy: unit-norm mean-imputed rows."""
    G = nalt.astype(np.float64)
    cnt = (~miss).sum(axis=1)
    mean = np.where(cnt > 0, np.where(miss, 0, G).sum(axis=1)
                    / np.maximum(cnt, 1), 0.0)
    c = np.where(miss, mean[:, None], G) - mean[:, None]
    ss = np.sqrt((c * c).sum(axis=1))
    return np.where(ss[:, None] > 0, c / np.where(ss > 0, ss, 1)[:, None], 0.0)


def assert_margin(Z, r2, pairs):
    """No r² of the pairs (i, j) lies within MARGIN of the threshold."""
    i, j = pairs
    r = np.einsum('ij,ij->i', Z[i], Z[j])
    gap = np.abs(r * r - r2)
    assert gap.min() > MARGIN, (gap.min(), i[gap.argmin()], j[gap.argmin()])


def window_pairs(cidx, pos, bp):
    """All pairs j < i on one contig with pos[i] - pos[j] <= bp."""
    i, j = np.tril_indices(len(pos), -1)
    keep = (cidx[i] == cidx[j]) & (pos[i] - pos[j] <= bp)
    return i[keep], j[keep]


def test_standardize_rows_device_matches_reference():
    import jax.numpy as jnp
    import torch
    from hail_tpu.ops.ldprune import standardize_rows_device as ref
    from hail_tpu_torch.ops.ldprune import standardize_rows_device as port
    rng = np.random.default_rng(3)
    nalt = ld_genotypes(64, 150, rng)
    nalt[7] = 2                                      # monomorphic
    miss = rng.random(nalt.shape) < 0.05
    miss[11] = True                                  # every call missing
    gz8 = np.where(miss, 0, nalt).astype(np.int8)
    m8 = miss.astype(np.int8)
    z_r, mean_r, ok_r = ref(jnp.asarray(gz8), jnp.asarray(m8))
    z_p, mean_p, ok_p = port(torch.from_numpy(gz8), torch.from_numpy(m8))
    assert z_p.dtype == torch.float64
    np.testing.assert_array_equal(mean_p, mean_r)
    np.testing.assert_array_equal(ok_p, ok_r)
    assert not ok_p[7] and not ok_p[11] and ok_p.sum() == 62
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_r), rtol=1e-14,
                               atol=0)


@pytest.mark.parametrize('m,w,block', [
    (200, 13, 64),      # ragged last block, w not a multiple of 8
    (128, 8, 64),       # whole blocks, one byte per row
    (50, 1, 2048),      # one block larger than the matrix
    (90, 40, 16),       # window wider than a block
])
def test_banded_r2_hits_bits_match_reference(m, w, block):
    import jax.numpy as jnp
    import torch
    from hail_tpu.ops import ldprune as ref
    from hail_tpu_torch.ops import ldprune as port
    rng = np.random.default_rng(m + w)
    nalt = ld_genotypes(m, 120, rng)
    Z = standardized(nalt, np.zeros(nalt.shape, bool))
    i, k = np.meshgrid(np.arange(m), np.arange(w), indexing='ij')
    j = i - w + k
    inside = j >= 0
    assert_margin(Z, 0.2, (i[inside], j[inside]))
    got = list(port.banded_r2_hits(torch.from_numpy(Z), w, 0.2, block))
    want = list(ref.banded_r2_hits(jnp.asarray(Z), w, 0.2, block))
    assert [(s, e) for s, e, _ in got] == [(s, e) for s, e, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    bits = np.concatenate([h for _, _, h in got])
    assert bits.any() and not bits.all()
    # and against the definition: r²(i, i - w + k) >= 0.2
    r = np.where(inside, np.einsum('ikn,ikn->ik', Z[i],
                                   Z[np.maximum(j, 0)]), 0.0)
    np.testing.assert_array_equal(bits, r * r >= 0.2)


def _kept_keys(t):
    return [(r.locus.contig, r.locus.position, tuple(r.alleles))
            for r in t.collect()]


@pytest.mark.parametrize('route', ['gt', 'float_entry'])
@pytest.mark.parametrize('r2,bp', [(0.2, 5), (0.2, 1_000_000), (0.5, 12)])
def test_ld_prune_matches_reference(hl, route, r2, bp):
    mt_r, nalt, miss, cidx, pos = build_ld_mt('hail_tpu')
    mt_p, *_ = build_ld_mt('hail_tpu_torch')
    assert_margin(standardized(nalt, miss), r2, window_pairs(cidx, pos, bp))
    entry = (lambda mt: mt.GT) if route == 'gt' else (lambda mt: mt.X)
    want = _kept_keys(hl.ld_prune(entry(mt_r), r2=r2, bp_window_size=bp))
    got = _kept_keys(hlt.ld_prune(entry(mt_p), r2=r2, bp_window_size=bp))
    assert got == want
    # the data prunes: fewer kept than eligible rows (distinct keys, not
    # monomorphic, not all missing), but not all of them
    assert 0 < len(got) < sum(PARTS) - 3


def test_ld_prune_reads_linreg_cached_pair(monkeypatch):
    from hail_tpu_torch.ops import devcache, linreg_i8
    mt, *_ = build_ld_mt('hail_tpu_torch')
    unpacked = []
    real = linreg_i8.unpack_gt_2bit

    def counting(*a, **kw):
        unpacked.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(linreg_i8, 'unpack_gt_2bit', counting)
    devcache.clear()
    hlt.linear_regression_rows(y=mt.pheno, x=mt.GT.n_alt_alleles(),
                               covariates=[1.0]).collect()
    assert len(unpacked) == len(PARTS)
    before = devcache.stats()
    kept = hlt.ld_prune(mt.GT, r2=0.2, bp_window_size=5).count()
    after = devcache.stats()
    assert kept > 0
    assert len(unpacked) == len(PARTS)                # no decode again
    assert after['hits'] - before['hits'] == len(PARTS)
    assert after['misses'] == before['misses']
