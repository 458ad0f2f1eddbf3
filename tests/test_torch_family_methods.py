"""The family methods of the port against hail_tpu on the same inputs, on
the CPU: `trio_matrix` (complete trios or all), `mendel_errors` (autosomes,
X outside and inside the PAR, Y, male and female children), the TDT and
`de_novo` (the Samocha model, autosomal and hemizygous), each table equal
to the reference's, floats at rtol 1e-12; the TDT's t and u also against a
numpy count, mendel_errors' codes against a numpy table of PLINK's rules,
and the de novo posterior against its closed form (tests/test_methods.py).
The experimental trio helpers (`explode_trio_matrix`,
`phase_trio_matrix_by_transmission`) run on a trio matrix made here.
"""

import numpy as np
import pytest

import hail_tpu_torch as hlt
from test_torch_misc_methods import as_calls, both, entries_mt, same

# father, mother, child (sex of the child); fam3 lacks a mother
FAMILIES = [('fam1', 'dad1', 'mom1', 'son1', False),
            ('fam1', 'dad1', 'mom1', 'dtr1', True),
            ('fam2', 'dad2', 'mom2', 'son2', False),
            ('fam2', 'dad2', 'mom2', 'dtr2', True),
            ('fam3', 'dad3', None, 'kid3', False)]
SAMPLES = ['dad1', 'mom1', 'son1', 'dtr1', 'dad2', 'mom2', 'son2', 'dtr2',
           'dad3', 'kid3', 'loner']
# GRCh37: X's PAR1 is 60,001-2,699,520 and Y's 10,001-2,649,520
CONTIGS = [('1', 1_000)] * 40 + [('X', 100_000)] * 20 + \
    [('X', 5_000_000)] * 30 + [('Y', 100_000)] * 10 + [('Y', 5_000_000)] * 20


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def pedigree(pkg):
    return pkg.Pedigree([pkg.Trio(kid, fam_id=fam, pat_id=dad, mat_id=mom,
                                  is_female=female)
                         for fam, dad, mom, kid, female in FAMILIES])


def loci():
    out, last = [], {}
    for c, base in CONTIGS:
        last[c, base] = last.get((c, base), base) + 7
        out.append((c, last[c, base]))
    return out


def genotypes(seed, missing=0.05):
    """(R, C) n_alt in {0, 1, 2}, -1 where missing, drawn so that every
    Mendel code turns up: a quarter of the children's calls are redrawn
    without regard to their parents."""
    rng = np.random.default_rng(seed)
    R, C = len(CONTIGS), len(SAMPLES)
    g = rng.integers(0, 3, (R, C))
    idx = {s: i for i, s in enumerate(SAMPLES)}
    for _, dad, mom, kid, _ in FAMILIES:
        d = g[:, idx[dad]]
        m = g[:, idx[mom]] if mom else rng.integers(0, 3, R)
        from_d = (rng.random(R) < d / 2).astype(int)
        from_m = (rng.random(R) < m / 2).astype(int)
        g[:, idx[kid]] = np.where(rng.random(R) < 0.25, rng.integers(0, 3, R),
                                  from_d + from_m)
    g[rng.random((R, C)) < missing] = -1
    return g


def calls_of(g):
    return [[None if x < 0 else (int(x == 2), int(x >= 1)) for x in row]
            for row in g]


def family_mt(pkg, g, n_parts=3, extra=None):
    R = len(CONTIGS)
    ents = {'GT': ('call', as_calls(pkg, calls_of(g)))}
    ents.update(extra or {})
    return entries_mt(pkg, loci(), [['A', 'C']] * (R - 5) + [['A', 'CT']] * 5,
                      SAMPLES, ents, n_parts=n_parts)


@pytest.mark.parametrize('complete', [True, False])
def test_trio_matrix(complete):
    g = genotypes(1)

    def run(pkg):
        tm = pkg.trio_matrix(family_mt(pkg, g), pedigree(pkg),
                             complete_trios=complete)
        return tm.cols().collect(), tm.entries().collect(), tm.count()
    ref, port = both(run)
    assert same(ref, port)
    assert port[2] == (len(CONTIGS), 4 if complete else 5)


def mendel_oracle(g):
    """PLINK's Mendel codes per (row, complete trio), from n_alt: 1-8 where
    the child has two copies (autosomes, PARs, female children), 9-10 on
    X outside the PAR for male children (the mother alone), 11-12 on Y
    outside the PAR for male children (the father alone)."""
    idx = {s: i for i, s in enumerate(SAMPLES)}
    contig = np.asarray([c for c, _ in loci()])
    pos = np.asarray([p for _, p in loci()])
    x_np = (contig == 'X') & ~((pos >= 60_001) & (pos < 2_699_521))
    y_np = (contig == 'Y') & ~((pos >= 10_001) & (pos < 2_649_521))
    out = {}
    for fam, dad, mom, kid, female in FAMILIES:
        if mom is None:
            continue
        k, d, m = g[:, idx[kid]], g[:, idx[dad]], g[:, idx[mom]]
        kc, dc, mc = k >= 0, d >= 0, m >= 0
        hr_, hv = (lambda a, c: c & (a == 0)), (lambda a, c: c & (a == 2))
        auto = ~(x_np | y_np) | female
        for r in range(len(k)):
            code = 0
            if auto[r]:
                if kc[r] and k[r] == 1:
                    code = (1 if hv(d, dc)[r] and hv(m, mc)[r] else
                            2 if hr_(d, dc)[r] and hr_(m, mc)[r] else 0)
                elif hv(k, kc)[r]:
                    code = (5 if hr_(d, dc)[r] and hr_(m, mc)[r] else
                            3 if hr_(d, dc)[r] else
                            4 if hr_(m, mc)[r] else 0)
                elif hr_(k, kc)[r]:
                    code = (8 if hv(d, dc)[r] and hv(m, mc)[r] else
                            6 if hv(d, dc)[r] else
                            7 if hv(m, mc)[r] else 0)
            elif x_np[r]:
                code = (9 if hr_(k, kc)[r] and hv(m, mc)[r] else
                        10 if hv(k, kc)[r] and hr_(m, mc)[r] else 0)
            else:
                code = (11 if hr_(k, kc)[r] and hv(d, dc)[r] else
                        12 if hv(k, kc)[r] and hr_(d, dc)[r] else 0)
            if code:
                out[(r, kid)] = code
    return out


@pytest.mark.parametrize('seed', [2, 3])
def test_mendel_errors(seed):
    g = genotypes(seed)

    def run(pkg):
        tabs = pkg.mendel_errors(family_mt(pkg, g).GT, pedigree(pkg))
        return [t.collect() for t in tabs]
    ref, port = both(run)
    assert same(ref, port)
    men, fam, ind, var = port
    pos_row = {(c, p): r for r, (c, p) in enumerate(loci())}
    got = {(pos_row[(e.locus.contig, e.locus.position)], e.s): e.mendel_code
           for e in men}
    want = mendel_oracle(g)
    assert got == want
    codes = set(want.values())
    assert {9, 10} & codes and {11, 12} & codes and {1, 2, 5, 8} & codes
    assert sum(r.errors for r in var) == len(want)
    assert sum(r.errors for r in fam) == len(want)
    # the last 5 rows are insertions, the others SNPs
    assert sum(r.snp_errors for r in fam) == sum(
        r < len(CONTIGS) - 5 for (r, _) in want)
    kids = {r.s: r.errors for r in ind}
    for _, _, mom, kid, _ in FAMILIES:
        if mom is not None:
            assert kids[kid] == sum(1 for (_, k) in want if k == kid)


def tdt_oracle(g, trios):
    """t and u per row from n_alt (-1 missing) over (kid, dad, mom) column
    triples, autosomes and X's PAR (both parents transmit), as
    chip_smoke.tdt_oracle counts them."""
    k, d, m = g[:, trios[:, 0]], g[:, trios[:, 1]], g[:, trios[:, 2]]
    ok = (k >= 0) & (d >= 0) & (m >= 0)
    dh, mh = ok & (d == 1), ok & (m == 1)
    one = dh ^ mh
    tr = np.where(dh, k - m // 2, k - d // 2)
    t = np.where(one, tr, 0) + np.where(dh & mh, k, 0)
    u = np.where(one, 1 - tr, 0) + np.where(dh & mh, 2 - k, 0)
    return t.sum(axis=1), u.sum(axis=1)


def test_transmission_disequilibrium_test():
    """On calls consistent with the pedigree: equal to the reference, and
    t and u equal numpy's count on the autosomal rows; X rows are kept, Y
    rows dropped."""
    rng = np.random.default_rng(5)
    g = genotypes(4, missing=0.03)
    idx = {s: i for i, s in enumerate(SAMPLES)}
    trios = np.asarray([(idx[k], idx[d], idx[m]) for _, d, m, k, _ in FAMILIES
                        if m is not None])
    for k_, d_, m_ in trios:           # the children drawn from their parents
        dd, mm = g[:, d_], g[:, m_]
        kid = ((rng.random(len(dd)) < np.clip(dd, 0, 2) / 2).astype(int)
               + (rng.random(len(mm)) < np.clip(mm, 0, 2) / 2))
        g[:, k_] = np.where((dd < 0) | (mm < 0), -1, kid)

    def run(pkg):
        return pkg.transmission_disequilibrium_test(
            family_mt(pkg, g), pedigree(pkg)).collect()
    ref, port = both(run)
    assert same(ref, port)
    contigs = [c for c, _ in loci()]
    assert len(port) == sum(c != 'Y' for c in contigs)
    auto = [r for r, c in enumerate(contigs) if c == '1']
    t_want, u_want = tdt_oracle(g[auto], trios)
    assert [r.t for r in port[:len(auto)]] == t_want.tolist()
    assert [r.u for r in port[:len(auto)]] == u_want.tolist()
    assert sum(t_want + u_want) > 0


def de_novo_fields(seed):
    """AD, DP, GQ and PL beside genotypes in which each child is het on
    a fifth of the rows where both parents are hom-ref (planted de novo
    sites), parents' AD mostly reference."""
    rng = np.random.default_rng(seed)
    g = genotypes(seed, missing=0.02)
    idx = {s: i for i, s in enumerate(SAMPLES)}
    for _, dad, mom, kid, _ in FAMILIES:
        if mom is None:
            continue
        both_ref = (g[:, idx[dad]] == 0) & (g[:, idx[mom]] == 0)
        plant = both_ref & (rng.random(len(g)) < 0.2)
        g[plant, idx[kid]] = 1
    R, C = g.shape
    ad, dp, gq, pl = [], [], [], []
    for r in range(R):
        ad_r, dp_r, gq_r, pl_r = [], [], [], []
        for c in range(C):
            x = g[r, c]
            depth = int(rng.integers(8, 60))
            alt = {0: int(rng.binomial(depth, 0.01)),
                   1: int(rng.binomial(depth, 0.45)),
                   2: depth - int(rng.binomial(depth, 0.02))}.get(x, 0)
            best = max(x, 0)
            p = [int(rng.integers(10, 200)) for _ in range(3)]
            p[best] = 0
            ad_r.append([depth - alt, alt])
            dp_r.append(depth + int(rng.integers(0, 3)))
            gq_r.append(int(sorted(p)[1]) if rng.random() > 0.05 else None)
            pl_r.append(p)
        ad.append(ad_r)
        dp.append(dp_r)
        gq.append(gq_r)
        pl.append(pl_r)
    return g, {'AD': ('array<int32>', ad), 'DP': ('int32', dp),
               'GQ': ('int32', gq), 'PL': ('array<int32>', pl)}


@pytest.mark.parametrize('ignore_af', [False, True])
def test_de_novo(ignore_af):
    g, extra = de_novo_fields(6)

    def run(pkg):
        mt = family_mt(pkg, g, extra=extra)
        mt = mt.annotate_rows(prior=pkg.float64(
            (mt.locus.position % 97) / 2000.0))
        return pkg.de_novo(mt, pedigree(pkg), pop_frequency_prior=mt.prior,
                           ignore_in_sample_allele_frequency=ignore_af
                           ).collect()
    ref, port = both(run)
    assert same(ref, port)
    assert len(port) > 5
    contigs = {r.locus.contig for r in port}
    assert '1' in contigs and 'X' in contigs
    assert {r.confidence for r in port} <= {'HIGH', 'MEDIUM', 'LOW'}
    assert all(0.05 <= r.p_de_novo <= 1 for r in port)


def test_de_novo_reference_model():
    """tests/test_methods.py: a strong de novo kept with HIGH confidence
    and its posterior equal to the closed form; an ambiguous father's site
    filtered by min_p. Both packages equal."""
    def run(pkg):
        rows = []
        for i, (kpl, dpl, mpl) in enumerate([
                ([90, 0, 90], [0, 60, 90], [0, 60, 90]),
                ([50, 0, 50], [0, 3, 30], [0, 60, 90])]):
            for s, gt, pl, ad in [('kid', [0, 1], kpl, [10, 10]),
                                  ('dad', [0, 0], dpl, [20, 0]),
                                  ('mom', [0, 0], mpl, [20, 0])]:
                rows.append({'locus': pkg.Locus('1', 100 + i),
                             'alleles': ['A', 'T'], 's': s,
                             'GT': pkg.Call(gt), 'AD': ad, 'DP': sum(ad),
                             'GQ': 50, 'PL': pl})
        t = pkg.Table.parallelize(rows, pkg.dtype(
            'struct{locus: locus<GRCh37>, alleles: array<str>, s: str, '
            'GT: call, AD: array<int32>, DP: int32, GQ: int32, '
            'PL: array<int32>}'))
        mt = t.to_matrix_table(['locus', 'alleles'], ['s'])
        ped = pkg.Pedigree([pkg.Trio('kid', fam_id='f1', pat_id='dad',
                                     mat_id='mom', is_female=False)])
        return pkg.de_novo(mt, ped, pop_frequency_prior=0.001).collect()
    ref, port = both(run)
    assert same(ref, port)
    assert len(port) == 1
    x = port[0]
    assert x.locus.position == 100 and x.confidence == 'HIGH'
    dnp = 1 / 3e7
    p_het = 1 - (1 - 0.001) ** 4
    norm_p = 1 / (1 + 2 * 1e-6)
    num = norm_p * norm_p * dnp
    den = num + 2 * (1e-6 * norm_p) * norm_p * p_het
    assert x.p_de_novo == pytest.approx(num / den, rel=1e-3)
    assert x.proband_entry.GT is not None and x.prior == pytest.approx(0.001)


def test_de_novo_requires_fields():
    def err(pkg):
        mt = family_mt(pkg, genotypes(7))
        with pytest.raises(ValueError) as e:
            pkg.de_novo(mt, pedigree(pkg), pop_frequency_prior=0.01)
        return str(e.value)
    ref, port = both(err)
    assert port == ref


def test_pedigree_from_fam_file(tmp_path):
    """A pedigree read from a .fam file drives mendel_errors as the one built
    from Trios does."""
    p = tmp_path / 'fams.fam'
    lines = []
    for fam, dad, mom, kid, female in FAMILIES:
        lines.append(f'{fam}\t{kid}\t{dad}\t{mom or 0}\t{2 if female else 1}\t0')
    p.write_text('\n'.join(lines) + '\n')
    g = genotypes(8)

    def run(pkg):
        ped = pkg.Pedigree.read(str(p))
        return [t.collect() for t in pkg.mendel_errors(family_mt(pkg, g).GT,
                                                       ped)]
    ref, port = both(run)
    assert same(ref, port)
    built = [t.collect() for t in hlt.mendel_errors(family_mt(hlt, g).GT,
                                                    pedigree(hlt))]
    assert same(port[0], built[0])


def test_explode_and_phase_trio_matrix():
    """tests/test_methods.py's trio helpers on a trio matrix made here."""
    g = genotypes(9)

    def run(pkg):
        tm = pkg.trio_matrix(family_mt(pkg, g), pedigree(pkg),
                             complete_trios=True)
        ex = pkg.experimental.explode_trio_matrix(tm)
        ph = pkg.experimental.phase_trio_matrix_by_transmission(tm)
        return (ex.count(), ex.entries().collect(),
                ph.entries().collect())
    ref, port = both(run)
    assert same(ref, port)
    assert port[0][1] == 3 * 4
    phased = [e.proband_entry.get('PBT_GT') for e in port[2]
              if e.proband_entry and e.proband_entry.get('PBT_GT') is not None]
    assert phased and all(c.phased for c in phased)
