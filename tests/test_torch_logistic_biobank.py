"""`hl.logistic_regression_rows(test='wald')` of the port at the shape of a
UK Biobank case-control GWAS, cut to a size the CPU holds: 3,000 samples,
the Neale lab's 26 covariate terms (`gwasbench/configs/
ukb_neale_logistic.json`), 256 variants in 4 partitions, a binary phenotype
at case shares near 5% and 20% (the null fit converges at this size), two
seeds. Held to the benchmark's plain torch reference
(`gwasbench/reference/logistic.py`: one variant at a time, LU solves), the
Newton tier's memory budget (`ops/glm_device`) forced to several blocks
against one block, and the spans a traced call records.

Tolerances: `n_iterations`, `converged` and `exploded` equal. beta,
standard_error, z_stat and p_value within 1e-9 of the reference's median
magnitude of each: both fits are f64 Newton iterations to |Δb| < 1e-8
from the same start, stopping at the same iteration, so they differ by
the solves' roundoff (Cholesky against LU) on a Fisher matrix whose
unscaled covariates (age², sex·age² near 5,000, PCs of sd 0.01) make it
ill-conditioned; 1e-9 leaves that roundoff, seen up to 3.2e-11 here,
room of thirty times. Under a forced budget the rows are the same fits in
other blocks, whose matrix products sum in another order: equal iteration
counts and flags, and values within 1e-10 of the median magnitude (seen
up to 3.5e-12).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import hail_tpu_torch as hlt
from hail_tpu_torch.ops import devcache, glm_device
from hail_tpu_torch.utils import timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES, N_VARIANTS, N_PARTS = 3000, 256, 4
FLOAT = ('beta', 'standard_error', 'z_stat', 'p_value')
EXACT = ('n_iterations', 'converged', 'exploded')
CASES = [(11, 0.05), (12, 0.20)]


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def _config():
    with open(os.path.join(ROOT, 'gwasbench', 'configs',
                           'ukb_neale_logistic.json')) as f:
        return json.load(f)


def _cohort(seed: int, share: float):
    """The MatrixTable, its calls and masks, the (n, 26) covariates, their
    expressions and the 0/1 phenotype `case` with the top `share` of a
    seeded liability as cases."""
    from gwasbench import data
    cfg = _config()
    cpu = torch.device('cpu')
    gen = data.generator(seed, cpu)
    cols = data.make_columns(gen, cpu, N_SAMPLES, cfg['column_fields'], 1)
    y = cols.pop('y0')
    cols['case'] = (y > np.quantile(y, 1 - share)).astype(np.float64)
    per = N_VARIANTS // N_PARTS
    parts = [data.make_calls(gen, cpu, per, N_SAMPLES, cfg['maf_min'],
                             cfg['missing']) for _ in range(N_PARTS)]
    terms = data.covariate_terms(cfg['covariates'])
    mt = data.matrix_table(parts, data.column_batch(cols))
    n_alt = np.concatenate([data.decode_n_alt(p) for p, _ in parts])
    missing = np.concatenate([m for _, m in parts])
    C = data.covariate_matrix(terms, cols, N_SAMPLES)
    return mt, n_alt, missing, C, data.covariate_exprs(mt, terms), \
        cols['case']


def _wald(mt, covariates) -> dict:
    """The program's fields as host arrays, the fit's by their names."""
    res = hlt.logistic_regression_rows(
        test='wald', y=mt.case, x=mt.GT.n_alt_alleles(),
        covariates=covariates)
    batches = res._stage.collect_batches()
    out = {f: np.concatenate([np.asarray(b.columns[f].values)
                              for b in batches]) for f in FLOAT}
    for f in EXACT:
        out[f] = np.concatenate([np.asarray(b.columns['fit'].fields[f].values)
                                 for b in batches])
    return out


def _assert_rows(got: dict, want: dict, rel: float):
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(want[f]), err_msg=f)
    for f in FLOAT:
        g, w = np.asarray(got[f], np.float64), np.asarray(want[f], np.float64)
        assert np.array_equal(np.isfinite(g), np.isfinite(w)), f
        ok = np.isfinite(w)
        scale = float(np.median(np.abs(w[ok])))
        gap = float(np.max(np.abs(g[ok] - w[ok]), initial=0.0))
        assert gap <= rel * scale, (f, gap, scale)


@pytest.mark.parametrize('seed,share', CASES)
def test_wald_matches_the_plain_reference(seed, share):
    from gwasbench.reference import logistic
    mt, n_alt, missing, C, covariates, case = _cohort(seed, share)
    assert abs(case.mean() - share) < 0.01
    got = _wald(mt, covariates)
    want = logistic.wald_rows(n_alt, missing, logistic.Covariates(
        C, torch.float64, torch.device('cpu')), case)
    want = {f.split('.')[-1]: v for f, v in want.items()}
    assert want['converged'].mean() > 0.9
    _assert_rows(got, want, 1e-9)


@pytest.mark.parametrize('seed,share', CASES)
def test_forced_budget_gives_the_same_rows(seed, share, monkeypatch):
    """A budget that holds 24 rows of this width a block splits each
    partition of 64 rows into 3 blocks, of 22, 22 and 20 rows, which the
    fits do not see."""
    mt, _, _, _, covariates, _ = _cohort(seed, share)
    devcache.clear()
    one = _wald(mt, covariates)
    row_bytes, fixed = glm_device._newton_bytes(N_SAMPLES, 26)
    monkeypatch.setattr(glm_device, '_capacity', lambda dev: (
        glm_device._IN_FLIGHT * (fixed + 24 * row_bytes)))
    timer.clear()
    with timer.recording():
        several = _wald(mt, covariates)
    rows = sorted(s.attrs['rows'] for s in timer.spans()
                  if s.name == 'glm.newton')
    assert rows == [20] * 4 + [22] * 8
    _assert_rows(several, one, 1e-10)
    timer.clear()


def test_traced_call_records_the_glm_spans():
    """glm.call and its column, null-fit, Newton, Wald, fetch and p-value
    spans, with their attributes, in the call's one action."""
    mt, _, _, _, covariates, case = _cohort(*CASES[0])
    devcache.clear()
    timer.clear()
    with timer.recording():
        out = _wald(mt, covariates)
    spans = timer.spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (call,) = by['glm.call']
    assert call.attrs == {'test': 'wald', 'phenotypes': 1}
    assert {s.action for s in spans} == {call.action}
    (cols,) = by['glm.columns']
    (null,) = by['glm.null']
    assert cols.parent == null.parent == call.id
    assert null.attrs['samples'] == N_SAMPLES
    assert null.attrs['covariates'] == 26
    assert null.attrs['iterations'] >= 2
    newton = by['glm.newton']
    assert len(newton) == N_PARTS          # one block a partition here
    for s in newton:
        assert s.attrs['rows'] == N_VARIANTS // N_PARTS
        assert s.attrs['samples'] == N_SAMPLES
        assert s.attrs['covariates'] == 26
        # every row is active in the first iteration, none after the last
        assert (s.attrs['rows'] <= s.attrs['row_iters']
                <= s.attrs['rows'] * s.attrs['iterations'])
    assert sum(s.attrs['row_iters'] for s in newton) >= int(
        out['n_iterations'].sum())
    assert len(by['glm.wald']) == len(by['glm.pvalues']) == N_PARTS
    fetches = by['fetch']
    # per partition one (rows, b 27 + n_iter + ll + status + se + z) f64
    assert sorted(s.attrs['bytes'] for s in fetches) == \
        [(N_VARIANTS // N_PARTS) * (27 + 5) * 8] * N_PARTS
    timer.clear()


@pytest.mark.parametrize('N,k,cache,rows', [
    (361_194, 26, 5.9e9, None), (361_194, 26, 0, None),
    (3_000, 26, 0, glm_device._MAX_BLOCK), (2_504, 5, 1e9,
                                            glm_device._MAX_BLOCK)])
def test_blocks_follow_width_and_budget(N, k, cache, rows):
    """On an 80 GB card, beside a device cache of `cache` bytes: blocks of
    at most `_MAX_BLOCK` rows, `_IN_FLIGHT` of which fit the budget, and
    a partition of 1,024 rows in blocks of nearly one size."""
    capacity = int(80e9 - cache) // 2
    row_bytes, fixed = glm_device._newton_bytes(N, k)
    block = glm_device._row_block(1024, row_bytes, fixed, capacity,
                                  glm_device._MAX_BLOCK)
    if rows is not None:
        assert block == min(rows, 1024)
    else:
        assert glm_device._MIN_BLOCK <= block < 1024
        assert glm_device._IN_FLIGHT * (fixed + block * row_bytes) \
            <= capacity
        n = -(-1024 // block)
        assert 0 <= n * block - 1024 < n


def test_budget_holds_under_contention():
    """32 threads take and give back holds of random sizes on one budget:
    what is held never passes the capacity but for one hold alone, and
    nothing is held at the end."""
    import random
    import sys
    budget = glm_device._Budget()
    capacity, seen, errors = 100, [], []
    lock = threading.Lock()
    held = [0]

    def worker(seed):
        rng = random.Random(seed)
        try:
            for _ in range(200):
                n = rng.choice([1, 10, 40, 150])
                with budget.hold(n, capacity):
                    with lock:
                        held[0] += n
                        seen.append((held[0], n))
                    time.sleep(0)
                    with lock:
                        held[0] -= n
        except Exception as e:          # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 32 * 200
    assert all(h <= capacity or h == n for h, n in seen)
    assert budget._held == 0
