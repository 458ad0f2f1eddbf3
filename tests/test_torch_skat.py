"""SKAT in the port against hail_tpu and R's SKAT package, on the CPU.

`skat`, `_linear_skat` and `_logistic_skat` are host numpy code in both
packages (the port's is a copy), so every row collected from the port
equals the reference's row exactly. The inputs are the inline data of the
R goldens (tests/test_golden_parity.py:185-253), whose q_stat and p_value
are held to R's values as there, and balding_nichols_model data in two
groups. Errors: a negative weight, a phenotype that is not binary, and a
logistic null fit that does not converge (too few iterations, a
separated phenotype) or explodes (collinear covariates) raise the same error
class with the same message in both packages; a group over `max_size` gives
a row of missing statistics.
"""

import pytest

import hail_tpu as hr
import hail_tpu_torch as hlt
from test_torch_sort import plain

LINEAR_GENOS = [[0, 1, 0, 0, 0], [1, 0, 0, 0, 0], [0, 1, 2, 0, 2],
                [1, 0, 0, 2, 1]]
LINEAR_COV = [[1, 2], [3, 4], [0, 9], [6, 1], [1, 1]]
LINEAR_PHENO = [3, 4, 6, 4, 1]
LOGISTIC_GENOS = [
    [2, 1, 1, 1, 0, 1, 1, 2, 1, 1, 2, 1, 0, 0, 1],
    [1, 0, 1, 1, 1, 2, 0, 2, 1, 1, 0, 1, 1, 0, 0],
    [0, 2, 0, 0, 2, 1, 1, 2, 2, 1, 1, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 0],
]
LOGISTIC_COV = [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0]
LOGISTIC_PHENO = [0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 1, 0, 0]


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def _linear_mt(h, weights=None):
    mt = h.utils.range_matrix_table(4, 5)
    mt = mt.annotate_entries(GT=h.unphased_diploid_gt_index_call(
        h.literal(LINEAR_GENOS)[mt.row_idx][mt.col_idx]))
    mt = mt.annotate_cols(
        phenotype=h.literal(LINEAR_PHENO)[mt.col_idx],
        cov1=h.map(lambda r: r[0], h.literal(LINEAR_COV))[mt.col_idx],
        cov2=h.map(lambda r: r[1], h.literal(LINEAR_COV))[mt.col_idx])
    w = 1.0 if weights is None else h.literal(weights)[mt.row_idx]
    return mt.annotate_rows(weight=w, group=0)


def _logistic_mt(h, weights=None, pheno=LOGISTIC_PHENO):
    mt = h.utils.range_matrix_table(4, 15)
    mt = mt.annotate_entries(GT=h.unphased_diploid_gt_index_call(
        h.literal(LOGISTIC_GENOS)[mt.row_idx][mt.col_idx]))
    mt = mt.annotate_cols(phenotype=h.literal(pheno)[mt.col_idx],
                          cov1=h.literal(LOGISTIC_COV)[mt.col_idx])
    w = 1.0 if weights is None else h.literal(weights)[mt.row_idx]
    return mt.annotate_rows(group=0, weight=w)


def _linear(h, **kw):
    mt = _linear_mt(h, kw.pop('weights', None))
    return h._linear_skat(mt.group, mt.weight, h.float64(mt.phenotype),
                          mt.GT.n_alt_alleles(), [1.0, mt.cov1, mt.cov2], **kw)


def _logistic(h, **kw):
    mt = _logistic_mt(h, kw.pop('weights', None),
                      kw.pop('pheno', LOGISTIC_PHENO))
    covariates = [1.0, mt.cov1] * kw.pop('cov_copies', 1)
    return h._logistic_skat(mt.group, mt.weight, mt.phenotype,
                            mt.GT.n_alt_alleles(), covariates, **kw)


def _skat_logistic_tuple(h):
    mt = _logistic_mt(h)
    return h.skat(mt.group, mt.weight, mt.phenotype, mt.GT.n_alt_alleles(),
                  [1.0, mt.cov1], logistic=(25, 1e-6))


def _skat_linear(h):
    mt = _linear_mt(h)
    return h.skat(mt.group, mt.weight, h.float64(mt.phenotype),
                  mt.GT.n_alt_alleles(), [1.0, mt.cov1, mt.cov2])


def _bn_groups(h):
    """tests/test_methods.py's test_skat, on a rewound seed sequence."""
    h.reset_global_randomness()
    mt = h.balding_nichols_model(2, 60, 80)
    mt = mt.annotate_cols(pheno=h.rand_norm(seed=11))
    mt = mt.annotate_rows(gene=h.if_else(mt.locus.position < 40, 'gene1',
                                         'gene2'), weight=1.0)
    return h.skat(mt.gene, mt.weight, mt.pheno, mt.GT.n_alt_alleles(),
                  covariates=[1.0])


# (name, builder, R's (q_stat, abs tol, p_value, abs tol) or None)
CASES = [
    ('linear', _linear, (2.854975, 5e-7, 0.2700286, 5e-7)),
    ('linear_weighted', lambda h: _linear(h, weights=[1, 2, 1, 1]), None),
    ('logistic', _logistic, (1.869576, 5e-6, 0.5819739, 5e-7)),
    ('logistic_weighted', lambda h: _logistic(h, weights=[1, 2, 1, 1]),
     (2.515238, 5e-6, 0.5335765, 5e-7)),
    ('skat_logistic_tuple', _skat_logistic_tuple,
     (1.869576, 5e-6, 0.5819739, 5e-7)),
    ('skat_linear', _skat_linear, (2.854975, 5e-7, 0.2700286, 5e-7)),
    ('bn_two_groups', _bn_groups, None),
    ('linear_oversize', lambda h: _linear(h, max_size=3), None),
    ('logistic_oversize', lambda h: _logistic(h, max_size=3), None),
]


@pytest.mark.parametrize('name,build,golden', CASES, ids=[c[0] for c in CASES])
def test_rows_equal_reference(name, build, golden):
    rows = build(hlt).collect()
    assert [plain(r) for r in rows] == [plain(r) for r in build(hr).collect()]
    if golden is not None:
        q, q_tol, p, p_tol = golden
        (r,) = rows
        assert r.size == 4 and r.fault == 0
        assert r.q_stat == pytest.approx(q, abs=q_tol)
        assert r.p_value == pytest.approx(p, abs=p_tol)
    if 'oversize' in name:
        (r,) = rows
        assert (r.size, r.q_stat, r.p_value, r.fault) == (4, None, None, None)
    if name == 'bn_two_groups':
        assert len(rows) == 2
        assert all(0 <= r.p_value <= 1.001 for r in rows)


ERRORS = [
    ('linear_negative_weight', lambda h: _linear(h, weights=[1, -2, 1, 1])),
    ('logistic_negative_weight',
     lambda h: _logistic(h, weights=[1, 1, -0.5, 1])),
    ('logistic_not_binary',
     lambda h: _logistic(h, pheno=[0, 0, 0, 1, 2] + LOGISTIC_PHENO[5:])),
    ('logistic_not_converged',
     lambda h: _logistic(h, null_max_iterations=1)),
    ('logistic_separated', lambda h: _logistic(h, pheno=LOGISTIC_COV)),
    ('logistic_exploded', lambda h: _logistic(h, cov_copies=2)),
]


@pytest.mark.parametrize('name,build', ERRORS, ids=[c[0] for c in ERRORS])
def test_errors_equal_reference(name, build):
    raised = []
    for h in (hr, hlt):
        table = build(h)            # deferred: the error comes at collect
        with pytest.raises(Exception) as info:
            table.collect()
        raised.append(info.value)
    ref, port = raised
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__module__ == type(ref).__module__.replace(
        'hail_tpu', 'hail_tpu_torch')
    assert str(port) == str(ref)
