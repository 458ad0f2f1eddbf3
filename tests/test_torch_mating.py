"""`simulate_random_mating` in the port against hail_tpu, on the CPU.

Both packages run the same host numpy code from a rewound seed sequence,
so the columns (sample ids, parents) and every entry are equal, missing
calls included; each child call is checked to take one allele from each
recorded parent's call, and to be missing exactly where either parent's
call is.
"""

import numpy as np
import pytest

import hail_tpu as hr
import hail_tpu_torch as hlt
from test_torch_sort import plain


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def _mated(h, **kw):
    """A balding_nichols_model MatrixTable with a tenth of its calls made
    missing, mated from a rewound seed sequence."""
    h.reset_global_randomness()
    mt = h.balding_nichols_model(2, 12, 30, n_partitions=3)
    mt = mt.annotate_entries(GT=h.or_missing(
        (mt.locus.position * 7 + mt.sample_idx) % 10 != 0, mt.GT))
    return mt, h.simulate_random_mating(mt, **kw)


def _calls(mt):
    """(j, k, missing), each (R, C), of the GT entries in column order."""
    from hail_tpu_torch.genetics.call import calls_allele_j, calls_allele_k
    st = mt._stage
    gts = [st.partition_fn(c).entries['GT'] for c in st.contexts]
    packed = np.concatenate([np.asarray(g.values) for g in gts])
    miss = np.concatenate([g.missing_mask() for g in gts])
    return calls_allele_j(packed), calls_allele_k(packed), miss


@pytest.mark.parametrize('kw', [
    dict(), dict(n_rounds=2), dict(n_rounds=2, keep_founders=False),
    dict(n_rounds=3, generation_size_multiplier=1.5),
    dict(n_rounds=2, generation_size_multiplier=1.5, keep_founders=False)],
    ids=['one_round', 'two_rounds', 'two_rounds_last_only', 'mult_1_5',
         'mult_1_5_last_only'])
def test_equals_reference_and_mendelian(kw):
    _, sim = _mated(hlt, **kw)
    _, ref = _mated(hr, **kw)
    cols = [plain(c) for c in sim.cols().collect()]
    assert cols == [plain(c) for c in ref.cols().collect()]
    assert [plain(e) for e in sim.entries().collect()] == \
        [plain(e) for e in ref.entries().collect()]
    # each generation of n_prev parents has floor(n_prev * multiplier)
    # children; with keep_founders the pool grows by each generation
    mult = kw.get('generation_size_multiplier', 1.0)
    sizes = [12]
    for _ in range(kw.get('n_rounds', 1)):
        pool = sum(sizes) if kw.get('keep_founders', True) else sizes[-1]
        sizes.append(int(np.floor(pool * mult)))
    n_out = sum(sizes) if kw.get('keep_founders', True) else sizes[-1]
    assert sim.count() == (30, n_out)
    if kw.get('keep_founders', True):
        # the pool of each round is the columns before it: the parents'
        # indices are column indices of the output
        j, k, miss = _calls(sim)
        for c, col in enumerate(sim._stage.cols.to_pylist()):
            if col.mother is None:
                assert col.s.startswith('generation_0_')
                continue
            mo, fa = col.mother, col.father
            assert mo < c and fa < c
            want_miss = miss[:, mo] | miss[:, fa]
            assert np.array_equal(miss[:, c], want_miss)
            for r in np.flatnonzero(~want_miss):
                x, y = j[r, c], k[r, c]
                m, f = (j[r, mo], k[r, mo]), (j[r, fa], k[r, fa])
                assert (x in m and y in f) or (y in m and x in f)


@pytest.mark.parametrize('kw,msg', [
    (dict(n_rounds=0), "'n_rounds' must be positive"),
    (dict(generation_size_multiplier=0), "'generation_size_multiplier'")])
def test_argument_errors_equal_reference(kw, msg):
    errors = []
    for h in (hr, hlt):
        with pytest.raises(ValueError, match=msg) as info:
            _mated(h, **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
