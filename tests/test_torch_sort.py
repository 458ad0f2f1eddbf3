"""Sorts of tables of more than one partition in the port against hail_tpu,
on the CPU: `Table.order_by`, `key_by` on a new key, `union` of keyed
tables, `distinct` and `collect_by_key` after a re-key,
`MatrixTable.entries()` (plain, after `filter_entries`, after
`transmute_entries`) and `mt.rows().order_by`, on
`range_table(12, n_partitions=3)` and `balding_nichols_model(2, 6, 24,
n_partitions=3)`. Each runs the host sample sort of `table._sample_sort`
and must equal the reference's rows exactly (same order, same values). The
reference sorts on the host too (`use_device_sort=0`): its device sort
gives the same order and spends seconds compiling for each shape.
"""

import math
from collections.abc import Mapping

import numpy as np
import pytest

import hail_tpu_torch as hlt


def plain(v):
    """A value of either package as plain hashable Python, so that values of
    the port and of the reference compare equal when they hold the same
    data (each package has its own Struct, Interval, Locus and Call)."""
    kind = type(v).__name__
    if kind == 'Struct':
        return ('Struct', tuple((k, plain(x)) for k, x in v.items()))
    if isinstance(v, Mapping):
        return ('dict', frozenset((plain(k), plain(x)) for k, x in v.items()))
    if isinstance(v, (set, frozenset)):
        return frozenset(plain(x) for x in v)
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    if isinstance(v, np.ndarray):
        return ('ndarray', v.shape, tuple(plain(x) for x in v.ravel().tolist()))
    if kind == 'Interval':
        return ('Interval', plain(v.start), plain(v.end), v.includes_start,
                v.includes_end)
    if kind == 'Locus':
        return ('Locus', v.contig, v.position, v.reference_genome.name)
    if kind == 'Call':
        return ('Call', tuple(v.alleles), v.phased)
    if isinstance(v, float) and math.isnan(v):
        return 'nan'
    return v


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


@pytest.fixture
def ref(hl):
    """The reference, its host sort on for the test."""
    old = hl._get_flags('use_device_sort')['use_device_sort']
    hl._set_flags(use_device_sort='0')
    yield hl
    hl._set_flags(use_device_sort=old)


def _range_cases(pkg):
    t = pkg.range_table(12, n_partitions=3)
    t = t.annotate(g=t.idx % 4, v=(t.idx * 7) % 5)
    k = t.key_by('g')
    return {
        'order_by_desc': lambda: t.order_by(-t.idx),
        'order_by_two_keys': lambda: t.order_by(t.v, pkg.desc(t.idx)),
        'key_by_new_key': lambda: t.key_by('v'),
        'union_keyed': lambda: k.union(k.annotate(v=k.v + 10)),
        'distinct': lambda: k.distinct(),
        'collect_by_key': lambda: k.collect_by_key(),
    }


def _bn_cases(pkg):
    pkg.reset_global_randomness()
    mt = pkg.balding_nichols_model(2, 6, 24, n_partitions=3)
    return {
        'entries': lambda: mt.entries(),
        'entries_filtered': lambda: mt.filter_entries(
            mt.GT.n_alt_alleles() > 0).entries(),
        'entries_transmuted': lambda: mt.transmute_entries(
            n=mt.GT.n_alt_alleles()).entries(),
        'rows_order_by': lambda: mt.rows().order_by(
            pkg.desc(mt.rows().ancestral_af)),
    }


RANGE_CASES = ['order_by_desc', 'order_by_two_keys', 'key_by_new_key',
               'union_keyed', 'distinct', 'collect_by_key']
BN_CASES = ['entries', 'entries_filtered', 'entries_transmuted',
            'rows_order_by']


@pytest.mark.parametrize('case', RANGE_CASES)
def test_range_table_sorts_match_reference(ref, case):
    got = _range_cases(hlt)[case]().collect()
    want = _range_cases(ref)[case]().collect()
    assert plain(got) == plain(want)


@pytest.mark.parametrize('case', BN_CASES)
def test_matrix_table_sorts_match_reference(ref, case):
    got = _bn_cases(hlt)[case]().collect()
    want = _bn_cases(ref)[case]().collect()
    assert len(got) == len(want) > 0
    assert plain(got) == plain(want)
