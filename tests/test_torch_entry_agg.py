"""The device tier of `aggregate_entries` in the port (ops/entry_agg.py)
against the reference's device tier (hail_tpu/ops/entry_agg.py, jnp under
XLA on the CPU) and against the port's own host evaluator
(`HAIL_TPU_NO_DEVICE_AGG=1`), on one MatrixTable built alike in both
packages: 53 samples over 37 + 41 + 0 + 29 rows in four partitions (one
empty), with an int32 DP and a float64 x that are missing in places, a
bool b, a GT with missing calls, a float row field r and an int32 column
field c, and entries filtered out where DP is missing.

Every aggregator the tier supports (`_SUPPORTED`) and every IR node kind
it lowers is covered. Integer results are equal; float results are equal
within rtol 1e-12 (the same f64 sums taken in another order). The
reference's device tier differs from its own host evaluator in three
places, and the port follows the host in two of them: an integer `/` is
f32 in jnp and f64 on the host and in the port, and an integer `**` with
a negative exponent wraps in jnp and is f64 on the host and in the port.
Integer `// 0` gives 0 on the host and the reference device tier's value
(-1 for 0 // 0, -2 otherwise) in the port, as the module states. Those
cases are held to the side they follow.

A spy on `run_device_entry_agg` shows the port's device tier ran once in
each non-empty partition of a supported plan, and not at all for an
unsupported aggregator (`collect`) or under `HAIL_TPU_NO_DEVICE_AGG=1`.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import hail_tpu as hr
import hail_tpu_torch as hlt
from test_torch_sort import plain

PARTS = (37, 41, 0, 29)
N_COLS = 53


@pytest.fixture(scope='module', autouse=True)
def port_session():
    hlt.init(device='cpu', global_seed=0, quiet=True)
    yield
    hlt.stop()


def build_mt(pkg, seed=0):
    ht = importlib.import_module(f'{pkg.__name__}.types')
    call = importlib.import_module(f'{pkg.__name__}.genetics.call')
    C = importlib.import_module(f'{pkg.__name__}.ir.columns')
    mtm = importlib.import_module(f'{pkg.__name__}.matrixtable')
    rgm = importlib.import_module(f'{pkg.__name__}.genetics.reference_genome')
    rg = rgm.default_reference()
    rng = np.random.default_rng(seed)
    mbs, start = [], 0
    for R in PARTS:
        nalt = rng.integers(0, 3, (R, N_COLS))
        gt = call.pack_diploid((nalt == 2).astype(np.int32),
                               (nalt >= 1).astype(np.int32))
        gt_m = rng.random((R, N_COLS)) < 0.05
        # garbage under the missing calls
        gt = np.where(gt_m, rng.integers(-2**31, 2**31, (R, N_COLS)), gt)
        dp = rng.integers(0, 40, (R, N_COLS)).astype(np.int32)
        dp[rng.random((R, N_COLS)) < 0.1] = 0
        dp_m = rng.random((R, N_COLS)) < 0.08
        x = rng.normal(size=(R, N_COLS)) * 3.0
        x_m = rng.random((R, N_COLS)) < 0.07
        b = rng.random((R, N_COLS)) < 0.4
        b_m = rng.random((R, N_COLS)) < 0.06
        alleles = np.empty(R, dtype=object)
        alleles[:] = [['A', 'T']] * R
        rows = C.Batch({
            'locus': C.LocusColumn(ht.tlocus(rg), np.zeros(R, np.int32),
                                   np.arange(start, start + R, dtype=np.int32)
                                   + 100),
            'alleles': C.ObjectColumn(ht.tarray(ht.tstr), alleles),
            'r': C.PrimitiveColumn(ht.tfloat64, rng.normal(size=R)),
        }, R)
        ents = {
            'GT': C.PrimitiveColumn(ht.tcall, gt.astype(np.int32), gt_m),
            'DP': C.PrimitiveColumn(ht.tint32, dp, dp_m),
            'x': C.PrimitiveColumn(ht.tfloat64, x, x_m),
            'b': C.PrimitiveColumn(ht.tbool, b, b_m),
        }
        mbs.append(mtm.MatrixBatch(rows, ents))
        start += R
    cols = C.Batch({
        's': C.ObjectColumn(ht.tstr, np.asarray([f's{i}' for i in range(N_COLS)],
                                                object)),
        'c': C.PrimitiveColumn(ht.tint32, rng.integers(-5, 6, N_COLS)
                               .astype(np.int32)),
    }, N_COLS)
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr),
                       r=ht.tfloat64)
    return mtm.MatrixTable(mtm.MatrixStage.from_batches(
        C.Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t,
        ht.tstruct(s=ht.tstr, c=ht.tint32),
        ht.tstruct(GT=ht.tcall, DP=ht.tint32, x=ht.tfloat64, b=ht.tbool), mbs))


@pytest.fixture(scope='module')
def mts():
    return build_mt(hr), build_mt(hlt)


@pytest.fixture
def spy(monkeypatch):
    """Counts the port's device-tier partitions."""
    from hail_tpu_torch.ops import entry_agg as ea
    calls = []
    real = ea.run_device_entry_agg

    def counted(mt, mb, i, *a):
        calls.append(i)
        return real(mt, mb, i, *a)

    monkeypatch.setattr(ea, 'run_device_entry_agg', counted)
    return calls


def _close(a, b, rtol=1e-12):
    """Recursive equality of plain values, floats within rtol."""
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if a == 'nan' or b == 'nan':
            return a == b
        return math.isclose(a, b, rel_tol=rtol, abs_tol=rtol)
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_close(x, y, rtol) for x, y in zip(a, b))
    return a == b


def _three(mts, f, monkeypatch):
    """(the reference's device tier, the port's device tier, the port's
    host evaluator) of aggregate_entries(f(pkg, mt))."""
    ref_mt, port_mt = mts
    ref = plain(ref_mt.aggregate_entries(f(hr, ref_mt)))
    dev = plain(port_mt.aggregate_entries(f(hlt, port_mt)))
    with monkeypatch.context() as m:
        m.setenv('HAIL_TPU_NO_DEVICE_AGG', '1')
        host = plain(port_mt.aggregate_entries(f(hlt, port_mt)))
    return ref, dev, host


NONEMPTY = sum(1 for R in PARTS if R)

AGGREGATORS = {
    'count': lambda h, m: h.agg.count(),
    'count_where': lambda h, m: h.agg.count_where(m.DP > 10),
    'sum_int': lambda h, m: h.agg.sum(m.DP),
    'sum_float': lambda h, m: h.agg.sum(m.x),
    'sum_bool': lambda h, m: h.agg.sum(m.b),
    'mean': lambda h, m: h.agg.mean(m.x),
    'stats_int': lambda h, m: h.agg.stats(m.DP),
    'stats_float': lambda h, m: h.agg.stats(m.x),
    'min_int': lambda h, m: h.agg.min(m.DP),
    'max_int': lambda h, m: h.agg.max(m.DP),
    'min_float': lambda h, m: h.agg.min(m.x),
    'max_float': lambda h, m: h.agg.max(m.x),
    'fraction': lambda h, m: h.agg.fraction(m.b),
    'any': lambda h, m: h.agg.any(m.DP > 38),
    'all': lambda h, m: h.agg.all(m.DP >= 0),
    'filter': lambda h, m: h.agg.filter(m.x > 0, h.agg.sum(m.DP)),
    'struct': lambda h, m: h.struct(
        n=h.agg.count(), s=h.agg.stats(m.GT.n_alt_alleles()),
        deep=h.agg.count_where(m.DP > 10), f=h.agg.fraction(h.is_missing(m.x)),
        lo=h.agg.min(m.DP), hi=h.agg.max(m.x)),
}


@pytest.mark.parametrize('name', sorted(AGGREGATORS))
def test_aggregator_matches_reference_and_host(mts, spy, monkeypatch, name):
    ref, dev, host = _three(mts, AGGREGATORS[name], monkeypatch)
    assert len(spy) == NONEMPTY
    assert _close(dev, ref), (dev, ref)
    assert _close(dev, host), (dev, host)


NODES = {
    'field_row': lambda h, m: h.agg.sum(m.DP * m.r),
    'field_col': lambda h, m: h.agg.sum(m.DP + m.c),
    'n_alt_alleles': lambda h, m: h.agg.sum(m.GT.n_alt_alleles()),
    'and': lambda h, m: h.agg.count_where((m.DP > 10) & m.b),
    'or': lambda h, m: h.agg.count_where((m.DP > 10) | m.b),
    'and_missing_sides': lambda h, m: h.agg.count_where(
        h.is_missing((m.x > 0) & m.b)),
    'or_missing_sides': lambda h, m: h.agg.count_where(
        h.is_missing((m.x > 0) | m.b)),
    'if': lambda h, m: h.agg.sum(h.if_else(m.b, m.DP, -m.DP)),
    'if_float': lambda h, m: h.agg.stats(h.if_else(m.x > 0, m.x, m.r)),
    'coalesce': lambda h, m: h.agg.sum(h.coalesce(m.DP, 7)),
    'coalesce_float': lambda h, m: h.agg.sum(h.coalesce(m.x, m.r, 0.5)),
    'cast_to_float': lambda h, m: h.agg.sum(h.float64(m.DP)),
    'cast_to_int': lambda h, m: h.agg.sum(h.int32(m.x)),
    'cast_to_int64': lambda h, m: h.agg.sum(h.int64(m.DP) * 3),
    'is_missing': lambda h, m: h.agg.count_where(h.is_missing(m.x)),
    'is_defined': lambda h, m: h.agg.count_where(h.is_defined(m.DP)),
    'missing_literal': lambda h, m: h.agg.sum(
        h.if_else(m.b, h.missing(h.tint32), m.DP)),
    'neg': lambda h, m: h.agg.sum(-m.x),
    'not': lambda h, m: h.agg.count_where(~m.b),
    'add': lambda h, m: h.agg.sum(m.DP + 5),
    'sub': lambda h, m: h.agg.sum(m.x - m.DP),
    'mul': lambda h, m: h.agg.sum(m.x * 2.5),
    'div_float_by_int': lambda h, m: h.agg.sum(m.x / m.DP),
    'div_int_exact': lambda h, m: h.agg.sum(m.DP / 4),
    'floordiv_int': lambda h, m: h.agg.sum(m.DP // 3),
    'floordiv_int_negative': lambda h, m: h.agg.sum((m.DP - 20) // (m.c + 7)),
    'floordiv_float': lambda h, m: h.agg.sum(m.x // 0.5),
    'mod_int': lambda h, m: h.agg.sum(m.DP % 7),
    'mod_int_negative': lambda h, m: h.agg.sum((m.DP - 20) % (m.c - 7)),
    'mod_int_by_zero': lambda h, m: h.agg.sum(m.DP % 0),
    'mod_float': lambda h, m: h.agg.sum(m.x % 1.5),
    'pow_int': lambda h, m: h.agg.sum(m.DP ** 2),
    'pow_float': lambda h, m: h.agg.sum(m.x ** 2),
    'eq': lambda h, m: h.agg.count_where(m.DP == 10),
    'ne': lambda h, m: h.agg.count_where(m.DP != 10),
    'lt': lambda h, m: h.agg.count_where(m.x < m.r),
    'le': lambda h, m: h.agg.count_where(m.DP <= m.c + 10),
    'gt': lambda h, m: h.agg.count_where(m.x > 1.5),
    'ge': lambda h, m: h.agg.count_where(m.DP >= 20),
    'eq_bool': lambda h, m: h.agg.count_where(m.b == (m.DP > 5)),
}


@pytest.mark.parametrize('name', sorted(NODES))
def test_ir_node_matches_reference_and_host(mts, spy, monkeypatch, name):
    ref, dev, host = _three(mts, NODES[name], monkeypatch)
    assert len(spy) == NONEMPTY
    assert _close(dev, ref), (dev, ref)
    assert _close(dev, host), (dev, host)


# where the reference's device tier and host evaluator differ: the side
# the port takes (module docstring)
DIVERGENT = {
    # jnp divides int32 by int32 in f32
    'div_int_by_int': ('host', lambda h, m: h.agg.sum(m.DP / 3)),
    # jnp's integer power wraps a negative exponent
    'pow_int_negative': ('host', lambda h, m: h.agg.sum((m.DP + 1) ** (m.c - 5))),
    # numpy gives 0 for x // 0, XLA -1 - (x != 0)
    'floordiv_int_by_zero': ('ref', lambda h, m: h.agg.sum(m.DP // 0)),
}


@pytest.mark.parametrize('name', sorted(DIVERGENT))
def test_divergent_cases_follow_their_side(mts, spy, monkeypatch, name):
    side, f = DIVERGENT[name]
    ref, dev, host = _three(mts, f, monkeypatch)
    assert len(spy) == NONEMPTY
    assert not _close(ref, host)          # the case does tell them apart
    assert _close(dev, host if side == 'host' else ref), (dev, ref, host)


def test_filtered_entries(spy, monkeypatch):
    ref_mt, port_mt = (m.filter_entries(m.GT.n_alt_alleles() < 2)
                       for m in (build_mt(hr, 1), build_mt(hlt, 1)))
    for f in (lambda h, m: h.agg.count(),
              lambda h, m: h.agg.sum(m.GT.n_alt_alleles()),
              lambda h, m: h.agg.stats(m.x)):
        ref, dev, host = _three((ref_mt, port_mt), f, monkeypatch)
        assert _close(dev, ref) and _close(dev, host), (dev, ref, host)
    assert len(spy) == 3 * NONEMPTY


def test_unsupported_aggregator_takes_the_host(mts, spy):
    _, port_mt = mts
    out = port_mt.aggregate_entries(hlt.agg.collect(port_mt.DP))
    assert len(out) == sum(PARTS) * N_COLS
    assert spy == []


def test_no_device_agg_flag(mts, spy, monkeypatch):
    _, port_mt = mts
    monkeypatch.setenv('HAIL_TPU_NO_DEVICE_AGG', '1')
    assert port_mt.aggregate_entries(hlt.agg.count()) == sum(PARTS) * N_COLS
    assert spy == []


def test_planner_rejects_what_it_cannot_lower():
    from hail_tpu_torch.ir import agg as aggmod
    from hail_tpu_torch.ops import entry_agg as ea
    mt = build_mt(hlt)
    for e in (hlt.agg.collect(mt.DP), hlt.agg.sum(hlt.len(mt.alleles)),
              hlt.agg.count_where(mt.GT.is_het())):
        assert ea.plan_device_entry_agg(aggmod.collect_agg_nodes(e._ir)) is None
    nodes = aggmod.collect_agg_nodes(hlt.agg.sum(mt.DP)._ir)
    leaves, plans = ea.plan_device_entry_agg(nodes)
    assert sorted(leaves) == ['g.DP.mask', 'g.DP.value']


def test_kernels_cache_on_the_semantic_hash(mts):
    from hail_tpu_torch.ir import agg as aggmod
    from hail_tpu_torch.ops import entry_agg as ea
    _, mt = mts
    kernels = []
    for _ in range(2):
        nodes = aggmod.collect_agg_nodes(hlt.agg.sum(mt.DP * 2)._ir)
        leaves, plans = ea.plan_device_entry_agg(nodes)
        kernels.append(ea.cached_kernel(nodes, plans, sorted(leaves)))
    assert kernels[0] is kernels[1]


def test_kernel_on_tensors_matches_the_reference_kernel():
    """make_kernel alone, on tensors, against the reference's jitted kernel
    on the same arrays: a (R, C) leaf, a (R, 1) row leaf, a (1, C) column
    leaf and a filtered-entry mask."""
    from hail_tpu.ir import agg as ragg
    from hail_tpu.ops import entry_agg as rea
    from hail_tpu_torch.ir import agg as pagg
    from hail_tpu_torch.ops import entry_agg as pea
    rng = np.random.default_rng(3)
    R, C = 64, 1003
    arrays = {
        'g.DP.value': rng.integers(0, 50, (R, C)).astype(np.int32),
        'g.DP.mask': rng.random((R, C)) < 0.1,
        'va.r.value': rng.normal(size=(R, 1)),
        'va.r.mask': rng.random((R, 1)) < 0.1,
        'sa.c.value': rng.integers(-3, 4, (1, C)).astype(np.int32),
        'sa.c.mask': np.zeros((1, C), bool),
    }
    filt = rng.random((R, C)) < 0.2
    out = {}
    for pkg, agg_m, ea in ((hr, ragg, rea), (hlt, pagg, pea)):
        mt = build_mt(pkg)
        e = pkg.struct(a=pkg.agg.stats(mt.DP * mt.r),
                       b=pkg.agg.count_where(mt.DP > mt.c + 20),
                       n=pkg.agg.count())
        nodes = agg_m.collect_agg_nodes(e._ir)
        leaves, plans = ea.plan_device_entry_agg(nodes)
        order = sorted(leaves)
        assert order == sorted(arrays)
        kernel = ea.make_kernel(plans, order)
        if pkg is hr:
            res = kernel([arrays[k] for k in order], filt)
        else:
            res = kernel([torch.from_numpy(arrays[k]) for k in order],
                         torch.from_numpy(filt))
        out[pkg.__name__] = [[float(np.asarray(v)) for v in part]
                             for part in res]
    for a, b in zip(out['hail_tpu'], out['hail_tpu_torch']):
        np.testing.assert_allclose(a, b, rtol=1e-12)
