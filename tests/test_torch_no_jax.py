"""hail_tpu_torch imports and runs with jax blocked, and loads nothing of
hail_tpu: its methods (QC, `summarize_variants`, the device tier of
`aggregate_entries`, a linear mixed model with its regression rows, SKAT,
`hl.experimental.ld_score` and `simulate_random_mating` among them; the
family methods on its output, `filter_intervals`, and a VariantDataset
written, read, validated, split and densified), every
module of the file I/O, PCA and relatedness (imported; the C++ helpers of
`native` are not built here), and distribution on a mesh of four CPU slots:
`parallel.mesh`, `parallel.dryrun` (run), `ops.device_sort` (through
`order_by`), a sharded BlockMatrix product and `backend.distributed`.
In a subprocess: this test process has jax loaded already
(tests/conftest.py imports it)."""

import os
import subprocess
import sys

_PROGRAM = r'''
import sys
sys.modules['jax'] = None          # any `import jax` now raises ImportError
import numpy as np
import hail_tpu_torch as hl
hl.init(device='cpu', global_seed=0, quiet=True)
mt = hl.balding_nichols_model(2, 40, 30, n_partitions=2)
mt = mt.annotate_cols(y=hl.rand_unif(0, 1, seed=1))
res = hl.linear_regression_rows(y=mt.y, x=mt.GT.n_alt_alleles(),
                                covariates=[1.0])
rows = res.collect()
assert len(rows) == 30 and any(np.isfinite(r.beta) for r in rows)
ibd = hl.identity_by_descent(mt).collect()
assert len(ibd) == 40 * 39 // 2
mt = mt.annotate_cols(yb=hl.float64(mt.y > 0.5))
glm = hl.logistic_regression_rows('wald', y=mt.yb, x=mt.GT.n_alt_alleles(),
                                  covariates=[1.0]).collect()
assert len(glm) == 30 and any(r.fit.converged for r in glm)
kept = hl.ld_prune(mt.GT, r2=0.2, bp_window_size=5).count()
assert 0 < kept <= 30
K = hl.genetic_relatedness_matrix(mt.GT).to_numpy()
assert K.shape == (40, 40) and np.allclose(K, K.T)
a = np.arange(6.0).reshape(2, 3)
bm = hl.linalg.BlockMatrix.from_numpy(a)
assert np.array_equal((bm @ bm.T).to_numpy(), a @ a.T)
import importlib
for name in ('io', 'io.native', 'io.vcf', 'io.bgen', 'io.hail_format',
             'io.avro', 'native', 'nd', 'methods.impex', 'ops.decomp',
             'methods.pca', 'methods.relatedness'):
    importlib.import_module('hail_tpu_torch.' + name)
phi = hl.king(mt.GT)
assert phi.count() == (40, 40)
ev, scores, _ = hl.hwe_normalized_pca(mt.GT, k=2)
assert len(ev) == 2 and scores.count() == 40
rel = hl.pc_relate(mt.GT, 0.01, k=2, statistics='kin', min_kinship=0.2)
assert hl.maximal_independent_set(rel.i, rel.j).count() <= 40
import tempfile
with tempfile.TemporaryDirectory() as d:
    mt.write(d + '/m.mt')
    assert hl.read_matrix_table(d + '/m.mt').count() == (30, 40)
    rel.write(d + '/r.ht')
    assert hl.read_table(d + '/r.ht').count() == rel.count()
mt = hl.variant_qc(hl.sample_qc(mt))
assert mt.rows().collect()[0].variant_qc.AN > 0
assert mt.cols().collect()[0].sample_qc.n_called > 0
assert hl.summarize_variants(mt, show=False).n_variants == 30
from hail_tpu_torch.ops import entry_agg as ea
ran = []
real = ea.run_device_entry_agg
ea.run_device_entry_agg = lambda *a: ran.append(1) or real(*a)
s = mt.aggregate_entries(hl.agg.stats(mt.GT.n_alt_alleles()))
assert s.n == 40 * 30 and ran == [1, 1]
model, _ = hl.linear_mixed_model(mt.y, [1.0], z_t=mt.GT.n_alt_alleles())
model.fit()
lmm = hl.linear_mixed_regression_rows(mt.GT.n_alt_alleles(), model).collect()
assert len(lmm) == 30 and any(np.isfinite(r.p_value) for r in lmm)
mt = mt.annotate_rows(gene=mt.locus.position % 3, w=1.0)
sk = hl.skat(mt.gene, mt.w, mt.y, mt.GT.n_alt_alleles(), [1.0]).collect()
assert len(sk) == 3 and all(0 <= r.p_value <= 1 for r in sk)
ld = hl.experimental.ld_score(mt.GT.n_alt_alleles(), mt.locus, radius=5)
assert all(r.ld_score > 0.5 for r in ld.collect())
sim = hl.simulate_random_mating(mt, n_rounds=2)
assert sim.count() == (30, 160)
for name in ('vds', 'vds.combiner', 'vds.functions', 'methods.misc',
             'methods.family_methods', 'methods.annotators'):
    importlib.import_module('hail_tpu_torch.' + name)
cols = sorted(sim.add_col_index().cols().collect(), key=lambda c: c.col_idx)
ped = hl.Pedigree([hl.Trio(c.s, fam_id=c.s, pat_id=cols[c.father].s,
                           mat_id=cols[c.mother].s)
                   for c in cols if c.mother is not None])
men = hl.mendel_errors(sim.GT, ped)[0]
assert men.count() == 0
assert len(hl.transmission_disequilibrium_test(sim, ped).collect()) == 30
assert hl.filter_intervals(mt, [hl.parse_locus_interval('1:1-10')]).count_rows() \
    == 9
with tempfile.TemporaryDirectory() as d:
    ms = mt.key_cols_by(s=hl.str(mt.sample_idx)).select_cols()
    rd = ms.select_entries(END=ms.locus.position, DP=10).key_rows_by(
        'locus').select_rows()
    vd = ms.select_entries(LGT=ms.GT, LA=hl.literal([0, 1]))
    v = hl.vds.VariantDataset(rd, vd)
    v.write(d + '/v.vds')
    v = hl.vds.read_vds(d + '/v.vds').validate()
    dense = hl.vds.to_dense_mt(hl.vds.split_multi(v))
    assert dense.count() == (30, 40)
    assert hl.vds.sample_qc(v).count() == 40
import torch
from hail_tpu_torch.parallel import mesh
from hail_tpu_torch.parallel.dryrun import dryrun_multichip
from hail_tpu_torch.ops.device_sort import device_range_sort
from hail_tpu_torch.backend.distributed import MultihostBackend
mesh._mesh_cache = mesh.get_mesh([torch.device('cpu')] * 4)
assert dryrun_multichip(4).startswith('dryrun_multichip(4): ok')
bm = hl.linalg.BlockMatrix.from_numpy(np.arange(32.0).reshape(8, 4))
assert isinstance(bm._store, mesh.Sharded)
assert np.array_equal((bm.T @ bm).to_numpy(),
                      np.arange(32.0).reshape(8, 4).T @ np.arange(32.0).reshape(8, 4))
t = hl.utils.range_table(40, n_partitions=3)
s = t.order_by(hl.desc(t.idx))
assert [r.idx for r in s.collect()] == list(range(39, -1, -1))
assert len(s._stage.collect_batches()) == 4
assert MultihostBackend().process_count == 1
hl.stop()
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m == 'jax' or m.startswith('jax.') or m == 'hail_tpu'
    or m.startswith('hail_tpu.'))]
assert not loaded, loaded
print('OK')
'''


def test_port_runs_without_jax_or_reference():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, '-c', _PROGRAM], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith('OK')
