"""Smoke run of the PyTorch / CUDA port (hail_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from hail_tpu_torch/csrc, holds each
against its plain torch version on the card at the shapes of the main path
(each at one ragged shape first), times each beside its plain version and
its bound on this card, then drives the
public entry points at the benchmark's size:
`hl.linear_regression_rows` (GWAS, 10,000 samples x 4 x 8,192 variants,
2% missing, 4 covariates), the f32 int8 path `linreg_stats_i8` over the
same 32,768 variants, `hl.logistic_regression_rows` (wald over all 32,768
variants from the GWAS's cached entry pair; lrt, score and firth over one
partition) and `hl.poisson_regression_rows` (wald, one partition), and
`hl.identity_by_descent` (1,000 samples x 16,384 variants). One more cold
GWAS call is split into host packing, host-to-device copy, K4 and the rest.
The BlockMatrix tier: `hl.ld_prune` over the GWAS's cached entry pairs
(r² 0.2, bp_window_size 256, as bench.py runs it) and over 8,192 variants
with planted LD, its kept set held to a numpy oracle of its three stages;
`hl.genetic_relatedness_matrix` (the ExactGrm route),
`hl.realized_relationship_matrix`, `hl.row_correlation` and `hl.ld_matrix`
over one partition against numpy f64; ExactGrm's strips at bench.py's
config 5 (50,176 samples x 4,096 variants) against the f64 route; and the
tier's device ops (torch, not kernels) timed against their bounds.
Relatedness and PCA: a MatrixTable of 10,000 samples x 8,192 variants in 4
partitions with 8 planted duplicate samples is written in the native
format and read back (GT held equal), and on what was read
`hl.hwe_normalized_pca` (k = 10, the randomized route), `hl.king`,
`hl.pc_relate` (k = 10, min_kinship 0.1) and `hl.maximal_independent_set`
run, each held to a numpy f64 oracle in this file; then `Table.order_by`
and `MatrixTable.entries()` over its 4 partitions, and a VCF round trip
(`hl.export_vcf`, `hl.import_vcf` GT-only) of the IBD MatrixTable's first
2,048 variants. QC: on 10,000 samples x 8,192 variants in 4 partitions
(GT, DP, GQ; 5% triallelic, an eighth on X) K5 against its plain version
(at one partition's shape and at 256 x 100,000, each beside a read-only
stream of the same bytes),
`hl.sample_qc`, `hl.variant_qc` (K5 once per partition), `hl.impute_sex`
and an `aggregate_entries` on the device tier and on the host evaluator,
each held to numpy; `hl.split_multi_hts` of 1,024 variants with AD and
PL held to numpy. The rest of statgen: the linear mixed model on 4,096
samples x 8,192 variants (`hl.genetic_relatedness_matrix`,
`hl.linear_mixed_model` with `k=` and with `z_t=` over 1,024 variants,
`fit`, `hl.linear_mixed_regression_rows`; 64 variants held to the scalar
loop, a planted variant found), `hl._linear_skat` and `hl._logistic_skat`
on 10,000 x 8,192 in 512 genes (q_stat held to numpy, a planted gene
found), `hl.experimental.ld_score` on 10,000 x 8,192 with a 1 Mb radius
(256 rows held to numpy) and `hl.simulate_random_mating` of 1,000 x 8,192
over two rounds (every child call checked against its parents'), with
the two device ops of that slice, ops/lmm and ops/ldscore, timed.
Every phase so far runs on a mesh of the one card. Distribution last: on a
mesh over every card of the host (over 4 slots of the one card where it
has one), `BlockMatrix.from_entry_expr` of the relatedness shape, its
products `bm @ bm.T` and `bm.T @ bm` and `hl.genetic_relatedness_matrix`,
each sharded at rest and held to one device (1e-12 of its largest entry)
and timed beside it; `device_range_sort` of 2^24 int64 keys and of f64
keys with ties against numpy's stable argsort; `Table.order_by` of
1,000,000 rows in 8 partitions against the host tier; `dryrun_multichip(4)`;
and tests/test_torch_multihost.py's checks in two processes (over NCCL on
a host of two cards or more, over gloo with both ranks on cuda:0 on a
host of one), which then build a BlockMatrix mesh spanning the two
processes (`span_checks`): `from_entry_expr` of the relatedness shape
equal to one device bit for bit and `bm @ bm.T` within 1e-12 of one
device's largest entry, equal on both ranks. Then the VariantDataset, on one card
again: a VDS of 1,000 samples x 1,024 sites in 4 partitions with the
combiner's schema (LGT, LA, LAD, DP, GQ; reference blocks with END, DP,
GQ) made from numpy with its dense truth beside it, written and read back
with `hl.vds.read_vds`, `validate`d, `hl.vds.sample_qc` held to numpy,
`hl.vds.lgt_to_gt`, `hl.vds.split_multi` and `hl.vds.to_dense_mt` held to
the truth, and on the dense MatrixTable `hl.variant_qc` (K5) and
`hl.linear_regression_rows` (K4 cold, K3) held to numpy; last
`hl.mendel_errors` (64 planted errors found, no other) and
`hl.transmission_disequilibrium_test` on 2,048 variants of
`simulate_random_mating`'s output, each count held to numpy. Then
Query-on-Batch: a `hl.batch` pipeline on its LocalBackend, four
PythonJobs each running the GWAS over 2,048 variants of the first
partition in threads of this process (K4, K3), a BashJob reading a file
one of them wrote and a gathering job, its rows equal to `phase_gwas`'s
bit for bit; `hl.init(backend='service')` with four worker slots, the same
GWAS over a MatrixTable built afresh whose four partitions are made by
jobs in worker processes that see no card and load neither jax nor
hail_tpu, while K4 and K3 launch here, in the driver, its rows equal to
the pipeline's; and `python -m hail_tpu_torch devices`, which must name
the card. Right after the GWAS, the packed-call routes on its calls: K6
(`decode_packed_gt`, packed int32 calls and their mask decoded on the
card) against its plain version bit for bit in both modes and timed,
`linreg_stats_call_exact` (K6, K3) over the 4 partitions with rows equal
to `linear_regression_rows`'s bit for bit and `linreg_stats_call` (K6,
K1) within the f32 bar of them, ops/regression's GLM fits (logistic and
poisson `glm_per_variant_fit`, `glm_score_test`, `firth_fit`) over 2,048
variants on the card against their plain f64 run on the CPU (rtol 1e-9,
iterations and flags equal), and `dryrun_multichip(4)` on 4 slots of the
card; then a Hail pipeline (`import hail as hl`, `hl.init()`,
`hl.read_matrix_table`, `hl.linear_regression_rows`) run unmodified through
`python -m hail_tpu_torch.dropin` in a subprocess on the card over 2,048
variants written in the native format, its rows equal to the direct
call's bit for bit, K4 and K3 launched in it.
`hl.plot` and `hl.ggplot`, host code over matplotlib, are not driven; a
log line says so.
It fails
(non-zero exit, no result line) when there is no card, when a kernel does
not build, launch or agree, when the main path did not launch every
kernel, or when the results disagree with numpy, the exact path, the
host GLM fits (stats/glmfit) or the oracles.

The last lines of stdout: the method rates as JSON, the device ops as JSON
(time per launch, launches per method call, bound, share of the bound,
yardstick), the kernels as JSON
(time, plain version's time, bound, share of the bound, launches on the
method paths and per call), the card's name and power limit as nvidia-smi
reports them, and
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20240611
N_SAMPLES = 10_000
BLOCK_R = 8_192
N_PARTS = 4
K = 4                      # covariates incl. the intercept
IBD_SAMPLES = 1_000
IBD_VARIANTS = 16_384
MISSING = 0.02
CHECK_ROWS = 256
GLM_CHECK_ROWS = 32
GLM_MAXIT, GLM_TOL = 25, 1e-8
LD_R2, LD_WINDOW = 0.2, 256    # bench.py:375: ld_prune(r2=0.2, bp_window_size=256)
# the planted-LD MatrixTable: 8,192 variants in partitions whose sizes are
# no multiples of the groups of four copies
LD_PARTS = (2_047, 2_049, 2_046, 2_050)
# bench.py's config 5: kinship strips over 50,176 samples x 4,096 variants
GRM_M, GRM_N, GRM_B, GRM_STRIPS = 4_096, 50_176, 4_096, 4
# relatedness and PCA: 10,000 samples x 8,192 variants in 4 partitions, the
# last 8 samples duplicates of the first 8; 64 sample rows held to numpy
REL_SAMPLES, REL_VARIANTS, REL_PARTS, REL_DUPS = 10_000, 8_192, 4, 8
REL_CHECK_ROWS = 64
PCA_K, REL_MAF, REL_MIN_KIN = 10, 0.01, 0.1
# the VCF round trip: the IBD MatrixTable's first 2,048 variants (one
# eighth: export_vcf formats each call in Python, 103 s for all 16,384 x
# 1,000 on the card's host, PERF.md PR 6)
VCF_VARIANTS = 2_048
# QC: 10,000 samples x 8,192 variants in 4 partitions with GT, DP and GQ,
# 2% of GT and 3% of DP and of GQ missing, 5% of the rows triallelic, the
# last eighth on X; split_multi_hts over 1,024 variants with AD and PL, a
# quarter of them triallelic
QC_SAMPLES, QC_VARIANTS, QC_PARTS = 10_000, 8_192, 4
QC_GT_MISSING, QC_FIELD_MISSING, QC_TRIALLELIC = 0.02, 0.03, 0.05
HTS_VARIANTS, HTS_TRIALLELIC = 1_024, 0.25
# K5's second shape: few, wide rows, as one partition of a biobank call set
# of 10^5 samples
K5_WIDE = (256, 100_000)
# the rest of statgen (phase_statgen_rest). The linear mixed model on 4,096
# samples x 8,192 variants in 4 partitions, not 10,000 samples: its eigh and
# its rotation are host n³ work, as in the reference, about 14.5x more of it
# at 10,000; its low-rank route over the first 1,024 variants (at most the
# samples: the full SVD forms an m x m Vᵀ); 64 variants held to the scalar
# loop, one planted. SKAT on 10,000 x 8,192 in 512 genes of 16, one planted;
# ld_score on 10,000 x 8,192, a variant every 5 kb, radius 1 Mb (windows of
# hundreds of variants); simulate_random_mating of 1,000 x 8,192, two rounds
LMM_SAMPLES, LMM_VARIANTS, LMM_PARTS, LMM_LOW_RANK = 4_096, 8_192, 4, 1_024
LMM_CAUSAL, LMM_CHECK_ROWS = 5_000, 64
SKAT_SAMPLES, SKAT_VARIANTS, SKAT_PARTS, SKAT_GROUP = 10_000, 8_192, 4, 16
SKAT_PLANTED, SKAT_CHECK_GROUPS = 100, 64
LDS_SAMPLES, LDS_VARIANTS, LDS_PARTS = 10_000, 8_192, 4
LDS_RADIUS, LDS_SPACING, LDS_CHECK_ROWS = 1_000_000, 5_000, 256
MATING_SAMPLES, MATING_VARIANTS, MATING_PARTS = 1_000, 8_192, 4
# distribution (phase_distribution): a mesh over every card of the host, or
# DIST_ONE_CARD_SLOTS slots on a host of one card; from_entry_expr, the
# products and the GRM over the relatedness phase's shape (10,000 samples x
# 8,192 variants in 4 partitions); the device sort over 2^24 keys;
# Table.order_by of 1,000,000 rows in 8 partitions
DIST_ONE_CARD_SLOTS = 4
SORT_KEYS = 16_777_216
ORDER_BY_ROWS, ORDER_BY_PARTS = 1_000_000, 8
DIST_RTOL = 1e-12
# the multihost run: two processes, then a mesh spanning them with
# SPAN_LOCAL_SLOTS slots of each rank's card (the 2 x 2 grid of the one-card
# mesh above) at the relatedness shape
SPAN_LOCAL_SLOTS = 2
MULTIHOST_TIMEOUT_S = 300
# the VariantDataset (phase_vds): 1,000 samples x 1,024 variant sites in 4
# partitions with the combiner's schema, not the 10,000 x 8,192 of the other
# phases: split_multi, to_dense_mt, validate and the native writer build
# Python objects per entry on the host, about 37 us an entry over the VDS
# path on the card's host (38.0 s at 1,024 x 1,000; PERF.md), so the main
# path's size would take about 52 minutes. 5% of the
# sites tri-allelic, 2% of the entries uncovered, reference blocks of 1 to
# 16 sites. Then mendel_errors and the TDT on the first 2,048 of the 8,192
# variants of simulate_random_mating's output (phase_mating; 4,000
# columns, all 8,192 took 26.7 s), with 64 planted Mendel errors
VDS_SAMPLES, VDS_SITES, VDS_PARTS = 1_000, 1_024, 4
VDS_TRIALLELIC, VDS_UNCOVERED, VDS_MAX_BLOCK, VDS_SPACING = 0.05, 0.02, 16, 10
FAM_VARIANTS, FAM_PLANTED = 2_048, 64
# Query-on-Batch (phase_batch, phase_qob): the first partition of the main
# MatrixTable (10,000 samples x 8,192 variants) in BATCH_JOBS slices of
# 2,048 variants, one DSL job or one QoB partition each; QOB_WORKERS worker
# slots of the private Batch service; every stage and wait bounded by
# QOB_TIMEOUT_S
BATCH_JOBS = 4
QOB_WORKERS = 4
QOB_TIMEOUT_S = 300.0
# the packed-call routes (phase_packed_calls): K6 and the routes over the
# main MatrixTable's calls (10,000 samples x 4 x 8,192 variants); the GLM
# fits of ops/regression over the first PACKED_GLM_ROWS variants of its
# first partition, on the card and in plain f64 on the CPU
PACKED_GLM_ROWS = 2_048
# the drop-in (phase_dropin): a Hail pipeline under `python -m
# hail_tpu_torch.dropin`, its GWAS over the first DROPIN_VARIANTS variants
# of the first partition, written to the native format and read back
DROPIN_VARIANTS = 2_048
DROPIN_TIMEOUT_S = 300

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates at the
# full 700 W): device memory, int8 on the tensor cores, f32 outside them.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
# and f64 on the tensor cores (DMMA), the rate of the f64 products of the
# BlockMatrix tier
F64_FLOPS_PER_S = 67e12
# No peak is published for one-bit operands. The card issues the 1-bit MMA
# (256 deep) at the rate of the int8 MMA (32 deep), which
# hail_tpu_torch/csrc/bench/mma_rate.cu measures in this run: eight times
# the int8 peak.
B1_OPS_PER_S = 8 * INT8_OPS_PER_S


def log(msg: str) -> None:
    print(msg, flush=True)


def build_mt(hl, rng, n_samples, block_r, n_parts, with_pheno, dups=0):
    """A MatrixTable of packed GT calls in `n_parts` partitions, built as
    bench.py's build_mt builds it: uniform n_alt in {0,1,2}, 2% missing.
    With `dups`, the last `dups` samples copy the calls and missingness of
    the first `dups`. Returns (mt, nalt blocks, missing blocks, column
    arrays)."""
    parts, nalts, misses = [], [], []
    for p in range(n_parts):
        nalt = rng.integers(0, 3, (block_r, n_samples)).astype(np.int32)
        miss = rng.random((block_r, n_samples)) < MISSING
        if dups:
            nalt[:, -dups:] = nalt[:, :dups]
            miss[:, -dups:] = miss[:, :dups]
        pos = np.arange(p * block_r, (p + 1) * block_r, dtype=np.int32) + 10_000
        parts.append(dict(nalt=nalt, miss=miss, contig=0, pos=pos))
        nalts.append(nalt)
        misses.append(miss)
    cols_np = {}
    if with_pheno:
        for name in ['pheno'] + [f'c{i}' for i in range(K - 1)]:
            cols_np[name] = rng.normal(size=n_samples)
        # GLM phenotypes as tests/test_glm_device.py makes them: a binary
        # and a count trait of the covariates plus the mean genotype
        eta = (covariates(cols_np) @ (rng.normal(size=K) * 0.4)
               + 0.15 * np.mean([np.where(m, 0, g).mean(axis=0)
                                 for g, m in zip(nalts, misses)], axis=0))
        cols_np['yb'] = (rng.random(n_samples)
                         < 1 / (1 + np.exp(-eta))).astype(np.float64)
        cols_np['yc'] = rng.poisson(np.exp(np.clip(eta, -3, 2))).astype(
            np.float64)
    return calls_mt(parts, n_samples, cols_np), nalts, misses, cols_np


def calls_mt(parts, n_samples, cols_np, row_fields=()):
    """A MatrixTable of packed GT calls, one partition per dict of `parts`:
    n_alt and missing (R, n_samples), contig index and positions (GRCh37),
    and int32 or f64 arrays under the names in `row_fields`. Columns: the
    key `s` ('s<i>') and the f64 arrays of `cols_np`."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.call import pack_diploid
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ir.columns import (Batch, LocusColumn, ObjectColumn,
                                           PrimitiveColumn)
    from hail_tpu_torch.matrixtable import MatrixBatch, MatrixStage, MatrixTable
    rg = default_reference()
    row_t = {name: {'i': ht.tint32, 'f': ht.tfloat64}[parts[0][name].dtype.kind]
             for name in row_fields}
    mbs = []
    for part in parts:
        nalt, R = part['nalt'], part['nalt'].shape[0]
        gt = pack_diploid((nalt == 2).astype(np.int32),
                          (nalt >= 1).astype(np.int32))
        alleles = np.empty(R, dtype=object)
        alleles[:] = [['A', 'T']] * R
        rows = {'locus': LocusColumn(
                    ht.tlocus(rg), np.full(R, part['contig'], np.int32),
                    np.asarray(part['pos'], np.int32)),
                'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles)}
        for name in row_fields:
            rows[name] = PrimitiveColumn(row_t[name], part[name])
        mbs.append(MatrixBatch(Batch(rows, R), {
            'GT': PrimitiveColumn(ht.tcall, gt, part['miss'])}))
    col_fields = {'s': ObjectColumn(
        ht.tstr, np.asarray([f's{i}' for i in range(n_samples)], object))}
    col_t = {'s': ht.tstr}
    for name, v in cols_np.items():
        col_fields[name] = PrimitiveColumn(ht.tfloat64, v)
        col_t[name] = ht.tfloat64
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), Batch(col_fields, n_samples), ['locus', 'alleles'],
        ['s'], ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr),
                          **row_t),
        ht.tstruct(**col_t), ht.tstruct(GT=ht.tcall), mbs))


def covariates(cols_np):
    """The covariate matrix [1, c0, c1, c2] (n, K)."""
    n = cols_np['pheno'].shape[0]
    return np.stack([np.ones(n)] + [cols_np[f'c{i}'] for i in range(K - 1)],
                    axis=1)


def timed_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds per call, from CUDA events after a warm-up.
    A wrapper's host side (checks, output allocations, the ctypes call)
    takes about as long as the faster kernels run, so the launches are
    queued behind a few milliseconds of other device work (one f32 matrix
    product) first: the events then time the card working through them
    back to back, not the host enqueueing them."""
    blocker = torch.ones((4096, 4096), device='cuda')
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    blocker @ blocker
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_times(kernel, plain):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = timed_ms(plain)
    k1 = timed_ms(kernel)
    k2 = timed_ms(kernel)
    p2 = timed_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes, n_ops=0, ops_per_s=INT8_OPS_PER_S, unit='int8_mma'):
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and its operations over the peak rate of their
    type. `bound_by` says which of the two, `bound_unit` which peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by='bytes', bound_unit='hbm')
    return dict(bound_ms=t_ops, bound_by='operations', bound_unit=unit)


def record(name, source, replaces, err, ms, plain_ms, bnd, library_ms=None,
           **extra):
    log(f'{name}: bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_unit"]}), the '
        f'kernel reaches {bnd["bound_ms"] / ms:.3f} of it')
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                share_of_bound=bnd['bound_ms'] / ms, library_ms=library_ms,
                **bnd, **extra)


def ragged_checks(dev):
    """Each kernel against its plain version at a shape that is a multiple
    of no tile: K3 at R = 1,037, N = 3,001 (rows not 16-byte aligned),
    C = 70 (two column groups); K4 at the same R and N (rows that start
    anywhere in a 16-byte piece, padding codes in each row's last byte)
    from a u8 base off 4 bytes; K1 at the same R and N with KP = 13 (two
    launches, rows off 4 bytes); K2 at 1,003 variants x 333 samples."""
    from hail_tpu_torch.ops import ibs, linreg_i8 as li
    rng = np.random.default_rng(SEED + 1)
    R, N, C = 1_037, 3_001, 70
    m = (rng.random((R, N)) < MISSING).astype(np.int8)
    g = rng.integers(0, 3, (R, N)).astype(np.int8) * (1 - m)
    codes = np.where(m == 1, 3, g).astype(np.uint8)
    codes = np.concatenate([codes, np.zeros((R, -N % 4), np.uint8)], axis=1)
    u8 = np.zeros((R + 1, codes.shape[1] // 4), np.uint8)
    for q in range(4):
        u8[1:] |= codes[:, q::4] << (2 * q)
    u8 = torch.from_numpy(u8).to(dev)[1:]        # base 751 bytes in
    got = li.unpack_gt_2bit(u8, N)
    plain = li._unpack_plain(u8, N)
    torch.cuda.synchronize()
    for name, a, b, want in zip(('gz8', 'm8'), got, plain, (g, m)):
        if not (torch.equal(a, b) and np.array_equal(a.cpu().numpy(), want)):
            raise AssertionError(f'K4 at the ragged shape: {name} differs')
    KP = 13
    G8 = torch.from_numpy(np.where(m == 1, -1, g).astype(np.int8)).to(dev)
    Wf = torch.from_numpy(rng.normal(size=(N, KP)).astype(np.float32)).to(dev)
    got = li.linreg_i8_sums(G8, li.f32_operand(Wf))
    plain = li._sums_ref(G8, Wf)
    torch.cuda.synchronize()
    if not torch.equal(got[2], plain[2]):
        raise AssertionError('K1 at the ragged shape: the row sums differ')
    for name, a, b, (exact, l2) in zip(('GW', 'MW'), got[:2], plain[:2],
                                       f32_sum_oracle(G8, Wf)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        f32_sum_check(a, exact, l2, 1e-5, f'K1 ragged {name} vs f64')
        f32_sum_check(a, b, l2, 1e-4, f'K1 ragged {name} vs plain', atol=2e-5)
    W = rng.integers(-127, 128, (N, C)).astype(np.int8)
    gz8, m8, Wd = (torch.from_numpy(a).to(dev) for a in (g, m, W))
    got = li.exact_pass(gz8, m8, li.exact_operand(Wd))
    plain = li._exact_pass_plain(gz8, m8, Wd)
    torch.cuda.synchronize()
    for name, a, b in zip(('GWd', 'MWd', 'nmiss', 's', 'ss'), got, plain):
        if not torch.equal(a, b):
            raise AssertionError(f'K3 at the ragged shape: {name} differs')
    mv, n = 1_003, 333
    nalt = rng.integers(0, 3, (mv, n))
    called = rng.random((mv, n)) >= 0.1
    called[:, 5] = False                         # a sample with no call
    ind = [torch.from_numpy(a).to(dev) for a in
           (called & (nalt == 1), called & (nalt == 0), called & (nalt == 2),
            called)]
    got = ibs.ibs_counts(*ind)
    plain = ibs._ibs_plain(*ind)
    torch.cuda.synchronize()
    for name, a, b in zip(('ibs0', 'ibs1', 'ibs2'), got, plain):
        if not torch.equal(a, b):
            raise AssertionError(f'K2 at the ragged shape: {name} differs')
    log(f'ragged shapes: K3 ({R} x {N}, C = {C}), K4 ({R} x {N}, u8 base off '
        f'4 bytes) and K2 ({mv} x {n}) bit-equal to their plain versions; K1 '
        f'({R} x {N}, KP = {KP}) row sums bit-equal, GW and MW within rtol '
        f'1e-5 + 1e-5 l2 of the f64 product')


def int_mm_yardstick(gz8, m8, Wd):
    """One library call beside K3, never called by the port: torch._int_mm
    of the stacked (2R, N) [gz8; m8] against Wdig padded to 40 columns. It
    computes the two products and not the three row sums. Returns its ms,
    or None with the reason logged when it refuses the shape."""
    try:
        A = torch.cat([gz8, m8])
        B = torch.zeros((Wd.shape[0], -(-Wd.shape[1] // 8) * 8),
                        dtype=torch.int8, device=Wd.device)
        B[:, :Wd.shape[1]] = Wd
        out = torch._int_mm(A, B)
        if not torch.equal(out[:gz8.shape[0], :Wd.shape[1]],
                           (gz8.double() @ Wd.double()).to(torch.int32)):
            raise RuntimeError('its product differs from the f64 product')
        return timed_ms(lambda: torch._int_mm(A, B))
    except (RuntimeError, AttributeError) as e:
        log(f'K3 yardstick torch._int_mm: refused ({str(e).splitlines()[0]}); '
            f'library_ms is null')
        return None


def exact_setup(cols_np):
    """The exact path's host operands for y = pheno, covariates
    [1, c0, c1, c2], as linear_regression_rows makes them."""
    n = cols_np['pheno'].shape[0]
    Ys = cols_np['pheno'][:, None]
    Q, _ = np.linalg.qr(covariates(cols_np))
    Qty = Q.T @ Ys
    yyp = (Ys * Ys).sum(axis=0) - (Qty * Qty).sum(axis=0)
    return Q, Ys, Qty, yyp, n - K - 1


def phase_kernels(dev, mt_parts, cols_np, ibd_ind):
    """Each kernel against its plain version on the card, at the main
    path's shapes. Returns the kernel records of the result line."""
    from hail_tpu_torch.ops import ibs, linreg_i8 as li
    nalts, misses = mt_parts
    records = []
    ragged_checks(dev)

    # K4 at one partition of the GWAS: 8,192 x 10,000
    from hail_tpu_torch.genetics.call import pack_diploid
    packed = pack_diploid((nalts[0] == 2).astype(np.int32),
                          (nalts[0] >= 1).astype(np.int32))
    u8 = torch.from_numpy(li.pack_gt_2bit(packed, misses[0])).to(dev)
    n = nalts[0].shape[1]
    gz8, m8 = li.unpack_gt_2bit(u8, n)
    gz8_p, m8_p = li._unpack_plain(u8, n)
    torch.cuda.synchronize()
    err4 = max(int((gz8 != gz8_p).sum()), int((m8 != m8_p).sum()))
    if err4:
        raise AssertionError(f'K4 unpack: {err4} entries differ from plain')
    want = np.where(misses[0], 0, nalts[0])
    if not np.array_equal(gz8.cpu().numpy(), want):
        raise AssertionError('K4 unpack: gz8 differs from the numpy decode')
    ms, plain_ms = compare_times(lambda: li.unpack_gt_2bit(u8, n),
                                 lambda: li._unpack_plain(u8, n))
    log(f'K4 unpack_gt_2bit {tuple(u8.shape)} -> 2 x {tuple(gz8.shape)}: '
        f'bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
    # bytes: the packed codes in, the int8 pair out; its shift and compare
    # per entry are counted as no operations (far below any rate)
    R = gz8.shape[0]
    k4_bytes = u8.numel() + 2 * R * n
    # beside it, never called by the port and no library version of K4 (it
    # computes nothing): a device copy that moves the same bytes, half of
    # them read and half written, as the rate a stream reaches on this card
    src = torch.empty(k4_bytes // 2, dtype=torch.int8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = timed_ms(lambda: dst.copy_(src))
    del src, dst
    # and K4's general path: the same rows with one more sample, so that
    # no row starts on a 16-byte piece and every row ends in padding codes
    u8r = torch.cat([u8, u8[:, :1]], dim=1)
    ragged_ms = timed_ms(lambda: li.unpack_gt_2bit(u8r, n + 1))
    del u8r
    log(f'K4 moves {k4_bytes / ms / 1e9:.3f} TB/s; Tensor.copy_ of the same '
        f'{k4_bytes / 1e6:.1f} MB takes {copy_ms:.4f} ms '
        f'({k4_bytes / copy_ms / 1e9:.3f} TB/s); K4 at {R} x {n + 1} (general '
        f'path) {ragged_ms:.4f} ms')
    records.append(record(
        'unpack_gt_2bit', 'hail_tpu_torch/csrc/unpack_2bit.cu',
        'hail_tpu/ops/linreg_i8.py:316', err4, ms, plain_ms,
        bound(k4_bytes), copy_ms=copy_ms, ragged_ms=ragged_ms))

    # K3 on that partition's (gz8, m8) against W = [Q | Ys] planes (C = 35)
    Q, Ys, Qty, yyp, dof = exact_setup(cols_np)
    Wop, scd, Qtyd, yypd, dd = li.exact_consts(Q, Ys, Qty, yyp, dof, dev)
    Wd = Wop.Wdig
    part_k = li.exact_pass(gz8, m8, Wop)
    part_p = li._exact_pass_plain(gz8, m8, Wd)
    torch.cuda.synchronize()
    err3 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(part_k, part_p))
    if err3:
        raise AssertionError(f'K3 exact pass: int32 partials differ by {err3}')
    out_k = li._exact_core(gz8, m8, Wop, scd, Qtyd, yypd, dd, K)
    out_p = li._exact_epilogue(*part_p, n, scd, Qtyd, yypd, dd, K)
    for a, b in zip(out_k, out_p):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError('K3 exact core: NaN positions differ')
        np.testing.assert_allclose(a, b, rtol=1e-10, equal_nan=True)
    ms, plain_ms = compare_times(lambda: li.exact_pass(gz8, m8, Wop),
                                 lambda: li._exact_pass_plain(gz8, m8, Wd))
    lib_ms = int_mm_yardstick(gz8, m8, Wd)
    log(f'K3 exact_pass gz8/m8 {tuple(gz8.shape)} x Wdig {tuple(Wd.shape)}: '
        f'int32 partials bit-equal, f64 outputs within rtol 1e-10; '
        f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm (the two '
        f'products, not the row sums) '
        f'{"refused" if lib_ms is None else f"{lib_ms:.4f} ms"}')
    # bytes: gz8, m8 and Wdig in, two (R, C) and three (R,) int32 out;
    # operations: 2C + 3 int8 multiply-adds per entry (two products of
    # width C, three row sums)
    C = Wd.shape[1]
    records.append(record(
        'linreg_exact_pass', 'hail_tpu_torch/csrc/linreg_exact.cu',
        'hail_tpu/ops/linreg_i8.py:246', err3, ms, plain_ms,
        bound(2 * R * n + n * C + 4 * (2 * R * C + 3 * R),
              2 * (2 * C + 3) * R * n), lib_ms))
    records.append(phase_k7(dev))

    # K1 on that partition as int8 G (-1 = missing) against W = [Q | Ys]
    # in f32 (KP = 5)
    G8 = torch.from_numpy(g8_of(nalts[0], misses[0])).to(dev)
    W = torch.from_numpy(np.concatenate([Q, Ys], axis=1).astype(np.float32)
                         ).to(dev)
    Wf = li.f32_operand(W)           # built once, outside the timed region
    sums_k = li.linreg_i8_sums(G8, Wf)
    sums_p = li._sums_ref(G8, W)
    torch.cuda.synchronize()
    if not torch.equal(sums_k[2], sums_p[2]):
        raise AssertionError('K1 sums: the row sums differ from plain')
    err1, notes = 0.0, []
    for name, a, b, (exact, l2) in zip(('GW', 'MW'), sums_k[:2], sums_p[:2],
                                       f32_sum_oracle(G8, W)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        rel_k = f32_sum_check(a, exact, l2, 1e-5, f'K1 {name} vs f64')
        rel_p = f32_sum_check(b, exact, l2, 1e-4, f'plain {name} vs f64')
        f32_sum_check(a, b, l2, 1e-4, f'K1 {name} vs plain', atol=2e-5)
        err1 = max(err1, float(np.abs(a - b).max()))
        notes.append(f'{name} rel err K1 {rel_k:.3g}, plain {rel_p:.3g}')
    ms, plain_ms = compare_times(lambda: li.linreg_i8_sums(G8, Wf),
                                 lambda: li._sums_ref(G8, W))
    log(f'K1 linreg_i8_sums G8 {tuple(G8.shape)} x W {tuple(W.shape)}: row '
        f'sums bit-equal; against the f64 product {"; ".join(notes)}; K1 vs '
        f'plain max abs diff {err1:.3g}; kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms')
    # beside it, the same G against 8 and 13 columns: KP > 8 reads G once
    # more per further chunk of eight columns
    wide_ms = {}
    for kp in (8, 13):
        Wk = li.f32_operand(torch.randn((n, kp), device=dev))
        wide_ms[f'kp{kp}_ms'] = timed_ms(lambda: li.linreg_i8_sums(G8, Wk))
    log('K1 at ' + ', '.join(f'KP = {k[2:-3]} {v:.4f} ms'
                             for k, v in wide_ms.items()))
    # bytes: G8 and f32 W in, two (R, KP) and one (R, 3) f32 out;
    # operations: the 2 KP true-f32 multiply-adds per entry of the two
    # products (TF32 is ruled out), on the CUDA cores; the three row sums
    # are integer sums of small bytes, counted as no operations (far below
    # any rate)
    KP = W.shape[1]
    records.append(record(
        'linreg_i8_sums', 'hail_tpu_torch/csrc/linreg_f32.cu',
        'hail_tpu/ops/linreg_i8.py:45', err1, ms, plain_ms,
        bound(R * n + 4 * n * KP + 4 * (2 * R * KP + 3 * R),
              2 * 2 * KP * R * n, F32_FLOPS_PER_S, 'f32_fma'), **wide_ms))

    # K2 at the IBD shape: 16,384 variants x 1,000 samples
    het, hom_ref, hom_var, called = (torch.from_numpy(a).to(dev)
                                     for a in ibd_ind)
    codes = ibs.genotype_codes(het, hom_ref, hom_var)
    got = ibs.ibs_counts_codes(codes)
    ref = ibs._ibs_plain(het, hom_ref, hom_var, called)
    torch.cuda.synchronize()
    err2 = max(int((a - b).abs().max()) for a, b in zip(got, ref))
    if err2:
        raise AssertionError(f'K2 IBS: counts differ by up to {err2}')
    ms, plain_ms = compare_times(
        lambda: ibs.ibs_counts_codes(codes),
        lambda: ibs._ibs_plain(het, hom_ref, hom_var, called))
    log(f'K2 ibs_counts codes {tuple(codes.shape)} -> 3 x {tuple(got[0].shape)}: '
        f'bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
    # bytes: the codes in, three (n, n) int32 out; operations: what the
    # function needs, five products of 0/1 indicators of depth m over the
    # pairs i <= j (the outputs are symmetric), on one-bit operands
    mv, ns = codes.shape
    n_ops = 2 * 5 * mv * ns * (ns + 1) // 2
    log(f'K2 operations: {n_ops / 1e9:.1f} GOP, '
        f'{n_ops / B1_OPS_PER_S * 1e3:.4f} ms as 1-bit MMAs '
        f'({n_ops / INT8_OPS_PER_S * 1e3:.4f} ms if they were int8)')
    records.append(record(
        'ibs_counts', 'hail_tpu_torch/csrc/ibs.cu', 'hail_tpu/ops/ibs.py:72',
        err2, ms, plain_ms,
        bound(mv * ns + 3 * 4 * ns * ns, n_ops, B1_OPS_PER_S, 'b1_mma')))
    return records


def host_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds of `fn` over `reps` calls after one, each
    ended by a synchronize: for host work and for routes that fetch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_k7(dev):
    """K7 (`linreg_i8.digit_operand`) at the cells' widths, 361,194 x 42
    (k = 26, P = 16) and 2,504 x 6: bit-equal to `exact_operand` of the
    host's `_digit_planes` and to the plain version on the card; its two
    launches timed with the bases fixed (`kernel ms`), the plain version,
    the host's `_digit_planes` (the yardstick it replaced), and the whole
    route from host arrays (copy, both launches, the fetch of the maxima).
    The record is the wider shape's; the narrower's figures ride along."""
    from hail_tpu_torch.ops import linreg_i8 as li
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for tag, (N, k, P) in (('kg', (2_504, 5, 1)), ('ukb', (361_194, 26, 16))):
        Q, Ys = rng.normal(size=(N, k)), rng.normal(size=(N, P))
        Ys[:, 0] *= 1e-3                         # columns of other scales
        Qd, Ysd = (torch.from_numpy(a).to(dev) for a in (Q, Ys))
        W, scales = li.digit_operand(Qd, Ysd)
        Wd_h, sc_h = li._digit_planes(np.concatenate([Q, Ys], axis=1))
        want = li.exact_operand(torch.from_numpy(Wd_h).to(dev))
        Wd_p, _ = li._digit_planes_plain(Qd, Ysd)
        torch.cuda.synchronize()
        if not (torch.equal(W.Wdig, want.Wdig) and torch.equal(W.WT, want.WT)
                and torch.equal(W.Wdig, Wd_p) and np.array_equal(scales, sc_h)):
            raise AssertionError(f'K7 at {N} x {k + P}: differs from the '
                                 f'host planes')
        base = torch.from_numpy(li._column_base(
            np.abs(np.concatenate([Q, Ys], axis=1)).max(axis=0))).to(dev)

        def kernel():
            li._digit_amax(Qd, Ysd)
            li._digit_launch(Qd, Ysd, base)

        def plain():
            li.exact_operand(li._digit_planes_plain(Qd, Ysd)[0])
        ms, plain_ms = compare_times(kernel, plain)
        amax_ms = timed_ms(lambda: li._digit_amax(Qd, Ysd))
        yard_ms = host_ms(lambda: li._digit_planes(
            np.concatenate([Q, Ys], axis=1)))
        route_ms = host_ms(lambda: li.digit_operand(
            *(torch.from_numpy(a).to(dev) for a in (Q, Ys))))
        # bytes: W read once, WT and Wdig written once (the kernel reads W
        # twice: once for the maxima, once for the digits)
        C, (Cp, ldw) = W.Wdig.shape[1], W.WT.shape
        w_bytes = 8 * N * (k + P)
        out[tag] = dict(N=N, KP=k + P, ms=ms, amax_ms=amax_ms,
                        plain_ms=plain_ms, host_ms=yard_ms, route_ms=route_ms,
                        bnd=bound(w_bytes + Cp * ldw + N * C),
                        two_pass_bound_ms=bound(2 * w_bytes + Cp * ldw
                                                + N * C)['bound_ms'])
        log(f'K7 digit_operand {N} x {k + P}: bit-equal to the host planes '
            f'and the plain version; kernel {ms:.4f} ms (maxima {amax_ms:.4f}'
            f'), plain {plain_ms:.4f} ms, host _digit_planes {yard_ms:.1f} '
            f'ms, route from host arrays {route_ms:.2f} ms')
        del Qd, Ysd, W, want, Wd_p
    u, g = out['ukb'], out['kg']
    return record(
        'digit_planes', 'hail_tpu_torch/csrc/digit_planes.cu',
        'none (hail_tpu/ops/linreg_i8.py:227 _digit_planes is host numpy)',
        0, u['ms'], u['plain_ms'], u['bnd'], shape=[u['N'], u['KP']],
        amax_ms=u['amax_ms'], host_ms=u['host_ms'], route_ms=u['route_ms'],
        two_pass_bound_ms=u['two_pass_bound_ms'], kg_shape=[g['N'], g['KP']],
        kg_ms=g['ms'], kg_plain_ms=g['plain_ms'], kg_host_ms=g['host_ms'],
        kg_route_ms=g['route_ms'], kg_bound_ms=g['bnd']['bound_ms'])


def f32_sum_oracle(G8, W):
    """For K1's GW and MW: the f64 product of the same f32 operands and,
    per element, the l2 norm of its terms, the scale of the rounding error
    of an f32 sum of them: [(exact, l2) for Gz, M]."""
    miss = G8 < 0
    W64 = W.double()
    out = []
    for A in (torch.where(miss, 0, G8).double(), miss.double()):
        out.append(((A @ W64).cpu().numpy(),
                    torch.sqrt((A * A) @ (W64 * W64)).cpu().numpy()))
    return out


def f32_sum_check(x, ref, l2, rtol, what, atol=1e-5):
    """f32 sums of f32 products in some order, held to `ref`:
    |x - ref| <= rtol |ref| + atol l2. The atol term is the random-walk
    scale of f32 rounding (a few eps per add, over the l2 norm of the
    terms); the rtol term bounds drift that grows with the sum, as in a
    long sequential sum of terms of one sign. Returns the largest
    |x - ref| / |ref|."""
    bad = np.abs(x - ref) > rtol * np.abs(ref) + atol * l2
    if bad.any():
        i = np.argwhere(bad)[0]
        raise AssertionError(f'{what}: {int(bad.sum())} elements beyond '
                             f'rtol {rtol} + {atol} l2, first at {tuple(i)}: '
                             f'{x[tuple(i)]} vs {ref[tuple(i)]}')
    with np.errstate(divide='ignore', invalid='ignore'):
        rel = np.abs(x - ref) / np.abs(ref)
    return float(np.nanmax(np.where(np.isfinite(rel), rel, 0.0)))


def g8_of(nalt, miss):
    """int8 storage of the f32 path: n_alt, -1 where missing."""
    return np.where(miss, -1, nalt).astype(np.int8)


def numpy_ols(nalt, miss, cols_np):
    """Independent f64 OLS of pheno ~ [1, c0, c1, c2, x] per row, x mean-
    imputed: (beta, se, t) of x."""
    n = cols_np['pheno'].shape[0]
    cov = covariates(cols_np)
    y = cols_np['pheno']
    out = np.empty((nalt.shape[0], 3))
    for r in range(nalt.shape[0]):
        x = nalt[r].astype(np.float64)
        x[miss[r]] = x[~miss[r]].mean()
        X = np.concatenate([cov, x[:, None]], axis=1)
        coef, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
        resid = y - X @ coef
        sigma2 = resid @ resid / (n - X.shape[1])
        se = np.sqrt(sigma2 * np.linalg.inv(X.T @ X)[-1, -1])
        out[r] = coef[-1], se, coef[-1] / se
    return out


def phase_gwas(hl, mt, n_variants, nalts, misses, cols_np):
    """hl.linear_regression_rows at the bench's size: cold, warm twice, and
    warm with every stats column on the host. Returns the rates, the
    launches, the launches per call and the rows of every partition
    (beta, standard_error, t_stat, p_value)."""
    from hail_tpu_torch.ops import _kernels, devcache
    covs = [1.0] + [getattr(mt, f'c{i}') for i in range(K - 1)]

    def run_count():
        t0 = time.perf_counter()
        res = hl.linear_regression_rows(y=mt.pheno, x=mt.GT.n_alt_alleles(),
                                        covariates=covs)
        n = res._force_count()
        dt = time.perf_counter() - t0
        if n != n_variants:
            raise AssertionError(f'_force_count {n} != {n_variants}')
        return n_variants / dt

    _kernels.reset_launch_counts()
    cold = run_count()
    cold_launches = dict(_kernels.launches)
    if not (cold_launches['hail_unpack_gt_2bit']
            and cold_launches['hail_linreg_exact_pass']):
        raise AssertionError(f'GWAS cold call did not launch K3 and K4: '
                             f'{cold_launches}')
    hits = devcache.hits
    warm = [run_count()]
    warm_launches = {k: v - cold_launches[k]
                     for k, v in _kernels.launches.items()}
    warm.append(run_count())
    if devcache.hits <= hits:
        raise AssertionError(f'warm call missed devcache: {devcache.stats()}')

    t0 = time.perf_counter()
    res = hl.linear_regression_rows(y=mt.pheno, x=mt.GT.n_alt_alleles(),
                                    covariates=covs)
    fields = ('beta', 'standard_error', 't_stat', 'p_value')
    got = {f: [] for f in fields}
    for b in res._stage.collect_batches():
        for f in fields:
            got[f].append(np.asarray(b.columns[f].values, np.float64))
    host = n_variants / (time.perf_counter() - t0)
    got = {f: np.concatenate(v) for f, v in got.items()}
    for f, v in got.items():
        if v.shape != (n_variants,) or not np.isfinite(v).all():
            raise AssertionError(f'{f}: shape {v.shape} or non-finite values')
    rows = np.stack([got[f] for f in fields], axis=1)
    want = numpy_ols(nalts[0][:CHECK_ROWS], misses[0][:CHECK_ROWS], cols_np)
    for j, f in enumerate(fields[:3]):
        np.testing.assert_allclose(got[f][:CHECK_ROWS], want[:, j], rtol=1e-10,
                                   err_msg=f'{f} vs numpy f64 OLS')
    log(f'GWAS {n_variants} variants x {cols_np["pheno"].shape[0]} samples: '
        f'cold {cold:.1f} v/s, warm {warm[0]:.1f} and {warm[1]:.1f} v/s, '
        f'host-materialized {host:.1f} v/s; beta/se/t of {CHECK_ROWS} rows '
        f'match numpy f64 OLS at rtol 1e-10; devcache {devcache.stats()}')
    # K7: a pair of launches in every call (the column plane is made on
    # the card anew each call; no cache holds its constants)
    per_call = {'hail_unpack_gt_2bit': cold_launches['hail_unpack_gt_2bit'],
                'hail_linreg_exact_pass':
                    warm_launches['hail_linreg_exact_pass'],
                'hail_digit_amax': cold_launches['hail_digit_amax'],
                'hail_digit_planes': cold_launches['hail_digit_planes']}
    launches = dict(_kernels.launches)
    return (dict(cold=cold, warm=warm, host_materialized=host,
                 cold_split=cold_split(run_count, n_variants)),
            launches, per_call, rows)


def cold_split(run_count, n_variants):
    """One more cold call, the entry cache emptied first and the program's
    spans recorded (`hail_tpu_torch.utils.timer`): in each partition's
    thread, the ship of `statgen._ship_gt_pair` (`part.ship`), its host
    packing (`ship.pack`), the host-to-device copy of the codes
    (`ship.copy`) and K4's launch on the host (its `kernel` span; the
    kernel's own time is on the card's trace). The partitions run in
    parallel threads, so the sums over partitions do not add up to the
    call; the slowest partition's ship is on its critical path, and the
    rest of the call (the host plane, K3, the f64 epilogue, the count) is
    what is left beside it. Its launches are not among the main path's."""
    from hail_tpu_torch.ops import devcache
    from hail_tpu_torch.utils import timer
    devcache.clear()
    timer.clear()
    with timer.recording():
        total = n_variants / run_count()
    spans = timer.spans()
    timer.clear()

    def took(name, kernel=None):
        return [(s.end_ns - s.start_ns) / 1e9 for s in spans
                if s.name == name and kernel in (None, s.attrs.get('name'))]
    ship, pack, copy = took('part.ship'), took('ship.pack'), took('ship.copy')
    k4 = took('kernel', 'hail_unpack_gt_2bit')
    n = len(ship)
    # K4 launches on the card only: on the CPU its plain version runs
    if not (n and len(pack) == len(copy) == n and len(k4) in (0, n)):
        raise AssertionError(f'cold split: {n} partitions shipped, '
                             f'{len(pack)} packed, {len(copy)} copied, '
                             f'{len(k4)} K4 launches')
    out = dict(call_s=total, partitions=n, pack_s=sum(pack),
               h2d_s=sum(copy), k4_launch_s=sum(k4),
               slowest_partition_s=max(ship), rest_s=total - max(ship))
    log(f'cold call split: {total:.3f} s; summed over {n} partitions in '
        f'threads: pack_gt_2bit {out["pack_s"]:.3f} s, host-to-device copy '
        f'{out["h2d_s"]:.3f} s, K4 launches on the host '
        f'{out["k4_launch_s"]:.4f} s; the slowest partition\'s ship '
        f'{out["slowest_partition_s"]:.3f} s, the rest of the call '
        f'{out["rest_s"]:.3f} s')
    return out


def phase_linreg_f32(dev, nalts, misses, cols_np):
    """`linreg_stats_i8` (K1's path) over all partitions at full width,
    held to the exact path on the same G8 at the reference's f32 bar
    (rtol 2e-4, atol 1e-6). Returns its variants/s and the call's
    launches (the comparison's are not among them)."""
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    G8 = torch.from_numpy(np.concatenate(
        [g8_of(g, m) for g, m in zip(nalts, misses)])).to(dev)
    Q, Ys, Qty, yyp, dof = exact_setup(cols_np)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = li.linreg_stats_i8(G8, Q, Ys, Qty, yyp, dof)
    rate = G8.shape[0] / (time.perf_counter() - t0)
    launches = dict(_kernels.launches)
    if not launches['hail_linreg_i8_sums']:
        raise AssertionError('linreg_stats_i8 did not launch K1')
    exact = li.linreg_stats_i8_exact(G8, Q, Ys, Qty, yyp, dof)
    for f in ('beta', 'p_value'):
        if got[f].shape != (G8.shape[0], 1) or not np.isfinite(got[f]).all():
            raise AssertionError(f'f32 {f}: shape {got[f].shape} or '
                                 f'non-finite values')
        np.testing.assert_allclose(got[f], exact[f], rtol=2e-4, atol=1e-6,
                                   err_msg=f'f32 {f} vs the exact path')
    log(f'linreg_stats_i8 (K1) {G8.shape[0]} variants x {G8.shape[1]} '
        f'samples: {rate:.1f} v/s; beta and p within rtol 2e-4, atol 1e-6 '
        f'of the exact path')
    return rate, launches


def _glm_host_rows(method, test, cov, y, x_rows):
    """stats/glmfit per row, as the host route of the method computes it:
    the per-row result dict of `test` and its fit."""
    from hail_tpu_torch.stats import glmfit
    if method == 'logistic':
        null = glmfit.logreg_fit(cov, y, None, GLM_MAXIT, GLM_TOL)
    else:
        n, k = cov.shape
        b0 = np.concatenate([[np.log(y.sum() / n)], np.zeros(k - 1)])
        mu0 = np.exp(cov @ b0)
        null = glmfit.poisson_fit(cov, y, b0, mu0, cov.T @ (y - mu0),
                                  (mu0 * cov.T) @ cov, GLM_MAXIT, GLM_TOL)
    out = []
    for x in x_rows:
        X = np.hstack([cov, x[:, None]])
        if test == 'score':
            out.append(glmfit.logistic_score_test(X, y, null))
        elif test == 'firth':
            out.append(glmfit.firth_test(null, X, y, 100, GLM_TOL))
        elif method == 'logistic':
            fit = glmfit.logreg_fit(X, y, null, GLM_MAXIT, GLM_TOL)
            out.append(glmfit.wald_test(X, fit) if test == 'wald'
                       else glmfit.lrt_test(X, null, fit))
        else:
            b = np.concatenate([null['b'], [0.0]])
            mu = 1.0 / (1.0 + np.exp(-(X @ b)))    # the reference's quirk
            score = np.concatenate([null['score'], [x @ (y - mu)]])
            f01 = ((cov.T * mu) @ x).reshape(-1, 1)
            fisher = np.block([[null['fisher'], f01],
                               [f01.T, np.array([[(mu * x) @ x]])]])
            fit = glmfit.poisson_fit(X, y, b, mu, score, fisher, GLM_MAXIT,
                                     GLM_TOL)
            out.append(glmfit.wald_test(X, fit))
    return out


def _glm_check(batch, host, test, n_rows):
    """The first rows of the method's first partition against the host
    fits: iteration counts and flags equal, numbers within rtol 1e-9
    (tests/test_glm_device.py)."""
    rows = batch.slice(0, n_rows).to_pylist()
    nums = {'wald': ('beta', 'standard_error', 'z_stat', 'p_value'),
            'lrt': ('beta', 'chi_sq_stat', 'p_value'),
            'score': ('chi_sq_stat', 'p_value'),
            'firth': ('beta', 'chi_sq_stat', 'p_value')}[test]
    for r, (got, want) in enumerate(zip(rows, host)):
        fit = want.get('fit')
        if fit is not None:
            for f in ('n_iterations', 'converged', 'exploded'):
                if got.fit[f] != fit[f]:
                    raise AssertionError(f'{test} row {r}: fit.{f} '
                                         f'{got.fit[f]} != host {fit[f]}')
        for f in nums:
            a, b = got[f], want[f]
            if (a is None) != (b is None):
                raise AssertionError(f'{test} row {r}: {f} {a} vs host {b}')
            if b is not None:
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300,
                                           err_msg=f'{test} row {r}: {f}')
    if len(rows) != n_rows:
        raise AssertionError(f'{test}: {len(rows)} rows checked')


class Spy:
    """For one phase, wraps functions of a module and records the host
    seconds of each call (for a function that ends in a device-to-host
    copy, its device work too), from any thread: list.append is atomic. A
    generator function is drained inside the call, so that its seconds are
    its own. Restores the functions on exit."""

    def __init__(self, module, *names, keep: bool = False):
        """With `keep`, `last[name]` holds the arguments, keyword arguments
        and result of the latest call (the phases time device ops on the
        tensors a method gave them)."""
        import inspect
        self.spent = {n: [] for n in names}
        self.last = {}
        self._module = module
        self._saved = {n: getattr(module, n) for n in names}
        for n, fn in self._saved.items():
            drain = inspect.isgeneratorfunction(fn)

            def wrapped(*a, _fn=fn, _n=n, _drain=drain, **kw):
                t0 = time.perf_counter()
                try:
                    out = _fn(*a, **kw)
                    out = iter(list(out)) if _drain else out
                    if keep:
                        self.last[_n] = (a, kw, out)
                    return out
                finally:
                    self.spent[_n].append(time.perf_counter() - t0)
            setattr(module, n, wrapped)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self._module, n, fn)

    def clear(self):
        for v in self.spent.values():
            v.clear()

    def count(self, *names):
        return sum(len(self.spent[n]) for n in names or self.spent)

    def total(self, *names):
        return sum(sum(self.spent[n]) for n in names or self.spent)


def phase_glm(hl, mt, n_variants, nalts, misses, cols_np):
    """The GLM device tier over the GWAS's cached entry pair: logistic wald
    at full width, lrt/score/firth and poisson wald over one partition;
    each holds its first rows to stats/glmfit. Returns variants/s and, for
    each call, its seconds and the seconds of its device-tier calls
    summed over partitions (which run in parallel threads)."""
    from hail_tpu_torch.ops import glm_device
    with Spy(glm_device, 'logistic_rows_device', 'poisson_rows_device') as spy:
        return _glm_calls(hl, mt, n_variants, nalts, misses, cols_np, spy)


def _glm_calls(hl, mt, n_variants, nalts, misses, cols_np, spy):
    from hail_tpu_torch.ops import _kernels, devcache
    cov = covariates(cols_np)
    x = np.where(misses[0], 0, nalts[0])[:GLM_CHECK_ROWS].astype(np.float64)
    mrow = misses[0][:GLM_CHECK_ROWS]
    x = np.where(mrow, (x.sum(axis=1) / (~mrow).sum(axis=1))[:, None], x)
    one = mt._filter_partitions([0])
    _kernels.reset_launch_counts()
    rates, tier = {}, {}
    for method, test, src, n in (
            ('logistic', 'wald', mt, n_variants),
            ('logistic', 'lrt', one, nalts[0].shape[0]),
            ('logistic', 'score', one, nalts[0].shape[0]),
            ('logistic', 'firth', one, nalts[0].shape[0]),
            ('poisson', 'wald', one, nalts[0].shape[0])):
        covs = [1.0] + [getattr(src, f'c{i}') for i in range(K - 1)]
        fn = (hl.logistic_regression_rows if method == 'logistic'
              else hl.poisson_regression_rows)
        y = src.yb if method == 'logistic' else src.yc
        hits = devcache.hits
        spy.clear()
        t0 = time.perf_counter()
        res = fn(test, y=y, x=src.GT.n_alt_alleles(), covariates=covs)
        batches = res._stage.collect_batches()
        total = time.perf_counter() - t0
        rate = n / total
        got = np.concatenate([np.asarray(b.columns['p_value'].values,
                                         np.float64) for b in batches])
        if got.shape != (n,) or not np.isfinite(got).any():
            raise AssertionError(f'{method} {test}: p-values of shape '
                                 f'{got.shape}, none finite')
        if devcache.hits - hits != len(batches):
            raise AssertionError(f'{method} {test} missed devcache: '
                                 f'{devcache.stats()}')
        yv = cols_np['yb' if method == 'logistic' else 'yc']
        _glm_check(batches[0], _glm_host_rows(method, test, cov, yv, x),
                   test, GLM_CHECK_ROWS)
        rates[f'{method}_{test}'] = rate
        tier[f'{method}_{test}'] = dict(total_s=total,
                                        device_tier_s=spy.total())
        log(f'{method}_regression_rows {test} {n} variants x {cov.shape[0]} '
            f'samples: {rate:.1f} v/s ({total:.3f} s; device-tier calls '
            f'{spy.total():.3f} s summed over {spy.count()} partitions); '
            f'{GLM_CHECK_ROWS} rows match '
            f'stats/glmfit (iterations and flags equal, rtol 1e-9)')
    launches = dict(_kernels.launches)
    if launches['hail_unpack_gt_2bit']:
        raise AssertionError('the GLM calls decoded GT again (K4 launched)')
    return rates, tier, launches


def ibd_method(hl, mt):
    """hl.identity_by_descent at 1,000 samples x 16,384 variants, then the
    collect of its pair rows: the rows, the seconds of the call and of the
    collect, and the call's launches."""
    from hail_tpu_torch.ops import _kernels
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    table = hl.identity_by_descent(mt)
    call = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    if not launches['hail_ibs_counts']:
        raise AssertionError('identity_by_descent did not launch K2')
    t0 = time.perf_counter()
    rows = table.collect()
    collect = time.perf_counter() - t0
    return rows, (call, collect), launches


def ibd_check(rows, seconds, mt, dev):
    """The method's counts against K2 and its plain version on the same
    indicators, finite Z's, and the kernel's share of the call."""
    from hail_tpu_torch.methods.relatedness import _gt_indicator_matrices
    from hail_tpu_torch.ops import ibs
    n = mt.count_cols()
    if len(rows) != n * (n - 1) // 2:
        raise AssertionError(f'{len(rows)} pairs, expected {n * (n - 1) // 2}')

    het, hom_ref, hom_var, called, _ = _gt_indicator_matrices(mt.GT)
    ind = [torch.from_numpy(a).to(dev) for a in (het, hom_ref, hom_var, called)]
    got = ibs.ibs_counts(*ind)
    ref = ibs._ibs_plain(*ind)
    for name, a, b in zip(('ibs0', 'ibs1', 'ibs2'), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f'{name}: kernel and plain version differ')
    m0, m1, m2 = (a.cpu().numpy() for a in got)
    for r in rows[:: max(1, len(rows) // 1000)]:
        i, j = int(r.i[1:]), int(r.j[1:])
        if (r.ibs0, r.ibs1, r.ibs2) != (m0[i, j], m1[i, j], m2[i, j]):
            raise AssertionError(f'pair ({r.i}, {r.j}): method counts differ')
        if not all(np.isfinite([r.ibd.Z0, r.ibd.Z1, r.ibd.Z2, r.ibd.PI_HAT])):
            raise AssertionError(f'pair ({r.i}, {r.j}): non-finite Z')
    codes = ibs.genotype_codes(*ind[:3])
    kernel_s = timed_ms(lambda: ibs.ibs_counts_codes(codes), reps=3) / 1e3
    call, collect = seconds
    log(f'IBD {n} samples x {het.shape[0]} variants: the call (indicators, '
        f'K2, the PLINK epilogue, the pair table by column) {call:.3f} s, of '
        f'it K2 {kernel_s:.4f} s and the host {call - kernel_s:.3f} s; the '
        f'collect of its {len(rows)} pair rows {collect:.3f} s; IBS matrices '
        f'equal the plain version')
    return dict(total_s=call + collect, call_s=call, collect_s=collect,
                kernel_s=kernel_s, host_s=call - kernel_s)


def phase_ld_prune_gwas(hl, mt, n_variants, n_parts):
    """hl.ld_prune on the GWAS MatrixTable as bench.py runs it (r² 0.2,
    bp_window_size 256, so W = 256), after the GWAS: every partition's
    (gz8, m8) pair comes from the device cache and K4 is not launched. The
    data has no LD, so every variant is kept. Returns its rate, the split
    of the call into the device ops and the host stages, and the device
    ops' calls per method call."""
    from hail_tpu_torch.ops import _kernels, devcache, ldprune
    _kernels.reset_launch_counts()
    before = devcache.stats()
    with Spy(ldprune, 'standardize_rows_device', 'banded_r2_hits',
             '_band_block') as spy:
        t0 = time.perf_counter()
        kept = hl.ld_prune(mt.GT, r2=LD_R2, bp_window_size=LD_WINDOW
                           )._force_count()
        total = time.perf_counter() - t0
    after = devcache.stats()
    if after['hits'] - before['hits'] != n_parts or \
            after['misses'] != before['misses']:
        raise AssertionError(f'ld_prune missed the device cache: {before} -> '
                             f'{after}')
    if _kernels.launches['hail_unpack_gt_2bit']:
        raise AssertionError('ld_prune after the GWAS decoded GT again (K4 '
                             'launched)')
    if kept != n_variants:
        raise AssertionError(f'ld_prune kept {kept} of {n_variants} variants '
                             f'of data without LD')
    std_s = spy.total('standardize_rows_device')
    band_s = spy.total('banded_r2_hits')
    out = dict(variants_per_s=n_variants / total, call_s=total,
               standardize_s=std_s, banded_r2_hits_s=band_s,
               host_s=total - std_s - band_s, kept=kept)
    log(f'ld_prune {n_variants} variants x {mt.count_cols()} samples (r2 '
        f'{LD_R2}, bp_window_size {LD_WINDOW}): {out["variants_per_s"]:.1f} '
        f'v/s ({total:.3f} s: standardize_rows_device {std_s:.4f} s over '
        f'{spy.count("standardize_rows_device")} calls, banded_r2_hits '
        f'{band_s:.4f} s with {spy.count("_band_block")} _band_block calls '
        f'and its copy to the host, host stages {out["host_s"]:.3f} s); '
        f'{kept} kept; devcache hit on all {n_parts} partitions, K4 not '
        f'launched')
    return out, {n: spy.count(n) for n in spy.spent}


def build_ld_mt(hl, rng, n_samples, part_sizes):
    """A MatrixTable of packed GT calls with planted LD: of every four
    variants, the last three copy their predecessor with 10% of the calls
    drawn again; 2% missing; consecutive positions on one contig. The
    partitions' sizes are no multiples of four, so groups of copies cross
    partition boundaries and stages 2 and 3 of ld_prune find edges.
    Returns (mt, nalt, missing, partition of each variant)."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.call import pack_diploid
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ir.columns import Batch, LocusColumn, ObjectColumn, PrimitiveColumn
    from hail_tpu_torch.matrixtable import MatrixBatch, MatrixStage, MatrixTable
    m = sum(part_sizes)
    nalt = rng.integers(0, 3, (m, n_samples)).astype(np.int32)
    for i in range(m):
        if i % 4:
            redraw = rng.random(n_samples) < 0.1
            nalt[i] = np.where(redraw, nalt[i], nalt[i - 1])
    miss = rng.random((m, n_samples)) < MISSING
    rg = default_reference()
    mbs, lo = [], 0
    for r in part_sizes:
        sl = slice(lo, lo + r)
        alleles = np.empty(r, dtype=object)
        alleles[:] = [['A', 'T']] * r
        rows = Batch({
            'locus': LocusColumn(ht.tlocus(rg), np.zeros(r, np.int32),
                                 np.arange(lo, lo + r, dtype=np.int32) + 10_000),
            'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles)}, r)
        gt = pack_diploid((nalt[sl] == 2).astype(np.int32),
                          (nalt[sl] >= 1).astype(np.int32))
        mbs.append(MatrixBatch(rows, {'GT': PrimitiveColumn(ht.tcall, gt,
                                                            miss[sl])}))
        lo += r
    cols = Batch({'s': ObjectColumn(ht.tstr, np.asarray(
        [f's{i}' for i in range(n_samples)], object))}, n_samples)
    mt = MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), cols, ['locus', 'alleles'], ['s'],
        ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr)),
        ht.tstruct(s=ht.tstr), ht.tstruct(GT=ht.tcall), mbs))
    part = np.repeat(np.arange(len(part_sizes)), part_sizes)
    return mt, nalt, miss, part


def ld_prune_oracle(nalt, miss, part, r2, w):
    """The three stages of ld_prune in numpy f64, for keys that are unique
    and positions that are consecutive on one contig (so each variant's
    window is the w variants before it): (1) within each partition, a
    variant survives unless an earlier survivor of its window has
    r² >= r2; (2) edges between survivors of any partition in a window
    with r² >= r2; (3) repeatedly remove the node of most remaining edges,
    a tie going to the lower minor allele frequency, in order of first
    appearance. Asserts that no r² lies within 1e-9 of r2. Returns the
    kept mask and the count of what each stage did."""
    G = nalt.astype(np.float64)
    cnt = (~miss).sum(axis=1)
    mean = np.where(miss, 0, G).sum(axis=1) / np.maximum(cnt, 1)
    c = np.where(miss, mean[:, None], G) - mean[:, None]
    ss = np.sqrt((c * c).sum(axis=1))
    ok = ss > 0
    Z = np.where(ok[:, None], c / np.where(ok, ss, 1)[:, None], 0.0)
    del G, c
    m = len(Z)
    r = np.zeros((m, w))                     # r[i, k]: pair (i, i - w + k)
    for s in range(0, m, 1024):
        e = min(s + 1024, m)
        lo = max(0, s - w)
        cb = Z[s:e] @ Z[lo:e].T
        j = np.arange(s, e)[:, None] - w + np.arange(w)[None, :]
        r[s:e] = np.where(j >= 0, np.take_along_axis(
            cb, np.clip(j - lo, 0, None), axis=1), 0.0)
    valid = (np.arange(m)[:, None] - w + np.arange(w)[None, :]) >= 0
    gap = np.abs(r[valid] ** 2 - r2).min()
    if gap <= 1e-9:
        raise AssertionError(f'an r² lies within {gap:.3g} of {r2}')
    hit = valid & (r * r >= r2)
    survive = np.zeros(m, bool)
    for i in range(m):
        js = i - w + np.flatnonzero(hit[i])
        if ok[i] and not (survive[js] & (part[js] == part[i])).any():
            survive[i] = True
    edges = [(int(j), int(i)) for i in np.flatnonzero(survive)
             for j in i - w + np.flatnonzero(hit[i]) if survive[j]]
    nbrs = {}
    for j, i in edges:
        nbrs.setdefault(j, set()).add(i)
        nbrs.setdefault(i, set()).add(j)
    twice_maf = np.minimum(mean, 2.0 - mean)
    removed = set()
    while True:
        deg = {v: len(n - removed) for v, n in nbrs.items() if v not in removed}
        best = None
        for v, d in deg.items():
            if d and (best is None or d > deg[best] or (
                    d == deg[best] and twice_maf[v] < twice_maf[best])):
                best = v
        if best is None:
            break
        removed.add(best)
    keep = survive.copy()
    keep[list(removed)] = False
    return keep, dict(eligible=int(ok.sum()), stage1_pruned=int(ok.sum()
                      - survive.sum()), stage2_edges=len(edges),
                      stage3_removed=len(removed), kept=int(keep.sum()),
                      r2_gap=float(gap))


def phase_ld_prune_planted(hl, rng, n_samples):
    """hl.ld_prune on a MatrixTable with planted LD (a cold call: K4 decodes
    each partition), its kept keys held equal to ld_prune_oracle."""
    from hail_tpu_torch.ops import _kernels
    mt, nalt, miss, part = build_ld_mt(hl, rng, n_samples, LD_PARTS)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = hl.ld_prune(mt.GT, r2=LD_R2, bp_window_size=LD_WINDOW).collect()
    total = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    keep, stages = ld_prune_oracle(nalt, miss, part, LD_R2, LD_WINDOW)
    want = np.flatnonzero(keep) + 10_000
    got_pos = np.asarray([r.locus.position for r in got])
    if not np.array_equal(got_pos, want):
        raise AssertionError(f'ld_prune kept {len(got_pos)} variants, the '
                             f'oracle {len(want)}; first difference at '
                             f'{np.flatnonzero(got_pos[:len(want)] != want[:len(got_pos)])[:1]}')
    if not (stages['stage1_pruned'] and stages['stage2_edges']
            and stages['stage3_removed']):
        raise AssertionError(f'not every stage of ld_prune acted: {stages}')
    log(f'ld_prune with planted LD, {len(nalt)} variants x {n_samples} '
        f'samples in partitions of {LD_PARTS}: {total:.3f} s (cold), kept '
        f'set equal to the numpy f64 oracle of the three stages ({stages}; '
        f'no r² within 1e-9 of {LD_R2})')
    return dict(call_s=total, **stages), launches


def f64_check(got, want, what, rtol=1e-10, atol=1e-12):
    """|got - want| <= rtol |want| + atol: two f64 sums of the same n terms
    in other orders differ by up to n·eps times the sum of the terms'
    sizes, which is at most about 1 for these normalized rows (1.1e-12 at
    n = 10,000): that is the atol."""
    err = np.abs(got - want)
    bad = err > rtol * np.abs(want) + atol
    if got.shape != want.shape or not np.isfinite(got).all() or bad.any():
        raise AssertionError(f'{what}: shape {got.shape} vs {want.shape}, '
                             f'{int(bad.sum())} entries beyond rtol {rtol} + '
                             f'atol {atol}, max abs err {err.max():.3g}')
    return float(err.max())


def phase_blockmatrix_methods(hl, dev, mt, nalt, miss):
    """genetic_relatedness_matrix (the ExactGrm route), realized_relationship
    _matrix, row_correlation and ld_matrix over one partition of the GWAS
    MatrixTable, each against numpy f64: the GRM at max abs 1e-12 (the
    oracle of tests/test_grm_i8.py), the others at rtol 1e-10 (f64_check).
    Returns their seconds (each with the seconds of its host evaluation of
    the entry expression, `statgen._entry_expr_to_blocks`) and errors, and
    the GRM's _grm_strip calls."""
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.ops import grm
    G = nalt.astype(np.float64)
    cnt = (~miss).sum(axis=1)
    mean = np.where(miss, 0, G).sum(axis=1) / np.maximum(cnt, 1)
    c = np.where(miss, mean[:, None], G) - mean[:, None]
    del G
    out = {}

    def call(name, fn):
        with Spy(statgen, '_entry_expr_to_blocks') as ev:
            t0 = time.perf_counter()
            bm = fn()
            torch.cuda.synchronize()
            out[f'{name}_s'] = time.perf_counter() - t0
        out[f'{name}_entry_eval_s'] = ev.total()
        if bm._data.dtype != torch.float64 or bm._data.device.type != dev.type:
            raise AssertionError(f'{name}: {bm._data.dtype} on '
                                 f'{bm._data.device}')
        return bm.to_numpy()

    with Spy(grm, '_grm_strip') as spy:
        K = call('grm', lambda: hl.genetic_relatedness_matrix(mt.GT))
    if dev.type == 'cuda' and not spy.count():
        raise AssertionError('the GRM did not take the ExactGrm route')
    p = mean / 2
    d = np.sqrt(2 * p * (1 - p))
    ok = (d > 0) & (cnt > 0)
    Z = np.where(ok[:, None], c / np.where(ok, d, 1)[:, None], 0.0)
    err = np.abs(K - Z.T @ Z / max(int(ok.sum()), 1)).max()
    if not err <= 1e-12:
        raise AssertionError(f'GRM: max abs err {err:.3g} from the f64 oracle')
    out['grm_max_abs_err'] = float(err)
    del K
    n = c.shape[1]
    ss = (c * c).sum(axis=1)
    Z = np.where(ss[:, None] > 0, c / np.sqrt(np.where(ss > 0, ss, 1))[:, None],
                 0.0)
    W = Z * np.sqrt(n)
    K = call('rrm', lambda: hl.realized_relationship_matrix(mt.GT))
    out['rrm_max_abs_err'] = f64_check(K, W.T @ W / int((ss > 0).sum()), 'RRM')
    del K, W
    x = mt.GT.n_alt_alleles()
    corr = Z @ Z.T
    R = call('row_correlation', lambda: hl.row_correlation(x))
    out['row_correlation_max_abs_err'] = f64_check(R, corr, 'row_correlation')
    R = call('ld_matrix', lambda: hl.ld_matrix(x, mt.locus, radius=LD_WINDOW))
    i = np.arange(len(corr))
    # consecutive positions on one contig: the window is |i - j| <= radius
    inside = np.abs(i[:, None] - i[None, :]) <= LD_WINDOW
    out['ld_matrix_max_abs_err'] = f64_check(R, np.where(inside, corr, 0.0),
                                             'ld_matrix')
    if (R[~inside] != 0).any():
        raise AssertionError('ld_matrix: entries outside the window')
    log(f'BlockMatrix methods over {nalt.shape[0]} variants x {n} samples: '
        + ', '.join(f'{k} {v:.3f}' if k.endswith('_s') else f'{k} {v:.3g}'
                    for k, v in out.items())
        + f'; GRM by ExactGrm in {spy.count()} strips, within '
        f'1e-12 of the numpy f64 oracle; the others within rtol 1e-10')
    return out, spy.count()


def phase_grm_strips(dev):
    """ExactGrm at bench.py's config 5: random codes (25% missing) made on
    the card from a seed, as bench.py:386-395 makes them. Times strips of
    GRM_B columns (CUDA events) and estimates the full kinship's seconds as
    bench.py does; holds the first strip within 1e-12 of the f64 route
    (Zᵀ·Z_strip / m by torch.matmul in f64), and times that route beside
    it. Returns the device-op record of _grm_strip."""
    from hail_tpu_torch.ops.grm import ExactGrm, _plane_product
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    codes = torch.randint(0, 4, (GRM_M, GRM_N), generator=gen, device=dev,
                          dtype=torch.int8)
    m8 = (codes == 3).to(torch.int8)
    gz8 = torch.where(codes == 3, 0, codes)
    del codes
    cnt = (1 - m8.to(torch.int32)).sum(dim=1).cpu().numpy()
    s = gz8.to(torch.int32).sum(dim=1).cpu().numpy()
    p = s / np.maximum(2 * cnt, 1)
    ok = 2 * p * (1 - p) > 0
    g = ExactGrm(gz8, m8, p, ok)
    strip0 = g.strip(0, GRM_B)
    dfl = torch.from_numpy(np.sqrt(2 * p * (1 - p))).to(dev)
    okd = torch.from_numpy(ok).to(dev)
    Z = torch.where(okd[:, None] & (m8 == 0),
                    (gz8.to(torch.float64) - torch.from_numpy(2 * p).to(dev)[:, None])
                    / torch.where(okd, dfl, 1.0)[:, None], 0.0)
    del gz8, m8
    Zs = Z[:, :GRM_B].contiguous()
    ref = (Z.T @ Zs) / g.m_used
    err = float((strip0 - ref).abs().max())
    if not err <= 1e-12:
        raise AssertionError(f'ExactGrm strip: max abs err {err:.3g} from the '
                             f'f64 route')
    del strip0, ref
    f64_ms = timed_ms(lambda: Z.T @ Zs, reps=4)
    del Zs
    # one of a strip's 63 steps: the int8 product (torch._int_mm, its right
    # operand column-major as _plane_product passes it, and row-major as a
    # contiguous (m, B) operand would be) and its f64 accumulation
    rows = g.ct[:GRM_B]
    q = g._planes[0][0]
    prod = _plane_product(g.ct, rows, q)
    row_major = (rows * q).T.contiguous()
    acc = torch.zeros(prod.shape, dtype=torch.float64, device=dev)
    step = dict(product_ms=timed_ms(lambda: _plane_product(g.ct, rows, q),
                                    reps=5),
                product_row_major_ms=timed_ms(
                    lambda: torch._int_mm(g.ct, row_major), reps=5),
                accumulate_ms=timed_ms(lambda: acc.add_(prod, alpha=1e-3),
                                       reps=5))
    del prod, row_major, acc
    strip_ms = [timed_ms(lambda lo=lo: g.strip(lo, lo + GRM_B), reps=1)
                for lo in range(GRM_B, (GRM_STRIPS + 1) * GRM_B, GRM_B)]
    ms = sum(strip_ms) / GRM_STRIPS
    full_s = GRM_N / GRM_B * ms / 1e3
    # operations: what the function needs, Zᵀ·Z_strip in f64 (2 n B m);
    # bytes: the three int8 indicator matrices in, the f64 strip out
    n_ops = 2 * GRM_N * GRM_B * GRM_M
    bnd = bound(3 * GRM_M * GRM_N + 8 * GRM_N * GRM_B, n_ops,
                F64_FLOPS_PER_S, 'f64_mma')
    log(f'ExactGrm {GRM_N} samples x {GRM_M} variants, strips of {GRM_B}: '
        f'{", ".join(f"{t:.2f}" for t in strip_ms)} ms per strip '
        f'({2 * GRM_N * GRM_B * GRM_M / ms / 1e9:.2f} TFLOP/s of useful f64), '
        f'full {GRM_N} x {GRM_N} kinship in ~{full_s:.2f} s; the f64 route '
        f'(torch.matmul f64) {f64_ms:.2f} ms per strip; first strip within '
        f'{err:.3g} of it; bound {bnd["bound_ms"]:.2f} ms ({bnd["bound_by"]}); '
        f'one of its 63 steps: the int8 product {step["product_ms"]:.3f} ms '
        f'(with a row-major right operand {step["product_row_major_ms"]:.3f} '
        f'ms), its f64 accumulation {step["accumulate_ms"]:.3f} ms')
    del Z
    return dict(name='_grm_strip', source='hail_tpu_torch/ops/grm.py',
                replaces='hail_tpu/ops/grm.py:65',
                shape=f'{GRM_N} samples x {GRM_M} variants, strip {GRM_B}',
                ms=ms, strip_ms=strip_ms, full_kinship_s_est=full_s,
                max_abs_err=err, **bnd, share_of_bound=bnd['bound_ms'] / ms,
                yardstick='torch.matmul f64 (the f64 route)',
                yardstick_ms=f64_ms, **step)


def ld_device_ops(dev, gz8, m8):
    """standardize_rows_device and _band_block at the main path's shapes
    (one partition's pair, 8,192 x 10,000; a block of 2,048 rows against a
    window of 256), timed with CUDA events. standardize_rows_device ends in
    a small device-to-host copy, so its events also hold the host's gap
    between two calls. Returns their device-op records."""
    from hail_tpu_torch.ops import ldprune
    R, n = gz8.shape
    std_ms = timed_ms(lambda: ldprune.standardize_rows_device(gz8, m8), reps=5)
    z, _, _ = ldprune.standardize_rows_device(gz8, m8)
    block, w = 2048, LD_WINDOW
    zpad = torch.cat([z.new_zeros((w, n)), z], dim=0)
    s = block                                      # an inner block
    band_ms = timed_ms(lambda: ldprune._band_block(zpad, s, w, block, LD_R2))
    zb, zw = zpad[s + w:s + w + block], zpad[s:s + block + w]
    prod_ms = timed_ms(lambda: zb @ zw.T)
    del z, zpad
    # standardize: the int8 pair in, Z out in f64; its arithmetic is far
    # below any rate
    std = bound(10 * R * n)
    # the band: the r² it needs, 2 w n f64 operations per row of the block,
    # against the rows read once and the packed bits written
    band = bound(8 * (block + w) * n + block * (w // 8), 2 * block * w * n,
                 F64_FLOPS_PER_S, 'f64_mma')
    log(f'standardize_rows_device {R} x {n}: {std_ms:.4f} ms (bound '
        f'{std["bound_ms"]:.4f}); _band_block block {block}, W {w}: '
        f'{band_ms:.4f} ms, its product alone {prod_ms:.4f} ms (bound '
        f'{band["bound_ms"]:.4f}, the r² it needs)')
    return [
        dict(name='standardize_rows_device', source='hail_tpu_torch/ops/ldprune.py',
             replaces='hail_tpu/ops/ldprune.py:79', shape=f'{R} x {n}',
             ms=std_ms, **std, share_of_bound=std['bound_ms'] / std_ms,
             yardstick=None, yardstick_ms=None),
        dict(name='_band_block', source='hail_tpu_torch/ops/ldprune.py',
             replaces='hail_tpu/ops/ldprune.py:30',
             shape=f'{n} samples, block {block}, W = {w}', ms=band_ms, **band,
             share_of_bound=band['bound_ms'] / band_ms,
             yardstick='its product alone (torch.matmul f64)',
             yardstick_ms=prod_ms)]


def np_randomized_svd(A, k, q, oversample, seed):
    """The randomized SVD of ops/decomp (Halko, CholeskyQR2, host eigh) in
    numpy f64, with the same Ω: the PCA oracle. Returns (s, Vt)."""
    def orthonormalize(Y):
        for _ in range(2):
            G = Y.T @ Y
            try:
                Rinv = np.linalg.inv(np.linalg.cholesky(G)).T
            except np.linalg.LinAlgError:
                w, V = np.linalg.eigh(G)
                tol = max(np.max(w), 0.0) * len(G) * np.finfo(G.dtype).eps
                Rinv = (V * np.where(w > tol, 1 / np.sqrt(np.maximum(w, tol)),
                                     0.0)[None, :]) @ V.T
            Y = Y @ Rinv
        return Y

    m, n = A.shape
    l = min(k + oversample, m, n)
    Omega = np.random.default_rng(seed & 0xFFFFFFFF).normal(size=(n, l))
    Q = orthonormalize(A @ Omega)
    for _ in range(q):
        Q = orthonormalize(A @ orthonormalize(A.T @ Q))
    B = Q.T @ A
    w, V = np.linalg.eigh(B @ B.T)
    w, V = w[::-1], V[:, ::-1]
    s = np.sqrt(np.maximum(w, 0.0))
    tol = s[0] * max(m, n) * np.finfo(s.dtype).eps
    sinv = np.where(s > tol, 1.0 / np.maximum(s, tol), 0.0)
    return s[:k], ((sinv[:, None] * V.T) @ B)[:k]


def hwe_oracle(nalt, miss):
    """hwe_normalized_pca's matrix in numpy: calls mean-imputed per
    variant, variants with p in (0, 1), (g - 2p) / sqrt(2p(1-p) m)."""
    G = nalt.astype(np.float64)
    cnt = (~miss).sum(axis=1)
    mean = np.where(cnt > 0, np.where(miss, 0, G).sum(axis=1)
                    / np.maximum(cnt, 1), 0.0)
    p = mean / 2
    keep = (p > 0) & (p < 1) & (cnt > 0)
    G = np.where(miss, mean[:, None], G)[keep]
    m = G.shape[0]
    return (G - mean[keep][:, None]) / np.sqrt(
        2 * p[keep] * (1 - p[keep]) * m)[:, None]


def king_oracle(nalt, miss, rows):
    """KING's φ for the samples `rows` against every sample, in numpy f64
    from the indicators (reference relatedness.py:53-66)."""
    called = ~miss
    H, R, A, Cl = ((a & called).astype(np.float64) for a in
                   (nalt == 1, nalt == 0, nalt == 2, np.ones_like(miss)))
    both_het = H[:, rows].T @ H
    opp = R[:, rows].T @ A + A[:, rows].T @ R
    n_i = H[:, rows].T @ Cl
    n_j = Cl[:, rows].T @ H
    return 0.5 + (2 * both_het - 4 * opp - n_i - n_j) / np.maximum(
        4 * np.minimum(n_i, n_j), 1e-300)


def pc_relate_oracle(nalt, miss, scores, maf, rows):
    """PC-Relate's kin, ibd0, ibd1 and ibd2 for the samples `rows` against
    every sample, in numpy f64 from the method's PCA scores (reference
    relatedness.py:118-168); with the least distance of any μ from maf,
    1 - maf, 0 and 1, and of any of these kin from the k0 cutoff."""
    G = nalt.astype(np.float64)
    n = G.shape[1]
    X = np.concatenate([np.ones((n, 1)), scores], axis=1)
    cnt = (~miss).sum(axis=1)
    mean = np.where(miss, 0.0, G).sum(axis=1) / np.maximum(cnt, 1)
    B = np.linalg.solve(X.T @ X, X.T @ np.where(miss, mean[:, None], G).T).T
    mu = B @ X.T / 2.0
    mu_gap = min(float(np.abs(mu - t).min()) for t in (maf, 1 - maf, 0, 1))
    ok = ~((mu <= maf) | (mu >= 1 - maf) | (mu <= 0) | (mu >= 1) | miss)
    var = np.where(ok, mu * (1 - mu), 0.0)
    ca = np.where(ok, G - 2 * mu, 0.0)
    sd = np.sqrt(var)
    kin = (ca[:, rows].T @ ca) / (4 * (sd[:, rows].T @ sd))
    f = 2 * (ca * ca).sum(axis=0) / (4 * (sd * sd).sum(axis=0)) - 1
    del ca, sd
    gd = np.where(~ok, 0.0, np.where(G == 0, mu, np.where(G == 1, 0.0, 1 - mu)))
    ngd = gd - var * (1 + f)[None, :]
    del gd
    k2 = (ngd[:, rows].T @ ngd) / (var[:, rows].T @ var)
    del ngd, var
    ha, hr = ((ok & (G == v)).astype(np.float64) for v in (2, 0))
    ibs0 = ha[:, rows].T @ hr + hr[:, rows].T @ ha
    del ha, hr
    mu2 = np.where(ok, mu * mu, 0.0)
    om2 = np.where(ok, (1 - mu) * (1 - mu), 0.0)
    k0_den = mu2[:, rows].T @ om2 + om2[:, rows].T @ mu2
    cutoff = 2.0 ** (-5.0 / 2.0)
    k0 = np.where(kin <= cutoff, 1 - 4 * kin + k2, ibs0 / k0_den)
    return dict(kin=kin, ibd0=k0, ibd1=1 - (k2 + k0), ibd2=k2), \
        mu_gap, float(np.abs(kin - cutoff).min())


def _sample_index(s):
    return int(s[1:])


def _scores(table, n):
    """The (n, k) scores of a PCA scores table keyed by sample 's<i>'."""
    out = np.zeros((n, PCA_K))
    for r in table.collect():
        out[_sample_index(r.s)] = r.scores
    return out


def _same_calls(mt, nalt, miss, what):
    """The GT of `mt`'s partitions against the calls nalt / missing."""
    from hail_tpu_torch.genetics.call import calls_n_alt_alleles
    st = mt._stage
    gts = [st.partition_fn(c).entries['GT'] for c in st.contexts]
    got_miss = np.concatenate([g.missing_mask() for g in gts])
    got = np.concatenate([calls_n_alt_alleles(np.asarray(g.values))
                          for g in gts])
    if not (np.array_equal(got_miss, miss)
            and np.array_equal(np.where(miss, 0, got), np.where(miss, 0, nalt))):
        raise AssertionError(f'{what}: GT differs from the calls written')


def phase_relatedness(hl, dev, rng):
    """The relatedness MatrixTable (REL_SAMPLES x REL_VARIANTS in REL_PARTS
    partitions, the last REL_DUPS samples duplicates of the first), written
    in the native format and read back; on the table read back,
    hwe_normalized_pca (the randomized route on the card), king, pc_relate
    and maximal_independent_set, each held to numpy f64; then a sort of the
    rows and the entries of a few samples, tables of REL_PARTS partitions.
    Returns the phase's seconds and errors, and the device-op records of
    _king_kernel, _pc_relate_kernel and the PCA's randomized_svd."""
    import importlib
    import tempfile
    rel_mod = importlib.import_module('hail_tpu_torch.methods.relatedness')
    pca_mod = importlib.import_module('hail_tpu_torch.methods.pca')
    out = {}
    mt0, nalts, misses, _ = build_mt(hl, rng, REL_SAMPLES,
                                     REL_VARIANTS // REL_PARTS, REL_PARTS,
                                     with_pheno=False, dups=REL_DUPS)
    nalt, miss = np.concatenate(nalts), np.concatenate(misses)
    del nalts, misses
    n = REL_SAMPLES
    planted = [(k, n - REL_DUPS + k) for k in range(REL_DUPS)]
    check = np.unique(np.concatenate([
        np.arange(REL_DUPS), np.arange(n - REL_DUPS, n),
        rng.choice(n, REL_CHECK_ROWS - 2 * REL_DUPS, replace=False)]))[
            :REL_CHECK_ROWS]
    tmp = tempfile.TemporaryDirectory()
    path = f'{tmp.name}/rel.mt'
    t0 = time.perf_counter()
    mt0.write(path)
    out['write_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mt = hl.read_matrix_table(path)
    _same_calls(mt, nalt, miss, 'read_matrix_table')
    out['read_s'] = time.perf_counter() - t0
    log(f'native format: write of {REL_VARIANTS} x {n} calls in {REL_PARTS} '
        f'partitions {out["write_s"]:.3f} s, read back (every partition) '
        f'{out["read_s"]:.3f} s; GT equal entry for entry')

    # hwe_normalized_pca: min(m, n) > 2048, the randomized route
    with Spy(pca_mod, '_randomized_svd', keep=True) as spy:
        t0 = time.perf_counter()
        ev, scores_t, _ = hl.hwe_normalized_pca(mt.GT, k=PCA_K)
        scores = _scores(scores_t, n)
        out['hwe_normalized_pca_s'] = time.perf_counter() - t0
    svd_calls = len(spy.spent['_randomized_svd'])
    (A, k), kw, _ = spy.last.pop('_randomized_svd')
    if A.device.type != dev.type or A.dtype != torch.float64:
        raise AssertionError(f'hwe_normalized_pca: its matrix is {A.dtype} on '
                             f'{A.device}')
    svd_ms = timed_ms(lambda: pca_mod._randomized_svd(A, k, **kw), reps=3)
    svd_m, svd_l = A.shape[0], min(k + kw.get('oversample', 10), *A.shape)
    del A
    s_want, Vt_want = np_randomized_svd(hwe_oracle(nalt, miss), PCA_K,
                                        kw['q'], 10, kw['seed'])
    want = Vt_want.T * s_want[None, :]
    ev_err = float(np.abs(np.asarray(ev) / s_want ** 2 - 1).max())
    sign = np.where((scores * want).sum(axis=0) < 0, -1.0, 1.0)
    sc_err = float(np.abs(scores * sign - want).max() / np.abs(want).max())
    if not (ev_err <= 1e-9 and sc_err <= 1e-8):
        raise AssertionError(f'hwe_normalized_pca: eigenvalues rel err '
                             f'{ev_err:.3g}, scores {sc_err:.3g} of the largest')
    out.update(pca_eigval_rel_err=ev_err, pca_scores_rel_err=sc_err,
               pca_sign_flips=int((sign < 0).sum()))
    log(f'hwe_normalized_pca k = {PCA_K} ({REL_VARIANTS} x {n}, randomized, '
        f'q = {kw["q"]}, seed {kw["seed"]}, matrix f64 on {dev.type}): '
        f'{out["hwe_normalized_pca_s"]:.3f} s; eigenvalues within rtol '
        f'{ev_err:.3g}, scores within {sc_err:.3g} of the largest of the '
        f'numpy run with the same Ω ({out["pca_sign_flips"]} columns of '
        f'opposite sign); randomized_svd {svd_ms:.3f} ms')

    with Spy(rel_mod, '_king_kernel', keep=True) as spy:
        t0 = time.perf_counter()
        kmt = hl.king(mt.GT)
        out['king_s'] = time.perf_counter() - t0
    king_calls = spy.count()
    king_args = spy.last.pop('_king_kernel')[0]
    if any(a.device.type != dev.type or a.dtype != torch.float64
           for a in king_args):
        raise AssertionError('king: its indicators are not f64 on the card')
    phi = kmt._stage.partition_fn(kmt._stage.contexts[0]).entries['phi'].values
    out['king_max_abs_err'] = float(np.abs(
        phi[check] - king_oracle(nalt, miss, check)).max())
    if not out['king_max_abs_err'] <= 1e-12:
        raise AssertionError(f'king: max abs err {out["king_max_abs_err"]:.3g}')
    if not (all(phi[i, j] == phi[j, i] == 0.5 for i, j in planted)
            and (np.diag(phi) == 0.5).all()):
        raise AssertionError('king: a planted pair or the diagonal is not 1/2')
    del kmt, phi
    king_ms = timed_ms(lambda: rel_mod._king_kernel(*king_args), reps=3)
    m = king_args[0].shape[0]
    del king_args
    log(f'king: {out["king_s"]:.3f} s; {len(check)} rows of φ within '
        f'{out["king_max_abs_err"]:.3g} of numpy; the {REL_DUPS} planted pairs '
        f'and the diagonal exactly 1/2; _king_kernel {king_ms:.3f} ms')

    with Spy(rel_mod, '_pc_relate_kernel', keep=True) as spy, \
            Spy(pca_mod, 'hwe_normalized_pca', keep=True) as pspy:
        t0 = time.perf_counter()
        rel = hl.pc_relate(mt.GT, min_individual_maf=REL_MAF, k=PCA_K,
                           min_kinship=REL_MIN_KIN, statistics='all')
        pairs = rel.collect()
        out['pc_relate_s'] = time.perf_counter() - t0
    pc_calls = spy.count()
    pc_args, _, pc_out = spy.last.pop('_pc_relate_kernel')
    if any(a.device.type != dev.type for a in pc_args[:3]):
        raise AssertionError('pc_relate: its matrices are not on the card')
    pc_scores = _scores(pspy.last['hwe_normalized_pca'][2][1], n)
    want, mu_gap, kin_gap = pc_relate_oracle(nalt, miss, pc_scores, REL_MAF,
                                             check)
    if not (mu_gap > 1e-9 and kin_gap > 1e-9):
        raise AssertionError(f'pc_relate: a μ lies {mu_gap:.3g} from a bound '
                             f'or a kin {kin_gap:.3g} from the k0 cutoff')
    got = dict(kin=pc_out[0], ibd2=pc_out[1], ibd0=pc_out[2])
    got['ibd1'] = 1 - (got['ibd2'] + got['ibd0'])
    for f in ('kin', 'ibd0', 'ibd1', 'ibd2'):
        out[f'pc_relate_{f}_max_abs_err'] = f64_check(
            got[f][torch.from_numpy(check).to(dev)].cpu().numpy(), want[f],
            f'pc_relate {f}', rtol=1e-9)
    found = [(_sample_index(r.i.s), _sample_index(r.j.s)) for r in pairs]
    if found != planted:
        raise AssertionError(f'pc_relate: pairs {found[:10]}, expected the '
                             f'{REL_DUPS} planted')
    row_of = {int(r): i for i, r in enumerate(check)}
    for r, (i, j) in zip(pairs, planted):
        for f in ('kin', 'ibd0', 'ibd1', 'ibd2'):
            f64_check(np.asarray([r[f]]), want[f][row_of[i], j:j + 1],
                      f'pc_relate pair ({i}, {j}) {f}', rtol=1e-9)
    del got, pc_out
    pc_ms = timed_ms(lambda: rel_mod._pc_relate_kernel(*pc_args), reps=2)
    del pc_args
    log(f'pc_relate (k = {PCA_K}, min_kinship {REL_MIN_KIN}, all statistics): '
        f'{out["pc_relate_s"]:.3f} s; exactly the {REL_DUPS} planted pairs; '
        f'{len(check)} rows of kin, ibd0, ibd1, ibd2 within rtol 1e-9 of '
        f'numpy (nearest μ {mu_gap:.3g} from a bound, kin {kin_gap:.3g} from '
        f'the k0 cutoff); _pc_relate_kernel {pc_ms:.3f} ms')

    t0 = time.perf_counter()
    kept = hl.maximal_independent_set(rel.i, rel.j, keep=True).collect()
    out['maximal_independent_set_s'] = time.perf_counter() - t0
    kept = {_sample_index(r.node.s) for r in kept}
    if len(kept) != REL_DUPS or any(len(kept & {i, j}) != 1 for i, j in planted):
        raise AssertionError(f'maximal_independent_set kept {sorted(kept)}')
    log(f'maximal_independent_set: one sample of each planted pair kept, '
        f'{out["maximal_independent_set_s"]:.3f} s')
    out.update(phase_sorts(hl, mt, nalt, miss))
    del mt, mt0
    tmp.cleanup()

    ops = []
    # operations: the f64 products as the reference takes them (three for
    # KING, six for PC-Relate, each 2 m n^2; for the randomized SVD the
    # 2 + 2q products of the (m, n) matrix with l columns, each 2 m n l, and
    # not its l-wide ones); bytes: the (m, n) f64 inputs (and M's bool)
    # read once, the outputs written once
    rel_src = 'hail_tpu_torch/methods/relatedness.py'
    for name, src, ms, calls, rows, n_ops, n_bytes, replaces in (
            ('_king_kernel', rel_src, king_ms, king_calls, m,
             3 * 2 * m * n * n, 4 * 8 * m * n + 8 * n * n,
             'hail_tpu/methods/relatedness.py:54'),
            ('_pc_relate_kernel', rel_src, pc_ms, pc_calls, m,
             6 * 2 * m * n * n, (8 + 1 + 8) * m * n + 3 * 8 * n * n,
             'hail_tpu/methods/relatedness.py:132-167'),
            ('randomized_svd', 'hail_tpu_torch/ops/decomp.py', svd_ms,
             svd_calls, svd_m, (2 + 2 * kw['q']) * 2 * svd_m * n * svd_l,
             8 * svd_m * n + 8 * PCA_K * (svd_m + n),
             'hail_tpu/ops/decomp.py:62')):
        bnd = bound(n_bytes, n_ops, F64_FLOPS_PER_S, 'f64_mma')
        ops.append(dict(name=name, source=src, replaces=replaces,
                        shape=f'{rows} variants x {n} samples',
                        launches_per_call=calls, ms=ms, **bnd,
                        share_of_bound=bnd['bound_ms'] / ms, yardstick=None,
                        yardstick_ms=None))
    return out, ops


def phase_sorts(hl, mt, nalt, miss):
    """Sorts of tables of REL_PARTS partitions: the rows by descending
    position, and the entries of two samples in key order."""
    t0 = time.perf_counter()
    rows = mt.rows()
    pos = [r.locus.position for r in
           rows.order_by(hl.desc(rows.locus.position)).collect()]
    order_by_s = time.perf_counter() - t0
    if pos != sorted(pos, reverse=True) or len(pos) != nalt.shape[0]:
        raise AssertionError('Table.order_by: rows out of order or missing')
    cols = [0, REL_SAMPLES - 1]
    t0 = time.perf_counter()
    few = mt.filter_cols(hl.literal({f's{c}' for c in cols}).contains(mt.s))
    ents = few.entries().collect()
    entries_s = time.perf_counter() - t0
    want = [(v, c) for v in range(nalt.shape[0]) for c in cols]
    got = [(r.locus.position - 10_000, _sample_index(r.s)) for r in ents]
    if got != want:
        raise AssertionError('MatrixTable.entries(): entries out of order')
    for r, (v, c) in zip(ents, want):
        if (r.GT is None) != miss[v, c] or (
                r.GT is not None and r.GT.n_alt_alleles() != nalt[v, c]):
            raise AssertionError(f'MatrixTable.entries(): GT at ({v}, {c})')
    log(f'sorts over {REL_PARTS} partitions: Table.order_by of {len(pos)} rows '
        f'{order_by_s:.3f} s, entries() of {len(cols)} samples ({len(ents)} '
        f'rows) {entries_s:.3f} s; both in order, GT equal')
    return dict(order_by_s=order_by_s, entries_s=entries_s)


def phase_vcf(hl, mt):
    """hl.export_vcf (block-gzipped) of the IBD MatrixTable's first
    VCF_VARIANTS variants and hl.import_vcf of it, GT only (the route of
    the C++ line parser when `native` builds, else the reference's own
    Python parser: a host route either way). GT held equal."""
    import tempfile
    from hail_tpu_torch import native
    from hail_tpu_torch.genetics.call import calls_n_alt_alleles
    st = mt._stage
    gt = st.partition_fn(st.contexts[0]).entries['GT']
    src = mt.head(VCF_VARIANTS) if VCF_VARIANTS < gt.values.shape[0] else mt
    nalt = calls_n_alt_alleles(np.asarray(gt.values))[:VCF_VARIANTS]
    miss = gt.missing_mask()[:VCF_VARIANTS]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        hl.export_vcf(src, f'{d}/ibd.vcf.bgz')
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = hl.import_vcf(f'{d}/ibd.vcf.bgz', entry_fields=['GT'])
        _same_calls(back, nalt, miss, 'import_vcf')
        import_s = time.perf_counter() - t0
    route = 'native' if native.get_lib() is not None else 'python'
    log(f'VCF: export_vcf of {nalt.shape[0]} x {nalt.shape[1]} calls '
        f'{export_s:.3f} s, import_vcf (GT, the {route} parser'
        + ('' if route == 'native' else f': {native.build_error()}')
        + f') {import_s:.3f} s; GT equal')
    return dict(export_s=export_s, import_s=import_s, parser=route,
                shape=list(nalt.shape))


def build_qc_mt(hl, rng, n_samples, n_variants, n_parts):
    """The QC MatrixTable: GT, DP and GQ over `n_variants` rows in `n_parts`
    partitions (QC_GT_MISSING of GT missing, QC_FIELD_MISSING of DP and of
    GQ), QC_TRIALLELIC of the rows triallelic, the last eighth of the rows
    on X outside the PARs, where the first half of the samples (males) carry
    homozygous calls. Alleles: [A, G] (a transition) and [A, T] (a
    transversion) in turn, [A, G, T] where triallelic, at frequencies from
    Beta(0.5, 4) (the third allele Beta(0.5, 8)): mostly rare, as in a
    sequenced call set, which also sets the cost of variant_qc's host HWE
    test (its recurrence runs over the minor allele count). Returns (mt, the
    partitions' arrays: j, k (int8, j <= k), GT missing, DP, DP missing, GQ,
    GQ missing, the allele count per row)."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ir.columns import (Batch, LocusColumn, ObjectColumn,
                                           PrimitiveColumn)
    from hail_tpu_torch.matrixtable import MatrixBatch, MatrixStage, MatrixTable
    rg = default_reference()
    x_idx = rg.contigs.index('X')
    R, C = n_variants // n_parts, n_samples
    first_x = n_variants - n_variants // 8
    mbs, parts = [], []
    for p in range(n_parts):
        idx = np.arange(p * R, (p + 1) * R)
        on_x = idx >= first_x
        n_all = np.where(rng.random(R) < QC_TRIALLELIC, 3, 2)
        # allele frequencies skewed to rare, as in a sequenced call set
        af1 = np.clip(rng.beta(0.5, 4.0, R), 0.005, 0.5)
        af2 = np.where(n_all == 3, np.clip(rng.beta(0.5, 8.0, R), 0.005, 0.2),
                       0.0)
        al = []
        for _ in range(2):
            u = rng.random((R, C))
            al.append(np.where(u < af1[:, None], 1,
                               np.where(u < (af1 + af2)[:, None], 2, 0))
                      .astype(np.int8))
        males = np.zeros(C, bool)
        males[:C // 2] = True
        al[1] = np.where(on_x[:, None] & males[None, :], al[0], al[1])
        j, k = np.minimum(*al), np.maximum(*al)
        gt = (2 | (j.astype(np.int32) << 3) | (k.astype(np.int32) << 17))
        gt_m = rng.random((R, C)) < QC_GT_MISSING
        dp = rng.integers(0, 60, (R, C), dtype=np.int32)
        dp_m = rng.random((R, C)) < QC_FIELD_MISSING
        gq = rng.integers(0, 99, (R, C), dtype=np.int32)
        gq_m = rng.random((R, C)) < QC_FIELD_MISSING
        alleles = np.empty(R, dtype=object)
        alleles[:] = [['A', 'G', 'T'] if n == 3 else
                      (['A', 'G'] if i % 2 == 0 else ['A', 'T'])
                      for i, n in zip(idx, n_all)]
        rows = Batch({
            'locus': LocusColumn(ht.tlocus(rg),
                                 np.where(on_x, x_idx, 0).astype(np.int32),
                                 np.where(on_x, 3_000_000, 10_000).astype(np.int32)
                                 + idx.astype(np.int32)),
            'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles),
        }, R)
        mbs.append(MatrixBatch(rows, {
            'GT': PrimitiveColumn(ht.tcall, gt, gt_m),
            'DP': PrimitiveColumn(ht.tint32, dp, dp_m),
            'GQ': PrimitiveColumn(ht.tint32, gq, gq_m)}))
        parts.append(dict(j=j, k=k, gt_m=gt_m, dp=dp, dp_m=dp_m, gq=gq,
                          gq_m=gq_m, n_all=n_all, on_x=on_x,
                          ti1=np.asarray([len(a) == 3 or a[1] == 'G'
                                          for a in alleles])))
    cols = Batch({'s': ObjectColumn(
        ht.tstr, np.asarray([f's{i}' for i in range(C)], object))}, C)
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    mt = MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t,
        ht.tstruct(s=ht.tstr),
        ht.tstruct(GT=ht.tcall, DP=ht.tint32, GQ=ht.tint32), mbs))
    return mt, parts


def _qc_struct(batch, name):
    """The fields of StructColumn `name` of a row or column batch as numpy
    (values, missing) pairs."""
    col = batch.columns[name]
    out = {}
    for f, c in col.fields.items():
        if hasattr(c, 'fields'):
            for g, cc in c.fields.items():
                out[f'{f}.{g}'] = (np.asarray(cc.values), cc.missing_mask())
        else:
            out[f] = (np.asarray(c.values), c.missing_mask())
    return out


def _eq(got, want, what, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    ok = (np.array_equal(got, want) if rtol == 0 else
          np.allclose(got, want, rtol=rtol, atol=0, equal_nan=True))
    if not ok or got.shape != want.shape:
        raise AssertionError(f'{what}: differs from the numpy oracle')


def variant_qc_oracle(q, part):
    """variant_qc's counters of one partition against numpy on its arrays."""
    j, k, called = part['j'], part['k'], ~part['gt_m']
    n_called = called.sum(axis=1)
    _eq(q['n_called'][0], n_called, 'variant_qc n_called')
    _eq(q['AN'][0], 2 * n_called, 'variant_qc AN')
    _eq(q['n_het'][0], (called & (j != k)).sum(axis=1), 'variant_qc n_het')
    _eq(q['n_non_ref'][0], (called & (k > 0)).sum(axis=1),
        'variant_qc n_non_ref')
    _eq(q['call_rate'][0], n_called / j.shape[1], 'variant_qc call_rate')
    ac = np.stack([(called & (j == a)).sum(axis=1) + (called & (k == a)).sum(axis=1)
                   for a in range(3)], axis=1)
    hom = np.stack([(called & (j == a) & (k == a)).sum(axis=1)
                    for a in range(3)], axis=1)
    tri = part['n_all'] == 3
    for name, want in (('AC', ac), ('homozygote_count', hom)):
        got = q[name][0]
        _eq(got[:, :2], want[:, :2], f'variant_qc {name}')
        if tri.any():
            _eq(got[tri, 2], want[tri, 2], f'variant_qc {name} (third allele)')
    for f in ('dp', 'gq'):
        v, ok = part[f].astype(np.float64), ~part[f'{f}_m']
        n = ok.sum(axis=1)
        mean = np.where(ok, v, 0).sum(axis=1) / n
        _eq(q[f'{f}_stats.mean'][0], mean, f'variant_qc {f}_stats.mean')
        _eq(q[f'{f}_stats.min'][0], np.where(ok, v, np.inf).min(axis=1),
            f'variant_qc {f}_stats.min')
        _eq(q[f'{f}_stats.max'][0], np.where(ok, v, -np.inf).max(axis=1),
            f'variant_qc {f}_stats.max')
        var = np.where(ok, v * v, 0).sum(axis=1) / n - mean * mean
        _eq(q[f'{f}_stats.stdev'][0], np.sqrt(np.maximum(var, 0)),
            f'variant_qc {f}_stats.stdev', rtol=1e-12)


def sample_qc_oracle(sq, parts):
    """sample_qc's counters against numpy over every partition."""
    tot = {}

    def add(key, v):
        tot[key] = tot.get(key, 0) + v

    for part in parts:
        j, k, called = part['j'], part['k'], ~part['gt_m']
        add('n_called', called.sum(axis=0))
        add('n_hom_ref', (called & (k == 0)).sum(axis=0))
        add('n_het', (called & (j != k)).sum(axis=0))
        add('n_hom_var', (called & (j == k) & (j > 0)).sum(axis=0))
        ti1 = part['ti1'][:, None]
        add('n_transition', (called & ti1 & (j == 1)).sum(axis=0)
            + (called & ti1 & (k == 1)).sum(axis=0))
        add('n_snp', (called & (j > 0)).sum(axis=0)
            + (called & (k > 0)).sum(axis=0))
        for f in ('dp', 'gq'):
            v, ok = part[f].astype(np.float64), ~part[f'{f}_m']
            add(f'{f}_sum', np.where(ok, v, 0).sum(axis=0))
            add(f'{f}_n', ok.sum(axis=0))
            tot[f'{f}_min'] = np.minimum(tot.get(f'{f}_min', np.inf),
                                         np.where(ok, v, np.inf).min(axis=0))
    for key in ('n_called', 'n_hom_ref', 'n_het', 'n_hom_var', 'n_transition',
                'n_snp'):
        _eq(sq[key][0], tot[key], f'sample_qc {key}')
    _eq(sq['n_transversion'][0], tot['n_snp'] - tot['n_transition'],
        'sample_qc n_transversion')
    for f in ('dp', 'gq'):
        _eq(sq[f'{f}_stats.mean'][0], tot[f'{f}_sum'] / tot[f'{f}_n'],
            f'sample_qc {f}_stats.mean')
        _eq(sq[f'{f}_stats.min'][0], tot[f'{f}_min'], f'sample_qc {f}_stats.min')


def impute_sex_oracle(parts, n_samples):
    """f_stat per sample from the X rows: AF of allele 1 over the called
    calls, rows with AF > 0, expected homs Σ 1 - 2 AF (1 - AF), observed
    the called non-het calls."""
    n = np.zeros(n_samples)
    exp = np.zeros(n_samples)
    obs = np.zeros(n_samples)
    for part in parts:
        x = part['on_x']
        if not x.any():
            continue
        j, k, called = part['j'][x], part['k'][x], ~part['gt_m'][x]
        an = 2 * called.sum(axis=1)
        af = ((called & (j == 1)).sum(axis=1)
              + (called & (k == 1)).sum(axis=1)) / np.maximum(an, 1)
        use = called & ((an > 0) & (af > 0))[:, None]
        n += use.sum(axis=0)
        exp += np.where(use, (1 - 2 * af * (1 - af))[:, None], 0).sum(axis=0)
        obs += (use & (j == k)).sum(axis=0)
    return n, exp, (obs - exp) / (n - exp)


def hts_mt(hl, rng, n_samples, n_variants):
    """An HTS MatrixTable in 2 partitions: diploid GT (QC_GT_MISSING
    missing), AD, DP, GQ and PL, HTS_TRIALLELIC of the rows triallelic
    ([A, G, T]; else [A, G]). Returns (mt, the partitions' arrays)."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ir.columns import (Batch, DenseArrayColumn,
                                           LocusColumn, ObjectColumn,
                                           PrimitiveColumn)
    from hail_tpu_torch.matrixtable import MatrixBatch, MatrixStage, MatrixTable
    rg = default_reference()
    R, C = n_variants // 2, n_samples
    mbs, parts = [], []
    for p in range(2):
        A = np.where(rng.random(R) < HTS_TRIALLELIC, 3, 2)
        al = rng.integers(0, 3, (2, R, C)) % A[None, :, None]
        j, k = np.minimum(*al), np.maximum(*al)
        gt = (2 | (j << 3) | (k << 17)).astype(np.int32)
        gt_m = rng.random((R, C)) < QC_GT_MISSING
        ad = rng.integers(0, 40, (R, C, 3), dtype=np.int32)
        ad[A == 2, :, 2] = 0
        pl = rng.integers(0, 300, (R, C, 6), dtype=np.int32)
        pl[A == 2, :, 3:] = 0
        dp = ad.sum(axis=2, dtype=np.int32)
        gq = rng.integers(0, 99, (R, C), dtype=np.int32)
        alleles = np.empty(R, dtype=object)
        alleles[:] = [['A', 'G', 'T'] if a == 3 else ['A', 'G'] for a in A]
        rows = Batch({
            'locus': LocusColumn(ht.tlocus(rg), np.zeros(R, np.int32),
                                 np.arange(p * R, (p + 1) * R, dtype=np.int32)
                                 + 10_000),
            'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles)}, R)
        lens = np.broadcast_to(A[:, None], (R, C))
        mbs.append(MatrixBatch(rows, {
            'GT': PrimitiveColumn(ht.tcall, gt, gt_m),
            'AD': DenseArrayColumn(ht.tarray(ht.tint32), ad, lens.copy()),
            'DP': PrimitiveColumn(ht.tint32, dp),
            'GQ': PrimitiveColumn(ht.tint32, gq),
            'PL': DenseArrayColumn(ht.tarray(ht.tint32), pl,
                                   (lens * (lens + 1) // 2).copy())}))
        parts.append(dict(A=A, j=j, k=k, gt_m=gt_m, ad=ad, pl=pl, gq=gq))
    cols = Batch({'s': ObjectColumn(
        ht.tstr, np.asarray([f's{i}' for i in range(C)], object))}, C)
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    ent_t = ht.tstruct(GT=ht.tcall, AD=ht.tarray(ht.tint32), DP=ht.tint32,
                       GQ=ht.tint32, PL=ht.tarray(ht.tint32))
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), cols, ['locus', 'alleles'], ['s'], row_t,
        ht.tstruct(s=ht.tstr), ent_t, mbs)), parts


def split_hts_oracle(mb, part):
    """split_multi_hts of one partition against numpy: each row r and alt a
    (in order) gives GT downcoded to [j == a] + [k == a], AD [ΣAD - AD[a],
    AD[a]], PL[d] the least PL over genotypes (x, y) with [x == a] + [y ==
    a] = d, GQ from that PL (the two least, each capped at 99), and PL and
    GQ missing where GT is."""
    src = [(r, a) for r, n in enumerate(part['A']) for a in range(1, n)]
    rr = np.asarray([r for r, _ in src])
    aa = np.asarray([a for _, a in src])[:, None]
    if mb.n_rows != len(src):
        raise AssertionError(f'split_multi_hts: {mb.n_rows} rows, expected '
                             f'{len(src)}')
    j, k, gt_m = part['j'][rr], part['k'][rr], part['gt_m'][rr]
    nalt = (j == aa).astype(np.int64) + (k == aa)
    gt = np.asarray(mb.entries['GT'].values)
    from hail_tpu_torch.genetics.call import calls_n_alt_alleles
    _eq(calls_n_alt_alleles(gt)[~gt_m], nalt[~gt_m], 'split_multi_hts GT')
    _eq(mb.entries['GT'].missing_mask(), gt_m, 'split_multi_hts GT missing')
    ad = part['ad'][rr]
    sel = np.take_along_axis(ad, np.broadcast_to(aa[:, :, None], ad.shape[:2] + (1,)),
                             axis=2)[..., 0]
    _eq(mb.entries['AD'].values[..., :2],
        np.stack([ad.sum(axis=2) - sel, sel], axis=2), 'split_multi_hts AD')
    pl = part['pl'][rr].astype(np.int64)
    gts = [(x, y) for y in range(3) for x in range(y + 1)]   # PL order
    A = part['A'][rr][:, None]
    new = np.full(pl.shape[:2] + (3,), np.iinfo(np.int64).max)
    for gi, (x, y) in enumerate(gts):
        d = (x == aa).astype(np.int64) + (y == aa)           # (rows, 1)
        valid = (y < A)                                      # in this row
        for dd in range(3):
            hit = (d == dd) & valid
            new[..., dd] = np.where(hit, np.minimum(new[..., dd], pl[..., gi]),
                                    new[..., dd])
    got_pl = mb.entries['PL'].values[..., :3]
    _eq(got_pl[~gt_m], new[~gt_m], 'split_multi_hts PL')
    _eq(mb.entries['PL'].missing_mask(), gt_m, 'split_multi_hts PL missing')
    srt = np.sort(new, axis=2)
    gq = np.minimum(srt[..., 1], 99) - np.minimum(srt[..., 0], 99)
    got_gq = np.asarray(mb.entries['GQ'].values)
    _eq(got_gq[~gt_m], gq[~gt_m], 'split_multi_hts GQ')
    _eq(got_gq[gt_m], part['gq'][rr][gt_m], 'split_multi_hts GQ (old)')


def k5_wide_arrays(rng, R, C):
    """K5's inputs at R x C with the QC MatrixTable's frequencies: packed
    diploid calls of alleles from Beta(0.5, 4) (the third, on
    QC_TRIALLELIC of the rows, from Beta(0.5, 8)), QC_GT_MISSING of the
    calls missing, DP in [0, 60) and GQ in [0, 99) with QC_FIELD_MISSING
    of each -1."""
    af1 = np.clip(rng.beta(0.5, 4.0, R), 0.005, 0.5)[:, None]
    af2 = np.where(rng.random(R) < QC_TRIALLELIC,
                   np.clip(rng.beta(0.5, 8.0, R), 0.005, 0.2), 0.0)[:, None]
    al = []
    for _ in range(2):
        u = rng.random((R, C), dtype=np.float32)
        al.append(np.where(u < af1, 1, np.where(u < af1 + af2, 2, 0))
                  .astype(np.int32))
    packed = 2 | (np.minimum(*al) << 3) | (np.maximum(*al) << 17)
    missing = rng.random((R, C), dtype=np.float32) < QC_GT_MISSING
    dp = np.where(rng.random((R, C), dtype=np.float32) < QC_FIELD_MISSING,
                  -1, rng.integers(0, 60, (R, C), dtype=np.int32))
    gq = np.where(rng.random((R, C), dtype=np.float32) < QC_FIELD_MISSING,
                  -1, rng.integers(0, 99, (R, C), dtype=np.int32))
    return packed, missing, dp.astype(np.int32), gq.astype(np.int32)


def k5_at(qc, args):
    """K5 at the shape of `args` (variant_qc_block's, DP and GQ given):
    bit-equal to its plain version; its time beside the plain version's and
    beside a read-only stream of the same four inputs (torch f32 sums over
    their bytes: another function, a yardstick of the card's read rate, not
    a library time; a mask of R * C bytes a multiple of 4); its bound.
    Returns (the shape's figures, the largest error on finite values)."""
    got = qc.variant_qc_block(*args)
    want = qc._variant_qc_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for key, w in want.items():
        g = got[key].to(w.dtype)
        if not torch.equal(g, w):
            raise AssertionError(f'K5 variant_qc: {key} differs from plain')
        fin = torch.isfinite(w) if w.is_floating_point() else None
        d = (g - w) if fin is None else (g - w)[fin]
        err = max(err, float(d.abs().max()) if d.numel() else 0.0)
    ms, plain_ms = compare_times(lambda: qc.variant_qc_block(*args),
                                 lambda: qc._variant_qc_ref(*args))
    # the four inputs' bytes read as f32 (torch's integer and bool sums
    # widen to int64 and read far below the card's rate)
    words = [t.reshape(-1).view(torch.uint8).view(torch.float32)
             for t in args[:4]]
    stream_ms = timed_ms(lambda: [w.sum() for w in words])
    R, C = args[0].shape
    # bytes: packed (4), missing (1), DP and GQ (4 + 4) per entry read once;
    # per row 8 int32 counts, 8 f64 statistics and 2 x 3 int32 allele counts
    # written once; its work per entry (integer compares and adds, and six
    # f64 adds and products for DP and GQ: 0.004 ms at 2,048 x 10,000 even
    # at half the 67 TFLOP/s) is far below the bytes, counted as none
    n_bytes = 13 * R * C + R * (8 * 4 + 8 * 8 + 2 * 3 * 4)
    bnd = bound(n_bytes)
    shape = dict(shape=f'{R} x {C}', ms=ms, plain_ms=plain_ms,
                 stream_ms=stream_ms, **bnd,
                 share_of_bound=bnd['bound_ms'] / ms)
    log(f'K5 variant_qc {R} x {C}, A = 3, DP and GQ: bit-equal to plain; '
        f'kernel {ms:.4f} ms ({n_bytes / ms / 1e9:.3f} TB/s, '
        f'{shape["share_of_bound"]:.3f} of its {bnd["bound_ms"]:.4f} ms '
        f'bound), plain {plain_ms:.4f} ms, a read-only stream of the same '
        f'inputs {stream_ms:.4f} ms')
    return shape, err


def phase_qc(hl, dev, rng):
    """QC on the QC MatrixTable (QC_SAMPLES x QC_VARIANTS in QC_PARTS
    partitions): K5 against its plain version at one partition's shape,
    then sample_qc, variant_qc (K5 once per partition), impute_sex and an
    aggregate_entries on the device tier and on the host evaluator, each
    timed and held to numpy; split_multi_hts on an HTS MatrixTable of
    HTS_VARIANTS rows. K5 is timed at K5_WIDE too, on data of its own
    generator, so `rng` draws what it drew before that shape. Returns
    (the phase's figures, the K5 record, its launches on the variant_qc
    path, the entry_agg device-op record)."""
    import os
    from hail_tpu_torch.ops import _kernels, entry_agg as ea, qc
    from hail_tpu_torch.stats import hwe
    out = {}
    t0 = time.perf_counter()
    mt, parts = build_qc_mt(hl, rng, QC_SAMPLES, QC_VARIANTS, QC_PARTS)
    log(f'QC MatrixTable {QC_VARIANTS} x {QC_SAMPLES} in {QC_PARTS} partitions '
        f'built in {time.perf_counter() - t0:.2f} s')

    # K5 at one partition (2,048 x 10,000) and at few, wide rows (256 x
    # 100,000), A = 3, DP and GQ
    p0 = parts[0]
    packed = (2 | (p0['j'].astype(np.int32) << 3)
              | (p0['k'].astype(np.int32) << 17))
    shapes, err5 = [], 0.0
    for arrays in ((packed, p0['gt_m'], np.where(p0['dp_m'], -1, p0['dp']),
                    np.where(p0['gq_m'], -1, p0['gq'])),
                   k5_wide_arrays(np.random.default_rng(SEED + 8),
                                  *K5_WIDE)):
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays) + (3, True, True)
        shape, err = k5_at(qc, args)
        shapes.append(shape)
        err5 = max(err5, err)
        del args
    main = shapes[0]
    rec = record('variant_qc', 'hail_tpu_torch/csrc/variant_qc.cu',
                 'hail_tpu/ops/qc.py:22', err5, main['ms'], main['plain_ms'],
                 {k: main[k] for k in ('bound_ms', 'bound_by', 'bound_unit')},
                 stream_ms=main['stream_ms'], shapes=shapes)

    t0 = time.perf_counter()
    sq = hl.sample_qc(mt)
    out['sample_qc_s'] = time.perf_counter() - t0
    sample_qc_oracle(_qc_struct(sq._stage.cols, 'sample_qc'), parts)
    log(f'sample_qc: {out["sample_qc_s"]:.3f} s; n_called, hom/het counts, '
        f'transitions, transversions, DP and GQ mean and min of all '
        f'{QC_SAMPLES} samples equal numpy')

    # the main path of K5: one launch per partition; beside the call, the
    # seconds of its device part (copies in and out, K5) and of the host HWE
    # test, summed over the partitions' threads
    _kernels.reset_launch_counts()
    with Spy(qc, 'run_variant_qc_block') as dev_spy, \
            Spy(hwe, 'hwe_test_vec') as hwe_spy:
        t0 = time.perf_counter()
        vq = hl.variant_qc(mt)
        summary = vq.aggregate_rows(hl.struct(
            an=hl.agg.sum(vq.variant_qc.AN),
            low=hl.agg.count_where(vq.variant_qc.call_rate < 0.97)))
        out['variant_qc_s'] = time.perf_counter() - t0
    n_qc = dict(_kernels.launches)
    out['variant_qc_device_part_s'] = dev_spy.total()
    out['variant_qc_hwe_s'] = hwe_spy.total()
    if n_qc['hail_variant_qc'] != QC_PARTS:
        raise AssertionError(f'variant_qc launched K5 {n_qc["hail_variant_qc"]} '
                             f'times over {QC_PARTS} partitions')
    an = 0
    for ctx, part in zip(vq._stage.contexts, parts):
        q = _qc_struct(vq._stage.partition_fn(ctx).rows, 'variant_qc')
        variant_qc_oracle(q, part)
        an += int(q['AN'][0].sum())
    if summary.an != an:
        raise AssertionError('variant_qc: the sum of AN differs')
    log(f'variant_qc: {out["variant_qc_s"]:.3f} s (with an aggregate_rows over '
        f'its result; {n_qc["hail_variant_qc"]} K5 launches; summed over the '
        f'partitions\' threads: run_variant_qc_block '
        f'{out["variant_qc_device_part_s"]:.3f} s, hwe_test_vec '
        f'{out["variant_qc_hwe_s"]:.3f} s); AC, AN, '
        f'homozygote counts, n_called, n_het, n_non_ref, call_rate, DP and GQ '
        f'stats of all {QC_VARIANTS} rows equal numpy')

    t0 = time.perf_counter()
    sex = hl.impute_sex(mt.GT)
    f_stat = {_sample_index(r.s): r for r in sex.collect()}
    out['impute_sex_s'] = time.perf_counter() - t0
    n_x, exp_x, f_want = impute_sex_oracle(parts, QC_SAMPLES)
    got_f = np.asarray([f_stat[i].f_stat for i in range(QC_SAMPLES)], float)
    _eq([f_stat[i].n_called for i in range(QC_SAMPLES)], n_x,
        'impute_sex n_called')
    _eq(got_f, f_want, 'impute_sex f_stat', rtol=1e-9)
    males = sum(f_stat[i].is_female is False for i in range(QC_SAMPLES // 2))
    females = sum(f_stat[i].is_female is True
                  for i in range(QC_SAMPLES // 2, QC_SAMPLES))
    out.update(impute_sex_males=males, impute_sex_females=females)
    log(f'impute_sex: {out["impute_sex_s"]:.3f} s; f_stat and n_called of all '
        f'{QC_SAMPLES} samples equal numpy (rtol 1e-9); {males} of '
        f'{QC_SAMPLES // 2} planted males and {females} of the others called '
        f'female')

    expr = hl.struct(
        n=hl.agg.count(), nalt=hl.agg.stats(mt.GT.n_alt_alleles()),
        deep=hl.agg.count_where(mt.DP > 10),
        gq_missing=hl.agg.fraction(hl.is_missing(mt.GQ)),
        gq_min=hl.agg.min(mt.GQ), dp_max=hl.agg.max(mt.DP))
    # each tier twice: the first call of the device tier in a process
    # also pays torch's first use of each op
    with Spy(ea, 'run_device_entry_agg', keep=True) as spy:
        for key in ('aggregate_entries_device_s', 'aggregate_entries_device_warm_s'):
            t0 = time.perf_counter()
            dev_res = mt.aggregate_entries(expr)
            out[key] = time.perf_counter() - t0
    if spy.count() != 2 * QC_PARTS:
        raise AssertionError(f'aggregate_entries: the device tier ran in '
                             f'{spy.count()} of 2 x {QC_PARTS} partitions')
    os.environ['HAIL_TPU_NO_DEVICE_AGG'] = '1'
    try:
        for key in ('aggregate_entries_host_s', 'aggregate_entries_host_warm_s'):
            t0 = time.perf_counter()
            host_res = mt.aggregate_entries(expr)
            out[key] = time.perf_counter() - t0
    finally:
        del os.environ['HAIL_TPU_NO_DEVICE_AGG']
    called = np.concatenate([~p['gt_m'] for p in parts])
    nalt = np.concatenate([p['j'] > 0 for p in parts]).astype(np.int64) \
        + np.concatenate([p['k'] > 0 for p in parts])
    nv = nalt[called].astype(np.float64)
    want = dict(
        n=called.size, nalt_n=nv.size, nalt_sum=nv.sum(),
        nalt_mean=nv.sum() / nv.size, nalt_min=nv.min(), nalt_max=nv.max(),
        deep=sum(int(((p['dp'] > 10) & ~p['dp_m']).sum()) for p in parts),
        gq_missing=sum(int(p['gq_m'].sum()) for p in parts) / called.size,
        gq_min=min(int(p['gq'][~p['gq_m']].min()) for p in parts),
        dp_max=max(int(p['dp'][~p['dp_m']].max()) for p in parts))
    for tier, res in (('device', dev_res), ('host', host_res)):
        got = dict(n=res.n, nalt_n=res.nalt.n, nalt_sum=res.nalt.sum,
                   nalt_mean=res.nalt.mean, nalt_min=res.nalt.min,
                   nalt_max=res.nalt.max, deep=res.deep,
                   gq_missing=res.gq_missing, gq_min=res.gq_min,
                   dp_max=res.dp_max)
        if got != want:
            raise AssertionError(f'aggregate_entries ({tier}): {got} != {want}')
    if not math.isclose(dev_res.nalt.stdev, host_res.nalt.stdev, rel_tol=1e-12):
        raise AssertionError('aggregate_entries: the two tiers\' stdev differ')
    log(f'aggregate_entries (count, stats of n_alt_alleles, count_where DP > '
        f'10, fraction of GQ missing, min GQ, max DP): device tier '
        f'{out["aggregate_entries_device_s"]:.3f} s, again '
        f'{out["aggregate_entries_device_warm_s"]:.3f} s (in every partition), '
        f'host evaluator {out["aggregate_entries_host_s"]:.3f} s, again '
        f'{out["aggregate_entries_host_warm_s"]:.3f} s; both equal numpy')
    # the reduction alone, on the tensors of the last partition it ran on
    a_mt, a_mb, _, leaves, plans, kernel = spy.last['run_device_entry_agg'][0]
    env, filt = ea.partition_tensors(a_mt, a_mb, leaves, dev)
    agg_ms = timed_ms(lambda: kernel(env, filt))
    # bytes: the six leaves (GT, DP, GQ values and masks: 4 + 1 + 4 + 1 + 4
    # + 1) and the filtered-entry mask (1) read once per entry
    Ra, Ca = filt.shape
    bnd = bound(16 * Ra * Ca)
    op = dict(name='entry_agg.make_kernel', source='hail_tpu_torch/ops/entry_agg.py',
              replaces='hail_tpu/ops/entry_agg.py:241',
              shape=f'{Ra} variants x {Ca} samples, 6 aggregators',
              launches_per_call=QC_PARTS, ms=agg_ms, **bnd,
              share_of_bound=bnd['bound_ms'] / agg_ms, yardstick=None,
              yardstick_ms=None)
    log(f'entry_agg reduction on one partition: {agg_ms:.3f} ms, bound '
        f'{bnd["bound_ms"]:.4f} ms')
    del env, filt, a_mt, a_mb, spy, mt, sq, vq, parts

    hmt, hparts = hts_mt(hl, rng, QC_SAMPLES, HTS_VARIANTS)
    t0 = time.perf_counter()
    split = hl.split_multi_hts(hmt)
    mbs = [split._stage.partition_fn(c) for c in split._stage.contexts]
    out['split_multi_hts_s'] = time.perf_counter() - t0
    n_out = sum(mb.n_rows for mb in mbs)
    for mb, part in zip(mbs, hparts):
        split_hts_oracle(mb, part)
    log(f'split_multi_hts of {HTS_VARIANTS} x {QC_SAMPLES} (GT, AD, DP, GQ, PL; '
        f'{n_out - HTS_VARIANTS} triallelic): {out["split_multi_hts_s"]:.3f} s '
        f'for its {n_out} rows; GT, AD, PL and GQ equal numpy')
    return out, rec, n_qc, op


def mean_imputed(nalt, miss):
    """n_alt as f64 with each missing call set to its row's mean over the
    called samples, as the methods impute it (statgen's LMM, SKAT and
    ld_score)."""
    G = nalt.astype(np.float64)
    cnt = (~miss).sum(axis=1)
    mean = np.where(cnt > 0, np.where(miss, 0, G).sum(axis=1)
                    / np.maximum(cnt, 1), 0.0)
    return np.where(miss, mean[:, None], G)


def standardized(G):
    """Rows centred and scaled to unit variance (0 where constant)."""
    c = G - G.mean(axis=1, keepdims=True)
    sd = c.std(axis=1, keepdims=True)
    return np.where(sd > 0, c / np.where(sd > 0, sd, 1), 0.0)


def split_parts(nalt, miss, n_parts, contigs=None, pos=None, **row_fields):
    """calls_mt's partition dicts for (m, n) calls in n_parts equal blocks;
    by default all on contig 0 at positions 10,000 + row."""
    m = nalt.shape[0]
    block = m // n_parts
    contigs = np.zeros(m, np.int32) if contigs is None else contigs
    pos = np.arange(m, dtype=np.int32) + 10_000 if pos is None else pos
    parts = []
    for p in range(n_parts):
        sl = slice(p * block, (p + 1) * block)
        parts.append(dict(nalt=nalt[sl], miss=miss[sl], contig=int(contigs[sl][0]),
                          pos=pos[sl], **{k: v[sl] for k, v in row_fields.items()}))
    return parts


def _row_arrays(table, fields):
    b = table._stage.collect_single()
    return {f: np.asarray(b.columns[f].values, np.float64) for f in fields}


def lmm_loop_check(model, pa, res, what):
    """The batched test's first LMM_CHECK_ROWS variants against the scalar
    loop `fit_alternatives_numpy` (rank-one update against one solve per
    variant) at rtol 1e-8. chi² is twice the difference of two
    log-likelihoods of size |ll0|, each summed from terms of that size: its
    roundoff floor is a few eps·|ll0|, so chi² gets an atol of
    1e-13·|ll0| beside the rtol (a variant with chi² near 0 would
    otherwise ask for more digits than the difference has)."""
    loop = model.fit_alternatives_numpy(pa[:, :LMM_CHECK_ROWS])
    ll0 = abs(model._neg_reml(-model.log_gamma)[0])
    worst = 0.0
    for f, atol in (('beta', 0.0), ('sigma_sq', 0.0), ('chi_sq', 1e-13 * ll0)):
        got, want = res[f][:LMM_CHECK_ROWS], loop[f]
        err = np.abs(got - want)
        bad = ~(err <= 1e-8 * np.abs(want) + atol)
        if bad.any():
            raise AssertionError(f'LMM {what}: {f} of {int(bad.sum())} of '
                                 f'{LMM_CHECK_ROWS} variants differs from the '
                                 f'scalar loop (max abs err {err.max():.3g})')
        worst = max(worst, float(np.max(err / np.maximum(np.abs(want), 1e-300))))
    return worst


def lmm_checks(model, res, pa, what):
    """Finite fit in (0, 1), the loop check, the planted variant; returns
    the figures to print."""
    if not (model.fitted and 0 <= model.h_sq <= 1):
        raise AssertionError(f'LMM {what}: h_sq {model.h_sq}')
    rel = lmm_loop_check(model, pa, res, what)
    p = res['p_value'][LMM_CAUSAL]
    if not p < 1e-8:
        raise AssertionError(f'LMM {what}: the planted variant has p {p}')
    n_nan = int(np.isnan(res['p_value']).sum())
    finite = res['p_value'][~np.isnan(res['p_value'])]
    if not ((finite >= 0) & (finite <= 1)).all():
        raise AssertionError(f'LMM {what}: a p-value outside [0, 1]')
    return dict(h_sq=model.h_sq, causal_p=float(p), nan_rows=n_nan,
                loop_max_rel_err=rel)


def phase_lmm(hl, rng):
    """The linear mixed model on LMM_SAMPLES x LMM_VARIANTS in LMM_PARTS
    partitions: a phenotype half polygenic over every variant plus one
    planted variant (LMM_CAUSAL) and a covariate. Full rank: the GRM
    (ExactGrm on the card), `linear_mixed_model(k=...)` (host eigh), `fit`
    (host REML), `linear_mixed_regression_rows` (host rotation, ops/lmm on
    the device); low rank: `z_t` over the first LMM_LOW_RANK variants (host
    SVD), its fit and regression rows. Returns (figures, ops/lmm's device
    args)."""
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.ops import lmm
    from hail_tpu_torch.stats import linear_mixed_model as lmm_mod
    n, m = LMM_SAMPLES, LMM_VARIANTS
    nalt = rng.integers(0, 3, (m, n)).astype(np.int32)
    miss = rng.random((m, n)) < MISSING
    G = mean_imputed(nalt, miss)
    Zs = standardized(G)
    g = Zs.T @ rng.normal(size=m)
    c0 = rng.normal(size=n)
    y = (g * math.sqrt(0.5) / g.std() + 0.3 * Zs[LMM_CAUSAL] + 0.3 * c0
         + rng.normal(size=n) * math.sqrt(0.5))
    del Zs, g
    mt = calls_mt(split_parts(nalt, miss, LMM_PARTS), n, {'y': y, 'c0': c0})
    low = calls_mt(split_parts(nalt[:LMM_LOW_RANK], miss[:LMM_LOW_RANK], 1),
                   n, {})
    out = {}

    t0 = time.perf_counter()
    K = hl.genetic_relatedness_matrix(mt.GT).to_numpy()
    out['grm_s'] = time.perf_counter() - t0
    # ExactGrm's strips sum in their own orders: K is symmetric to roundoff
    if K.shape != (n, n) or not np.abs(K - K.T).max() <= 1e-12:
        raise AssertionError('LMM: the GRM is not a symmetric n x n matrix')
    with Spy(np.linalg, 'eigh') as eig:
        t0 = time.perf_counter()
        model, _ = hl.linear_mixed_model(mt.y, [1.0, mt.c0], k=K)
        out['model_s'] = time.perf_counter() - t0
    out['eigh_s'] = eig.total()
    del K
    t0 = time.perf_counter()
    model.fit()
    out['fit_s'] = time.perf_counter() - t0
    fields = ('beta', 'sigma_sq', 'chi_sq', 'p_value')
    with Spy(statgen, '_entry_expr_to_blocks') as ent, \
            Spy(lmm_mod, '_device_contractions') as dev_part, \
            Spy(lmm, 'contractions', keep=True) as op:
        t0 = time.perf_counter()
        res = _row_arrays(hl.linear_mixed_regression_rows(
            mt.GT.n_alt_alleles(), model), fields)
        out['regression_s'] = time.perf_counter() - t0
    if op.count() != 1:
        raise AssertionError(f'LMM: ops/lmm ran {op.count()} times')
    op_args = op.last['contractions'][0]
    out['entry_s'] = ent.total()
    out['ops_lmm_s'] = dev_part.total()
    # the rotation the call made, made again here on the same arrays
    t0 = time.perf_counter()
    pa = model._u.T @ G.T
    out['rotation_s'] = time.perf_counter() - t0
    out['rest_s'] = (out['regression_s'] - out['entry_s'] - out['rotation_s']
                     - out['ops_lmm_s'])
    out['full_rank'] = lmm_checks(model, res, pa, 'full rank')
    del pa
    log(f'LMM full rank, {n} samples x {m} variants: GRM {out["grm_s"]:.3f} s, '
        f'linear_mixed_model {out["model_s"]:.3f} s (host eigh '
        f'{out["eigh_s"]:.3f} s), REML fit {out["fit_s"]:.3f} s (h_sq '
        f'{model.h_sq:.4f}), linear_mixed_regression_rows '
        f'{out["regression_s"]:.3f} s: entry evaluation {out["entry_s"]:.3f} '
        f's, host rotation {out["rotation_s"]:.3f} s (timed again by this '
        f'script), ops/lmm with its copies {out["ops_lmm_s"]:.3f} s, the rest '
        f'{out["rest_s"]:.3f} s; {LMM_CHECK_ROWS} variants equal the scalar '
        f'loop (max rel err {out["full_rank"]["loop_max_rel_err"]:.3g}), the '
        f'planted variant p {out["full_rank"]["causal_p"]:.3g}, '
        f'{out["full_rank"]["nan_rows"]} NaN rows')

    with Spy(np.linalg, 'svd') as svd:
        t0 = time.perf_counter()
        model, Z = hl.linear_mixed_model(mt.y, [1.0, mt.c0],
                                         z_t=low.GT.n_alt_alleles())
        out['low_rank_model_s'] = time.perf_counter() - t0
    out['low_rank_svd_s'] = svd.total()
    if Z.shape != (n, LMM_LOW_RANK):
        raise AssertionError(f'LMM low rank: Z is {Z.shape}')
    t0 = time.perf_counter()
    model.fit()
    out['low_rank_fit_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = _row_arrays(hl.linear_mixed_regression_rows(
        mt.GT.n_alt_alleles(), model), fields)
    out['low_rank_regression_s'] = time.perf_counter() - t0
    out['low_rank'] = lmm_checks(model, res,
                                 model._u.T @ G[:LMM_CHECK_ROWS].T, 'low rank')
    log(f'LMM low rank, z_t over {LMM_LOW_RANK} variants: linear_mixed_model '
        f'{out["low_rank_model_s"]:.3f} s (host SVD {out["low_rank_svd_s"]:.3f} '
        f's), fit {out["low_rank_fit_s"]:.3f} s (h_sq {model.h_sq:.4f}), '
        f'regression rows {out["low_rank_regression_s"]:.3f} s; '
        f'{LMM_CHECK_ROWS} variants equal the scalar loop (max rel err '
        f'{out["low_rank"]["loop_max_rel_err"]:.3g}), the planted variant p '
        f'{out["low_rank"]["causal_p"]:.3g}, {out["low_rank"]["nan_rows"]} '
        f'NaN rows')
    return out, op_args


def logistic_null_mu(X, y, max_iter=25, tol=1e-6):
    """The logistic null fit's μ by Newton's method as Hail defines it: the
    intercept starts at logit(ȳ), and the fit stops at the iterate whose
    step is below `tol`, before taking that step."""
    b = np.zeros(X.shape[1])
    b[0] = math.log(y.mean() / (1 - y.mean()))
    for _ in range(max_iter):
        mu = 1 / (1 + np.exp(-(X @ b)))
        delta = np.linalg.solve(X.T @ (X * (mu * (1 - mu))[:, None]),
                                X.T @ (y - mu))
        if np.max(np.abs(delta)) < tol:
            return mu
        b = b + delta
    raise AssertionError('SKAT: the numpy null fit did not converge')


def skat_rows_check(rows, G, w, resid, scale, what):
    """Every group: size SKAT_GROUP, p in [0, 1], fault 0; the first
    SKAT_CHECK_GROUPS q_stat equal ||Gw·resid||² / scale at rtol 1e-10; the
    planted group p < 1e-6. Returns (max rel err of q, planted p)."""
    by_group = {r.group: r for r in rows}
    if sorted(by_group) != list(range(SKAT_VARIANTS // SKAT_GROUP)):
        raise AssertionError(f'SKAT {what}: groups {len(by_group)}')
    for r in rows:
        if r.size != SKAT_GROUP or r.fault != 0 or not 0 <= r.p_value <= 1:
            raise AssertionError(f'SKAT {what}: group {r.group}: {r}')
    worst = 0.0
    for gi in range(SKAT_CHECK_GROUPS):
        idx = slice(gi * SKAT_GROUP, (gi + 1) * SKAT_GROUP)
        v = (G[idx] * np.sqrt(w[idx])[:, None]) @ resid
        q = float(v @ v) / scale
        err = abs(by_group[gi].q_stat - q) / abs(q)
        if not err <= 1e-10:
            raise AssertionError(f'SKAT {what}: group {gi} q_stat '
                                 f'{by_group[gi].q_stat} vs numpy {q}')
        worst = max(worst, err)
    p = by_group[SKAT_PLANTED].p_value
    if not p < 1e-6:
        raise AssertionError(f'SKAT {what}: the planted group has p {p}')
    return worst, p


def phase_skat(hl, rng):
    """SKAT over SKAT_SAMPLES x SKAT_VARIANTS in SKAT_PARTS partitions, in
    genes of SKAT_GROUP consecutive variants with allele frequencies from
    Beta(0.5, 15) (mostly rare), weights Beta(1, 25) of each variant's
    MAF (SKAT's default), a covariate, and the burden of gene SKAT_PLANTED
    in both phenotypes: `hl._linear_skat` and `hl._logistic_skat`, held to
    numpy."""
    import scipy.stats
    n, m = SKAT_SAMPLES, SKAT_VARIANTS
    af = rng.beta(0.5, 15, m)
    nalt = rng.binomial(2, af[:, None], (m, n)).astype(np.int32)
    miss = rng.random((m, n)) < MISSING
    G = mean_imputed(nalt, miss)
    maf = G.mean(axis=1) / 2
    w = scipy.stats.beta.pdf(np.minimum(maf, 1 - maf), 1, 25)
    gene = (np.arange(m) // SKAT_GROUP).astype(np.int32)
    planted = slice(SKAT_PLANTED * SKAT_GROUP, (SKAT_PLANTED + 1) * SKAT_GROUP)
    burden = nalt[planted].sum(axis=0)
    c0 = rng.normal(size=n)
    y = 0.4 * burden + 0.3 * c0 + rng.normal(size=n)
    yb = (rng.random(n) < 1 / (1 + np.exp(-(-1.0 + 0.8 * burden + 0.3 * c0)))
          ).astype(np.float64)
    mt = calls_mt(split_parts(nalt, miss, SKAT_PARTS, w=w, gene=gene), n,
                  {'y': y, 'yb': yb, 'c0': c0}, row_fields=('w', 'gene'))
    X = np.stack([np.ones(n), c0], axis=1)
    out = {}
    for what, fn, pheno in (('linear', hl._linear_skat, mt.y),
                            ('logistic', hl._logistic_skat, mt.yb)):
        t0 = time.perf_counter()
        rows = fn(mt.gene, mt.w, pheno, mt.GT.n_alt_alleles(),
                  [1.0, mt.c0]).collect()
        out[f'{what}_s'] = time.perf_counter() - t0
        if what == 'linear':
            beta = np.linalg.lstsq(X, y, rcond=None)[0]
            resid = y - X @ beta
            scale = 2 * float(resid @ resid) / (n - 2)
        else:
            resid, scale = yb - logistic_null_mu(X, yb), 2.0
        err, p = skat_rows_check(rows, G, w, resid, scale, what)
        out[f'{what}_q_max_rel_err'] = err
        out[f'{what}_planted_p'] = p
        log(f'SKAT {what}, {n} samples x {m} variants in {m // SKAT_GROUP} '
            f'genes of {SKAT_GROUP}: {out[f"{what}_s"]:.3f} s with the collect '
            f'of its rows; every group p in [0, 1] and fault 0, q_stat of '
            f'{SKAT_CHECK_GROUPS} genes equal numpy (max rel err {err:.3g}), '
            f'the planted gene p {p:.3g}')
    return out


def ld_score_oracle(G, gp, rows, radius):
    """The scores of `rows` by the reference's formula in numpy f64: r
    between rows of G centred and scaled to unit norm."""
    c = G - G.mean(axis=1, keepdims=True)
    ss = np.sqrt((c * c).sum(axis=1, keepdims=True))
    Z = np.where(ss > 0, c / np.where(ss > 0, ss, 1), 0.0)
    r = Z[rows] @ Z.T
    r2 = r * r
    r2 = r2 - (1 - r2) / max(Z.shape[1] - 2, 1)
    return (r2 * (np.abs(gp[rows, None] - gp[None, :]) <= radius)).sum(axis=1)


def phase_ld_score(hl, rng):
    """hl.experimental.ld_score over LDS_SAMPLES x LDS_VARIANTS in LDS_PARTS
    partitions (the last on chromosome 2), a variant every LDS_SPACING bp,
    LD that decays along the genome (each call redrawn from its left
    neighbour's with probability 0.3), 2% missing, radius LDS_RADIUS:
    LDS_CHECK_ROWS rows spread over the partitions held to numpy. Returns
    (figures, ops/ldscore's device args, the global positions)."""
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ops import ldscore
    n, m = LDS_SAMPLES, LDS_VARIANTS
    nalt = np.empty((m, n), np.int32)
    nalt[0] = rng.integers(0, 3, n)
    for i in range(1, m):
        nalt[i] = np.where(rng.random(n) < 0.3, rng.integers(0, 3, n),
                           nalt[i - 1])
    miss = rng.random((m, n)) < MISSING
    block = m // LDS_PARTS
    contigs = (np.arange(m) >= (LDS_PARTS - 1) * block).astype(np.int32)
    pos = (10_000 + LDS_SPACING * np.where(contigs == 0, np.arange(m),
                                           np.arange(m) - (LDS_PARTS - 1) * block)
           ).astype(np.int32)
    mt = calls_mt(split_parts(nalt, miss, LDS_PARTS, contigs, pos), n, {})
    out = {}
    with Spy(ldscore, 'ld_scores') as host, \
            Spy(ldscore, 'window_scores', keep=True) as op:
        t0 = time.perf_counter()
        scores = _row_arrays(hl.experimental.ld_score(
            mt.GT.n_alt_alleles(), mt.locus, radius=LDS_RADIUS),
            ('ld_score',))['ld_score']
        out['ld_score_s'] = time.perf_counter() - t0
    if op.count() != 1:
        raise AssertionError(f'ld_score: ops/ldscore ran {op.count()} times')
    out['ops_ldscore_s'] = host.total()
    op_args = op.last['window_scores'][0]
    rg = default_reference()
    offsets = np.asarray([rg._global_offsets[c] for c in rg.contigs], np.int64)
    gp = offsets[contigs] + pos.astype(np.int64) - 1
    rows = np.linspace(0, m - 1, LDS_CHECK_ROWS).astype(np.int64)
    want = ld_score_oracle(mean_imputed(nalt, miss), gp, rows, LDS_RADIUS)
    err = np.abs(scores[rows] - want) / np.abs(want)
    if scores.shape != (m,) or not np.isfinite(scores).all() \
            or not (err <= 1e-10).all():
        raise AssertionError(f'ld_score: {int((err > 1e-10).sum())} of '
                             f'{LDS_CHECK_ROWS} rows differ from numpy')
    window = np.abs(gp[:, None] - gp[None, :]) <= LDS_RADIUS
    out.update(ld_score_max_rel_err=float(err.max()),
               window_min=int(window.sum(axis=1).min()),
               window_max=int(window.sum(axis=1).max()),
               pairs_in_windows=int(window.sum()))
    log(f'ld_score, {n} samples x {m} variants, radius {LDS_RADIUS}: '
        f'{out["ld_score_s"]:.3f} s (ops/ldscore with its copies '
        f'{out["ops_ldscore_s"]:.3f} s); windows of {out["window_min"]}-'
        f'{out["window_max"]} variants; {LDS_CHECK_ROWS} rows equal numpy '
        f'(max rel err {out["ld_score_max_rel_err"]:.3g}); scores '
        f'{scores.min():.3f}-{scores.max():.3f}')
    return out, op_args, gp


def phase_mating(hl, rng):
    """hl.simulate_random_mating of MATING_SAMPLES x MATING_VARIANTS in
    MATING_PARTS partitions (2% missing), two rounds, founders kept: every
    child's call takes one allele from each recorded parent's call and is
    missing exactly where either parent's is. Returns (figures, the
    simulated MatrixTable, which phase_family takes)."""
    from hail_tpu_torch.genetics.call import calls_allele_j, calls_allele_k
    mt, _, _, _ = build_mt(hl, rng, MATING_SAMPLES,
                           MATING_VARIANTS // MATING_PARTS, MATING_PARTS,
                           with_pheno=False)
    t0 = time.perf_counter()
    sim = hl.simulate_random_mating(mt, n_rounds=2, keep_founders=True)
    st = sim._stage
    gts = [st.partition_fn(c).entries['GT'] for c in st.contexts]
    cols = st.cols.to_pylist()
    seconds = time.perf_counter() - t0
    packed = np.concatenate([np.asarray(g.values) for g in gts])
    miss = np.concatenate([g.missing_mask() for g in gts])
    j, k = calls_allele_j(packed), calls_allele_k(packed)
    n_cols = 4 * MATING_SAMPLES
    if packed.shape != (MATING_VARIANTS, n_cols) or len(cols) != n_cols:
        raise AssertionError(f'simulate_random_mating: {packed.shape}')
    child = np.asarray([i for i, c in enumerate(cols) if c.mother is not None])
    mo = np.asarray([cols[i].mother for i in child])
    fa = np.asarray([cols[i].father for i in child])
    if len(child) != 3 * MATING_SAMPLES or not ((mo < child) & (fa < child)).all():
        raise AssertionError('simulate_random_mating: parents are not earlier '
                             'columns')
    want_miss = miss[:, mo] | miss[:, fa]
    if not np.array_equal(miss[:, child], want_miss):
        raise AssertionError('simulate_random_mating: missing calls differ')
    x, y = j[:, child], k[:, child]

    def has(a, col):
        return (a == j[:, col]) | (a == k[:, col])
    ok = (has(x, mo) & has(y, fa)) | (has(y, mo) & has(x, fa)) | want_miss
    if not ok.all():
        raise AssertionError(f'simulate_random_mating: {int((~ok).sum())} '
                             f'child calls not made of their parents\' alleles')
    log(f'simulate_random_mating of {MATING_SAMPLES} x {MATING_VARIANTS}, two '
        f'rounds, founders kept: {seconds:.3f} s for {n_cols} columns; every '
        f'child call of {len(child)} children holds an allele of each parent\'s '
        f'call, missing exactly where a parent\'s is ({int(want_miss.sum())} '
        f'calls)')
    return dict(seconds=seconds, columns=n_cols), sim


def statgen_device_ops(lmm_args, lds_args, gp):
    """ops/lmm and ops/ldscore timed on the tensors the methods gave them,
    against their bounds (f64 at F64_FLOPS_PER_S)."""
    from hail_tpu_torch.ops import ldscore, lmm
    pa, wpx, w, r0 = lmm_args
    n, m = pa.shape
    k = wpx.shape[1]
    lmm_ms = timed_ms(lambda: lmm.contractions(pa, wpx, w, r0))
    read_ms = timed_ms(lambda: pa.sum(dim=0))
    # bytes: pa, wpx, w and r0 read once, the (k + 2, m) block written;
    # operations: the product's 2(k + 1)nm and w·pa² summed, 3nm
    lb = bound(8 * (n * m + n * k + 2 * n + (k + 2) * m),
               (2 * (k + 1) + 3) * n * m, F64_FLOPS_PER_S, 'f64_mma')
    Z, g, n_samples, radius = lds_args
    mv, nv = Z.shape
    lds_ms = timed_ms(lambda: ldscore.window_scores(Z, g, n_samples, radius),
                      reps=3)
    prod_ms = timed_ms(lambda: Z @ Z.T, reps=3)
    # operations: the reference's whole r = Z·Zᵀ, 2m²n; r is symmetric, so
    # its upper half, m(m + 1)n, would do, and the windows need only their
    # pairs' products
    db = bound(8 * (mv * nv + 2 * mv), 2 * mv * mv * nv, F64_FLOPS_PER_S,
               'f64_mma')
    pairs = int((np.abs(gp[:, None] - gp[None, :]) <= LDS_RADIUS).sum())
    half_ms = mv * (mv + 1) * nv / F64_FLOPS_PER_S * 1e3
    window_ms = 2 * pairs * nv / F64_FLOPS_PER_S * 1e3
    log(f'ops/lmm {n} x {m}, k {k}: {lmm_ms:.4f} ms (bound '
        f'{lb["bound_ms"]:.4f} ms, {lb["bound_by"]}; a read of pa '
        f'{read_ms:.4f} ms); ops/ldscore {mv} x {nv}: {lds_ms:.4f} ms (bound '
        f'{db["bound_ms"]:.4f} ms, the upper half {half_ms:.4f} ms, the '
        f'windows\' pairs {window_ms:.4f} ms; Z·Zᵀ alone {prod_ms:.4f} ms)')
    return [
        dict(name='ops/lmm', source='hail_tpu_torch/ops/lmm.py',
             replaces='hail_tpu/stats/linear_mixed_model.py:196-206',
             shape=f'{n} samples x {m} variants, k = {k}',
             launches_per_call=1, ms=lmm_ms, **lb,
             share_of_bound=lb['bound_ms'] / lmm_ms,
             yardstick='pa.sum(dim=0): one read of pa (torch)',
             yardstick_ms=read_ms),
        dict(name='ops/ldscore', source='hail_tpu_torch/ops/ldscore.py',
             replaces='hail_tpu/experimental/__init__.py:265-272',
             shape=f'{mv} variants x {nv} samples, strips of '
                   f'{ldscore.STRIP}, radius {radius}',
             launches_per_call=1, ms=lds_ms, **db,
             share_of_bound=db['bound_ms'] / lds_ms,
             yardstick='Z @ Z.T alone (torch.matmul f64)',
             yardstick_ms=prod_ms, upper_half_bound_ms=half_ms,
             window_pairs_bound_ms=window_ms)]


def phase_statgen_rest(hl, dev, rng):
    """The rest of statgen: the LMM (full and low rank), SKAT (linear and
    logistic), hl.experimental.ld_score and simulate_random_mating, each
    held to numpy, then ops/lmm and ops/ldscore timed. Returns (figures,
    device-op records, simulate_random_mating's MatrixTable)."""
    out = {}
    out['lmm'], lmm_args = phase_lmm(hl, rng)
    out['skat'] = phase_skat(hl, rng)
    out['ld_score'], lds_args, gp = phase_ld_score(hl, rng)
    out['simulate_random_mating'], sim = phase_mating(hl, rng)
    ops = statgen_device_ops(lmm_args, lds_args, gp)
    return out, ops, sim


def pin_mesh(devices):
    """Install a mesh over `devices` as the default mesh (its cache, as the
    tests' fixtures do)."""
    from hail_tpu_torch.parallel import mesh
    mesh._mesh_cache = mesh.get_mesh(devices)
    return mesh._mesh_cache


def mesh_timed_ms(fn, devices, reps: int = 3, warm: bool = True):
    """(mean milliseconds per call, the last call's result) from CUDA
    events on every card among `devices`: an event before and after `reps`
    calls on each card's stream, after one warm-up call unless `warm` is
    False; the longest of the cards' spans."""
    cards = sorted({d.index for d in devices})
    if warm:
        fn()
    for c in cards:
        torch.cuda.synchronize(c)
    starts = {c: torch.cuda.Event(enable_timing=True) for c in cards}
    ends = {c: torch.cuda.Event(enable_timing=True) for c in cards}
    for c in cards:
        starts[c].record(torch.cuda.current_stream(c))
    for _ in range(reps):
        out = fn()
    for c in cards:
        ends[c].record(torch.cuda.current_stream(c))
    for c in cards:
        ends[c].synchronize()
    return max(starts[c].elapsed_time(ends[c]) for c in cards) / reps, out


def _near(got, want, what):
    """max |got - want| within DIST_RTOL of want's largest entry."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= DIST_RTOL * scale:
        raise AssertionError(f'{what}: {err:.3e} from one device (scale '
                             f'{scale:.3e})')
    return err


def _spread(store, n_slots, what):
    """A `Sharded` of n_slots blocks, none over total / n_slots."""
    from hail_tpu_torch.parallel.mesh import Sharded
    if not isinstance(store, Sharded) or len(store.shards) != n_slots:
        raise AssertionError(f'{what}: not sharded over {n_slots} slots')
    total = store.shape[0] * store.shape[1]
    if max(t.numel() for t in store.shards) > total // n_slots:
        raise AssertionError(f'{what}: a block over total / {n_slots}')


def span_checks(hl, pid):
    """In each of `multihost`'s two workers: a BlockMatrix mesh spanning
    the two processes, SPAN_LOCAL_SLOTS slots of this rank's card each.
    `from_entry_expr` of the relatedness shape on it and on one device
    (equal bit for bit), `bm @ bm.T` on it (each rank multiplies its own
    output blocks, the panels it lacks sent by the other rank) against one
    device's within DIST_RTOL of the largest entry, through the collective
    `to_numpy`. Prints one `SPAN {json}` line: the seconds, the product's
    ms (host clock around synchronised calls, both ranks started at a
    barrier), the bytes this rank sent for one product and a digest of
    the product that the ranks must share."""
    import hashlib
    import torch.distributed as dist
    from hail_tpu_torch.context import Env
    from hail_tpu_torch.linalg import BlockMatrix
    from hail_tpu_torch.parallel import mesh
    dev = Env.device()
    rng = np.random.default_rng(SEED + 13)          # alike on both ranks
    mt, _, _, _ = build_mt(hl, rng, REL_SAMPLES, REL_VARIANTS // REL_PARTS,
                           REL_PARTS, with_pheno=False)
    x = mt.GT.n_alt_alleles()
    out = dict(rank=pid, device=str(dev), group=dist.get_backend(),
               slots_per_rank=SPAN_LOCAL_SLOTS)

    def synced():
        torch.cuda.synchronize(dev)
        dist.barrier()
        return time.perf_counter()

    pin_mesh([dev])
    t0 = synced()
    bm1 = BlockMatrix.from_entry_expr(x, mean_impute=True)
    out['from_entry_expr_one_device_s'] = synced() - t0
    one_ms, want = mesh_timed_ms(lambda: (bm1 @ bm1.T)._store, [dev])
    out['one_device_ms'] = one_ms

    mesh._mesh_cache = mesh.spanning_mesh([dev] * SPAN_LOCAL_SLOTS)
    t0 = synced()
    bms = BlockMatrix.from_entry_expr(x, mean_impute=True)
    out['from_entry_expr_s'] = synced() - t0
    store = bms._store
    n_slots = store.mesh.size
    total = bms.shape[0] * bms.shape[1]
    if ([t is not None for t in store.shards]
            != [store.mesh.owner(s) == pid for s in range(n_slots)]
            or max(store.shards[s].numel() for s in store.mesh.local_slots)
            > total // n_slots):
        raise AssertionError(f'rank {pid}: from_entry_expr holds other '
                             'blocks than its own slots\' or one over total / '
                             f'{n_slots}')
    if not np.array_equal(bms.to_numpy(), bm1.to_numpy()):
        raise AssertionError(f'rank {pid}: from_entry_expr on the spanning '
                             'mesh differs from one device')

    span = store.mesh
    sent = span.bytes_sent
    prod = bms @ bms.T
    out['bytes_sent'] = span.bytes_sent - sent
    got = prod.to_numpy()
    wanted = want.cpu().numpy()
    err = float(np.max(np.abs(got - wanted)))
    scale = float(np.max(np.abs(wanted)))
    if not err <= DIST_RTOL * scale:
        raise AssertionError(f'rank {pid}: bm @ bm.T on the spanning mesh '
                             f'{err:.3e} from one device (scale {scale:.3e})')
    out['max_abs_err'] = err
    out['digest'] = hashlib.blake2b(got.tobytes(), digest_size=16).hexdigest()
    del prod, got, wanted, want
    reps = 3
    t0 = synced()
    for _ in range(reps):
        prod = bms @ bms.T
    out['ms'] = (synced() - t0) * 1e3 / reps
    out['spec'] = str(prod._store.spec)
    print('SPAN ' + json.dumps(out), flush=True)
    pin_mesh([dev])


def multihost(n_cards):
    """tests/test_torch_multihost.py's four checks in two processes, each on
    the card of its rank (both on cuda:0 on a host of one card), then
    `span_checks` in the same two processes. The group runs on NCCL where
    the host has a card for each rank, on gloo where it has one (NCCL
    refuses two ranks on one card): the backend chooses it from the layout
    before the group starts. Returns (seconds, the spanning mesh's
    figures)."""
    import os
    import socket
    backend = 'nccl' if n_cards >= 2 else 'gloo'
    cards = 'cuda:0 and cuda:1' if n_cards >= 2 else 'cuda:0, both ranks'
    log(f'multihost: two processes on {cards}; the group on {backend}, '
        f'chosen from the layout ({n_cards} card(s), 2 ranks) before it '
        'starts')
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        coord = f'127.0.0.1:{s.getsockname()[1]}'
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
    worker = os.path.join(root, 'tests', 'test_torch_multihost.py')
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, coord, '2', str(i),
                               'cuda', 'span'], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=root) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTIHOST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spans = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        if (p.returncode != 0 or f'[p{i}] ALL OK' not in out
                or f'[p{i}] the group on {backend}' not in out):
            raise AssertionError(f'multihost rank {i} failed:\n{out[-3000:]}')
        spans += [json.loads(line[5:]) for line in out.splitlines()
                  if line.startswith('SPAN ')]
    seconds = time.perf_counter() - t0
    if len(spans) != 2 or spans[0]['digest'] != spans[1]['digest']:
        raise AssertionError('multihost: the ranks\' products differ')
    log(f'multihost: alltoall_bytes, map_collect, an aggregate and a '
        f'distributed order_by passed over {backend}; the run took '
        f'{seconds:.2f} s')
    for sp in spans:
        log(f'spanning mesh, rank {sp["rank"]} on {sp["device"]} '
            f'({sp["slots_per_rank"]} slots a rank, {sp["group"]}): '
            f'from_entry_expr of {REL_VARIANTS} x {REL_SAMPLES} '
            f'{sp["from_entry_expr_s"]:.3f} s (one device '
            f'{sp["from_entry_expr_one_device_s"]:.3f} s), equal bit for '
            f'bit; bm @ bm.T {sp["ms"]:.4f} ms sharded {sp["spec"]} (one '
            f'device {sp["one_device_ms"]:.4f} ms), {sp["bytes_sent"]} bytes '
            f'sent, within {sp["max_abs_err"]:.2e} of one device; the ranks\' '
            'products equal bit for bit')
    return seconds, spans


def phase_distribution(hl, dev, rng):
    """Distribution: the BlockMatrix sharded at rest with its sharded
    product, the GRM's storage, the device range sort and Table.order_by's
    device tier, dryrun_multichip(4), and the multihost backend with a
    mesh spanning its two processes, each held to one device (or numpy,
    or the host tier). Returns (figures, device-op records)."""
    from hail_tpu_torch.linalg import BlockMatrix
    from hail_tpu_torch.linalg import blockmatrix as bm_mod
    from hail_tpu_torch.ops import device_sort
    from hail_tpu_torch.parallel.dryrun import dryrun_multichip
    t_phase = time.perf_counter()
    one = [dev]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        slots = [torch.device('cuda', i) for i in range(n_cards)]
        log(f'distribution: a mesh over the host\'s {n_cards} cards')
    else:
        slots = [dev] * DIST_ONE_CARD_SLOTS
        log(f'distribution: one card: a mesh of {len(slots)} slots, all on '
            f'{dev} (the sharded code runs; no block crosses a link)')
    n_dev_cards = len({d.index for d in slots})
    out = dict(cards=n_cards, slots=len(slots))

    def on(devices, fn):
        pin_mesh(devices)
        try:
            return fn()
        finally:
            pin_mesh(one)

    mt, _, _, _ = build_mt(hl, rng, REL_SAMPLES, REL_VARIANTS // REL_PARTS,
                           REL_PARTS, with_pheno=False)
    x = mt.GT.n_alt_alleles()
    t0 = time.perf_counter()
    bm1 = BlockMatrix.from_entry_expr(x, mean_impute=True)
    torch.cuda.synchronize()
    out['from_entry_expr_one_device_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bms = on(slots, lambda: BlockMatrix.from_entry_expr(x, mean_impute=True))
    for c in range(n_dev_cards):
        torch.cuda.synchronize(c)
    out['from_entry_expr_s'] = time.perf_counter() - t0
    _spread(bms._store, len(slots), 'from_entry_expr')
    if not torch.equal(bms._store.assemble(dev), bm1._store):
        raise AssertionError('from_entry_expr: the sharded matrix differs '
                             'from one device')
    log(f'from_entry_expr of {REL_VARIANTS} x {REL_SAMPLES}: sharded '
        f'{bms._store.spec} over {len(slots)} slots in '
        f'{out["from_entry_expr_s"]:.3f} s (one device '
        f'{out["from_entry_expr_one_device_s"]:.3f} s), equal bit for bit')

    ops = []
    for name, f in (('bm @ bm.T', lambda b: b @ b.T),
                    ('bm.T @ bm', lambda b: b.T @ b)):
        one_ms, want = mesh_timed_ms(lambda: f(bm1)._store, one)
        with Spy(bm_mod, '_sharded_matmul') as spy:
            got = on(slots, lambda: f(bms))
        calls = len(spy.spent['_sharded_matmul'])
        _spread(got._store, len(slots), name)
        err = _near(got._store.assemble(dev), want, name)
        ms, _ = on(slots, lambda: mesh_timed_ms(lambda: f(bms)._store, slots))
        n, m = want.shape
        k = bm1.shape[1] if name == 'bm @ bm.T' else bm1.shape[0]
        bnd = bound(8 * (2 * n * k + n * m), 2 * n * m * k, F64_FLOPS_PER_S,
                    'f64_mma')
        bnd['bound_ms'] /= n_dev_cards
        log(f'_sharded_matmul {name} ({n} x {k} x {m}): {ms:.4f} ms over '
            f'{len(slots)} slots on {n_dev_cards} card(s), one device '
            f'{one_ms:.4f} ms, bound {bnd["bound_ms"]:.4f} ms; within '
            f'{err:.2e} of one device')
        ops.append(dict(
            name='_sharded_matmul', source='hail_tpu_torch/linalg/blockmatrix.py',
            replaces='hail_tpu/linalg/blockmatrix.py:751',
            shape=f'{name}: ({n} x {k}) @ ({k} x {m}) f64, {len(slots)} '
                  f'slots on {n_dev_cards} card(s)',
            launches_per_call=calls, ms=ms, **bnd,
            share_of_bound=bnd['bound_ms'] / ms,
            yardstick='the one-device product (torch.matmul f64, one card)',
            yardstick_ms=one_ms, max_abs_err=err))
        del got, want

    grm_one_ms, grm1 = mesh_timed_ms(
        lambda: hl.genetic_relatedness_matrix(mt.GT), one, reps=1, warm=False)
    grm_ms, grms = on(slots, lambda: mesh_timed_ms(
        lambda: hl.genetic_relatedness_matrix(mt.GT), slots, reps=1,
        warm=False))
    _spread(grms._store, len(slots), 'genetic_relatedness_matrix')
    grm_err = _near(grms._store.assemble(dev), grm1._store,
                    'genetic_relatedness_matrix')
    grm_bound = 2 * REL_SAMPLES ** 2 * REL_VARIANTS / F64_FLOPS_PER_S * 1e3
    out['grm'] = dict(ms=grm_ms, one_device_ms=grm_one_ms,
                      f64_bound_ms=grm_bound / n_dev_cards, max_abs_err=grm_err)
    log(f'genetic_relatedness_matrix {REL_SAMPLES}²: {grm_ms:.1f} ms sharded '
        f'{grms._store.spec} (one device {grm_one_ms:.1f} ms; the f64 product '
        f'bound {grm_bound / n_dev_cards:.4f} ms), within {grm_err:.2e} of '
        'one device')
    del bm1, bms, grm1, grms

    keys_i = rng.integers(-2 ** 62, 2 ** 62, SORT_KEYS, dtype=np.int64)
    keys_f = np.round(rng.normal(size=SORT_KEYS) * 64) / 4     # ties
    out['device_range_sort'] = {}
    for label, keys, asc in (('int64', keys_i, True),
                             ('float64 with ties, descending', keys_f, False)):
        t0 = time.perf_counter()
        want = np.argsort(keys if asc else -keys, kind='stable')
        np_s = time.perf_counter() - t0
        ms, order = on(slots, lambda: mesh_timed_ms(
            lambda: device_sort.device_range_sort(keys, asc), slots, reps=2))
        if not np.array_equal(order, want):
            raise AssertionError(f'device_range_sort ({label}): not numpy\'s '
                                 'stable argsort')
        lib_ms, _ = mesh_timed_ms(lambda: torch.sort(
            torch.from_numpy(keys if asc else -keys).to(dev),
            stable=True).indices.cpu(), one, reps=2)
        bnd = bound(16 * SORT_KEYS)
        out['device_range_sort'][label] = dict(ms=ms, numpy_s=np_s,
                                               library_ms=lib_ms)
        log(f'device_range_sort of {SORT_KEYS} {label} keys over {len(slots)} '
            f'slots: {ms:.2f} ms host to host (numpy\'s stable argsort '
            f'{np_s * 1e3:.1f} ms; torch.sort on one card with the copies '
            f'{lib_ms:.2f} ms), equal to numpy')
        ops.append(dict(
            name='device_range_sort', source='hail_tpu_torch/ops/device_sort.py',
            replaces='hail_tpu/ops/device_sort.py:31',
            shape=f'{SORT_KEYS} {label} keys, {len(slots)} slots on '
                  f'{n_dev_cards} card(s), keys and order host arrays',
            launches_per_call=1, ms=ms, **bnd,
            share_of_bound=bnd['bound_ms'] / ms,
            yardstick='torch.sort(stable=True) on one card, with the copy of '
                      'the keys in and of the order out',
            yardstick_ms=lib_ms, numpy_ms=np_s * 1e3))
    del keys_i, keys_f, want, order

    t = hl.utils.range_table(ORDER_BY_ROWS, n_partitions=ORDER_BY_PARTS)
    t = t.annotate(k=hl.int64((t.idx * 2654435761) % 500_009))
    with Spy(device_sort, 'device_range_sort') as spy:
        t0 = time.perf_counter()
        dev_parts = on(slots, lambda: t.order_by(t.k)._stage.collect_batches())
        dev_s = time.perf_counter() - t0
    hl._set_flags(use_device_sort='0')
    try:
        t0 = time.perf_counter()
        host_parts = t.order_by(t.k)._stage.collect_batches()
        host_s = time.perf_counter() - t0
    finally:
        hl._set_flags(use_device_sort='1')
    sort_calls = len(spy.spent['device_range_sort'])
    col = lambda parts, f: np.concatenate([b.columns[f].values for b in parts])
    ks = col(dev_parts, 'k')
    if (sort_calls != 1 or len(dev_parts) != len(slots)
            or not np.array_equal(col(dev_parts, 'idx'), col(host_parts, 'idx'))
            or not np.array_equal(ks, col(host_parts, 'k'))
            or (np.diff(ks) < 0).any() or ks.shape[0] != ORDER_BY_ROWS):
        raise AssertionError('Table.order_by: the device tier differs from '
                             'the host tier')
    out['order_by'] = dict(device_tier_s=dev_s, host_tier_s=host_s,
                           partitions=len(dev_parts))
    log(f'Table.order_by of {ORDER_BY_ROWS} rows in {ORDER_BY_PARTS} '
        f'partitions: device tier {dev_s:.3f} s ({len(dev_parts)} output '
        f'partitions, {sort_calls} device_range_sort), host tier '
        f'{host_s:.3f} s; equal row for row')

    dry = [slots[i % len(slots)] for i in range(4)]
    t0 = time.perf_counter()
    log(on(dry, lambda: dryrun_multichip(4)))
    out['dryrun_s'] = time.perf_counter() - t0
    out['multihost_s'], out['spanning_mesh'] = multihost(n_cards)
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'distribution: the phase took {out["phase_s"]:.1f} s')
    return out, ops


# ---------------------------------------------------------------------------
# the VariantDataset and the family methods (phase_vds)
# ---------------------------------------------------------------------------

def build_vds(hl, rng, n_samples, n_sites, n_parts):
    """A VariantDataset with the combiner's schema, built from numpy arrays
    made from `rng`, with the dense truth beside it. Sites lie VDS_SPACING bp
    apart on contig 1; VDS_TRIALLELIC of them are tri-allelic ([A, G, T]),
    the others [A, G] and [A, T] in turn; allele frequencies from Beta(0.5,
    4) (the third allele Beta(0.5, 8)), each site carried by one sample at
    least. VDS_UNCOVERED of the entries have no data (no variant call and no
    reference block). Variant data: LGT, LA, LAD, DP, GQ where a sample
    carries an alternate allele; column fields pheno, c0, c1, c2 for the
    GWAS. Reference data: END, DP, GQ, in blocks of 1 to VDS_MAX_BLOCK sites
    (drawn per block) over every hom-ref entry, each ending 0 to
    VDS_SPACING - 1 bp past its last site. Returns (vds, the truth: global
    calls j <= k, the masks var, homref and uncovered, the dense DP and GQ,
    LA, LAD and their widths, the alleles, the variant entries' DP and GQ,
    the blocks' starts, lengths, DP and GQ, and the column arrays)."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ir.columns import (Batch, DenseArrayColumn,
                                           LocusColumn, ObjectColumn,
                                           PrimitiveColumn)
    from hail_tpu_torch.genetics.call import pack_diploid
    from hail_tpu_torch.matrixtable import MatrixBatch, MatrixStage, MatrixTable
    V, N = n_sites, n_samples
    pos = (100_000 + VDS_SPACING * np.arange(V)).astype(np.int32)
    n_all = np.where(rng.random(V) < VDS_TRIALLELIC, 3, 2)
    af1 = np.clip(rng.beta(0.5, 4.0, V), 0.005, 0.5)
    af2 = np.where(n_all == 3, np.clip(rng.beta(0.5, 8.0, V), 0.005, 0.2), 0.0)
    al = []
    for _ in range(2):
        u = rng.random((V, N))
        al.append(np.where(u < af1[:, None], 1,
                           np.where(u < (af1 + af2)[:, None], 2, 0))
                  .astype(np.int8))
    j, k = np.minimum(*al), np.maximum(*al)
    uncovered = rng.random((V, N)) < VDS_UNCOVERED
    var = (k > 0) & ~uncovered
    none = np.flatnonzero(~var.any(axis=1))
    s0 = none % N
    j[none, s0], k[none, s0] = 0, 1
    uncovered[none, s0], var[none, s0] = False, True
    homref = ~var & ~uncovered
    j[~var], k[~var] = 0, 0
    alleles = [['A', 'G', 'T'] if n == 3 else (['A', 'G'] if i % 2 == 0
                                               else ['A', 'T'])
               for i, n in enumerate(n_all)]

    # variant entries in local alleles: LA [0, k] (0/k or k/k) or [0, j, k]
    width = np.where((j > 0) & (j < k), 3, 2).astype(np.int32)
    la = np.zeros((V, N, 3), np.int32)
    la[..., 1] = np.where(width == 3, j, k)
    la[..., 2] = np.where(width == 3, k, 0)
    lgt = pack_diploid((j > 0).astype(np.int32),
                       np.where(width == 3, 2, 1).astype(np.int32))
    lad = rng.integers(0, 30, (V, N, 3)).astype(np.int32)
    lad[..., 2] = np.where(width == 3, lad[..., 2], 0)
    v_dp = (lad.sum(axis=2) + rng.integers(0, 5, (V, N))).astype(np.int32)
    v_gq = rng.integers(0, 99, (V, N), dtype=np.int32)

    # reference blocks over the hom-ref entries, walked site by site
    start = np.zeros((V, N), bool)
    cover = np.full((V, N), -1, np.int64)
    left = np.zeros(N, np.int64)
    open_row = np.full(N, -1, np.int64)
    for i in range(V):
        h = homref[i]
        cont = h & (left > 0) & (open_row >= 0)
        new = h & ~cont
        draw = rng.integers(1, VDS_MAX_BLOCK + 1, N)
        left = np.where(new, draw - 1, np.where(cont, left - 1, 0))
        open_row = np.where(h, np.where(new, i, open_row), -1)
        start[i] = new
        cover[i] = open_row
    nxt = np.vstack([cover[1:], np.full((1, N), -1)])
    last_r, last_s = np.nonzero((cover >= 0) & (nxt != cover))
    r_end = np.zeros((V, N), np.int32)
    r_end[cover[last_r, last_s], last_s] = (
        pos[last_r] + rng.integers(0, VDS_SPACING, last_r.size))
    r_dp = rng.integers(0, 60, (V, N), dtype=np.int32)
    r_gq = rng.integers(0, 99, (V, N), dtype=np.int32)
    rows_c = np.clip(cover, 0, None)
    cols_idx = np.arange(N)[None, :]
    dp = np.where(var, v_dp, r_dp[rows_c, cols_idx])
    gq = np.where(var, v_gq, r_gq[rows_c, cols_idx])

    cols_np = {name: rng.normal(size=N)
               for name in ['pheno'] + [f'c{i}' for i in range(K - 1)]}
    rg = default_reference()
    s_col = ObjectColumn(ht.tstr, np.asarray([f's{i}' for i in range(N)],
                                             object))
    bounds = np.linspace(0, V, n_parts + 1).astype(int)
    vmbs, rmbs = [], []
    for p in range(n_parts):
        sl = slice(bounds[p], bounds[p + 1])
        R = int(bounds[p + 1] - bounds[p])
        al_col = np.empty(R, dtype=object)
        al_col[:] = alleles[sl]
        f = ~var[sl]
        rows = Batch({'locus': LocusColumn(ht.tlocus(rg), np.zeros(R, np.int32),
                                           pos[sl]),
                      'alleles': ObjectColumn(ht.tarray(ht.tstr), al_col)}, R)
        vmbs.append(MatrixBatch(rows, {
            'LGT': PrimitiveColumn(ht.tcall, lgt[sl], f),
            'LA': DenseArrayColumn(ht.tarray(ht.tint32), la[sl], width[sl],
                                   None, f),
            'LAD': DenseArrayColumn(ht.tarray(ht.tint32), lad[sl], width[sl],
                                    None, f),
            'DP': PrimitiveColumn(ht.tint32, v_dp[sl], f),
            'GQ': PrimitiveColumn(ht.tint32, v_gq[sl], f)}, f))
        keep = np.flatnonzero(start[sl].any(axis=1))
        f = ~start[sl][keep]
        rows = Batch({'locus': LocusColumn(ht.tlocus(rg),
                                           np.zeros(keep.size, np.int32),
                                           pos[sl][keep])}, int(keep.size))
        rmbs.append(MatrixBatch(rows, {
            'END': PrimitiveColumn(ht.tint32, r_end[sl][keep], f),
            'DP': PrimitiveColumn(ht.tint32, r_dp[sl][keep], f),
            'GQ': PrimitiveColumn(ht.tint32, r_gq[sl][keep], f)}, f))
    v_cols = {'s': s_col, **{n: PrimitiveColumn(ht.tfloat64, v)
                             for n, v in cols_np.items()}}
    vd = MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), Batch(v_cols, N), ['locus', 'alleles'], ['s'],
        ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr)),
        ht.tstruct(s=ht.tstr, **{n: ht.tfloat64 for n in cols_np}),
        ht.tstruct(LGT=ht.tcall, LA=ht.tarray(ht.tint32),
                   LAD=ht.tarray(ht.tint32), DP=ht.tint32, GQ=ht.tint32),
        vmbs))
    rd = MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), Batch({'s': s_col}, N), ['locus'], ['s'],
        ht.tstruct(locus=ht.tlocus(rg)), ht.tstruct(s=ht.tstr),
        ht.tstruct(END=ht.tint32, DP=ht.tint32, GQ=ht.tint32), rmbs))
    truth = dict(j=j, k=k, var=var, homref=homref, uncovered=uncovered,
                 dp=dp, gq=gq, la=la, width=width, lad=lad, n_all=n_all,
                 alleles=alleles, v_dp=v_dp, v_gq=v_gq, start=start,
                 length=np.where(start, r_end - pos[:, None] + 1, 0),
                 r_dp=r_dp, r_gq=r_gq, cols_np=cols_np)
    return hl.vds.VariantDataset(rd, vd), truth


def vds_sample_qc_oracle(table, t, gq_bins=(0, 20, 60),
                         dp_bins=(0, 1, 10, 20, 30)):
    """hl.vds.sample_qc's counters of every sample against numpy on the
    truth: calls from the variant entries, allele types from each site's
    alleles, singletons from the allele counts over the variant entries,
    the GQ and DP bins over the variant entries (one each) and the
    reference blocks (their length in bases each)."""
    j, k, var = t['j'], t['k'], t['var']
    N = j.shape[1]
    ti = np.asarray([[a[1] == 'G', len(a) == 3 and a[2] == 'G']
                     for a in t['alleles']])
    want = dict(n_het=(var & (j != k)).sum(axis=0),
                n_hom_var=(var & (j == k) & (j > 0)).sum(axis=0))
    want['n_non_ref'] = want['n_het'] + want['n_hom_var']
    n_ti, n_tv, sing_ti, sing_tv = (np.zeros(N, np.int64) for _ in range(4))
    for g in (1, 2):
        ac = np.where(var, (j == g).astype(np.int64) + (k == g), 0).sum(axis=1)
        g_ti = ti[:, g - 1][:, None]
        for a in (j, k):
            carried = var & (a == g)
            n_ti += (carried & g_ti).sum(axis=0)
            n_tv += (carried & ~g_ti).sum(axis=0)
            single = carried & (ac == 1)[:, None]
            sing_ti += (single & g_ti).sum(axis=0)
            sing_tv += (single & ~g_ti).sum(axis=0)
    zero = np.zeros(N, np.int64)
    want.update(n_singleton=sing_ti + sing_tv, n_singleton_ti=sing_ti,
                n_singleton_tv=sing_tv, n_snp=n_ti + n_tv, n_transition=n_ti,
                n_transversion=n_tv, n_insertion=zero, n_deletion=zero,
                n_star=zero)
    for name, bins, v, r in (('gq', gq_bins, t['v_gq'], t['r_gq']),
                             ('dp', dp_bins, t['v_dp'], t['r_dp'])):
        want[f'bases_over_{name}_threshold'] = np.stack(
            [(var & (v >= b)).sum(axis=0)
             + np.where(t['start'] & (r >= b), t['length'], 0).sum(axis=0)
             for b in bins], axis=1)
    rows = {_sample_index(r.s): r for r in table.collect()}
    if len(rows) != N:
        raise AssertionError(f'vds.sample_qc: {len(rows)} rows for {N} samples')
    for name, w in want.items():
        got = [tuple(rows[i][name]) if w.ndim == 2 else rows[i][name]
               for i in range(N)]
        _eq(got, w, f'vds.sample_qc {name}')
    for name, (a, b) in (('r_ti_tv', (n_ti, n_tv)),
                         ('r_ti_tv_singleton', (sing_ti, sing_tv)),
                         ('r_het_hom_var', (want['n_het'], want['n_hom_var']))):
        ratio = [x / y if y else None for x, y in zip(a.tolist(), b.tolist())]
        if [rows[i][name] for i in range(N)] != ratio:
            raise AssertionError(f'vds.sample_qc {name}: differs from numpy')


def vds_split_truth(t):
    """The truth after split_multi: one row per alternate allele a of each
    site, calls downcoded to a (j <= k in {0, 1}), AD [Σ LAD - LAD at a,
    LAD at a] where the sample's LA holds a, else [Σ LAD, 0]. Returns the
    split rows' site, a, j, k and AD."""
    site = np.repeat(np.arange(t['n_all'].size), t['n_all'] - 1)
    a = np.concatenate([np.arange(1, n) for n in t['n_all']])
    j, k = t['j'][site], t['k'][site]
    sj = (j == a[:, None]).astype(np.int8)
    sk = (k == a[:, None]).astype(np.int8)
    sj, sk = np.minimum(sj, sk), np.maximum(sj, sk)
    la, lad = t['la'][site], t['lad'][site]
    inside = np.arange(3) < t['width'][site][..., None]
    hit = (la == a[:, None, None]) & inside
    hit[..., 0] = False
    nra = np.where(hit, lad, 0).sum(axis=2)
    tot = np.where(inside, lad, 0).sum(axis=2)
    return dict(site=site, a=a, j=sj, k=sk, ad=np.stack([tot - nra, nra], 2))


def vds_dense_check(mb, t, st):
    """The dense MatrixTable's one batch against the truth: its rows are the
    split rows in order; GT is each variant call downcoded, hom-ref where a
    reference block covers the site, and filtered where nothing does; DP and
    GQ come from the variant entry or the covering block; AD from LAD on
    variant entries, missing elsewhere. Returns the uncovered mask."""
    from hail_tpu_torch.genetics.call import calls_allele_j, calls_allele_k
    site = st['site']
    pos = np.asarray(mb.rows.columns['locus'].position)
    if not np.array_equal(pos, 100_000 + VDS_SPACING * site):
        raise AssertionError('to_dense_mt: the rows are not the split sites')
    got_al = mb.rows.columns['alleles'].to_pylist()
    if got_al != [['A', t['alleles'][s][a]] for s, a in zip(site, st['a'])]:
        raise AssertionError('to_dense_mt: the split alleles differ')
    unc = t['uncovered'][site]
    _eq(mb.entry_filtered_mask(), unc, 'to_dense_mt: filtered entries')
    gt = mb.entries['GT']
    _eq(gt.missing_mask(), unc, 'to_dense_mt: GT missing')
    packed, ok = np.asarray(gt.values), ~unc
    _eq(calls_allele_j(packed)[ok], st['j'][ok], 'to_dense_mt: GT j')
    _eq(calls_allele_k(packed)[ok], st['k'][ok], 'to_dense_mt: GT k')
    for f in ('DP', 'GQ'):
        col = mb.entries[f]
        _eq(col.missing_mask(), unc, f'to_dense_mt: {f} missing')
        _eq(np.asarray(col.values)[ok], t[f.lower()][site][ok],
            f'to_dense_mt: {f}')
    ad, var = mb.entries['AD'], t['var'][site]
    _eq(ad.missing_mask(), ~var, 'to_dense_mt: AD missing')
    _eq(np.asarray(ad.values)[var][:, :2], st['ad'][var], 'to_dense_mt: AD')
    return unc


def plant_mendel_errors(rng, nalt, miss, trios, n_plant):
    """Calls with `n_plant` Mendel errors planted in `trios` (kid, dad, mom
    column indices, kids that are no one's parent), each where the child and
    both parents are called: a hom-var child of hom-ref parents (code 5), a
    hom-ref child of hom-var parents (code 8) and a het child of hom-ref
    parents (code 2), in turn. Returns (the planted n_alt, [(row, trio,
    code)])."""
    kid, dad, mom = (np.asarray(x) for x in zip(*trios))
    ok = ~(miss[:, kid] | miss[:, dad] | miss[:, mom])
    kinds = [(5, 0, 2), (8, 2, 0), (2, 0, 1)]    # code, parents, child
    cands = {par: ok & (nalt[:, dad] == par) & (nalt[:, mom] == par)
             for par in (0, 2)}
    out = nalt.copy()
    planted, used = [], set()
    for n in range(n_plant):
        code, par, child = kinds[n % 3]
        cand = cands[par]
        while True:
            r = int(rng.integers(0, nalt.shape[0]))
            tis = np.flatnonzero(cand[r])
            if tis.size:
                ti = int(rng.choice(tis))
                if (r, ti) not in used:
                    break
        used.add((r, ti))
        out[r, kid[ti]] = child
        planted.append((r, ti, code))
    return out, planted


def tdt_oracle(nalt, miss, kid, dad, mom):
    """t and u per row over complete trios of called entries on autosomes:
    a het parent beside a hom parent transmitted the child's alternate
    alleles less the hom parent's; two het parents transmitted the child's
    n_alt of 2."""
    k, d, m = nalt[:, kid], nalt[:, dad], nalt[:, mom]
    ok = ~(miss[:, kid] | miss[:, dad] | miss[:, mom])
    dh, mh = ok & (d == 1), ok & (m == 1)
    one = dh ^ mh
    tr = np.where(dh, k - m // 2, k - d // 2)
    t = np.where(one, tr, 0) + np.where(dh & mh, k, 0)
    u = np.where(one, 1 - tr, 0) + np.where(dh & mh, 2 - k, 0)
    return t.sum(axis=1), u.sum(axis=1)


def phase_family(hl, sim, rng):
    """hl.mendel_errors and hl.transmission_disequilibrium_test on the first
    FAM_VARIANTS rows of simulate_random_mating's output (phase_mating):
    the Pedigree from the columns' parents, FAM_PLANTED Mendel errors
    planted in children of the last round, every count held to numpy."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.call import calls_n_alt_alleles, pack_diploid
    from hail_tpu_torch.ir.columns import PrimitiveColumn
    from hail_tpu_torch.matrixtable import MatrixBatch, MatrixStage, MatrixTable
    from hail_tpu_torch.matrixtable import _concat_matrix_batches
    out = {}
    st = sim._stage
    mb = _concat_matrix_batches(st.collect_batches(), st)
    mb = mb.filter_rows(np.arange(mb.n_rows) < FAM_VARIANTS)
    cols = st.cols.to_pylist()
    names = [c.s for c in cols]
    trios = [(i, c.father, c.mother) for i, c in enumerate(cols)
             if c.mother is not None]
    parents = {x for _, d, m in trios for x in (d, m)}
    leaves = [tr for tr in trios if tr[0] not in parents]
    ped = hl.Pedigree([hl.Trio(names[i], fam_id=f'f{i}', pat_id=names[d],
                               mat_id=names[m]) for i, d, m in trios])
    packed = np.asarray(mb.entries['GT'].values)
    miss = mb.entries['GT'].missing_mask()
    nalt = calls_n_alt_alleles(packed)
    planted_nalt, planted = plant_mendel_errors(rng, nalt, miss, leaves,
                                                FAM_PLANTED)
    calls = pack_diploid((planted_nalt == 2).astype(np.int32),
                         (planted_nalt >= 1).astype(np.int32))

    def mt_of(gt):
        return MatrixTable(MatrixStage.from_batches(
            st.globals, st.cols, st.row_key, st.col_key, st.row_type,
            st.col_type, st.entry_type,
            [MatrixBatch(mb.rows, {'GT': PrimitiveColumn(ht.tcall, gt, miss)})]))
    sim, pmt = mt_of(packed), mt_of(calls)

    t0 = time.perf_counter()
    men, fam, ind, var = hl.mendel_errors(pmt.GT, ped)
    men_rows, fam_rows = men.collect(), fam.collect()
    ind_rows, var_rows = ind.collect(), var.collect()
    out['mendel_errors_s'] = time.perf_counter() - t0
    row_of = {int(p): i for i, p in
              enumerate(np.asarray(mb.rows.columns['locus'].position))}
    col_of = {s: i for i, s in enumerate(names)}
    got = {(row_of[r.locus.position], col_of[r.s], r.mendel_code)
           for r in men_rows}
    want = {(r, leaves[ti][0], code) for r, ti, code in planted}
    if got != want or len(men_rows) != FAM_PLANTED:
        raise AssertionError(f'mendel_errors: {len(men_rows)} errors found, '
                             f'{len(got ^ want)} differ from the planted')
    fam_want = {names[i]: 0 for i, _, _ in trios}
    ind_want = {names[x]: 0 for tr in trios for x in tr}
    per_var = np.zeros(packed.shape[0], np.int64)
    for r, ti, code in planted:
        i, d, m = leaves[ti]
        fam_want[names[i]] += 1
        ind_want[names[i]] += 1
        ind_want[names[d]] += code in (1, 2, 3, 6, 11, 12)
        ind_want[names[m]] += code in (1, 2, 4, 7, 9, 10)
        per_var[r] += 1
    fam_got = {r.fam_id[1:]: r for r in fam_rows}
    if ({names[int(f)]: r.errors for f, r in fam_got.items()} != fam_want
            or any(r.snp_errors != r.errors or r.children != 1
                   for r in fam_rows)):
        raise AssertionError('mendel_errors: per-family counts differ')
    if {r.s: r.errors for r in ind_rows} != ind_want:
        raise AssertionError('mendel_errors: per-sample counts differ')
    if [r.errors for r in var_rows] != per_var.tolist():
        raise AssertionError('mendel_errors: per-variant counts differ')

    t0 = time.perf_counter()
    tdt = hl.transmission_disequilibrium_test(sim, ped).collect()
    out['tdt_s'] = time.perf_counter() - t0
    kid, dad, mom = (np.asarray(x) for x in zip(*trios))
    t_want, u_want = tdt_oracle(nalt, miss, kid, dad, mom)
    _eq([r.t for r in tdt], t_want, 'transmission_disequilibrium_test t')
    _eq([r.u for r in tdt], u_want, 'transmission_disequilibrium_test u')
    log(f'family methods on simulate_random_mating\'s {packed.shape[0]} x '
        f'{len(cols)} ({len(trios)} trios): mendel_errors '
        f'{out["mendel_errors_s"]:.3f} s found the {FAM_PLANTED} planted '
        f'errors and no other; per-family, per-sample and per-variant counts '
        f'equal numpy; transmission_disequilibrium_test {out["tdt_s"]:.3f} s, '
        f't and u of every variant equal numpy ({int(t_want.sum())} '
        f'transmitted, {int(u_want.sum())} untransmitted)')
    return out


def phase_vds(hl, dev, rng, sim):
    """The VariantDataset from files to a dense MatrixTable (VDS_SAMPLES x
    VDS_SITES in VDS_PARTS partitions, the combiner's schema): write and
    read_vds, validate, vds.sample_qc, lgt_to_gt, split_multi and
    to_dense_mt, then variant_qc (K5) and linear_regression_rows (K4 cold,
    K3) on the dense MatrixTable, each held to numpy; then the family
    methods on `sim`. Returns (figures, the kernels' launches on the VDS
    path)."""
    import os
    import tempfile
    from hail_tpu_torch.genetics.call import calls_allele_j, calls_allele_k
    from hail_tpu_torch.ops import _kernels, entry_agg as ea, qc
    pin_mesh([dev])
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    vds, t = build_vds(hl, rng, VDS_SAMPLES, VDS_SITES, VDS_PARTS)
    out['build_s'] = time.perf_counter() - t0
    log(f'VDS {VDS_SITES} sites x {VDS_SAMPLES} samples in {VDS_PARTS} '
        f'partitions built in {out["build_s"]:.2f} s: '
        f'{int(t["var"].sum())} variant entries, {int(t["start"].sum())} '
        f'reference blocks, {int((t["n_all"] == 3).sum())} tri-allelic sites')

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'cohort.vds')
        t0 = time.perf_counter()
        vds.write(path)
        out['write_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vds = hl.vds.read_vds(path)
        out['read_s'] = time.perf_counter() - t0
        with Spy(ea, 'run_device_entry_agg') as spy:
            t0 = time.perf_counter()
            vds.validate()
            out['validate_s'] = time.perf_counter() - t0
        out['validate_device_tier_partitions'] = spy.count()
        log(f'VDS write {out["write_s"]:.3f} s, read_vds {out["read_s"]:.3f} '
            f's, validate {out["validate_s"]:.3f} s (its aggregate_entries '
            f'ran on the device tier in {spy.count()} partitions'
            + ('' if spy.count() else ': agg.take has no device plan, so the '
               'host evaluator ran it') + ')')

        t0 = time.perf_counter()
        sq = hl.vds.sample_qc(vds)
        out['sample_qc_s'] = time.perf_counter() - t0
        vds_sample_qc_oracle(sq, t)
        log(f'vds.sample_qc: {out["sample_qc_s"]:.3f} s; every counter of all '
            f'{VDS_SAMPLES} samples (calls, allele types, singletons, GQ and '
            f'DP bins over variant entries and reference blocks) equals numpy')

        # lgt_to_gt over the first partition of the variant data
        t0 = time.perf_counter()
        vd = vds.variant_data._filter_partitions([0])
        g = vd.annotate_entries(GT=hl.vds.lgt_to_gt(vd.LGT, vd.LA))
        gmb = g._stage.partition_fn(g._stage.contexts[0])
        out['lgt_to_gt_s'] = time.perf_counter() - t0
        gp = np.asarray(gmb.entries['GT'].values)
        gm = gmb.entries['GT'].missing_mask()
        var = t['var'][:gp.shape[0]]
        _eq(gm, ~var, 'lgt_to_gt: missing')
        _eq(calls_allele_j(gp)[var], t['j'][:gp.shape[0]][var], 'lgt_to_gt: j')
        _eq(calls_allele_k(gp)[var], t['k'][:gp.shape[0]][var], 'lgt_to_gt: k')

        t0 = time.perf_counter()
        split = hl.vds.split_multi(vds)
        split.variant_data._stage.collect_batches()
        out['split_multi_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = hl.vds.to_dense_mt(split)
        out['to_dense_mt_s'] = time.perf_counter() - t0
    st = vds_split_truth(t)
    ctxs = dense._stage.contexts
    unc = vds_dense_check(dense._stage.partition_fn(ctxs[0]), t, st)
    n_rows = st['site'].size
    log(f'lgt_to_gt of the first partition of the variant data: '
        f'{out["lgt_to_gt_s"]:.3f} s, equal to the global calls; split_multi {out["split_multi_s"]:.3f} s, to_dense_mt '
        f'{out["to_dense_mt_s"]:.3f} s ({len(ctxs)} batch of {n_rows} rows, '
        f'{n_rows - VDS_SITES} from splits); GT, DP, GQ and AD of every entry '
        f'equal the truth, its {int(unc.sum())} uncovered entries filtered')

    _kernels.reset_launch_counts()
    with Spy(qc, 'run_variant_qc_block') as dev_spy:
        t0 = time.perf_counter()
        vq = hl.variant_qc(dense)
        q = _qc_struct(vq._stage.partition_fn(vq._stage.contexts[0]).rows,
                       'variant_qc')
        out['variant_qc_s'] = time.perf_counter() - t0
    out['variant_qc_device_part_s'] = dev_spy.total()
    n_vds = dict(_kernels.launches)
    if n_vds['hail_variant_qc'] != len(ctxs):
        raise AssertionError(f'variant_qc on the dense MatrixTable launched '
                             f'K5 {n_vds["hail_variant_qc"]} times')
    site = st['site']
    variant_qc_oracle(q, dict(j=st['j'], k=st['k'], gt_m=unc,
                              dp=t['dp'][site], dp_m=unc, gq=t['gq'][site],
                              gq_m=unc, n_all=np.full(n_rows, 2)))
    log(f'variant_qc on the dense MatrixTable: {out["variant_qc_s"]:.3f} s '
        f'(run_variant_qc_block {out["variant_qc_device_part_s"]:.3f} s; '
        f'{n_vds["hail_variant_qc"]} K5 launch); every counter of all '
        f'{n_rows} rows equals numpy')

    covs = [1.0] + [getattr(dense, f'c{i}') for i in range(K - 1)]
    for key in ('gwas_cold_s', 'gwas_warm_s'):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = hl.linear_regression_rows(y=dense.pheno,
                                        x=dense.GT.n_alt_alleles(),
                                        covariates=covs)
        b = [res._stage.partition_fn(c) for c in res._stage.contexts]
        out[key] = time.perf_counter() - t0
        calls = dict(_kernels.launches)
        if key == 'gwas_cold_s' and not calls['hail_unpack_gt_2bit']:
            raise AssertionError('the cold GWAS on the dense MatrixTable did '
                                 'not launch K4')
        if not calls['hail_linreg_exact_pass']:
            raise AssertionError(f'the GWAS on the dense MatrixTable did not '
                                 f'launch K3 ({key})')
        for name, v in calls.items():
            n_vds[name] += v
    got = np.stack([np.concatenate([np.asarray(x.columns[f].values, np.float64)
                                    for x in b])
                    for f in ('beta', 'standard_error', 't_stat')], axis=1)
    if got.shape[0] != n_rows:
        raise AssertionError(f'GWAS on the dense MatrixTable: {got.shape[0]} '
                             f'rows')
    want = numpy_ols((st['j'] + st['k'])[:CHECK_ROWS].astype(np.int32),
                     unc[:CHECK_ROWS], t['cols_np'])
    np.testing.assert_allclose(got[:CHECK_ROWS], want, rtol=1e-10,
                               err_msg='GWAS on the dense MatrixTable vs '
                                       'numpy f64 OLS')
    log(f'linear_regression_rows on the dense MatrixTable ({n_rows} rows): '
        f'cold {out["gwas_cold_s"]:.3f} s, warm {out["gwas_warm_s"]:.3f} s; '
        f'beta/se/t of {CHECK_ROWS} rows match numpy f64 OLS at rtol 1e-10; '
        f'launches: K4 {n_vds["hail_unpack_gt_2bit"]}, K3 '
        f'{n_vds["hail_linreg_exact_pass"]}')
    del dense, vq, res, vds, split
    out['family'] = phase_family(hl, sim, rng)
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'VDS and family methods: the phase took {out["phase_s"]:.1f} s')
    return out, n_vds


GWAS_FIELDS = ('beta', 'standard_error', 't_stat', 'p_value')


def gwas_rows(hl, mt):
    """linear_regression_rows with phase_gwas's covariates [1, c0, c1, c2]
    over `mt`: its rows as an (R, 4) array of GWAS_FIELDS."""
    res = hl.linear_regression_rows(
        y=mt.pheno, x=mt.GT.n_alt_alleles(),
        covariates=[1.0] + [getattr(mt, f'c{i}') for i in range(K - 1)])
    batches = res._stage.collect_batches()
    return np.stack([np.concatenate([np.asarray(b.columns[f].values,
                                                np.float64) for b in batches])
                     for f in GWAS_FIELDS], axis=1)


def check_gwas_slice(got, want, nalt, miss, cols_np, what):
    """`got` equals `want` (phase_gwas's rows) bit for bit, and its first
    CHECK_ROWS rows equal numpy's f64 OLS at rtol 1e-10."""
    if got.shape != want.shape:
        raise AssertionError(f'{what}: {got.shape} rows, want {want.shape}')
    if not np.array_equal(got, want):
        bad = np.argwhere(got != want)
        raise AssertionError(f'{what}: {len(bad)} values differ from '
                             f'phase_gwas\'s, first at {bad[0].tolist()}')
    np.testing.assert_allclose(got[:CHECK_ROWS, :3],
                               numpy_ols(nalt[:CHECK_ROWS], miss[:CHECK_ROWS],
                                         cols_np), rtol=1e-10,
                               err_msg=f'{what} vs numpy f64 OLS')


def phase_batch(hl, mt, want, nalts, misses, cols_np):
    """The `batch` pipeline DSL on its LocalBackend at the default
    max_parallel_jobs: BATCH_JOBS PythonJobs, each a GWAS over one slice of
    2,048 variants of the main MatrixTable's first partition (10,000
    samples, covariates [1, c0, c1, c2]), run in threads of this process,
    so that K4 and K3 launch from four threads sharing the card, the
    device cache and the session; a BashJob that reads a file the first
    job wrote; a gathering PythonJob that depends on all four. The gathered
    rows must equal phase_gwas's rows of that partition (`want`) bit for
    bit. Returns (figures, launches, the gathered rows)."""
    import tempfile
    from hail_tpu_torch.ops import _kernels, devcache
    part0 = mt._filter_partitions([0])
    pos0 = 10_000
    n = want.shape[0] // BATCH_JOBS

    def gwas_slice(k, out_path=None):
        lo = pos0 + k * n
        sub = part0.filter_rows((part0.locus.position >= lo)
                                & (part0.locus.position < lo + n))
        rows = gwas_rows(hl, sub)
        if out_path is not None:
            with open(out_path, 'w') as f:
                f.write(f'{rows.shape[0]} {float(rows[0, 0])!r}\n')
        return rows

    gathered = {}

    def gather(summary_file, *parts):
        with open(summary_file) as f:
            n_rows, beta0 = f.read().split()
        if (int(n_rows), float(beta0)) != (parts[0].shape[0], parts[0][0, 0]):
            raise AssertionError(f'the BashJob read {n_rows} {beta0}')
        gathered['rows'] = np.concatenate(parts)
        return list(gathered['rows'].shape)

    b = hl.batch.Batch(name='gwas-slices')
    jobs = [b.new_python_job(f'gwas-{k}') for k in range(BATCH_JOBS)]
    parts = [j.call(gwas_slice, k, j.summary if k == 0 else None)
             for k, j in enumerate(jobs)]
    bash = b.new_job('read-summary').timeout(QOB_TIMEOUT_S)
    bash.command(f'cat {jobs[0].summary} > {bash.summary}')
    g = b.new_python_job('gather')
    g.depends_on(*jobs)
    shape = g.call(gather, bash.summary, *parts)
    with tempfile.TemporaryDirectory() as d:
        dest = f'{d}/shape.json'
        b.write_output(shape.as_json(), dest)
        _kernels.reset_launch_counts()
        stats0 = devcache.stats()
        t0 = time.perf_counter()
        run = b.run()
        seconds = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        with open(dest) as f:
            out_shape = json.load(f)
    stats1 = devcache.stats()
    status = run.status()
    if status != {'state': 'success', 'n_jobs': BATCH_JOBS + 2,
                  'n_failed': 0}:
        raise AssertionError(f'the pipeline ended {status}: {run.errors()}')
    if out_shape != list(want.shape):
        raise AssertionError(f'gathered {out_shape}, want {want.shape}')
    got = gathered['rows']
    check_gwas_slice(got, want, nalts[0], misses[0], cols_np,
                     'the pipeline\'s gathered rows')
    if launches['hail_unpack_gt_2bit'] != BATCH_JOBS or \
            launches['hail_linreg_exact_pass'] < BATCH_JOBS:
        raise AssertionError(f'the pipeline\'s jobs launched {launches}')
    cache = {k: stats1[k] - stats0[k] for k in ('hits', 'misses')
             if k in stats0}
    log(f'batch DSL: {BATCH_JOBS} GWAS jobs of {n} variants x '
        f'{cols_np["pheno"].shape[0]} samples, a BashJob and a gathering job '
        f'on the LocalBackend in {seconds:.3f} s; the {want.shape[0]} '
        f'gathered rows equal phase_gwas\'s bit for bit, and {CHECK_ROWS} '
        f'equal numpy f64 OLS at rtol 1e-10; K4 {launches["hail_unpack_gt_2bit"]}'
        f' and K3 {launches["hail_linreg_exact_pass"]} launches from the '
        f'jobs\' threads; devcache {cache} over the run')
    return (dict(seconds=seconds, jobs=BATCH_JOBS + 2, variants_per_job=n,
                 devcache=cache), launches, got)


def shipped_mt(mt):
    """`mt` (a MatrixTable of in-memory batches) rebuilt so that each
    partition travels in its context: a job of the service backend is
    handed its own partition and no other."""
    from hail_tpu_torch.matrixtable import MatrixStage, MatrixTable
    st = mt._stage
    batches = [st.partition_fn(c) for c in st.contexts]
    return MatrixTable(MatrixStage(
        st.globals, st.cols, st.row_key, st.col_key, st.row_type,
        st.col_type, st.entry_type, batches, lambda batch: batch,
        uid_bases=list(np.cumsum([0] + [b.n_rows for b in batches[:-1]]))))


def phase_qob(hl, dev, want, nalts, misses, cols_np):
    """Query-on-Batch: the slices of phase_batch as the four partitions of a
    MatrixTable built afresh (so that no memo answers its partitions), each
    in its job's context, under `hl.init(backend='service')` with
    QOB_WORKERS worker slots and the driver on the card. Its partitions are
    made by four jobs in worker processes that see no card and load
    neither jax nor hail_tpu (a probe stage asks each); the GWAS (K4, K3)
    runs in this, the driver's, process. The rows must equal
    phase_batch's. Restores the local backend. Returns (figures,
    launches)."""
    import os
    from hail_tpu_torch.backend.service_backend import ServiceBackend
    from hail_tpu_torch.ops import _kernels
    t_phase = time.perf_counter()
    n = want.shape[0] // BATCH_JOBS
    parts = [dict(nalt=nalts[0][k * n:(k + 1) * n],
                  miss=misses[0][k * n:(k + 1) * n], contig=0,
                  pos=np.arange(k * n, (k + 1) * n, dtype=np.int32) + 10_000)
             for k in range(BATCH_JOBS)]
    out = {}
    hl.stop()
    hl.init(backend='service', device=str(dev), n_threads=QOB_WORKERS,
            global_seed=0, quiet=True, stage_timeout=QOB_TIMEOUT_S)
    try:
        pin_mesh([dev])
        be = hl.current_backend()
        if not isinstance(be, ServiceBackend):
            raise AssertionError(f'backend {type(be).__name__}')
        t0 = time.perf_counter()
        fresh = shipped_mt(calls_mt(parts, cols_np['pheno'].shape[0], cols_np))
        out['build_s'] = time.perf_counter() - t0
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = gwas_rows(hl, fresh)
        out['gwas_s'] = time.perf_counter() - t0
        del fresh
        launches = dict(_kernels.launches)
        stages = be._counter
        jobs = [j for bid in range(1, stages + 1)
                for j in be.client.list_jobs(bid)]
        out['stages'], out['jobs'] = stages, len(jobs)
        if stages != 1 or len(jobs) != BATCH_JOBS or any(
                j['state'] != 'Success' for j in jobs):
            raise AssertionError(f'the GWAS ran {stages} stages of jobs: '
                                 f'{[j["state"] for j in jobs]}')
        out['drain'] = dict(be._drain_stats)
        out['job_s'] = sorted(j['duration'] / 1e3 for j in jobs
                              if j.get('duration') is not None)

        def probe(c):
            import os as o
            import sys as s
            import torch as t
            return (o.getpid(), t.cuda.is_available(),
                    o.environ.get('CUDA_VISIBLE_DEVICES'),
                    [m for m in ('jax', 'hail_tpu') if m in s.modules])

        t0 = time.perf_counter()
        seen = be.map_collect(list(range(QOB_WORKERS)), probe)
        out['probe_stage_s'] = time.perf_counter() - t0
        probe_jobs = be.client.list_jobs(be._counter)
        out['worker_start_s'] = sorted(
            j['duration'] / 1e3 for j in probe_jobs
            if j.get('duration') is not None)
    finally:
        hl.stop()
        hl.init(device=str(dev), global_seed=0, quiet=True)
        pin_mesh([dev])
    if [s[1:] for s in seen] != [(False, '', [])] * QOB_WORKERS or \
            os.getpid() in {s[0] for s in seen}:
        raise AssertionError(f'the workers saw: {seen}, driver pid '
                             f'{os.getpid()}')
    if not (launches['hail_unpack_gt_2bit'] and
            launches['hail_linreg_exact_pass']):
        raise AssertionError(f'the QoB GWAS launched {launches} in the driver')
    check_gwas_slice(got, want, nalts[0], misses[0], cols_np,
                     'the QoB GWAS')
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'QoB: hl.init(backend=\'service\') with {QOB_WORKERS} worker slots; '
        f'the GWAS over {BATCH_JOBS} partitions of {n} variants, each in its '
        f'job\'s context, in {out["stages"]} stage of {out["jobs"]} jobs took '
        f'{out["gwas_s"]:.3f} s (jobs ran {out["job_s"]} s, drain '
        f'{out["drain"]}); K4 {launches["hail_unpack_gt_2bit"]} and K3 '
        f'{launches["hail_linreg_exact_pass"]} launches in the driver; its '
        f'rows equal phase_batch\'s bit for bit; a probe stage of '
        f'{QOB_WORKERS} jobs took {out["probe_stage_s"]:.3f} s (workers '
        f'{out["worker_start_s"]} s from start to exit): every worker in '
        f'another process, no CUDA, CUDA_VISIBLE_DEVICES empty, no jax and '
        f'no hail_tpu loaded')
    return out, launches


def phase_cli(dev):
    """`python -m hail_tpu_torch devices` in a subprocess names the card
    (`backend: cpu` in a rehearsal on the CPU)."""
    import os
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-m', 'hail_tpu_torch', 'devices'],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    want = (f'backend: cuda\n  cuda:0 {torch.cuda.get_device_name(0)}\n'
            if dev.type == 'cuda' else 'backend: cpu\n')
    if r.returncode != 0 or not r.stdout.startswith(want):
        raise AssertionError(f'devices: rc {r.returncode}, {r.stdout!r} '
                             f'{r.stderr[-2000:]!r}')
    seconds = time.perf_counter() - t0
    log(f'cli: python -m hail_tpu_torch devices in {seconds:.3f} s -> '
        + ' | '.join(r.stdout.strip().splitlines()))
    return dict(seconds=seconds, devices=r.stdout.strip())


# ---------------------------------------------------------------------------
# the packed-call routes (K6) and the drop-in (phase_packed_calls,
# phase_dropin)
# ---------------------------------------------------------------------------

def _glm_fits(dev, G, miss, cov, yb, yc):
    """ops/regression's fits on `dev`: the logistic null fit, then
    glm_per_variant_fit with both links, glm_score_test and the full Firth
    fit from the null start. Returns {name: tuple of numpy results}."""
    from hail_tpu_torch.ops import regression as rg

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k = cov.shape[1]
    G, miss, cov, yb, yc = t(G), t(miss), t(cov), t(yb), t(yc)
    null = rg.logreg_null_fit(cov, yb)
    pois0 = torch.zeros(k, dtype=torch.float64, device=dev)
    pois0[0] = torch.log(yc.mean())
    start = torch.cat([null[0].expand(G.shape[0], k),
                       torch.zeros((G.shape[0], 1), dtype=torch.float64,
                                   device=dev)], dim=1)
    out = {'logreg_null_fit': null,
           'glm_per_variant_fit logistic': rg.glm_per_variant_fit(
               G, miss, cov, yb, null[0], link='logistic'),
           'glm_per_variant_fit poisson': rg.glm_per_variant_fit(
               G, miss, cov, yc, pois0, link='poisson'),
           'glm_score_test': rg.glm_score_test(G, miss, cov, yb, null[0]),
           'firth_fit': rg.firth_fit(G, miss, cov, yb, start, k + 1)}
    torch.cuda.synchronize()
    return {name: tuple(np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                   else v) for v in res)
            for name, res in out.items()}


def phase_packed_calls(hl, dev, nalts, misses, cols_np, want_rows):
    """The packed-call routes at bench.py's headline shape (10,000 samples
    x 4 x 8,192 variants, covariates [1, c0, c1, c2]): K6 against its plain
    version bit for bit in both modes on every partition's calls, and timed
    (CUDA events) beside a `Tensor.copy_` of the same bytes; then, the
    counts set to 0, `linreg_stats_call_exact` (K6, K3) and
    `linreg_stats_call` (K6 as G8, K1) over the 4 partitions from the calls
    resident on the card: the exact rows equal `want_rows` (phase_gwas's
    `linear_regression_rows` rows, K4 and K3 on the same pairs) bit for
    bit, the f32 rows' beta, standard error and p within rtol 2e-4, atol
    1e-6 of them. Then ops/
    regression's fits over the first PACKED_GLM_ROWS variants on the card
    against their plain f64 run on the CPU (rtol 1e-9, n_iter and flags
    equal), and `dryrun_multichip(4)` on 4 slots of the card. Returns
    (figures, the routes' launches, K6's kernel record, K6's launches per
    call of a route on one partition)."""
    from hail_tpu_torch.genetics.call import pack_diploid
    from hail_tpu_torch.ops import _kernels, linreg_i8 as li
    from hail_tpu_torch.parallel.dryrun import dryrun_multichip
    t_phase = time.perf_counter()
    calls = []
    for nalt, miss in zip(nalts, misses):
        gt = pack_diploid((nalt == 2).astype(np.int32),
                          (nalt >= 1).astype(np.int32))
        calls.append((torch.from_numpy(gt).to(dev),
                      torch.from_numpy(miss).to(dev)))
    # K6 against its plain version, both modes, every partition
    for i, (p, m) in enumerate(calls):
        gz8, m8 = li.decode_packed_gt(p, m)
        G8 = li.decode_packed_g8(p, m)
        gz8_p, m8_p = li._decode_plain(p, m)
        G8_p = li._decode_plain(p, m, True)
        torch.cuda.synchronize()
        if not (torch.equal(gz8, gz8_p) and torch.equal(m8, m8_p)
                and torch.equal(G8, G8_p)):
            raise AssertionError(f'K6 on partition {i}: differs from its '
                                 'plain version')
        if i == 0 and not np.array_equal(gz8.cpu().numpy(),
                                         np.where(misses[0], 0, nalts[0])):
            raise AssertionError('K6: gz8 differs from the numpy decode')
    del gz8, m8, G8, gz8_p, m8_p, G8_p
    p0, m0 = calls[0]
    ms, plain_ms = compare_times(lambda: li.decode_packed_gt(p0, m0),
                                 lambda: li._decode_plain(p0, m0))
    g8_ms, g8_plain_ms = compare_times(
        lambda: li.decode_packed_g8(p0, m0),
        lambda: li._decode_plain(p0, m0, True))
    R, N = p0.shape
    # bytes: the int32 call and the bool mask in, the pair (2 B) or G8
    # (1 B) out; its dozen integer operations per entry are far below any
    # rate. Beside it, never called by the port: a device copy of the same
    # bytes, half read and half written, the rate a stream reaches here
    pair_bytes, g8_bytes = 7 * R * N, 6 * R * N
    src = torch.empty(pair_bytes // 2, dtype=torch.int8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = timed_ms(lambda: dst.copy_(src))
    del src, dst
    g8_bound = bound(g8_bytes)
    log(f'K6 decode_packed_gt {R} x {N}: both modes bit-equal to the plain '
        f'version on {len(calls)} partitions; pair {ms:.4f} ms (plain {plain_ms:.4f}), '
        f'G8 {g8_ms:.4f} ms (plain {g8_plain_ms:.4f}, bound '
        f'{g8_bound["bound_ms"]:.4f}, share '
        f'{g8_bound["bound_ms"] / g8_ms:.3f}); Tensor.copy_ of '
        f'{pair_bytes / 1e6:.1f} MB {copy_ms:.4f} ms')
    rec = record('decode_packed_gt', 'hail_tpu_torch/csrc/decode_gt.cu',
                 'hail_tpu/ops/linreg_i8.py:325', 0, ms, plain_ms,
                 bound(pair_bytes), copy_ms=copy_ms, g8_ms=g8_ms,
                 g8_plain_ms=g8_plain_ms, g8_bound_ms=g8_bound['bound_ms'])

    # the routes, from the calls on the card, counts from 0
    Q, Ys, Qty, yyp, dof = exact_setup(cols_np)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    exact = [li.linreg_stats_call_exact(None, None, Q, Ys, Qty, yyp, dof,
                                        packed_dev=p, missing_dev=m)
             for p, m in calls]
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32 = [li.linreg_stats_call(None, None, Q, Ys, Qty, yyp, dof,
                                packed_dev=p, missing_dev=m)
           for p, m in calls]
    f32_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    n_parts = len(calls)
    # K6 launches per call of a route on one partition
    k6_per_call = launches['hail_decode_packed_gt'] // (2 * n_parts)
    if (launches['hail_decode_packed_gt'] != 2 * n_parts
            or launches['hail_linreg_exact_pass'] != n_parts
            or launches['hail_linreg_i8_sums'] != n_parts
            or launches['hail_unpack_gt_2bit']):
        raise AssertionError(f'the packed-call routes launched {launches}')
    del calls
    got = np.concatenate([np.stack([e[f][:, 0] for f in GWAS_FIELDS], axis=1)
                          for e in exact])
    if got.shape != want_rows.shape or not np.array_equal(got, want_rows):
        bad = np.argwhere(got != want_rows)
        raise AssertionError(f'linreg_block_call_exact: {len(bad)} values '
                             'differ from linear_regression_rows\'s, first '
                             f'at {bad[:1].tolist()}')
    got32 = np.concatenate([np.stack([e[f][:, 0] for f in GWAS_FIELDS],
                                     axis=1) for e in f32])
    # beta, standard error and p: the f32 route's t near 0 is a quotient
    # of two f32 differences, and its error there is not bounded by a
    # fixed atol
    np.testing.assert_allclose(got32[:, [0, 1, 3]], got[:, [0, 1, 3]],
                               rtol=2e-4, atol=1e-6,
                               err_msg='linreg_block_call vs the exact rows')
    n_var = got.shape[0]
    log(f'packed-call routes over {n_var} variants x {N} samples: '
        f'linreg_stats_call_exact {n_var / exact_s:.1f} v/s, rows equal '
        f'linear_regression_rows\'s bit for bit; linreg_stats_call '
        f'{n_var / f32_s:.1f} v/s, beta, se and p within rtol 2e-4, '
        f'atol 1e-6 '
        f'of them; '
        f'launches {launches}')

    # ops/regression's fits: the card against plain f64 on the CPU
    r = PACKED_GLM_ROWS
    args = (nalts[0][:r].astype(np.float64), misses[0][:r],
            covariates(cols_np), cols_np['yb'], cols_np['yc'])
    t0 = time.perf_counter()
    card = _glm_fits(dev, *args)
    glm_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _glm_fits(torch.device('cpu'), *args)
    glm_cpu_s = time.perf_counter() - t0
    iters = {}
    for name, want in cpu.items():
        for j, (a, b) in enumerate(zip(card[name], want)):
            if b.dtype.kind == 'f':
                np.testing.assert_allclose(a, b, rtol=1e-9, equal_nan=True,
                                           err_msg=f'{name}[{j}] card vs cpu')
            elif not np.array_equal(a, b):
                raise AssertionError(f'{name}[{j}]: card {a} vs cpu {b}')
        if name != 'glm_score_test':
            iters[name] = int(card[name][-2 if name != 'logreg_null_fit'
                                         else 4])
    log(f'ops/regression over {r} variants x {N} samples: the card '
        f'{glm_card_s:.3f} s, plain f64 on the CPU {glm_cpu_s:.3f} s, equal '
        f'at rtol 1e-9 with n_iter and flags equal (n_iter {iters})')

    # the dry run on 4 slots of the card
    pin_mesh([dev] * 4)
    try:
        t0 = time.perf_counter()
        log(dryrun_multichip(4))
        dry_s = time.perf_counter() - t0
    finally:
        pin_mesh([dev])
    fig = dict(exact_variants_per_s=n_var / exact_s,
               f32_variants_per_s=n_var / f32_s, glm_card_s=glm_card_s,
               glm_cpu_s=glm_cpu_s, glm_n_iter=iters, dryrun_s=dry_s,
               phase_s=time.perf_counter() - t_phase)
    log(f'packed calls: the phase took {fig["phase_s"]:.1f} s')
    return fig, launches, rec, k6_per_call


DROPIN_PIPELINE = r"""
import json
import sys

import numpy as np
import hail as hl

hl.init(quiet=True)
mt = hl.read_matrix_table(sys.argv[1])
res = hl.linear_regression_rows(
    y=mt.pheno, x=mt.GT.n_alt_alleles(),
    covariates=[1.0, mt.c0, mt.c1, mt.c2])
rows = res.collect()
np.save(sys.argv[2], np.array([[r.beta, r.standard_error, r.t_stat,
                                r.p_value] for r in rows], np.float64))
# the port's launch counts, read where the drop-in put them
launches = sys.modules['hail_tpu_torch.ops._kernels'].launches
print('DROPIN ' + json.dumps({'hail': hl.__file__,
                              'device': str(hl.current_device()),
                              'launches': dict(launches)}))
"""


def phase_dropin(hl, dev, mt):
    """A Hail pipeline (`import hail as hl`, `hl.init()` naming no device,
    `hl.read_matrix_table`, `hl.linear_regression_rows`, collect) run
    unmodified through `python -m hail_tpu_torch.dropin` in a subprocess on
    the card, over the first DROPIN_VARIANTS variants of the main
    MatrixTable's first partition written in the native format: its rows
    equal the direct call's on the same file bit for bit, its `hail` is the
    drop-in's, and it launched K4 and K3. Returns (figures, its launches)."""
    import os
    import tempfile
    part0 = mt._filter_partitions([0])
    sub = part0.filter_rows(part0.locus.position < 10_000 + DROPIN_VARIANTS)
    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = f'{d}/gwas.mt'
        sub.write(path)
        want = gwas_rows(hl, hl.read_matrix_table(path))
        with open(f'{d}/pipeline.py', 'w') as f:
            f.write(DROPIN_PIPELINE)
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        # the pipeline's hl.init() takes the card; on a CPU rehearsal of
        # this script the drop-in is asked for the CPU
        device = ['--device', 'cpu'] if dev.type == 'cpu' else []
        res = subprocess.run(
            [sys.executable, '-m', 'hail_tpu_torch.dropin', *device,
             'pipeline.py', path, f'{d}/rows.npy'], cwd=d, env=env,
            capture_output=True, text=True, timeout=DROPIN_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f'the drop-in pipeline exited '
                                 f'{res.returncode}:\n{res.stderr[-4000:]}')
        got = np.load(f'{d}/rows.npy')
    line = [x for x in res.stdout.splitlines() if x.startswith('DROPIN ')]
    info = json.loads(line[-1][len('DROPIN '):])
    if not info['hail'].startswith(os.path.join(root, 'hail_tpu_torch',
                                                'dropin')):
        raise AssertionError(f'the pipeline imported hail from {info["hail"]}')
    if not info['device'].startswith(dev.type):
        raise AssertionError(f'the pipeline ran on {info["device"]}')
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f'the drop-in pipeline\'s {got.shape} rows '
                             f'differ from the direct call\'s {want.shape}')
    n = info['launches']
    if not (n['hail_unpack_gt_2bit'] and n['hail_linreg_exact_pass']):
        raise AssertionError(f'the pipeline launched {n}')
    fig = dict(pipeline_s=seconds, rows=int(got.shape[0]),
               phase_s=time.perf_counter() - t_phase)
    log(f'drop-in: `python -m hail_tpu_torch.dropin pipeline.py` on '
        f'{info["device"]} in {seconds:.1f} s; its {got.shape[0]} GWAS rows '
        f'equal the direct call\'s bit for bit; K4 '
        f'{n["hail_unpack_gt_2bit"]} and K3 {n["hail_linreg_exact_pass"]} '
        f'launches in it; the phase took {fig["phase_s"]:.1f} s')
    return fig, n


def run(dev, n_samples=N_SAMPLES, block_r=BLOCK_R, n_parts=N_PARTS,
        ibd_samples=IBD_SAMPLES, ibd_variants=IBD_VARIANTS):
    import hail_tpu_torch as hl
    from hail_tpu_torch.ops import _kernels
    from hail_tpu_torch.methods.relatedness import _gt_indicator_matrices

    t0 = time.perf_counter()
    if dev.type == 'cuda':
        _kernels.library()
    log(f'build: kernels ready in {time.perf_counter() - t0:.2f} s '
        f'(nvcc for sm_90a from hail_tpu_torch/csrc)')
    if dev.type == 'cuda':
        # the card's rate for the int8 and the 1-bit mma.sync, on which
        # K2's design and the one-bit rate of its bound rest
        for line in _kernels.run_bench('mma_rate'):
            log(f'mma_rate: {line}')
        # and its rate for f32 FFMAs outside the tensor cores, beside the
        # data sheet's (F32_FLOPS_PER_S) under K1's operations
        for line in _kernels.run_bench('ffma_rate'):
            log(f'ffma_rate: {line}')

    hl.init(device=str(dev), global_seed=0, quiet=True)
    # the phases before phase_distribution run on a mesh of this one card,
    # whatever the host has, so that their figures stay comparable
    pin_mesh([dev])
    # no partition retries: a failure in any partition fails the run
    hl._set_flags(max_partition_attempts='1')
    import scipy.stats  # noqa: F401  (set-up: the p-values import it once)
    rng = np.random.default_rng(SEED)
    mt, nalts, misses, cols_np = build_mt(hl, rng, n_samples, block_r,
                                          n_parts, with_pheno=True)
    mt_ibd, _, _, _ = build_mt(hl, rng, ibd_samples, ibd_variants, 1,
                               with_pheno=False)
    ibd_ind = _gt_indicator_matrices(mt_ibd.GT)[:4]

    records = phase_kernels(dev, (nalts, misses), cols_np, ibd_ind)

    # the main paths: each sets the counts to 0 before it drives its
    # method calls and reads them right after, so launches made to compare
    # a kernel with its plain version are not among them
    gwas, n_gwas, per_call, gwas_rows_all = phase_gwas(
        hl, mt, n_parts * block_r, nalts, misses, cols_np)
    gwas0 = gwas_rows_all[:block_r]
    gwas['linreg_stats_i8'], n_f32 = phase_linreg_f32(dev, nalts, misses,
                                                      cols_np)
    # the packed-call routes (K6, then K3 or K1) on the same calls, held to
    # the GWAS's rows; the GLM fits of ops/regression; the dry run; then a
    # pipeline through the drop-in in a subprocess
    gwas['packed_calls'], n_packed, k6, k6_per_call = phase_packed_calls(
        hl, dev, nalts, misses, cols_np, gwas_rows_all)
    del gwas_rows_all
    gwas['dropin'], n_dropin = phase_dropin(hl, dev, mt)
    glm, glm_s, n_glm = phase_glm(hl, mt, n_parts * block_r, nalts, misses,
                                  cols_np)
    # the BlockMatrix tier: ld_prune over the GWAS's cached pairs, then with
    # planted LD; the GRM and the other BlockMatrix methods over one
    # partition; ExactGrm's strips at bench.py's config 5
    ld, ld_calls = phase_ld_prune_gwas(hl, mt, n_parts * block_r, n_parts)
    ld['planted'], n_ld = phase_ld_prune_planted(hl, rng, n_samples)
    bm_methods, grm_strips = phase_blockmatrix_methods(
        hl, dev, mt._filter_partitions([0]), nalts[0], misses[0])
    pair = li_pair(dev, nalts[0], misses[0])
    device_ops = ld_device_ops(dev, *pair) + [phase_grm_strips(dev)]
    del pair
    per_launch = {'standardize_rows_device':
                      ld_calls['standardize_rows_device'],
                  '_band_block': ld_calls['_band_block'],
                  '_grm_strip': grm_strips}
    for op in device_ops:
        op['launches_per_call'] = per_launch[op['name']]
    ibd_rows, ibd_seconds, n_ibd = ibd_method(hl, mt_ibd)
    ibd = ibd_check(ibd_rows, ibd_seconds, mt_ibd, dev)
    del ibd_rows
    # relatedness and PCA on a MatrixTable written and read back, VCF out
    # and in, and the sorts of tables of more than one partition
    rel, rel_ops = phase_relatedness(hl, dev, rng)
    rel['vcf'] = phase_vcf(hl, mt_ibd)
    device_ops += rel_ops
    # QC: K5 on variant_qc's path, sample_qc, impute_sex, the entry-agg
    # device tier and split_multi_hts
    qc, k5, n_qc, agg_op = phase_qc(hl, dev, rng)
    records.append(k5)
    device_ops.append(agg_op)
    # the rest of statgen: the LMM, SKAT, ld_score, simulate_random_mating
    rest, rest_ops, sim = phase_statgen_rest(hl, dev, rng)
    device_ops += rest_ops
    # distribution: the sharded BlockMatrix, the device sort, the dry run
    # and the multihost backend
    dist, dist_ops = phase_distribution(hl, dev, rng)
    device_ops += dist_ops
    # the VariantDataset to a dense MatrixTable, then variant_qc (K5) and
    # the GWAS (K4, K3) on it; mendel_errors and the TDT on `sim`
    vds, n_vds = phase_vds(hl, dev, rng, sim)
    del sim
    # Query-on-Batch: the pipeline DSL's GWAS jobs in threads, then the
    # service backend with its workers off the card (it re-inits the
    # session, so it comes last), then the CLI
    t_qob = time.perf_counter()
    qob, n_batch, rows = phase_batch(hl, mt, gwas0, nalts, misses, cols_np)
    qob['service'], n_qob = phase_qob(hl, dev, rows, nalts, misses, cols_np)
    qob['cli'] = phase_cli(dev)
    qob['phases_s'] = time.perf_counter() - t_qob
    log(f'Query-on-Batch: the three phases took {qob["phases_s"]:.1f} s')
    per_call['hail_linreg_i8_sums'] = n_f32['hail_linreg_i8_sums']
    per_call['hail_ibs_counts'] = n_ibd['hail_ibs_counts']
    per_call['hail_variant_qc'] = n_qc['hail_variant_qc']
    per_call['hail_decode_packed_gt'] = k6_per_call
    records.append(k6)
    names = {'unpack_gt_2bit': 'hail_unpack_gt_2bit',
             'linreg_exact_pass': 'hail_linreg_exact_pass',
             'linreg_i8_sums': 'hail_linreg_i8_sums',
             'ibs_counts': 'hail_ibs_counts',
             'variant_qc': 'hail_variant_qc',
             'decode_packed_gt': 'hail_decode_packed_gt',
             'digit_planes': ('hail_digit_amax', 'hail_digit_planes')}
    for rec in records:
        c_names = names[rec['name']]
        if isinstance(c_names, str):
            c_names = (c_names,)
        rec['launches'] = sum(n[c] for c in c_names
                              for n in (n_gwas, n_f32, n_packed, n_dropin,
                                        n_glm, n_ld, n_ibd, n_qc, n_vds,
                                        n_batch, n_qob))
        rec['launches_per_call'] = sum(per_call[c] for c in c_names)
        if not rec['launches']:
            raise AssertionError(f'the main path never launched {rec["name"]}')
    log('launches on the method paths: ' + ', '.join(
        f'{r["name"]} {r["launches"]} ({r["launches_per_call"]} per call)'
        for r in records))
    import importlib.util
    mpl = importlib.util.find_spec('matplotlib') is not None
    log(f'hl.plot, hl.ggplot: host code over matplotlib (here '
        f'{"installed" if mpl else "not installed"}), not driven and not '
        'counted as passed; tests/test_torch_plot.py holds them to hail_tpu '
        'on the CPU')
    hl.stop()

    loaded = [m for m, mod in sys.modules.items() if mod is not None and (
        m in ('jax', 'hail_tpu') or m.startswith(('jax.', 'hail_tpu.')))]
    if loaded:
        raise AssertionError(f'modules of the reference were loaded: {loaded}')
    log('imports: no jax and no hail_tpu module loaded')
    return (records, device_ops, gwas, glm, glm_s, ibd, ld, bm_methods, rel,
            qc, rest, dist, vds, qob)


def li_pair(dev, nalt, miss):
    """One partition's (gz8, m8) pair on the card, as K4 makes it."""
    from hail_tpu_torch.genetics.call import pack_diploid
    from hail_tpu_torch.ops import linreg_i8 as li
    packed = pack_diploid((nalt == 2).astype(np.int32),
                          (nalt >= 1).astype(np.int32))
    u8 = torch.from_numpy(li.pack_gt_2bit(packed, miss)).to(dev)
    return li.unpack_gt_2bit(u8, nalt.shape[1])


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run needs '
              'an NVIDIA card', file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {name}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    (records, device_ops, gwas, glm, glm_s, ibd, ld, bm_methods, rel,
     qc, rest, dist, vds, qob) = run(dev)
    log(f'run: {time.perf_counter() - t0:.1f} s, the kernels\' build included')
    order = ('name', 'route', 'source', 'replaces', 'launches',
             'launches_per_call', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
             'bound_by', 'bound_unit', 'share_of_bound', 'library_ms')
    print(json.dumps({'gwas_variants_per_s': gwas,
                      'glm_variants_per_s': glm, 'glm_seconds': glm_s,
                      'ibd_seconds': ibd, 'ld_prune': ld,
                      'blockmatrix_methods': bm_methods,
                      'relatedness': rel, 'qc_seconds': qc,
                      'statgen_rest': rest, 'distribution': dist,
                      'vds': vds, 'query_on_batch': qob}))
    op_order = ('name', 'source', 'replaces', 'shape', 'launches_per_call',
                'ms', 'bound_ms', 'bound_by', 'bound_unit', 'share_of_bound',
                'yardstick', 'yardstick_ms')
    print(json.dumps({'device_ops': [
        {**{k: r[k] for k in op_order},
         **{k: v for k, v in r.items() if k not in op_order}}
        for r in device_ops]}))
    print(json.dumps({'kernels': [
        {**{k: r[k] for k in order},
         **{k: v for k, v in r.items() if k not in order}} for r in records]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
