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
It fails
(non-zero exit, no result line) when there is no card, when a kernel does
not build, launch or agree, when the main path did not launch every
kernel, or when the results disagree with numpy, the exact path or the
host GLM fits (stats/glmfit).

The last lines of stdout: the method rates as JSON, the kernels as JSON
(time, plain version's time, bound, share of the bound, launches on the
method paths and per call), the card's name and power limit as nvidia-smi
reports them, and
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import json
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

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates at the
# full 700 W): device memory, int8 on the tensor cores, f32 outside them.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
# No peak is published for one-bit operands. The card issues the 1-bit MMA
# (256 deep) at the rate of the int8 MMA (32 deep), which
# hail_tpu_torch/csrc/bench/mma_rate.cu measures in this run: eight times
# the int8 peak.
B1_OPS_PER_S = 8 * INT8_OPS_PER_S


def log(msg: str) -> None:
    print(msg, flush=True)


def build_mt(hl, rng, n_samples, block_r, n_parts, with_pheno):
    """A MatrixTable of packed GT calls in `n_parts` partitions, built as
    bench.py's build_mt builds it: uniform n_alt in {0,1,2}, 2% missing.
    Returns (mt, nalt blocks, missing blocks, column arrays)."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.call import pack_diploid
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ir.columns import (Batch, LocusColumn, ObjectColumn,
                                           PrimitiveColumn)
    from hail_tpu_torch.matrixtable import MatrixBatch, MatrixStage, MatrixTable
    rg = default_reference()
    mbs, nalts, misses = [], [], []
    for p in range(n_parts):
        nalt = rng.integers(0, 3, (block_r, n_samples)).astype(np.int32)
        miss = rng.random((block_r, n_samples)) < MISSING
        gt = pack_diploid((nalt == 2).astype(np.int32),
                          (nalt >= 1).astype(np.int32))
        pos = np.arange(p * block_r, (p + 1) * block_r, dtype=np.int32) + 10_000
        alleles = np.empty(block_r, dtype=object)
        alleles[:] = [['A', 'T']] * block_r
        rows = Batch({
            'locus': LocusColumn(ht.tlocus(rg), np.zeros(block_r, np.int32), pos),
            'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles),
        }, block_r)
        mbs.append(MatrixBatch(rows, {'GT': PrimitiveColumn(ht.tcall, gt, miss)}))
        nalts.append(nalt)
        misses.append(miss)
    col_fields = {'s': ObjectColumn(
        ht.tstr, np.asarray([f's{i}' for i in range(n_samples)], object))}
    col_t = {'s': ht.tstr}
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
        for name, v in cols_np.items():
            col_fields[name] = PrimitiveColumn(ht.tfloat64, v)
            col_t[name] = ht.tfloat64
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    mt = MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), Batch(col_fields, n_samples), ['locus', 'alleles'], ['s'],
        row_t, ht.tstruct(**col_t), ht.tstruct(GT=ht.tcall), mbs))
    return mt, nalts, misses, cols_np


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
    warm with every stats column on the host. Returns the rates."""
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
    want = numpy_ols(nalts[0][:CHECK_ROWS], misses[0][:CHECK_ROWS], cols_np)
    for j, f in enumerate(fields[:3]):
        np.testing.assert_allclose(got[f][:CHECK_ROWS], want[:, j], rtol=1e-10,
                                   err_msg=f'{f} vs numpy f64 OLS')
    log(f'GWAS {n_variants} variants x {cols_np["pheno"].shape[0]} samples: '
        f'cold {cold:.1f} v/s, warm {warm[0]:.1f} and {warm[1]:.1f} v/s, '
        f'host-materialized {host:.1f} v/s; beta/se/t of {CHECK_ROWS} rows '
        f'match numpy f64 OLS at rtol 1e-10; devcache {devcache.stats()}')
    per_call = {'hail_unpack_gt_2bit': cold_launches['hail_unpack_gt_2bit'],
                'hail_linreg_exact_pass':
                    warm_launches['hail_linreg_exact_pass']}
    launches = dict(_kernels.launches)
    return (dict(cold=cold, warm=warm, host_materialized=host,
                 cold_split=cold_split(run_count, n_variants),
                 warm_profile=profile_warm_call(run_count, n_variants)),
            launches, per_call)


def cold_split(run_count, n_variants):
    """One more cold call, the entry cache emptied first, with the steps of
    `statgen._ship_gt_pair` timed in each partition's thread: host packing
    (`pack_gt_2bit`), the host-to-device copy of the codes, and K4 with the
    stream drained before and after it (so its seconds include whatever
    another partition had queued). The partitions run in parallel threads,
    so the sums over partitions do not add up to the call; the slowest
    partition's three steps are on its critical path, and the rest of the
    call (the host plane, K3, the f64 epilogue, the count) is what is left
    beside them. Its launches are not among the main path's."""
    from hail_tpu_torch.methods import statgen
    from hail_tpu_torch.ops import devcache, linreg_i8 as li
    real = dict(pack=li.pack_gt_2bit, unpack=li.unpack_gt_2bit,
                ship=statgen._ship_gt_pair)
    spent = dict(pack=[], unpack=[], ship=[])

    def timed(name, drain):
        def fn(*a, **kw):
            if drain:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            if drain:
                torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)   # append is atomic
            return out
        return fn

    li.pack_gt_2bit = timed('pack', False)
    li.unpack_gt_2bit = timed('unpack', True)
    statgen._ship_gt_pair = timed('ship', False)
    try:
        devcache.clear()
        total = n_variants / run_count()
    finally:
        li.pack_gt_2bit, li.unpack_gt_2bit = real['pack'], real['unpack']
        statgen._ship_gt_pair = real['ship']
    n = len(spent['ship'])
    if not (n and len(spent['pack']) == len(spent['unpack']) == n):
        raise AssertionError(f'cold split: {n} partitions shipped, '
                             f'{len(spent["pack"])} packed, '
                             f'{len(spent["unpack"])} unpacked')
    pack, k4, ship = (sum(spent[k]) for k in ('pack', 'unpack', 'ship'))
    out = dict(call_s=total, partitions=n, pack_s=pack, h2d_s=ship - pack - k4,
               k4_s=k4, slowest_partition_s=max(spent['ship']),
               rest_s=total - max(spent['ship']))
    log(f'cold call split: {total:.3f} s; summed over {n} partitions in '
        f'threads: pack_gt_2bit {pack:.3f} s, host-to-device copy '
        f'{out["h2d_s"]:.3f} s, K4 with the stream drained around it '
        f'{k4:.4f} s; the slowest partition\'s three steps '
        f'{out["slowest_partition_s"]:.3f} s, the rest of the call '
        f'{out["rest_s"]:.3f} s')
    return out


def profile_warm_call(run_count, n_variants):
    """One more warm call under torch.profiler: the milliseconds the card
    was busy in it (the device time of its kernels and copies, summed), the
    exact pass's share of them, and the idle share of the call. None, with
    the reason logged, where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        with profile(activities=acts):          # the tracer's own start-up
            run_count()
        with profile(activities=acts) as p:
            call_ms = n_variants / run_count() * 1e3
            torch.cuda.synchronize()
    except RuntimeError as e:
        log(f'warm call profile: the profiler failed '
            f'({str(e).splitlines()[0]}); device busy time not measured')
        return None

    def device_us(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0))
    events = p.key_averages()
    busy_ms = sum(device_us(e) for e in events) / 1e3
    k3_ms = sum(device_us(e) for e in events if 'exact_pass' in e.key) / 1e3
    if not busy_ms:
        log('warm call profile: the profiler shows no device time; device '
            'busy time not measured')
        return None
    log(f'warm call profile: {call_ms:.3f} ms on the host clock (profiler on), '
        f'device busy {busy_ms:.3f} ms (idle share {1 - busy_ms / call_ms:.3f}), '
        f'of which the exact pass kernel {k3_ms:.3f} ms')
    return dict(call_ms=call_ms, device_busy_ms=busy_ms, exact_pass_ms=k3_ms,
                idle_share=1 - busy_ms / call_ms)


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


def _timing_device_tier(glm_device, spent):
    """Wrap the device tier's two entry functions so that each call
    appends its seconds to `spent` (from the partitions' threads:
    list.append is atomic); each ends in one device-to-host copy, so its
    wall time covers its device work. Returns the undo."""
    saved = {}
    for name in ('logistic_rows_device', 'poisson_rows_device'):
        fn = saved[name] = getattr(glm_device, name)

        def timed(*a, _fn=fn, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spent.append(time.perf_counter() - t0)
        setattr(glm_device, name, timed)
    return lambda: [setattr(glm_device, n, f) for n, f in saved.items()]


def phase_glm(hl, mt, n_variants, nalts, misses, cols_np):
    """The GLM device tier over the GWAS's cached entry pair: logistic wald
    at full width, lrt/score/firth and poisson wald over one partition;
    each holds its first rows to stats/glmfit. Returns variants/s and, for
    each call, its seconds and the seconds of its device-tier calls
    summed over partitions (which run in parallel threads)."""
    from hail_tpu_torch.ops import glm_device
    spent = []
    undo = _timing_device_tier(glm_device, spent)
    try:
        return _glm_calls(hl, mt, n_variants, nalts, misses, cols_np, spent)
    finally:
        undo()


def _glm_calls(hl, mt, n_variants, nalts, misses, cols_np, spent):
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
        spent.clear()
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
                                        device_tier_s=sum(spent))
        log(f'{method}_regression_rows {test} {n} variants x {cov.shape[0]} '
            f'samples: {rate:.1f} v/s ({total:.3f} s; device-tier calls '
            f'{sum(spent):.3f} s summed over {len(spent)} partitions); '
            f'{GLM_CHECK_ROWS} rows match '
            f'stats/glmfit (iterations and flags equal, rtol 1e-9)')
    launches = dict(_kernels.launches)
    if launches['hail_unpack_gt_2bit']:
        raise AssertionError('the GLM calls decoded GT again (K4 launched)')
    return rates, tier, launches


def ibd_method(hl, mt):
    """hl.identity_by_descent at 1,000 samples x 16,384 variants: the pair
    rows, the seconds of the call and its launches."""
    from hail_tpu_torch.ops import _kernels
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = hl.identity_by_descent(mt).collect()
    total = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    if not launches['hail_ibs_counts']:
        raise AssertionError('identity_by_descent did not launch K2')
    return rows, total, launches


def ibd_check(rows, total, mt, dev):
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
    log(f'IBD {n} samples x {het.shape[0]} variants: {len(rows)} pairs in '
        f'{total:.3f} s; K2 kernel {kernel_s:.4f} s, host (indicators, PLINK '
        f'epilogue, pair rows) {total - kernel_s:.3f} s; IBS matrices equal '
        f'the plain version')
    return dict(total_s=total, kernel_s=kernel_s, host_s=total - kernel_s)


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
    gwas, n_gwas, per_call = phase_gwas(hl, mt, n_parts * block_r, nalts,
                                        misses, cols_np)
    gwas['linreg_stats_i8'], n_f32 = phase_linreg_f32(dev, nalts, misses,
                                                      cols_np)
    glm, glm_s, n_glm = phase_glm(hl, mt, n_parts * block_r, nalts, misses,
                                  cols_np)
    ibd_rows, ibd_total, n_ibd = ibd_method(hl, mt_ibd)
    ibd = ibd_check(ibd_rows, ibd_total, mt_ibd, dev)
    per_call['hail_linreg_i8_sums'] = n_f32['hail_linreg_i8_sums']
    per_call['hail_ibs_counts'] = n_ibd['hail_ibs_counts']
    names = {'unpack_gt_2bit': 'hail_unpack_gt_2bit',
             'linreg_exact_pass': 'hail_linreg_exact_pass',
             'linreg_i8_sums': 'hail_linreg_i8_sums',
             'ibs_counts': 'hail_ibs_counts'}
    for rec in records:
        c_name = names[rec['name']]
        rec['launches'] = sum(n[c_name] for n in (n_gwas, n_f32, n_glm, n_ibd))
        rec['launches_per_call'] = per_call[c_name]
        if not rec['launches']:
            raise AssertionError(f'the main path never launched {rec["name"]}')
    log('launches on the method paths: ' + ', '.join(
        f'{r["name"]} {r["launches"]} ({r["launches_per_call"]} per call)'
        for r in records))
    hl.stop()

    loaded = [m for m, mod in sys.modules.items() if mod is not None and (
        m in ('jax', 'hail_tpu') or m.startswith(('jax.', 'hail_tpu.')))]
    if loaded:
        raise AssertionError(f'modules of the reference were loaded: {loaded}')
    log('imports: no jax and no hail_tpu module loaded')
    return records, gwas, glm, glm_s, ibd


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
    records, gwas, glm, glm_s, ibd = run(dev)
    order = ('name', 'route', 'source', 'replaces', 'launches',
             'launches_per_call', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
             'bound_by', 'bound_unit', 'share_of_bound', 'library_ms')
    print(json.dumps({'gwas_variants_per_s': gwas,
                      'glm_variants_per_s': glm, 'glm_seconds': glm_s,
                      'ibd_seconds': ibd}))
    print(json.dumps({'kernels': [
        {**{k: r[k] for k in order},
         **{k: v for k, v in r.items() if k not in order}} for r in records]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
