"""Exact f64-parity GWAS linreg at int8 speed (port of hail_tpu/ops/linreg_i8.py).

Genotypes are small integers, so every sum the OLS needs from G — Gᵀ[Q|Ys],
Mᵀ[Q|Ys], ΣG, ΣG², missing counts — is computed EXACTLY from int8 x int8
-> int32 products: the float64 operand W = [Q | Ys] is decomposed into 7
signed 7-bit digit planes with per-column power-of-two scales
(`_digit_planes`), stacked along W's column axis so G is read once, and the
int32 partials are recombined in f64. The OLS epilogue (the reference nd
formula, statgen.py:631, with algebraic mean imputation) runs in f64 torch
on the device.

Hand-written CUDA kernels carry the device part (csrc/):
- `unpack_gt_2bit` (K4): 2-bit wire codes -> the cached (gz8, m8) pair;
- `decode_packed_gt` / `decode_packed_g8` (K6): packed int32 calls and
  their missing mask -> the same pair, or the signed int8 G8 that K1
  reads; the packed-call routes (`linreg_block_call_exact`,
  `linreg_block_call` and their host wrappers `linreg_stats_call_exact`,
  `linreg_stats_call`) decode on the device with it;
- `exact_pass` (K3): GWd, MWd, nmiss, s, ss in one read of (gz8, m8);
- `digit_operand` (K7): W = [Q | Ys] f64 -> K3's operand, the digit planes
  of `_digit_planes` bit for bit, made on the device (`exact_consts`);
- `linreg_i8_sums` (K1): the f32 one-pass sums of `linreg_block_i8`, the
  int8-storage f32-compute OLS (`linreg_stats_i8`), from int8 G with
  -1 = missing.
Each has its plain torch version beside it (`_unpack_plain`,
`_decode_plain`, `_exact_pass_plain`, `_digit_planes_plain`, `_sums_ref`).
A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _kernels
from ..utils import timer

_EXACT_PLANES = 7
_DIGIT_BITS = 7
_MAX_EXACT_N = 8_000_000   # int32 accumulator: N·2·127 < 2³¹
# f32 accumulator of K1: the row sums ΣM, ΣGz, ΣGz² are integers, exact in
# f32 while below 2²⁴; with GT dosages ≤ 2, ΣGz² ≤ 4·N < 2²⁴
_MAX_F32_N = (1 << 22) - 1


def _column_base(amax: np.ndarray) -> np.ndarray:
    """Each column's block exponent from its max |w|: 2^ceil(log2(max)), 1
    for a zero column, in numpy's own rounding (the device route brings
    its maxima here, so that both routes take one base)."""
    amax = np.where(amax == 0, 1.0, amax)
    return np.exp2(np.ceil(np.log2(amax)))


def _plane_scales(base: np.ndarray, planes: int = _EXACT_PLANES,
                  bits: int = _DIGIT_BITS) -> np.ndarray:
    """The (planes, KP) f64 scales of the digit planes of columns of `base`."""
    mult = float(1 << bits)
    return np.stack([base / (mult ** (d_ + 1)) for d_ in range(planes)],
                    axis=0)


def _digit_planes(W: np.ndarray, planes: int = _EXACT_PLANES,
                  bits: int = _DIGIT_BITS):
    """Decompose f64 W (N, KP) into int8 digit planes stacked plane-major
    along axis 1 → (N, planes·KP), plus (planes, KP) f64 scales."""
    W = np.asarray(W, np.float64)
    base = _column_base(np.max(np.abs(W), axis=0))
    resid = W / base
    mult = float(1 << bits)
    digs = []
    for _ in range(planes):
        q = np.clip(np.rint(resid * mult), -127, 127)
        digs.append(q.astype(np.int8))
        resid = resid * mult - q
    return np.concatenate(digs, axis=1), _plane_scales(base, planes, bits)


def pack_gt_2bit(packed: np.ndarray, missing) -> np.ndarray:
    """Host: packed-call int32 (R, N) [+ missing bool] → 2-bit codes packed
    4-per-byte, uint8 (R, ceil(N/4)). Code ∈ {0,1,2} = n_alt_alleles, 3 =
    missing; the first entry sits in the low bits. The wire form of a
    linreg call's h2d copy: 0.25 B/entry instead of packed int32 + bool's 5.
    Bit layout of the reference Call encoding (variant/Call.scala:14-77)."""
    ploidy = packed & 3
    aj = (packed >> 3) & ((1 << 14) - 1)
    ak = (packed >> 17) & ((1 << 15) - 1)
    nalt = (((aj != 0) & (ploidy >= 1)).astype(np.uint8)
            + ((ak != 0) & (ploidy == 2)).astype(np.uint8))
    if missing is not None:
        nalt = np.where(missing, np.uint8(3), nalt)
    R, N = nalt.shape
    N4 = -(-N // 4)
    if N4 * 4 != N:
        nalt = np.concatenate(
            [nalt, np.zeros((R, N4 * 4 - N), np.uint8)], axis=1)
    v = nalt.reshape(R, N4, 4)
    return (v[:, :, 0] | (v[:, :, 1] << 2) | (v[:, :, 2] << 4)
            | (v[:, :, 3] << 6)).astype(np.uint8)


# ---------------------------------------------------------------------------
# K4: 2-bit unpack
# ---------------------------------------------------------------------------

def _unpack_plain(u8: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=u8.device)
    codes = (u8.unsqueeze(-1) >> shifts) & 3                # (R, N4, 4)
    codes = codes.reshape(u8.shape[0], -1)[:, :n].to(torch.int8)
    m8 = (codes == 3).to(torch.int8)
    return codes * (1 - m8), m8


def unpack_gt_2bit(u8: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device: 2-bit-packed codes uint8 (R, ceil(n/4)) → the cached
    (gz8, m8) int8 (R, n) pair (gz8 zero where missing)."""
    if u8.device.type == 'cpu':
        return _unpack_plain(u8, n)
    R, n4 = u8.shape
    if n4 != -(-n // 4):
        raise ValueError(f'unpack_gt_2bit: {n4} bytes per row cannot hold '
                         f'{n} codes')
    _kernels.check(u8, 'unpack_gt_2bit/u8', torch.uint8)
    gz8 = torch.empty((R, n), dtype=torch.int8, device=u8.device)
    m8 = torch.empty((R, n), dtype=torch.int8, device=u8.device)
    _kernels.launch('hail_unpack_gt_2bit', u8.data_ptr(), R, n4, n,
                    gz8.data_ptr(), m8.data_ptr(), rows=R, samples=n)
    return gz8, m8


# ---------------------------------------------------------------------------
# K6: device decode of packed calls
# ---------------------------------------------------------------------------

def _decode_plain(packed: torch.Tensor, missing, g8: bool = False):
    """Plain version of K6: the n_alt of each packed call (the bit layout of
    `pack_gt_2bit`), as the (gz8, m8) pair or, with `g8`, as G8 (-1 where
    missing). `missing` None: no entry is missing."""
    ploidy = packed & 3
    aj = (packed >> 3) & ((1 << 14) - 1)
    ak = (packed >> 17) & ((1 << 15) - 1)
    nalt = (((aj != 0) & (ploidy >= 1)).to(torch.int8)
            + ((ak != 0) & (ploidy == 2)).to(torch.int8))
    if missing is None:
        return nalt if g8 else (nalt, torch.zeros_like(nalt))
    if g8:
        return torch.where(missing, -1, nalt).to(torch.int8)
    m8 = missing.to(torch.int8)
    return nalt * (1 - m8), m8


def _decode(packed: torch.Tensor, missing, g8: bool):
    if packed.device.type == 'cpu':
        return _decode_plain(packed, missing, g8)
    _kernels.check(packed, 'decode_packed_gt/packed', torch.int32)
    if packed.dim() != 2:
        raise ValueError(f'decode_packed_gt: packed is (R, N), got shape '
                         f'{tuple(packed.shape)}')
    if missing is not None:
        _kernels.check(missing, 'decode_packed_gt/missing', torch.bool,
                       packed.shape)
    out0 = torch.empty(packed.shape, dtype=torch.int8, device=packed.device)
    out1 = None if g8 else torch.empty_like(out0)
    _kernels.launch('hail_decode_packed_gt', packed.data_ptr(),
                    None if missing is None else missing.data_ptr(),
                    packed.numel(), out0.data_ptr(),
                    None if g8 else out1.data_ptr(), int(g8),
                    rows=packed.shape[0], samples=packed.shape[1])
    return out0 if g8 else (out0, out1)


def decode_packed_gt(packed: torch.Tensor, missing=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: packed int32 calls (R, N) in the genetics.call layout (ploidy
    bits [0:2), allele j [3:17), allele k [17:32)) and their bool (R, N)
    missing mask (None: none missing) -> the cached (gz8, m8) int8 pair:
    2 bytes an entry in device memory instead of the packed call's 5."""
    return _decode(packed, missing, False)


def decode_packed_g8(packed: torch.Tensor, missing=None) -> torch.Tensor:
    """K6 in its second mode: the signed int8 G8 (R, N), n_alt and -1 where
    missing, the operand of K1 (`linreg_i8_sums`)."""
    return _decode(packed, missing, True)


# ---------------------------------------------------------------------------
# K3: exact pass
# ---------------------------------------------------------------------------

def _exact_pass_plain(gz8: torch.Tensor, m8: torch.Tensor, Wdig: torch.Tensor):
    # Not int8 products: torch.mm on int8 returns int8 and wraps around, and
    # CUDA has no integer matmul. In f64 every product and partial sum is an
    # integer below 2³¹ < 2⁵³, so the products and the int32 cast are exact.
    W64 = Wdig.to(torch.float64)
    gz32 = gz8.to(torch.int32)
    m32 = m8.to(torch.int32)
    return ((gz8.to(torch.float64) @ W64).to(torch.int32),
            (m8.to(torch.float64) @ W64).to(torch.int32),
            m32.sum(dim=1, dtype=torch.int32),
            gz32.sum(dim=1, dtype=torch.int32),
            (gz32 * gz32).sum(dim=1, dtype=torch.int32))


class ExactOperand(NamedTuple):
    """The right-hand operand of the exact pass, one per phenotype group.

    Wdig (N, C) int8: the digit planes of W = [Q | Ys] (`_digit_planes`).
    WT (Cp, ldw) int8: K3's layout of them, WT[:C, :N] = Wdig.T, row C all
    ones over the N samples (its products are the row sums of gz8 and m8)
    and zeros elsewhere; Cp = 8·(C // 8 + 1) whole MMA column tiles, ldw a
    multiple of 16 >= N, so that the samples of a column are contiguous and
    every row starts 16-byte aligned. `exact_operand` makes the pair; a
    change to one tensor in place is not seen by the other."""
    Wdig: torch.Tensor
    WT: torch.Tensor


def exact_operand(Wdig: torch.Tensor) -> ExactOperand:
    """Wdig (N, C) int8 with its kernel layout, built here once."""
    N, C = Wdig.shape
    WT = torch.zeros(((C // 8 + 1) * 8, -(-N // 16) * 16), dtype=torch.int8,
                     device=Wdig.device)
    WT[:C, :N] = Wdig.t()
    WT[C, :N] = 1
    return ExactOperand(Wdig, WT)


# ---------------------------------------------------------------------------
# K7: the digit planes on the device
# ---------------------------------------------------------------------------

def _digit_planes_plain(Q: torch.Tensor, Ys: torch.Tensor):
    """Plain version of K7: `_digit_planes` of [Q | Ys] in torch, bit-equal
    (torch.round rounds half to even as np.rint does; the maxima go
    through `_column_base`). (Wdig (N, C) int8 tensor, scales numpy)."""
    W = torch.cat([Q, Ys], dim=1)
    base = _column_base(W.abs().amax(dim=0).cpu().numpy())
    resid = W / torch.from_numpy(base).to(W.device)
    mult = float(1 << _DIGIT_BITS)
    digs = []
    for _ in range(_EXACT_PLANES):
        x = resid * mult
        q = torch.round(x).clamp(-127, 127)
        digs.append(q.to(torch.int8))
        resid = x - q
    return torch.cat(digs, dim=1), _plane_scales(base)


def _digit_amax(Q: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """K7's first launch: max |w| of each column of [Q | Ys], (KP,) f64 on
    the device."""
    amax = torch.zeros(Q.shape[1] + Ys.shape[1], dtype=torch.float64,
                       device=Q.device)
    _kernels.launch('hail_digit_amax', Q.data_ptr(), Q.shape[1],
                    Ys.data_ptr(), Ys.shape[1], Q.shape[0], amax.data_ptr(),
                    rows=Q.shape[0], cols=amax.shape[0])
    return amax


def _digit_launch(Q: torch.Tensor, Ys: torch.Tensor,
                  base: torch.Tensor) -> ExactOperand:
    """K7's second launch: the operand of [Q | Ys] from each column's
    power of two `base` (KP,) f64 on the device."""
    N, KP = Q.shape[0], Q.shape[1] + Ys.shape[1]
    _kernels.check(base, 'digit_planes/base', torch.float64, (KP,))
    C = _EXACT_PLANES * KP
    Cp, ldw = (C // 8 + 1) * 8, -(-N // 16) * 16
    Wdig = torch.empty((N, C), dtype=torch.int8, device=Q.device)
    WT = torch.empty((Cp, ldw), dtype=torch.int8, device=Q.device)
    _kernels.launch('hail_digit_planes', Q.data_ptr(), Q.shape[1],
                    Ys.data_ptr(), Ys.shape[1], N, base.data_ptr(),
                    Wdig.data_ptr(), WT.data_ptr(), ldw, Cp, rows=N, cols=KP)
    return ExactOperand(Wdig, WT)


def digit_operand(Q: torch.Tensor, Ys: torch.Tensor):
    """K7: the `ExactOperand` of W = [Q | Ys] (Q (N, k), Ys (N, P) f64 on
    one device) and its (planes, KP) f64 numpy scales, bit for bit those of
    `exact_operand(_digit_planes(W))`. On the card two launches with one
    small fetch between them: the column maxima come to the host, whose
    numpy makes the bases and scales; nothing per entry leaves the
    device."""
    if Q.dim() != 2 or Ys.dim() != 2 or Q.shape[0] != Ys.shape[0]:
        raise ValueError(f'digit_operand: Q (N, k) and Ys (N, P), got '
                         f'{tuple(Q.shape)} and {tuple(Ys.shape)}')
    if Q.shape[0] == 0:
        raise ValueError('digit_operand: no samples')
    if Q.device.type == 'cpu':
        Wdig, scales = _digit_planes_plain(Q, Ys)
        return exact_operand(Wdig), scales
    _kernels.check(Q, 'digit_planes/Q', torch.float64)
    _kernels.check(Ys, 'digit_planes/Ys', torch.float64)
    if Ys.device != Q.device:
        raise ValueError(f'digit_operand: Q on {Q.device}, Ys on {Ys.device}')
    base = _column_base(_digit_amax(Q, Ys).cpu().numpy())
    W = _digit_launch(Q, Ys, torch.from_numpy(base).to(Q.device))
    return W, _plane_scales(base)


def exact_pass(gz8: torch.Tensor, m8: torch.Tensor, W: ExactOperand):
    """One pass over (gz8, m8) int8 (R, N) against W.Wdig int8 (N, C):
    (GWd, MWd) int32 (R, C) and (nmiss, s, ss) int32 (R,). The kernel reads
    W.WT and allocates nothing but its outputs."""
    R, N = gz8.shape
    if N > _MAX_EXACT_N:
        raise ValueError(f'exact linreg: {N} samples exceed the int32 '
                         f'accumulator bound {_MAX_EXACT_N}')
    Wdig, WT = W
    if gz8.device.type == 'cpu':
        return _exact_pass_plain(gz8, m8, Wdig)
    C = Wdig.shape[1]
    _kernels.check(gz8, 'exact_pass/gz8', torch.int8)
    _kernels.check(m8, 'exact_pass/m8', torch.int8, (R, N))
    _kernels.check(Wdig, 'exact_pass/Wdig', torch.int8, (N, C))
    _kernels.check(WT, 'exact_pass/WT', torch.int8,
                   ((C // 8 + 1) * 8, -(-N // 16) * 16))
    dev = gz8.device
    GWd = torch.empty((R, C), dtype=torch.int32, device=dev)
    MWd = torch.empty((R, C), dtype=torch.int32, device=dev)
    nmiss, s, ss = (torch.empty(R, dtype=torch.int32, device=dev)
                    for _ in range(3))
    _kernels.launch('hail_linreg_exact_pass', gz8.data_ptr(), m8.data_ptr(),
                    WT.data_ptr(), WT.shape[1], R, N, C, WT.shape[0],
                    GWd.data_ptr(), MWd.data_ptr(), nmiss.data_ptr(),
                    s.data_ptr(), ss.data_ptr(), rows=R, samples=N, cols=C)
    return GWd, MWd, nmiss, s, ss


def _exact_core(gz8, m8, W, scales, Qty, yyp, d, k):
    """gz8 (R,N) int8 zero-at-missing genotypes, m8 (R,N) int8 missing
    indicators; the group's constants as `exact_consts` returns them (W an
    `ExactOperand`, the others f64). Returns (sum_x, ytx, beta, se, t) f64."""
    partials = exact_pass(gz8, m8, W)
    with timer.span('part.epilogue'):
        return _exact_epilogue(*partials, gz8.shape[1], scales, Qty, yyp, d,
                               k)


def _exact_epilogue(GWd, MWd, nmiss_i, s_i, ss_i, N, scales, Qty, yyp, d, k):
    """f64 recombine of the exact pass's int32 partials, then the OLS."""
    R = GWd.shape[0]
    KP = GWd.shape[1] // _EXACT_PLANES
    # recombine digit partials in f64: (R, planes, KP) · (planes, KP) → (R, KP)
    GW = (GWd.reshape(R, _EXACT_PLANES, KP).to(torch.float64)
          * scales).sum(dim=1)
    MW = (MWd.reshape(R, _EXACT_PLANES, KP).to(torch.float64)
          * scales).sum(dim=1)
    nmiss = nmiss_i.to(torch.float64)
    s = s_i.to(torch.float64)
    ss = ss_i.to(torch.float64)
    # f64 epilogue — the reference nd formula with algebraic mean imputation
    cnt = float(N) - nmiss
    mean = s / cnt                                 # 0/0 → nan, as reference
    GiW = GW + mean[:, None] * MW
    GQ = GiW[:, :k]
    ytx = GiW[:, k:]
    sum_x = s + mean * nmiss
    xyp = ytx - GQ @ Qty
    xxp = ss + mean * mean * nmiss - (GQ * GQ).sum(dim=1)
    rec = 1.0 / xxp
    beta = xyp * rec[:, None]
    se = torch.sqrt((1.0 / d) * (yyp[None, :] * rec[:, None] - beta * beta))
    t = beta / se
    return sum_x, ytx, beta, se, t


def _operand(W) -> ExactOperand:
    """The exact pass's operand: W as `exact_consts` gives it, or the bare
    (N, C) int8 digit planes (the reference's argument), laid out here."""
    return W if isinstance(W, ExactOperand) else exact_operand(W)


def _split_g8(G8):
    """int8 G8 (R, N), -1 = missing -> the (gz8, m8) pair of the exact
    pass: gz8 zero where missing, m8 1 there."""
    miss = G8 < 0
    gz8 = torch.where(miss, torch.zeros((), dtype=torch.int8,
                                        device=G8.device), G8)
    return gz8, miss.to(torch.int8)


def linreg_block_i8_exact(G8, Wdig, scales, Qty, yyp, d, k):
    """`_exact_core` from int8 G8 (R, N), -1 = missing: (sum_x, ytx, beta,
    se, t) f64. `Wdig` an `ExactOperand` or the (N, C) int8 planes."""
    return _exact_core(*_split_g8(G8), _operand(Wdig), scales, Qty, yyp, d,
                       k)


def linreg_block_gz_exact(gz8, m8, Wdig, scales, Qty, yyp, d, k):
    """`_exact_core` from an already decoded (gz8, m8) pair."""
    return _exact_core(gz8, m8, _operand(Wdig), scales, Qty, yyp, d, k)


def linreg_block_call_exact(packed, missing, Wdig, scales, Qty, yyp, d, k):
    """The exact path straight from packed calls: K6 decodes them on the
    device into the (gz8, m8) pair that K3 reads, so the host does no work
    per entry. `missing` None: no entry is missing."""
    gz8, m8 = decode_packed_gt(packed, missing)
    return _exact_core(gz8, m8, _operand(Wdig), scales, Qty, yyp, d, k)


def linreg_block_gz_exact_packed(gz8, m8, W, scales, Qty, yyp, d,
                                 k) -> torch.Tensor:
    """`_exact_core` from a decoded (gz8, m8) pair, as ONE stacked
    (R, 1+4P) f64 tensor so the host fetches a single buffer."""
    sum_x, ytx, beta, se, t = _exact_core(gz8, m8, W, scales, Qty, yyp,
                                          d, k)
    return torch.cat([sum_x[:, None], ytx, beta, se, t], dim=1)


def _linreg_block_i8_exact_packed(G8, W, scales, Qty, yyp, d,
                                  k) -> torch.Tensor:
    """The stacked exact result from int8 G with -1 = missing."""
    return linreg_block_gz_exact_packed(*_split_g8(G8), W, scales, Qty, yyp,
                                        d, k)


def _finish_stats_packed(packed_out, P, dof):
    """Split the stacked device result and finish p-values on host."""
    from .regression import t_pvalues
    if isinstance(packed_out, torch.Tensor):
        with timer.span('fetch', bytes=packed_out.nbytes, transfers=1):
            packed_out = packed_out.cpu().numpy()
    arr = np.asarray(packed_out, dtype=np.float64)
    sum_x = arr[:, 0]
    ytx = arr[:, 1:1 + P]
    beta = arr[:, 1 + P:1 + 2 * P]
    se = arr[:, 1 + 2 * P:1 + 3 * P]
    t = arr[:, 1 + 3 * P:1 + 4 * P]
    with timer.span('linreg.pvalues', rows=t.shape[0]):
        p = t_pvalues(t, dof)
    return dict(sum_x=sum_x, y_transpose_x=ytx, beta=beta,
                standard_error=se, t_stat=t, p_value=p)


def _f64_on(a, device) -> torch.Tensor:
    """A host array or a tensor as a contiguous f64 tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a, np.float64))
    return a.to(device, torch.float64).contiguous()


def exact_consts(Q, Ys, Qty, yyp, dof, device):
    """The device constants of one phenotype group: (W, scales, Qty, yyp,
    dof), W the `ExactOperand` of the digit planes with the kernel's layout
    built here once, the next three f64 tensors, dof a float. Q, Ys, Qty
    and yyp are host arrays or tensors already on `device` (then nothing
    of theirs is copied); Q and Ys go to the device as f64 and K7 makes
    the planes there (`digit_operand`)."""
    with timer.span('consts.planes'):
        W, scales = digit_operand(_f64_on(Q, device), _f64_on(Ys, device))
    copied = scales.nbytes + sum(a.nbytes for a in (Qty, yyp)
                                 if not isinstance(a, torch.Tensor))
    with timer.span('consts.copy', bytes=copied):
        return (W,
                torch.from_numpy(scales).to(device),
                _f64_on(Qty, device),
                _f64_on(yyp, device),
                float(dof))


def linreg_stats_i8_exact(G8: torch.Tensor, Q: np.ndarray, Ys: np.ndarray,
                          Qty: np.ndarray, yyp: np.ndarray, dof: int):
    """f64-parity results from int8 storage G8 (R, N), -1 = missing, a
    tensor on the device: one group's stats with p-values, from a single
    stacked device-to-host copy."""
    k = Q.shape[1]
    out = _linreg_block_i8_exact_packed(
        G8, *exact_consts(Q, Ys, Qty, yyp, dof, G8.device), k)
    return _finish_stats_packed(out, Ys.shape[1], dof)


def _device_calls(packed, missing, packed_dev, missing_dev):
    """The packed calls and their mask on the device: the caller's
    resident tensors where given, else copies of the host arrays to the
    session's device."""
    if packed_dev is None:
        from ..context import current_device
        packed_dev = torch.from_numpy(
            np.ascontiguousarray(packed, dtype=np.int32)).to(current_device())
    if missing_dev is None and missing is not None:
        missing_dev = torch.from_numpy(
            np.ascontiguousarray(missing, dtype=bool)).to(packed_dev.device)
    return packed_dev, missing_dev


def linreg_stats_call_exact(packed: np.ndarray, missing, Q: np.ndarray,
                            Ys: np.ndarray, Qty: np.ndarray, yyp: np.ndarray,
                            dof: int, packed_dev=None, missing_dev=None):
    """Host wrapper of the packed-call exact path: one group's stats with
    p-values. `packed_dev` / `missing_dev` are already resident copies of
    the calls and mask (a device cache's); without them the host arrays go
    to the session's device."""
    packed_dev, missing_dev = _device_calls(packed, missing, packed_dev,
                                            missing_dev)
    out = linreg_block_call_exact(
        packed_dev, missing_dev,
        *exact_consts(Q, Ys, Qty, yyp, dof, packed_dev.device), Q.shape[1])
    return _finish_stats(out, dof)


# ---------------------------------------------------------------------------
# K1: the f32 one-pass sums (int8 storage, f32 compute)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _true_f32_matmul():
    """f32 products in full f32 for the call, as the reference's
    Precision.HIGHEST asks: TF32 keeps about three decimal digits."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _sums_ref(G8: torch.Tensor, W: torch.Tensor):
    """Plain version of K1: (Gz·W, M·W, [ΣM, ΣGz, ΣGz²]) in f32 from int8
    G8 (R, N), -1 = missing, and f32 W (N, KP)."""
    miss = G8 < 0
    # cast before the product: CPU torch.mm on int8 wraps around
    gz = torch.where(miss, 0, G8).to(torch.float32)
    mf = miss.to(torch.float32)
    with _true_f32_matmul():
        gw = gz @ W
        mw = mf @ W
    st = torch.stack([mf.sum(dim=1), gz.sum(dim=1), (gz * gz).sum(dim=1)],
                     dim=1)
    return gw, mw, st


class F32Operand(NamedTuple):
    """The right-hand operand of the f32 pass, made once per call.

    W (N, KP) f32 = [Q | Ys]. WT (KP, ldw) f32: K1's layout of it,
    WT[:, :N] = W.T and zeros past column N, ldw a multiple of 4 >= N, so
    that four consecutive samples of a column are one aligned 16-byte
    piece. `f32_operand` makes the pair; a change to one tensor in place is
    not seen by the other."""
    W: torch.Tensor
    WT: torch.Tensor


def f32_operand(W: torch.Tensor) -> F32Operand:
    """W (N, KP) f32 with its kernel layout, built here once."""
    N, KP = W.shape
    WT = torch.zeros((KP, -(-N // 4) * 4), dtype=torch.float32,
                     device=W.device)
    WT[:, :N] = W.t()
    return F32Operand(W, WT)


def linreg_i8_sums(G8: torch.Tensor, W: F32Operand):
    """K1: one pass over int8 G8 (R, N), -1 = missing, against f32 W.W
    (N, KP): (GW, MW) f32 (R, KP) and ST = [ΣM, ΣGz, ΣGz²] f32 (R, 3).
    The row sums are exact for GT dosages (≤ 2) while N ≤ `_MAX_F32_N`.
    The kernel reads W.WT and allocates nothing but its outputs. The launch
    count rises by one per call: for KP > 8 the C entry point launches one
    kernel per chunk of eight columns."""
    if not isinstance(W, F32Operand):
        raise TypeError('linreg_i8_sums: W is an F32Operand (f32_operand(W)), '
                        'built once by the caller')
    R, N = G8.shape
    W, WT = W
    KP = W.shape[1]
    if N > _MAX_F32_N:
        raise ValueError(f'f32 linreg: {N} samples exceed the f32 row-sum '
                         f'bound {_MAX_F32_N}')
    if G8.device.type == 'cpu':
        return _sums_ref(G8, W)
    if KP < 1:
        raise ValueError('linreg_i8_sums: W has no columns')
    _kernels.check(G8, 'linreg_i8_sums/G8', torch.int8)
    _kernels.check(W, 'linreg_i8_sums/W', torch.float32, (N, KP))
    _kernels.check(WT, 'linreg_i8_sums/WT', torch.float32,
                   (KP, -(-N // 4) * 4))
    dev = G8.device
    GW = torch.empty((R, KP), dtype=torch.float32, device=dev)
    MW = torch.empty((R, KP), dtype=torch.float32, device=dev)
    ST = torch.empty((R, 3), dtype=torch.float32, device=dev)
    _kernels.launch('hail_linreg_i8_sums', G8.data_ptr(), WT.data_ptr(),
                    WT.shape[1], R, N, KP, GW.data_ptr(), MW.data_ptr(),
                    ST.data_ptr(), rows=R, samples=N, cols=KP)
    return GW, MW, ST


def _ols_epilogue(GW, MW, ST, n_pad_cols, N, k, Qty, yyp, d):
    """The OLS finish of the f32 path, in f32 as the reference's is:
    algebraic mean imputation and the reference nd block formula
    (statgen.py:631) from the one-pass sums. `n_pad_cols` padded sample
    columns count as all-missing (the port pads nothing and passes 0).
    W = [Q | Ys]; degenerate fits propagate NaN (no masking)."""
    f32 = torch.float32
    nmiss = ST[:, 0] - n_pad_cols
    cnt = float(N) - nmiss
    s = ST[:, 1]
    ss = ST[:, 2]
    mean = s / cnt                                 # 0/0 → nan, as reference
    GiW = GW + mean[:, None] * MW                  # imputed G @ [Q | Ys]
    GQ = GiW[:, :k]
    ytx = GiW[:, k:]
    sum_x = s + mean * nmiss                       # sum of imputed x
    with _true_f32_matmul():
        xyp = ytx - GQ @ torch.as_tensor(Qty, device=GW.device).to(f32)
    xxp = ss + mean * mean * nmiss - (GQ * GQ).sum(dim=1)
    rec = 1.0 / xxp
    beta = xyp * rec[:, None]
    d32 = torch.as_tensor(d, device=GW.device).to(f32)
    yyp32 = torch.as_tensor(yyp, device=GW.device).to(f32)
    se = torch.sqrt((1.0 / d32) * (yyp32[None, :] * rec[:, None] - beta * beta))
    t = beta / se
    return sum_x, ytx, beta, se, t


def linreg_block_i8(G8: torch.Tensor, W: torch.Tensor, Qty, yyp, d, k: int,
                    use_pallas: bool = True):
    """int8-storage f32-compute per-variant OLS.

    G8: (R, N) int8, -1 = missing. W: (N, k+P) = [Q | Ys] with Q the
    orthonormal covariate basis and Ys the phenotype matrix; Qty = Qᵀ Ys;
    yyp the residual y·y; d the dof. Returns (sum_x, ytx, beta, se, t) f32
    per the reference nd formula. `use_pallas=True` (the reference's name)
    takes the sums from K1 (`linreg_i8_sums`); False is the explicit plain
    route (`_sums_ref`)."""
    W = W.to(device=G8.device, dtype=torch.float32).contiguous()
    GW, MW, ST = (linreg_i8_sums(G8, f32_operand(W)) if use_pallas
                  else _sums_ref(G8, W))
    return _ols_epilogue(GW, MW, ST, 0, G8.shape[1], k, Qty, yyp, d)


def _finish_stats(out, dof):
    from .regression import t_pvalues
    sum_x, ytx, beta, se, t = (np.asarray(v.cpu().numpy(), dtype=np.float64)
                               for v in out)
    return dict(sum_x=sum_x, y_transpose_x=ytx, beta=beta,
                standard_error=se, t_stat=t, p_value=t_pvalues(t, dof))


def linreg_stats_i8(G8: torch.Tensor, Q: np.ndarray, Ys: np.ndarray,
                    Qty: np.ndarray, yyp: np.ndarray, dof: int):
    """f32 results with p-values from int8 storage G8 (R, N), -1 =
    missing, a tensor on the device; on CUDA the sums come from K1."""
    dev = G8.device
    k = Q.shape[1]
    W = torch.from_numpy(np.concatenate([Q, Ys], axis=1).astype(np.float32))
    out = linreg_block_i8(
        G8, W.to(dev), torch.as_tensor(np.asarray(Qty, np.float64), device=dev),
        torch.as_tensor(np.asarray(yyp, np.float64), device=dev), float(dof),
        k)
    return _finish_stats(out, dof)


def linreg_block_call(packed: torch.Tensor, missing, W: torch.Tensor, Qty,
                      yyp, d, k: int):
    """f32 OLS straight from packed calls (R, N) int32 and their bool mask:
    K6 decodes them on the device into G8, K1 takes the one-pass sums, and
    the f32 epilogue of `linreg_block_i8` finishes. W (N, k+P) = [Q | Ys].
    Returns (sum_x, ytx, beta, se, t) f32."""
    G8 = decode_packed_g8(packed, missing)
    W = W.to(device=packed.device, dtype=torch.float32).contiguous()
    GW, MW, ST = linreg_i8_sums(G8, f32_operand(W))
    return _ols_epilogue(GW, MW, ST, 0, packed.shape[1], k, Qty, yyp, d)


def linreg_stats_call(packed: np.ndarray, missing, Q: np.ndarray,
                      Ys: np.ndarray, Qty: np.ndarray, yyp: np.ndarray,
                      dof: int, packed_dev=None, missing_dev=None):
    """Host wrapper of the packed-call f32 path (`linreg_block_call`), with
    p-values; the calls as for `linreg_stats_call_exact`."""
    packed_dev, missing_dev = _device_calls(packed, missing, packed_dev,
                                            missing_dev)
    dev = packed_dev.device
    W = np.concatenate([Q, Ys], axis=1).astype(np.float32)
    out = linreg_block_call(
        packed_dev, missing_dev, torch.from_numpy(W).to(dev),
        torch.as_tensor(np.asarray(Qty, np.float64), device=dev),
        torch.as_tensor(np.asarray(yyp, np.float64), device=dev), float(dof),
        Q.shape[1])
    return _finish_stats(out, dof)
