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
- `exact_pass` (K3): GWd, MWd, nmiss, s, ss in one read of (gz8, m8);
- `linreg_i8_sums` (K1): the f32 one-pass sums of `linreg_block_i8`, the
  int8-storage f32-compute OLS (`linreg_stats_i8`), from int8 G with
  -1 = missing.
Each has its plain torch version beside it (`_unpack_plain`,
`_exact_pass_plain`, `_sums_ref`). A wrapper runs the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _kernels

_EXACT_PLANES = 7
_DIGIT_BITS = 7
_MAX_EXACT_N = 8_000_000   # int32 accumulator: N·2·127 < 2³¹
# f32 accumulator of K1: the row sums ΣM, ΣGz, ΣGz² are integers, exact in
# f32 while below 2²⁴; with GT dosages ≤ 2, ΣGz² ≤ 4·N < 2²⁴
_MAX_F32_N = (1 << 22) - 1


def _digit_planes(W: np.ndarray, planes: int = _EXACT_PLANES,
                  bits: int = _DIGIT_BITS):
    """Decompose f64 W (N, KP) into int8 digit planes stacked plane-major
    along axis 1 → (N, planes·KP), plus (planes, KP) f64 scales."""
    W = np.asarray(W, np.float64)
    amax = np.max(np.abs(W), axis=0)
    amax = np.where(amax == 0, 1.0, amax)
    base = np.exp2(np.ceil(np.log2(amax)))         # per-column block exponent
    resid = W / base
    mult = float(1 << bits)
    digs, scales = [], []
    for d_ in range(planes):
        q = np.clip(np.rint(resid * mult), -127, 127)
        digs.append(q.astype(np.int8))
        resid = resid * mult - q
        scales.append(base / (mult ** (d_ + 1)))
    return np.concatenate(digs, axis=1), np.stack(scales, axis=0)


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
                    gz8.data_ptr(), m8.data_ptr())
    return gz8, m8


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
                    s.data_ptr(), ss.data_ptr())
    return GWd, MWd, nmiss, s, ss


def _exact_core(gz8, m8, W, scales, Qty, yyp, d, k, planes=_EXACT_PLANES):
    """gz8 (R,N) int8 zero-at-missing genotypes, m8 (R,N) int8 missing
    indicators; the group's constants as `exact_consts` returns them (W an
    `ExactOperand`, the others f64). Returns (sum_x, ytx, beta, se, t) f64."""
    return _exact_epilogue(*exact_pass(gz8, m8, W), gz8.shape[1], scales,
                           Qty, yyp, d, k, planes)


def _exact_epilogue(GWd, MWd, nmiss_i, s_i, ss_i, N, scales, Qty, yyp, d, k,
                    planes=_EXACT_PLANES):
    """f64 recombine of the exact pass's int32 partials, then the OLS."""
    R = GWd.shape[0]
    KP = GWd.shape[1] // planes
    # recombine digit partials in f64: (R, planes, KP) · (planes, KP) → (R, KP)
    GW = (GWd.reshape(R, planes, KP).to(torch.float64) * scales).sum(dim=1)
    MW = (MWd.reshape(R, planes, KP).to(torch.float64) * scales).sum(dim=1)
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


def linreg_block_gz_exact_packed(gz8, m8, W, scales, Qty, yyp, d, k,
                                 planes=_EXACT_PLANES) -> torch.Tensor:
    """`_exact_core` from a decoded (gz8, m8) pair, as ONE stacked
    (R, 1+4P) f64 tensor so the host fetches a single buffer."""
    sum_x, ytx, beta, se, t = _exact_core(gz8, m8, W, scales, Qty, yyp,
                                          d, k, planes)
    return torch.cat([sum_x[:, None], ytx, beta, se, t], dim=1)


def _linreg_block_i8_exact_packed(G8, W, scales, Qty, yyp, d, k,
                                  planes=_EXACT_PLANES) -> torch.Tensor:
    """The stacked exact result from int8 G with -1 = missing."""
    miss = G8 < 0
    gz8 = torch.where(miss, torch.zeros((), dtype=torch.int8,
                                        device=G8.device), G8)
    return linreg_block_gz_exact_packed(gz8, miss.to(torch.int8), W,
                                        scales, Qty, yyp, d, k, planes)


def _finish_stats_packed(packed_out, P, dof):
    """Split the stacked device result and finish p-values on host."""
    import scipy.stats as st
    if isinstance(packed_out, torch.Tensor):
        packed_out = packed_out.cpu().numpy()
    arr = np.asarray(packed_out, dtype=np.float64)
    sum_x = arr[:, 0]
    ytx = arr[:, 1:1 + P]
    beta = arr[:, 1 + P:1 + 2 * P]
    se = arr[:, 1 + 2 * P:1 + 3 * P]
    t = arr[:, 1 + 3 * P:1 + 4 * P]
    with np.errstate(all='ignore'):
        p = 2 * st.t.sf(np.abs(t), dof) if dof > 0 else np.full_like(t, np.nan)
    return dict(sum_x=sum_x, y_transpose_x=ytx, beta=beta,
                standard_error=se, t_stat=t, p_value=p)


def exact_consts(Q: np.ndarray, Ys: np.ndarray, Qty: np.ndarray,
                 yyp: np.ndarray, dof, device):
    """The device constants of one phenotype group: (W, scales, Qty, yyp,
    dof), W the `ExactOperand` of the digit planes with the kernel's layout
    built here once, the next three f64 tensors, dof a float."""
    Wdig, scales = _digit_planes(np.concatenate([Q, Ys], axis=1))
    Wdig = torch.from_numpy(np.ascontiguousarray(Wdig)).to(device)
    return (exact_operand(Wdig),
            torch.from_numpy(scales).to(device),
            torch.as_tensor(np.asarray(Qty, np.float64), device=device),
            torch.as_tensor(np.asarray(yyp, np.float64), device=device),
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
                    ST.data_ptr())
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
    import scipy.stats as st
    sum_x, ytx, beta, se, t = (np.asarray(v.cpu().numpy(), dtype=np.float64)
                               for v in out)
    with np.errstate(all='ignore'):
        p = 2 * st.t.sf(np.abs(t), dof) if dof > 0 else np.full_like(t, np.nan)
    return dict(sum_x=sum_x, y_transpose_x=ytx, beta=beta,
                standard_error=se, t_stat=t, p_value=p)


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
