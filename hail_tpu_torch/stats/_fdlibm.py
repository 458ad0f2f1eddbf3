"""fdlibm (Sun Freely-Distributable LIBM) log/exp, bit-exact ports.

Java's StrictMath — and some JVM Math fallbacks — use fdlibm, whose results
can differ from glibc's correctly-rounded libm by 1 ulp on specific
arguments.  The reference engine's distribution kernels run on the JVM, so
reproducing its exact doubles can require these exact primitives.
"""

from __future__ import annotations

import struct


def _hi_lo(x: float):
    b = struct.unpack('>Q', struct.pack('>d', x))[0]
    return (b >> 32) & 0xFFFFFFFF, b & 0xFFFFFFFF


def _from_hi_lo(hi: int, lo: int) -> float:
    return struct.unpack('>d', struct.pack('>Q', ((hi & 0xFFFFFFFF) << 32) | (lo & 0xFFFFFFFF)))[0]


def _set_hi(x: float, hi: int) -> float:
    _, lo = _hi_lo(x)
    return _from_hi_lo(hi, lo)


_ln2_hi = _from_hi_lo(0x3FE62E42, 0xFEE00000)
_ln2_lo = _from_hi_lo(0x3DEA39EF, 0x35793C76)
_two54 = _from_hi_lo(0x43500000, 0x00000000)
_Lg1 = _from_hi_lo(0x3FE55555, 0x55555593)
_Lg2 = _from_hi_lo(0x3FD99999, 0x9997FA04)
_Lg3 = _from_hi_lo(0x3FD24924, 0x94229359)
_Lg4 = _from_hi_lo(0x3FCC71C5, 0x1D8E78AF)
_Lg5 = _from_hi_lo(0x3FC74664, 0x96CB03DE)
_Lg6 = _from_hi_lo(0x3FC39A09, 0xD078C69F)
_Lg7 = _from_hi_lo(0x3FC2F112, 0xDF3E5244)


def fd_log(x: float) -> float:
    """fdlibm __ieee754_log."""
    hx, lx = _hi_lo(x)
    k = 0
    if hx < 0x00100000:
        if ((hx & 0x7FFFFFFF) | lx) == 0:
            return float('-inf')
        if hx & 0x80000000:
            return float('nan')
        k -= 54
        x *= _two54
        hx, lx = _hi_lo(x)
    if hx >= 0x7FF00000:
        return x + x
    k += (hx >> 20) - 1023
    hx &= 0x000FFFFF
    i = (hx + 0x95F64) & 0x100000
    x = _set_hi(x, hx | (i ^ 0x3FF00000))
    k += i >> 20
    f = x - 1.0
    if (0x000FFFFF & (2 + hx)) < 3:
        if f == 0.0:
            if k == 0:
                return 0.0
            dk = float(k)
            return dk * _ln2_hi + dk * _ln2_lo
        r = f * f * (0.5 - 0.3333333333333333 * f)
        if k == 0:
            return f - r
        dk = float(k)
        return dk * _ln2_hi - ((r - dk * _ln2_lo) - f)
    s = f / (2.0 + f)
    dk = float(k)
    z = s * s
    i = hx - 0x6147A
    w = z * z
    j = 0x6B851 - hx
    t1 = w * (_Lg2 + w * (_Lg4 + w * _Lg6))
    t2 = z * (_Lg1 + w * (_Lg3 + w * (_Lg5 + w * _Lg7)))
    i |= j
    r = t2 + t1
    if i > 0:
        hfsq = 0.5 * f * f
        if k == 0:
            return f - (hfsq - s * (hfsq + r))
        return dk * _ln2_hi - ((hfsq - (s * (hfsq + r) + dk * _ln2_lo)) - f)
    if k == 0:
        return f - s * (f - r)
    return dk * _ln2_hi - ((s * (f - r) - dk * _ln2_lo) - f)


_halF = (0.5, -0.5)
_ln2HI = (_from_hi_lo(0x3FE62E42, 0xFEE00000), _from_hi_lo(0xBFE62E42, 0xFEE00000))
_ln2LO = (_from_hi_lo(0x3DEA39EF, 0x35793C76), _from_hi_lo(0xBDEA39EF, 0x35793C76))
_invln2 = _from_hi_lo(0x3FF71547, 0x652B82FE)
_P1 = _from_hi_lo(0x3FC55555, 0x5555553E)
_P2 = _from_hi_lo(0xBF66C16C, 0x16BEBD93)
_P3 = _from_hi_lo(0x3F11566A, 0xAF25DE2C)
_P4 = _from_hi_lo(0xBEBBBD41, 0xC5D26BF1)
_P5 = _from_hi_lo(0x3E663769, 0x72BEA4D0)
_o_threshold = _from_hi_lo(0x40862E42, 0xFEFA39EF)
_u_threshold = _from_hi_lo(0xC0874910, 0xD52D3051)
_twom1000 = _from_hi_lo(0x01700000, 0x00000000)
_huge = 1.0e300


def fd_exp(x: float) -> float:
    """fdlibm __ieee754_exp."""
    hx, _ = _hi_lo(x)
    xsb = (hx >> 31) & 1
    hx &= 0x7FFFFFFF

    if hx >= 0x40862E42:
        if hx >= 0x7FF00000:
            hx2, lx2 = _hi_lo(x)
            if ((hx2 & 0xFFFFF) | lx2) != 0 and hx >= 0x7FF00000 and hx > 0x7FF00000:
                return x + x  # NaN
            if x != x:
                return x
            return x if xsb == 0 else 0.0  # exp(inf)=inf, exp(-inf)=0
        if x > _o_threshold:
            return _huge * _huge
        if x < _u_threshold:
            return _twom1000 * _twom1000

    lo = 0.0
    hi = 0.0
    k = 0
    if hx > 0x3FD62E42:
        if hx < 0x3FF0A2B2:
            hi = x - _ln2HI[xsb]
            lo = _ln2LO[xsb]
            k = 1 - xsb - xsb
        else:
            k = int(_invln2 * x + _halF[xsb])
            t = float(k)
            hi = x - t * _ln2HI[0]
            lo = t * _ln2LO[0]
        x = hi - lo
    elif hx < 0x3E300000:
        return 1.0 + x
    else:
        k = 0

    t = x * x
    c = x - t * (_P1 + t * (_P2 + t * (_P3 + t * (_P4 + t * _P5))))
    if k == 0:
        return 1.0 - ((x * c / (c - 2.0)) - x)
    y = 1.0 - ((lo - (x * c) / (2.0 - c)) - hi)
    yhi, ylo = _hi_lo(y)
    if k >= -1021:
        return _from_hi_lo(yhi + (k << 20), ylo)
    return _from_hi_lo(yhi + ((k + 1000) << 20), ylo) * _twom1000
