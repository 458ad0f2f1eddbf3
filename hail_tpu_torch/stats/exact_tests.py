"""2x2-table association tests with the reference engine's exact semantics.

Ports of `is/hail/stats/package.scala`:
- `uniroot` (package.scala:13): Brent's method with the reference's exact
  update schedule and default tolerance 1.220703e-4.
- `fisher_exact_test` (package.scala:167): R fisher.test semantics — the
  odds ratio is the *conditional maximum-likelihood estimate* under the
  noncentral hypergeometric likelihood (not ad/bc), and the CI bounds invert
  the noncentral tail probabilities with `uniroot`.
- `chi_squared_test` (package.scala:131): Pearson statistic in the
  reference's exact operation order, p via the R pgamma port, odds ratio
  ad/bc.
- `contingency_table_test` (package.scala:149): routes to chi-squared when
  all cells >= min_cell_count, else Fisher.
- `cochran_mantel_haenszel` (MathFunctions CMH): stratified 2x2 test.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from .rmath import pchisq

_nan = float('nan')
_inf = float('inf')
_EPS = 2.220446049250313e-16


def uniroot(fn: Callable[[float], float], lo: float, hi: float,
            tolerance: float = 1.220703e-4) -> Optional[float]:
    """Brent root finder, matching the reference's update schedule."""
    a, b, c = lo, hi, lo
    fa, fb = fn(a), fn(b)
    fc = fa

    if fa == 0.0:
        return a
    if fb == 0.0:
        return b

    for _ in range(1001):
        previous_step = b - a
        tol_actual = 2 * _EPS * abs(b) + tolerance / 2
        new_step = (c - b) / 2

        if abs(fc) < abs(fb):
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb

        if abs(new_step) <= tol_actual or fb == 0.0:
            return b

        if abs(previous_step) >= tol_actual and abs(fa) > abs(fb):
            cb = c - b
            if a == c:
                t1 = fb / fa
                p = cb * t1
                q = 1.0 - t1
            else:
                q = fa / fc
                t1 = fb / fc
                t2 = fb / fa
                p = t2 * (cb * q * (q - t1) - (b - a) * (t1 - 1.0))
                q = (q - 1.0) * (t1 - 1.0) * (t2 - 1.0)
            if p > 0.0:
                q = -q
            else:
                p = -p
            if (p < (0.75 * cb * q - abs(tol_actual * q) / 2)
                    and p < abs(previous_step * q / 2)):
                new_step = p / q

        if abs(new_step) < tol_actual:
            new_step = tol_actual if new_step > 0.0 else -tol_actual

        a, fa = b, fb
        b += new_step
        fb = fn(b)
        if (fb > 0.0 and fc > 0.0) or (fb < 0.0 and fc < 0.0):
            c, fc = a, fa

    return None


def fisher_exact_test(a: int, b: int, c: int, d: int,
                      odds_ratio: float = 1.0,
                      confidence_level: float = 0.95,
                      alternative: str = 'two.sided'):
    """Returns (p_value, odds_ratio_mle, ci_lower, ci_upper)."""
    from ..utils.java import FatalError
    if not (a >= 0 and b >= 0 and c >= 0 and d >= 0):
        raise FatalError(
            f'fisher_exact_test: all arguments must be non-negative, got {a}, {b}, {c}, {d}')
    if confidence_level < 0.0 or confidence_level > 1.0:
        raise FatalError('Confidence level must be between 0 and 1')
    if odds_ratio < 0.0:
        raise FatalError('Odds ratio must be non-negative')
    if alternative not in ('greater', 'less', 'two.sided'):
        raise FatalError('Did not recognize test type string. '
                         'Use one of greater, less, two.sided')

    pop_size = a + b + c + d
    num_success_pop = a + c
    sample_size = a + b
    num_success_sample = a

    if not (pop_size > 0 and sample_size > 0 and sample_size < pop_size
            and num_success_pop > 0 and num_success_pop < pop_size):
        return (_nan, _nan, _nan, _nan)

    low = max(0, (a + b) - (b + d))
    high = min(a + b, a + c)
    support = list(range(low, high + 1))

    import scipy.stats as st
    hg = st.hypergeom(pop_size, num_success_pop, sample_size)
    logdc = [float(hg.logpmf(k)) for k in support]
    epsilon = 2.220446e-16

    def dnhyper(ncp: float):
        dd = [hr + math.log(ncp) * i for i, hr in enumerate(logdc)]
        mx = max(dd)
        dd = [math.exp(v - mx) for v in dd]
        s = sum(dd)
        return [v / s for v in dd]

    def phyper(k: int, lower_tail: bool) -> float:
        if lower_tail:
            return float(hg.cdf(k))
        # commons-math upperCumulativeProbability(k) = P(X >= k)
        return float(hg.sf(k - 1))

    def pnhyper(q: int, ncp: float = 1.0, upper_tail: bool = False) -> float:
        if ncp == 1.0:
            return phyper(q, lower_tail=not upper_tail)
        if ncp == 0.0:
            if upper_tail:
                return 1.0 if q <= low else 0.0
            return 1.0 if q >= low else 0.0
        if ncp == _inf:
            if upper_tail:
                return 1.0 if q <= high else 0.0
            return 1.0 if q >= high else 0.0
        dn = dnhyper(ncp)
        if upper_tail:
            return sum(p for p, k in zip(dn, support) if k >= q)
        return sum(p for p, k in zip(dn, support) if k <= q)

    def mnhyper(ncp: float) -> float:
        if ncp == 0.0:
            return float(low)
        if ncp == _inf:
            return float(high)
        return sum(p * k for p, k in zip(dnhyper(ncp), support))

    def mle(x: float) -> float:
        if x == low:
            return 0.0
        if x == high:
            return _inf
        mu = mnhyper(1.0)
        if mu > x:
            r = uniroot(lambda t: mnhyper(t) - x, 0.0, 1.0)
            return r if r is not None else _nan
        if mu < x:
            r = uniroot(lambda t: mnhyper(1 / t) - x, epsilon, 1.0)
            return 1.0 / r if r is not None else _nan
        return 1.0

    def ncp_lower(x: int, alpha: float) -> float:
        if x == low:
            return 0.0
        p = pnhyper(x, upper_tail=True)
        if p > alpha:
            r = uniroot(lambda t: pnhyper(x, t, True) - alpha, 0.0, 1.0)
            return r if r is not None else _nan
        if p < alpha:
            r = uniroot(lambda t: pnhyper(x, 1 / t, True) - alpha, epsilon, 1.0)
            return 1.0 / r if r is not None else _nan
        return 1.0

    def ncp_upper(x: int, alpha: float) -> float:
        if x == high:
            return _inf
        p = pnhyper(x)
        if p < alpha:
            r = uniroot(lambda t: pnhyper(x, t, False) - alpha, 0.0, 1.0)
            return r if r is not None else _nan
        if p > alpha:
            r = uniroot(lambda t: pnhyper(x, 1 / t, False) - alpha, epsilon, 1.0)
            return 1.0 / r if r is not None else _nan
        return 1.0

    if alternative == 'less':
        pvalue = pnhyper(num_success_sample, odds_ratio)
    elif alternative == 'greater':
        pvalue = pnhyper(num_success_sample, odds_ratio, upper_tail=True)
    else:
        if odds_ratio == 0:
            pvalue = 1.0 if low == num_success_sample else 0.0
        elif odds_ratio == _inf:
            pvalue = 1.0 if high == num_success_sample else 0.0
        else:
            rel_err = 1.0 + 1e-7
            dn = dnhyper(odds_ratio)
            crit = dn[num_success_sample - low] * rel_err
            pvalue = sum(p for p in dn if p <= crit)

    or_estimate = mle(float(num_success_sample))

    if alternative == 'less':
        ci = (0.0, ncp_upper(num_success_sample, 1 - confidence_level))
    elif alternative == 'greater':
        ci = (ncp_lower(num_success_sample, 1 - confidence_level), _inf)
    else:
        alpha = (1 - confidence_level) / 2.0
        ci = (ncp_lower(num_success_sample, alpha), ncp_upper(num_success_sample, alpha))

    return (pvalue, or_estimate, ci[0], ci[1])


def chi_squared_test(a0: int, b0: int, c0: int, d0: int):
    """Returns (p_value, odds_ratio) with the reference's exact statistic."""
    from ..utils.java import FatalError
    if a0 < 0 or b0 < 0 or c0 < 0 or d0 < 0:
        raise FatalError(
            f'chi_squared_test: all arguments must be non-negative, got {a0}, {b0}, {c0}, {d0}')
    a, b, c, d = float(a0), float(b0), float(c0), float(d0)
    ad = a * d
    bc = b * c
    det = ad - bc
    try:
        chi_square = (a + b + c + d) * (det / ((a + b) * (c + d))) * (det / ((b + d) * (a + c)))
    except ZeroDivisionError:
        chi_square = _nan
    try:
        orat = ad / bc
    except ZeroDivisionError:
        orat = _nan if ad == 0 else _inf
    return (pchisq(chi_square, 1, lower_tail=False), orat)


def contingency_table_test(a: int, b: int, c: int, d: int, min_cell_count: int):
    from ..utils.java import FatalError
    if min_cell_count < 0:
        raise FatalError(
            f"contingency_table_test: 'min_cell_count' must be non-negative, "
            f"found {min_cell_count}")
    if a >= min_cell_count and b >= min_cell_count and c >= min_cell_count and d >= min_cell_count:
        return chi_squared_test(a, b, c, d)
    p, orat, _, _ = fisher_exact_test(a, b, c, d)
    return (p, orat)


