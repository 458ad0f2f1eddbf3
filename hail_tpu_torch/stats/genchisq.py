"""Generalized chi-squared CDF (weighted sum of noncentral chi-squares plus a
Gaussian term).

Reference: `is/hail/stats/GeneralizedChiSquaredDistribution.scala` (Davies'
algorithm). Fresh implementation:

* central case with all-positive weights (the SKAT path) uses Ruben's (1962)
  series expansion  P(sum_i w_i chi2_{k_i} <= x) = sum_j c_j F_{N+2j}(x/beta)
  with beta <= min(w): all c_j >= 0, sum c_j = 1, so the truncation error is
  rigorously bounded by the un-accumulated mass — far more accurate than
  characteristic-function quadrature for small numbers of terms;
* the general case (negative weights, noncentrality, Gaussian term) falls
  back to Imhof's (1961) numerical inversion.

Q = sum_j w_j * chi2(k_j, lambda_j) + mu + sigma * N(0,1);  returns P(Q <= x).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
from scipy.integrate import quad
from scipy.stats import chi2 as _chi2


def _ruben_central(x: float, w: np.ndarray, k: np.ndarray,
                   max_terms: int = 100_000, eps: float = 1e-14):
    """P(sum_i w_i chi2_{k_i} <= x) for w_i > 0, x > 0 via Ruben's series.

    Returns (cdf, converged). Coefficient recurrence (Ruben 1962; see also
    Farebrother's AS 204): with beta <= min(w), ratio_i = 1 - beta/w_i,
        g_m = 0.5 * sum_i k_i * ratio_i^m
        c_0 = prod_i (beta/w_i)^(k_i/2)
        c_j = (1/j) * sum_{r=0}^{j-1} g_{j-r} c_r
    all c_j >= 0 and sum_j c_j = 1, so the remainder after J terms is bounded
    by 1 - sum_{j<=J} c_j.
    """
    beta = 0.90625 * float(np.min(w))
    ratio = 1.0 - beta / w
    n_total = float(np.sum(k))
    log_c0 = 0.5 * float(np.sum(k * np.log(beta / w)))
    if log_c0 < -700.0:  # c_0 underflows; let the caller fall back
        return float('nan'), float('nan'), False
    xb = x / beta
    c = np.empty(1024, dtype=np.float64)
    g = np.empty(1024, dtype=np.float64)
    c[0] = math.exp(log_c0)
    # incremental central-chi2 CDF over df: F_{N+2(j+1)}(x) = F_{N+2j}(x) - t_j
    # with t_j = (x/2)^{N/2+j} e^{-x/2} / Gamma(N/2+j+1),
    # t_{j+1} = t_j * (x/2) / (N/2+j+1) — O(1) per term instead of a scipy
    # call (wide eigenvalue spreads need 1e4-1e6 terms)
    from scipy.special import gammaln
    half = n_total / 2.0
    cdf_j = float(_chi2.cdf(xb, n_total))
    sf_j = float(_chi2.sf(xb, n_total))
    t_j = math.exp(half * math.log(xb / 2.0) - xb / 2.0 - gammaln(half + 1.0)) \
        if xb > 0 else 0.0
    total = c[0] * cdf_j
    # the survival sum keeps full *relative* precision in the far right tail
    # (1 - cdf would round to 0 below ~2^-53), which the SKAT tail needs
    sf = c[0] * sf_j
    mass = c[0]
    pw = ratio.copy()  # ratio^m, updated in place
    j = 0
    # the c_j recurrence is O(J^2); past ~20k terms Imhof is cheaper, so
    # bail out and let the caller fall back
    cap = min(max_terms, 20_000)
    while mass < 1.0 - eps and j + 1 < cap:
        j += 1
        if j >= len(c):
            c = np.concatenate([c, np.empty(len(c), dtype=np.float64)])
            g = np.concatenate([g, np.empty(len(g), dtype=np.float64)])
        g[j] = 0.5 * float(np.sum(k * pw))
        pw *= ratio
        # c_j = (1/j) * sum_{r=0}^{j-1} g_{j-r} c_r  (dot of reversed g slice)
        c[j] = float(np.dot(g[1:j + 1][::-1], c[:j])) / j
        cdf_j -= t_j
        sf_j += t_j
        t_j *= (xb / 2.0) / (half + j)
        total += c[j] * cdf_j
        sf += c[j] * sf_j
        mass += c[j]
    return (min(max(total, 0.0), 1.0), min(max(sf, 0.0), 1.0),
            bool(mass >= 1.0 - eps))


class _DaviesException(Exception):
    pass


def davies_qf(c: float, n: Sequence[int], lb: Sequence[float],
              nc: Sequence[float], sigma: float, lim: int, acc: float):
    """Davies (1980) "Algorithm AS 155" numerical inversion of the
    characteristic function of a linear combination of noncentral
    chi-squares plus a Gaussian term; computes P(Q < c).

    Fresh Python implementation of the published algorithm (Davies' qfc.c,
    MIT-licensed per the author). The reference ports the same algorithm
    (`is/hail/stats/GeneralizedChiSquaredDistribution.scala`); iteration
    counts (number of integrations) and fault codes match it because both
    follow the published control flow:
      fault 0 = ok, 1 = accuracy not achievable with `lim` integration
      terms, 2 = round-off error possibly significant.

    Returns (value, n_integrations, fault).
    """
    pi_ = 3.14159265358979
    log28 = 0.0866  # log(2)/8
    r = len(lb)
    n = [int(x) for x in n]
    lb = [float(x) for x in lb]
    nc = [float(x) for x in nc]
    st = {'count': 0, 'ndtsrt': True, 'fail': False, 'intl': 0.0,
          'ersm': 0.0, 'sigsq': sigma * sigma,
          'lmax': 0.0, 'lmin': 0.0, 'mean': 0.0}
    th = [0] * r

    def counter():
        st['count'] += 1
        if st['count'] > lim:
            raise _DaviesException()

    def exp1(x):
        return 0.0 if x < -50.0 else math.exp(x)

    def log1(x, first):
        # log(1+x), or log(1+x)-x, via a series for small |x|
        if abs(x) > 0.1:
            return math.log(1.0 + x) if first else math.log(1.0 + x) - x
        y = x / (2.0 + x)
        term = 2.0 * y ** 3
        kk = 3.0
        s = (2.0 if first else -x) * y
        y = y * y
        s1 = s + term / kk
        while s1 != s:
            kk += 2.0
            term *= y
            s = s1
            s1 = s + term / kk
        return s

    def order():
        for j in range(r):
            lj = abs(lb[j])
            kk = j - 1
            while kk >= 0 and lj > abs(lb[th[kk]]):
                th[kk + 1] = th[kk]
                kk -= 1
            th[kk + 1] = j
        st['ndtsrt'] = False

    def errbd(u):
        # tail-probability bound from the mgf; returns (bound, cutoff)
        counter()
        xconst = u * st['sigsq']
        sum1 = u * xconst
        u2 = 2.0 * u
        for j in range(r - 1, -1, -1):
            nj, lj, ncj = n[j], lb[j], nc[j]
            x = u2 * lj
            y = 1.0 - x
            xconst += lj * (ncj / y + nj) / y
            sum1 += ncj * (x / y) ** 2 + nj * ((x * x) / y + log1(-x, False))
        return exp1(-0.5 * sum1), xconst

    def ctff(accx, upn):
        # cutoff so that P(Q > c2) < accx (upn > 0) or P(Q < c2) < accx
        u2 = upn
        u1 = 0.0
        c1 = st['mean']
        rb = 2.0 * (st['lmax'] if u2 > 0.0 else st['lmin'])
        u = u2 / (1.0 + u2 * rb)
        eb, c2 = errbd(u)
        while eb > accx:
            u1 = u2
            c1 = c2
            u2 = 2.0 * u2
            u = u2 / (1.0 + u2 * rb)
            eb, c2 = errbd(u)
        u = (c1 - st['mean']) / (c2 - st['mean'])
        while u < 0.9:
            u = (u1 + u2) / 2.0
            eb, xconst = errbd(u / (1.0 + u * rb))
            if eb > accx:
                u1 = u
                c1 = xconst
            else:
                u2 = u
                c2 = xconst
            u = (c1 - st['mean']) / (c2 - st['mean'])
        return c2, u2

    def truncation(u, tausq):
        # bound on integration error from truncating the integral at u
        counter()
        sum1 = 0.0
        prod2 = 0.0
        prod3 = 0.0
        s = 0
        sum2 = (st['sigsq'] + tausq) * u * u
        prod1 = 2.0 * sum2
        u2 = 2.0 * u
        for j in range(r):
            lj, ncj, nj = lb[j], nc[j], n[j]
            x = (u2 * lj) ** 2
            sum1 += ncj * x / (1.0 + x)
            if x > 1.0:
                prod2 += nj * math.log(x)
                prod3 += nj * log1(x, True)
                s += nj
            else:
                prod1 += nj * log1(x, True)
        sum1 *= 0.5
        prod2 = prod1 + prod2
        prod3 = prod1 + prod3
        x = exp1(-sum1 - 0.25 * prod2) / pi_
        y = exp1(-sum1 - 0.25 * prod3) / pi_
        err1 = 1.0 if s == 0 else x * 2.0 / s
        err2 = 2.5 * y if prod3 > 1.0 else 1.0
        if err2 < err1:
            err1 = err2
        x = 0.5 * sum2
        err2 = 1.0 if x <= y else y / x
        return err1 if err1 < err2 else err2

    def findu(utx, accx):
        # find u with truncation(u) < accx, truncation(u/1.2) > accx
        ut = utx
        u = ut / 4.0
        if truncation(u, 0.0) > accx:
            u = ut
            while truncation(u, 0.0) > accx:
                ut *= 4.0
                u = ut
        else:
            ut = u
            u = u / 4.0
            while truncation(u, 0.0) <= accx:
                ut = u
                u = u / 4.0
        for d in (2.0, 1.4, 1.2, 1.1):
            u = ut / d
            if truncation(u, 0.0) <= accx:
                ut = u
        return ut

    def integrate(nterm, interv, tausq, mainx):
        # trapezoid-free Fourier sum; if not mainx, apply the convergence
        # factor 1 - exp(-tausq u^2 / 2)
        inpi = interv / pi_
        for kk in range(nterm, -1, -1):
            u = (kk + 0.5) * interv
            sum1 = -2.0 * u * c
            sum2 = abs(sum1)
            sum3 = -0.5 * st['sigsq'] * u * u
            for j in range(r - 1, -1, -1):
                nj = n[j]
                x = 2.0 * lb[j] * u
                y = x * x
                sum3 -= 0.25 * nj * log1(y, True)
                y = nc[j] * x / (1.0 + y)
                z = nj * math.atan(x) + y
                sum1 += z
                sum2 += abs(z)
                sum3 -= 0.5 * x * y
            x = inpi * exp1(sum3) / u
            if not mainx:
                x *= 1.0 - exp1(-0.5 * tausq * u * u)
            st['intl'] += math.sin(0.5 * sum1) * x
            st['ersm'] += 0.5 * sum2 * x

    def cfe(x):
        # coefficient of tausq in the convergence-factor error at x
        counter()
        if st['ndtsrt']:
            order()
        axl = abs(x)
        sxl = 1.0 if x > 0.0 else -1.0
        sum1 = 0.0
        for j in range(r - 1, -1, -1):
            t = th[j]
            if lb[t] * sxl > 0.0:
                lj = abs(lb[t])
                axl1 = axl - lj * (n[t] + nc[t])
                axl2 = lj / log28
                if axl1 > axl2:
                    axl = axl1
                else:
                    if axl > axl2:
                        axl = axl2
                    sum1 = (axl - axl1) / lj
                    for kk in range(j - 1, -1, -1):
                        sum1 += n[th[kk]] + nc[th[kk]]
                    break
        if sum1 > 100.0:
            st['fail'] = True
            return 1.0
        return 2.0 ** (sum1 / 4.0) / (pi_ * axl * axl)

    qfval = -1.0
    ifault = 0
    n_integrations = 0
    acc1 = acc
    xlim = float(lim)
    try:
        for j in range(r):
            if n[j] < 0:
                raise ValueError(
                    f"Degrees of freedom parameters must all be positive, "
                    f"{j}'th parameter is {n[j]}.")
            if nc[j] < 0.0:
                raise ValueError(
                    f"Non-centrality parameters must all be positive, "
                    f"{j}'th parameter is {nc[j]}.")
        sd = st['sigsq']
        for j in range(r):
            nj, lj, ncj = n[j], lb[j], nc[j]
            sd += lj * lj * (2 * nj + 4.0 * ncj)
            st['mean'] += lj * (nj + ncj)
            if st['lmax'] < lj:
                st['lmax'] = lj
            elif st['lmin'] > lj:
                st['lmin'] = lj
        if sd == 0.0:
            qfval = 1.0 if c > 0.0 else 0.0
            raise _DaviesException()
        sd = math.sqrt(sd)
        almx = -st['lmin'] if st['lmax'] < -st['lmin'] else st['lmax']

        utx = 16.0 / sd
        up = 4.5 / sd
        un = -up
        utx = findu(utx, 0.5 * acc1)
        if c != 0.0 and almx > 0.07 * sd:
            tausq = 0.25 * acc1 / cfe(c)
            if st['fail']:
                st['fail'] = False
            elif truncation(utx, tausq) < 0.2 * acc1:
                st['sigsq'] += tausq
                utx = findu(utx, 0.25 * acc1)
        acc1 = 0.5 * acc1

        # range check + integration-interval loop: auxiliary integrations
        # (with a convergence factor) shrink acc1 / enlarge sigsq until the
        # main integration needs an acceptable number of terms
        intv = 0.0
        xnt = 0.0
        while True:
            c2, up = ctff(acc1, up)
            d1 = c2 - c
            if d1 < 0.0:
                qfval = 1.0
                raise _DaviesException()
            c2, un = ctff(acc1, un)
            d2 = c - c2
            if d2 < 0.0:
                qfval = 0.0
                raise _DaviesException()
            intv = 2.0 * pi_ / (d1 if d1 > d2 else d2)
            xnt = utx / intv
            xntm = 3.0 / math.sqrt(acc1)
            if xnt <= xntm * 1.5:
                break
            if xntm > xlim:
                ifault = 1
                raise _DaviesException()
            ntm = int(math.floor(xntm + 0.5))
            intv1 = utx / ntm
            x = 2.0 * pi_ / intv1
            if x <= abs(c):
                break
            tausq = 0.33 * acc1 / (1.1 * (cfe(c - x) + cfe(c + x)))
            if st['fail']:
                break
            acc1 = 0.67 * acc1
            integrate(ntm, intv1, tausq, False)
            xlim -= xntm
            st['sigsq'] += tausq
            n_integrations += 1
            utx = findu(utx, 0.25 * acc1)
            acc1 = 0.75 * acc1

        # main integration
        if xnt > xlim:
            ifault = 1
            raise _DaviesException()
        nt = int(math.floor(xnt + 0.5))
        integrate(nt, intv, 0.0, True)
        n_integrations += 1
        qfval = 0.5 - st['intl']

        # round-off-error significance test (radix 8/16 machines)
        up_ = st['ersm']
        x = up_ + acc / 10.0
        for rat in (1, 2, 4, 8):
            if rat * x == rat * up_:
                ifault = 2
    except _DaviesException:
        pass
    return qfval, n_integrations, ifault


def _imhof(x0: float, w: np.ndarray, k: np.ndarray, lam: np.ndarray,
           sigma: float, min_accuracy: float):
    """Imhof (1961) characteristic-function inversion for the general case."""
    def theta(u):
        t = 0.5 * np.sum(k * np.arctan(w * u) + lam * w * u / (1.0 + (w * u) ** 2))
        return t - 0.5 * x0 * u

    def rho(u):
        r = np.prod((1.0 + (w * u) ** 2) ** (0.25 * k)) * np.exp(
            0.5 * np.sum(lam * (w * u) ** 2 / (1.0 + (w * u) ** 2)))
        return r * np.exp(0.125 * sigma ** 2 * u ** 2)

    def integrand(u):
        if u == 0.0:
            # limit: theta(u)/u -> 0.5*sum(k*w + lam*w) - 0.5*x0
            return 0.5 * np.sum(k * w + lam * w) - 0.5 * x0
        return math.sin(theta(u)) / (u * rho(u))

    val, err = quad(integrand, 0.0, np.inf, limit=200, epsabs=min_accuracy / 10)
    p_gt = 0.5 + val / math.pi
    p = 1.0 - p_gt
    p = min(max(p, 0.0), 1.0)
    converged = err < min_accuracy * 10 or err < 1e-4
    return p, bool(converged)


def pgenchisq_py(x: float, w: Sequence[float], k: Sequence[int],
                 lam: Sequence[float], mu: float, sigma: float,
                 max_iterations: int = 10_000, min_accuracy: float = 1e-5
                 ) -> Tuple[float, int, bool, int]:
    """P(Q <= x) via Davies AS 155; returns (value, n_iterations, converged,
    fault) matching the reference's `hl.pgenchisq` struct
    (python/hail/expr/functions.py:2387, converged == (fault == 0),
    n_iterations == number of integrations performed)."""
    x0 = x - mu
    val, nint, fault = davies_qf(x0, list(k), list(w), list(lam), sigma,
                                 int(max_iterations), float(min_accuracy))
    return val, nint, fault == 0, fault


def pgenchisq_sf_py(x: float, w: Sequence[float], k: Sequence[int],
                    lam: Sequence[float], mu: float, sigma: float,
                    max_iterations: int = 10**5, min_accuracy: float = 1e-6
                    ) -> Tuple[float, bool]:
    """P(Q > x) with full relative precision in the right tail when possible.

    For the central all-positive case (the SKAT path) the Ruben survival sum
    preserves tiny tail probabilities (e.g. 1e-24) that `1 - cdf` would round
    to 0; otherwise falls back to the complement of :func:`pgenchisq_py`.
    """
    w_arr = np.asarray(w, dtype=np.float64)
    k_arr = np.asarray(k, dtype=np.float64)
    lam_arr = np.asarray(lam, dtype=np.float64)
    x0 = x - mu
    if (sigma == 0.0 and w_arr.size > 0 and np.all(w_arr > 0)
            and np.all(lam_arr == 0.0)):
        if x0 <= 0.0:
            return 1.0, True
        _, sf, ok = _ruben_central(x0, w_arr, k_arr, max_terms=max_iterations)
        if ok and not math.isnan(sf):
            return sf, True
    p, _, conv, fault = pgenchisq_py(x, w, k, lam, mu, sigma,
                                     max_iterations, min_accuracy)
    return max(min(1.0 - p, 1.0), 0.0), bool(conv and fault == 0)
