"""Device-tier GLM: batched per-variant Newton / Firth fits (port of
hail_tpu/ops/glm_device.py).

The default engine behind `logistic_regression_rows` and
`poisson_regression_rows` (methods/statgen.py): one call fits a whole
block of variants at once, in f64 torch on the device, replacing the
reference's per-variant LAPACK loops (`is/hail/methods/LogisticRegression
.scala`, lowered python in reference statgen.py:1041 `logreg_fit` / :1191
`_firth_fit` / :1852 `_poisson_fit`) with per-variant-frozen batched
iterations. No kernel is written by hand here: the work is small batched
solves and matrix products, left to torch as the reference left them to XLA.

Faithfulness contract (vs the host port in stats/glmfit.py, the
operation-for-operation reference mirror):
  * each variant's Newton trajectory is its independent host loop's:
    converged/exploded/maxed variants FREEZE (their b stops moving and
    their n_iterations/log_lkhd are recorded at the stop) while the batch
    iterates the rest, so `n_iterations`, `converged` and `exploded` match
    the reference exactly and b/se/p match to float-reassociation noise.
  * the initial score/fisher reuse the null fit's covariate blocks (the
    reference quirk at statgen.py:1069-1078), and the poisson wald/lrt
    prelude evaluates its initial mu with sigmoid (statgen.py:1833).
  * explosion = singular solve, seen as a non-finite Newton step. A
    Cholesky factor that fails (`cholesky_ex` info != 0), holds a
    non-finite entry or has a pivot that is zero within roundoff becomes
    all NaN, the way the reference's `jnp.linalg.cholesky` reports a
    non-SPD matrix; `torch.linalg.cholesky` would raise for the whole block
    instead. The roundoff guard matters for an x that equals a covariate:
    its last pivot is O(eps) of its diagonal entry with a sign set by the
    order of the sums, so without the guard the two packages' factorings
    would split such rows between exploded and converged at random. No
    ridge is added: a ridge would mask the singularity the reference
    reports as `exploded`.

The `while_loop`s of the reference are Python loops here: one host sync
per iteration for the any-row-active test.

Memory: a block of R rows over N samples keeps a few (R, N) f64 planes
live in each iteration (`_NEWTON_PLANES`, `_SCORE_PLANES`), and the
backend's pool threads fit their partitions' blocks at once. So each
device has one budget (`_Budget`), half of what its device cache leaves of
its memory, and a block is made and fitted only while it holds its bytes
of that budget. Blocks are sized from N, k and the budget (`_row_block`)
so that `_IN_FLIGHT` of them share it: at biobank width (N = 361,194) a
block is a few hundred rows, at a few thousand samples the most,
`_MAX_BLOCK`. Each row's arithmetic is the same in any
block, so the results do not depend on the block size beyond the order
in which a matrix product sums.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..utils import timer
from .regression import _impute_mean_nan

_F64 = torch.float64


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


# A Cholesky pivot whose square is at or below this share of its diagonal
# entry is zero within f64 roundoff (its computed value is O(M·eps) of the
# entry, and its sign is noise): the matrix is singular.
_PIVOT_RTOL = 2.0 ** -46


def _chol(H):
    """Batched lower Cholesky factor; a matrix that is not SPD within
    roundoff, or not finite, gives an all-NaN factor (the reference's
    cholesky semantics, see the module doc). Like `jnp.linalg.cholesky` it
    factors the symmetrized input."""
    Hs = (H + H.mT) * 0.5
    L, info = torch.linalg.cholesky_ex(Hs)
    piv = torch.diagonal(L, dim1=1, dim2=2)
    bad = ((info != 0) | ~torch.isfinite(L).flatten(1).all(dim=1)
           | (piv * piv <= _PIVOT_RTOL
              * torch.diagonal(Hs, dim1=1, dim2=2)).any(dim=1))
    return torch.where(bad[:, None, None], torch.nan, L)


def _chol_solve(H, g):
    """Batched SPD solve; singular → NaN (explosion signal, see module doc)."""
    L = _chol(H)
    y = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0]


def _bernoulli_ll(y, mu):
    return torch.log(y[None, :] * mu + (1.0 - y[None, :]) * (1.0 - mu)).sum(
        dim=-1)


# status codes for the per-variant freeze
_ACTIVE, _CONV, _EXPL, _MAXED = 0, 1, 2, 3


def _fisher(Hcc, Hcg, Hgg):
    """[[Hcc, Hcg], [Hcgᵀ, Hgg]] as (R, k+1, k+1)."""
    R, k = Hcg.shape
    F = torch.zeros((R, k + 1, k + 1), dtype=Hcg.dtype, device=Hcg.device)
    F[:, :k, :k] = Hcc
    F[:, :k, k] = Hcg
    F[:, k, :k] = Hcg
    F[:, k, k] = Hgg
    return F


def _freeze(status, n_iter, active, bad, maxd, it, max_iterations, tolerance):
    """One iteration's stop decisions: (status, n_iter, stopped, step)."""
    now_expl = active & bad
    now_conv = active & ~bad & (maxd < tolerance)
    now_maxed = active & ~bad & ~(maxd < tolerance) & (it >= max_iterations)
    stopped = now_expl | now_conv | now_maxed
    status = torch.where(now_expl, _EXPL,
                         torch.where(now_conv, _CONV,
                                     torch.where(now_maxed, _MAXED, status)))
    n_iter = torch.where(stopped, it, n_iter)
    return (status.to(torch.int32), n_iter.to(torch.int32), stopped,
            active & ~stopped)


def glm_newton_batch(G, Mmask, Cov, y, null_b, null_score, null_fisher,
                     max_iterations: int, tolerance: float,
                     link: str = 'logistic'):
    """Batched per-variant Newton fit of y ~ link⁻¹([Cov, g]·b).

    G: (R, N) raw dosages; Mmask: (R, N) missing; Cov: (N, k); y: (N,);
    null_b/score/fisher: the host null fit (k,), (k,), (k, k); all f64
    tensors on one device.

    Returns (b (R,m), score (R,m), fisher (R,m,m), n_iter (R,), ll (R,),
    status (R,)) with m = k+1 and status in {1: converged, 2: exploded,
    3: hit max_iterations}. Matches stats/glmfit.logreg_fit / poisson_fit
    per variant (see module docstring). A `glm.newton` span with the
    block's shape, its iterations and `row_iters`, the rows still active
    summed over the iterations.
    """
    R, N = G.shape
    k = Cov.shape[1]
    with timer.span('glm.newton', rows=R, samples=N, covariates=k) as sp:
        dev = G.device
        Gi = _impute_mean_nan(G, Mmask)

        # initial state (reference statgen.py:1069-1078 / :1820-1840):
        # b_g = 0 so eta/mu are the shared null linear predictor; for
        # poisson the prelude's mu uses sigmoid (the reference quirk), the
        # loop's updates use exp.
        eta0 = Cov @ null_b
        mu0 = _sigmoid(eta0)
        w0 = mu0 * (1.0 - mu0) if link == 'logistic' else mu0
        r0 = y - mu0
        # P[n, k*l] = Cov[n,k]·Cov[n,l]: the per-variant covariate Fisher
        # block Σ_n w[r,n]·Cov[n,k]·Cov[n,l] as ONE (R,N)x(N,k²) matrix
        # product
        P = (Cov[:, :, None] * Cov[:, None, :]).reshape(N, k * k)
        b = torch.cat([null_b.expand(R, k), torch.zeros((R, 1), dtype=_F64,
                                                         device=dev)], dim=1)
        score = torch.cat([null_score.expand(R, k), (Gi @ r0)[:, None]], dim=1)
        f01 = (Gi * w0[None, :]) @ Cov                        # (R, k)
        f11 = (w0[None, :] * Gi * Gi).sum(dim=1)              # (R,)
        fisher = _fisher(null_fisher.expand(R, k, k), f01, f11)
        mu = mu0.expand(R, N)

        def loglik(mu):
            if link == 'logistic':
                return _bernoulli_ll(y, mu)
            return (y[None, :] * torch.log(mu) - mu).sum(dim=-1)

        status = torch.zeros(R, dtype=torch.int32, device=dev)
        n_iter = torch.zeros(R, dtype=torch.int32, device=dev)
        it, row_iters = 1, 0
        while True:
            active = status == _ACTIVE
            n_active = int(active.sum())
            if not n_active:
                break
            row_iters += n_active
            delta = _chol_solve(fisher, score)                # (R, m)
            finite = torch.isfinite(delta)
            bad = ~finite.all(dim=1)
            maxd = delta.abs().amax(dim=1)
            status, n_iter, _, step = _freeze(status, n_iter, active, bad,
                                              maxd, it, max_iterations,
                                              tolerance)
            # ll is NOT computed here: mu freezes for stopped rows, so the
            # post-loop loglik(mu_final) equals the value at stop time
            delta = torch.where(finite, delta, 0.0)
            b = torch.where(step[:, None], b + delta, b)
            # recompute mu/score/fisher at the stepped b (full recompute: the
            # null-block reuse happens only at initialization, as in
            # reference); each (R, N) plane is dropped once used, so that a
            # block's peak stays within _NEWTON_PLANES
            eta = (Cov @ b[:, :k].T).T + Gi * b[:, k:k + 1]   # (R, N)
            mu_new = _sigmoid(eta) if link == 'logistic' else torch.exp(eta)
            del eta
            w = mu_new * (1.0 - mu_new) if link == 'logistic' else mu_new
            r = y[None, :] - mu_new
            sc = torch.cat([r @ Cov, (r * Gi).sum(dim=1)[:, None]], dim=1)
            del r
            fi = _fisher((w @ P).reshape(R, k, k), (w * Gi) @ Cov,
                         (w * Gi * Gi).sum(dim=1))
            del w
            mu = torch.where(step[:, None], mu_new, mu)
            del mu_new
            score = torch.where(step[:, None], sc, score)
            fisher = torch.where(step[:, None, None], fi, fisher)
            it += 1
        ll = loglik(mu)      # mu is frozen at each row's stopping iteration
        sp.set(iterations=it - 1, row_iters=row_iters)
        return b, score, fisher, n_iter, ll, status


def wald_stats_batch(b, fisher):
    """se/z for the genotype coefficient from inv(fisher) at the fit
    (reference wald_test, statgen.py:1136). A `glm.wald` span."""
    m = b.shape[1]
    with timer.span('glm.wald', rows=b.shape[0]):
        L = _chol(fisher)
        eye = torch.eye(m, dtype=fisher.dtype, device=fisher.device).expand(
            fisher.shape)
        yv = torch.linalg.solve_triangular(L, eye, upper=False)
        cov = torch.linalg.solve_triangular(L.mT, yv, upper=True)
        se = torch.sqrt(cov[:, m - 1, m - 1])
        z = b[:, m - 1] / se
        return se, z


def glm_score_batch(G, Mmask, Cov, y, null_b, null_score, null_fisher,
                    link: str = 'logistic'):
    """Batched full-system score test at the null (reference
    logistic_score_test statgen.py:1161 / _poisson_score_test :1924):
    chi² = scoreᵀ fisher⁻¹ score over the full (k+1) system, including the
    null fit's (≈tolerance-sized, nonzero) covariate score block."""
    R, N = G.shape
    k = Cov.shape[1]
    Gi = _impute_mean_nan(G, Mmask)
    eta0 = Cov @ null_b
    mu0 = _sigmoid(eta0) if link == 'logistic' else torch.exp(eta0)
    w0 = mu0 * (1.0 - mu0) if link == 'logistic' else mu0
    r0 = y - mu0
    score = torch.cat([null_score.expand(R, k), (Gi @ r0)[:, None]], dim=1)
    f01 = (Gi * w0[None, :]) @ Cov
    f11 = (w0[None, :] * Gi * Gi).sum(dim=1)
    fisher = _fisher(null_fisher.expand(R, k, k), f01, f11)
    sol = _chol_solve(fisher, score)
    return (score * sol).sum(dim=1)


def firth_fit_batch(Gi, Cov, y, b0, m0: int, max_iterations: int,
                    tolerance: float):
    """Batched Firth penalized fit (reference _firth_fit, statgen.py:1191):
    the weighted FULL design [Cov, g]·√W every iteration; only the first m0
    coefficients move. Gi: (R, N) already-imputed dosages; b0: (R, m0)
    start. Returns (b, n_iter, ll, status) with the same per-variant freeze
    semantics as glm_newton_batch."""
    R, N = Gi.shape
    k = Cov.shape[1]
    dev = Gi.device

    def eta_of(b):
        if m0 <= k:
            return (Cov[:, :m0] @ b.T).T.expand(R, N)
        return (Cov @ b[:, :k].T).T + Gi * b[:, k:k + 1]

    # the full design, transposed: (R, M, N), the same for every iteration
    Xt = torch.cat([Cov.T[None].expand(R, k, N), Gi[:, None, :]], dim=1)
    eye = torch.eye(k + 1, dtype=_F64, device=dev).expand(R, k + 1, k + 1)
    b = b0
    status = torch.zeros(R, dtype=torch.int32, device=dev)
    n_iter = torch.zeros(R, dtype=torch.int32, device=dev)
    ll = torch.zeros(R, dtype=_F64, device=dev)
    it = 1
    while bool((status == _ACTIVE).any()):
        active = status == _ACTIVE
        mu = _sigmoid(eta_of(b))                          # (R, N)
        w = mu * (1.0 - mu)
        # Normal equations instead of the reference's per-variant QR of
        # √W·X (statgen.py:1222), as hail_tpu does: F = XᵀWX = RᵀR, so
        # Σ log diag L = Σ log|diag R|, h_n = w_n‖L⁻¹xₙ‖², and the leading
        # m0×m0 block of L is the Cholesky of F₁₁. Explosion = non-SPD F →
        # NaNs in L, the same singularities QR reported via diag R.
        wg = w * Gi                                       # (R, N)
        F_cc = torch.einsum('ni,rn,nj->rij', Cov, w, Cov)
        F_cg = torch.einsum('ni,rn->ri', Cov, wg)
        F_gg = (wg * Gi).sum(dim=1)
        L = _chol(_fisher(F_cc, F_cg, F_gg))              # (R, M, M)
        # L⁻¹xₙ for all N samples as one batched product with the inverse
        # factor: a triangular solve with N right-hand sides per row runs
        # column by column and dominates the fit
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        V = Linv @ Xt
        h = w * (V * V).sum(dim=1)                        # (R, N)
        resid = y[None, :] - mu
        rho = resid + h * (0.5 - mu)
        dep = torch.einsum('rmn,rn->rm', Xt[:, :m0], rho)
        L11 = L[:, :m0, :m0]
        diag_l0 = torch.diagonal(L11, dim1=1, dim2=2)
        bad_coef = (~torch.isfinite(diag_l0).all(dim=1)
                    | (diag_l0 == 0.0).any(dim=1))
        t1 = torch.linalg.solve_triangular(L11, dep[..., None], upper=False)
        delta = torch.linalg.solve_triangular(L11.mT, t1, upper=True)[..., 0]
        finite = torch.isfinite(delta)
        bad = bad_coef | ~finite.all(dim=1)
        maxd = torch.where(finite.all(dim=1), delta.abs().amax(dim=1),
                           torch.inf)
        diag_full = torch.diagonal(L, dim1=1, dim2=2)
        ll_now = (_bernoulli_ll(y, mu)
                  + torch.log(diag_full.abs()).sum(dim=1))
        status, n_iter, stopped, step = _freeze(
            status, n_iter, active, bad, maxd, it, max_iterations, tolerance)
        ll = torch.where(stopped, ll_now, ll)
        delta = torch.where(finite, delta, 0.0)
        b = torch.where(step[:, None], b + delta, b)
        it += 1
    return b, n_iter, ll, status


# ---------------------------------------------------------------------------
# host side: blocked execution + result assembly
# ---------------------------------------------------------------------------

def _firth_row_block(N: int, M: int) -> int:
    """Row block sized so the (R, M, N) workspace stays ≲0.5 GiB f64."""
    return max(16, min(1024, (1 << 26) // max(N * M, 1)))


# The (R, N) f64 planes that a block keeps live for each of its rows at the
# peak of an iteration, with room for the bool mask and the allocator's
# slack: glm_newton_batch holds the raw and the imputed x, mu and four
# planes of the step at once; glm_score_batch the two x planes and three
# of the statistic; firth_fit_batch 3 M + 8: the design, its product with
# the inverse factor and that product's square (M planes each) and a few
# more.
_NEWTON_PLANES = 9
_SCORE_PLANES = 5


_MIN_BLOCK, _MAX_BLOCK = 16, 2048
# blocks that share a device's budget at once: while one thread waits on
# its iteration's sync, another launches its work. More blocks of fewer
# rows hold more copies of P, fewer of more rows more planes at the peak;
# on the card one, two or four take one time at biobank width.
_IN_FLIGHT = 2


class _Budget:
    """The bytes of block workspace that the backend's pool threads hold
    at once on one device. A block waits until its bytes fit beside those
    held; a block larger than the whole capacity runs alone."""

    def __init__(self):
        self._held = 0
        self._cond = threading.Condition()

    @contextlib.contextmanager
    def hold(self, nbytes: int, capacity: int):
        with self._cond:
            self._cond.wait_for(
                lambda: not self._held or self._held + nbytes <= capacity)
            self._held += nbytes
        try:
            yield
        finally:
            with self._cond:
                self._held -= nbytes
                self._cond.notify_all()


_budgets: dict = {}
_budgets_lock = threading.Lock()


def _budget(dev) -> _Budget:
    """The one budget of device `dev`."""
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    with _budgets_lock:
        return _budgets.setdefault(dev, _Budget())


def _memory(dev) -> int:
    """The device's memory in bytes: the card's, or the host's for the
    CPU."""
    if dev.type == 'cuda':
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')


def _capacity(dev) -> int:
    """The device's budget for block workspace: half of what its device
    cache (ops/devcache.py) leaves of its memory. The other half is for
    the allocator's slack and whatever else the process keeps there."""
    from . import devcache
    return max(0, _memory(dev) - devcache.stats()['bytes']) // 2


def _row_block(R: int, row_bytes: int, fixed_bytes: int, capacity: int,
               most: int) -> int:
    """Rows of each block of a partition of R rows: as many as let
    `_IN_FLIGHT` blocks share `capacity`, within [_MIN_BLOCK, most], then
    evened out: the n = ceil(R / rows) blocks take ceil(R / n) rows each,
    the last the rest."""
    rows = (capacity // _IN_FLIGHT - fixed_bytes) // max(row_bytes, 1)
    rows = int(max(_MIN_BLOCK, min(most, rows)))
    return -(-R // -(-R // rows)) if R else rows


def _row_blocks(R: int, block: int):
    for s in range(0, R, block):
        yield s, min(s + block, R)


def _slice_cached_block(gz8, m8, s: int, e: int):
    """Rows [s, e) of the cached int8 entry pair (ops/devcache.py form) as
    f64 dosages and a bool missing mask, on the pair's device: no h2d at
    all, the GLM reads the same device buffers the linreg path staged.
    Blocks are not padded: torch keeps no compile cache for shapes to hit."""
    return gz8[s:e].to(_F64), m8[s:e] > 0


def _block_source(G, Mmask, cached: bool, s: int, e: int, device):
    """Rows [s, e) as (Gb, Mb) on `device`: `cached` means (G, Mmask) are
    the device (gz8, m8) int8 pair and slicing happens on the device,
    otherwise they are host arrays."""
    if cached:
        return _slice_cached_block(G, Mmask, s, e)
    return (torch.as_tensor(np.asarray(G[s:e], np.float64), device=device),
            torch.as_tensor(np.asarray(Mmask[s:e], bool), device=device))


def _fit_blocks(G, Mmask, cached: bool, dev, row_bytes: int,
                fixed_bytes: int, most: int, fit) -> list:
    """fit(Gb, Mb, n) over the row blocks of (G, Mmask), each block made on
    `dev` (`_block_source`) and fitted while it holds its bytes of the
    device's budget (`row_bytes` a row and `fixed_bytes` a block); the
    list of fit's results."""
    R = int(G.shape[0])
    capacity = _capacity(dev)
    block = _row_block(R, row_bytes, fixed_bytes, capacity, most)
    budget = _budget(dev)
    out = []
    for s, e in _row_blocks(R, block):
        with budget.hold(fixed_bytes + row_bytes * (e - s), capacity):
            Gb, Mb = _block_source(G, Mmask, cached, s, e, dev)
            out.append(fit(Gb, Mb, e - s))
            del Gb, Mb
    return out


def _newton_bytes(N: int, k: int) -> tuple:
    """(bytes a row, bytes a block) of glm_newton_batch's workspace: its
    (R, N) planes, and P = (N, k²) of the covariates' products."""
    return _NEWTON_PLANES * N * 8, N * k * k * 8


def _stacked_fetch(parts):
    """One device-to-host copy for a whole partition's results: each
    output's blocks concatenated, flattened and stacked into one f64 tensor
    (one `torch.cat` and one `.cpu()`, a `fetch` span with its bytes), then
    split on the host."""
    cats = [torch.cat(p, dim=0) if len(p) > 1 else p[0] for p in parts]
    flat = torch.cat([c.reshape(c.shape[0], -1).to(_F64) for c in cats],
                     dim=1)
    with timer.span('fetch', bytes=flat.nbytes, transfers=1):
        host = flat.cpu().numpy()
    out, o = [], 0
    for c in cats:
        w = int(np.prod(c.shape[1:])) if c.ndim > 1 else 1
        v = host[:, o:o + w]
        out.append(v.reshape((host.shape[0],) + tuple(c.shape[1:])))
        o += w
    return out


_linalg_lock = threading.Lock()
_linalg_ready: set = set()


def _device_of(G, device):
    """The device of a call: `device` if given, else the cached pair's, else
    the CPU. On a CUDA device, torch's linear-algebra backend is loaded
    here once, under a lock: torch loads it lazily at the first solve, and
    that first load fails when the partitions' threads race to it."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = G.device if isinstance(G, torch.Tensor) else torch.device('cpu')
    if dev.type == 'cuda' and dev not in _linalg_ready:
        with _linalg_lock:
            if dev not in _linalg_ready:
                eye = torch.eye(2, dtype=_F64, device=dev)[None]
                torch.linalg.solve_triangular(
                    torch.linalg.cholesky_ex(eye)[0], eye, upper=False)
                _linalg_ready.add(dev)
    return dev


def _null_tensors(null_fit, device):
    return tuple(torch.as_tensor(np.asarray(null_fit[f], np.float64),
                                 device=device)
                 for f in ('b', 'score', 'fisher'))


def _score_device(G, Mmask, Covd, yd, null_fit, link: str, most: int,
                  cached: bool, device):
    """The score test over blocks. Distinguishes the reference's two "no number"
    shapes: NaN inputs (all-missing / NaN dosage rows) flow through the
    reference's dgesv as NaN FLOATS (`nan_input`), while a singular finite
    fisher raises there and yields None (`valid`=False, `nan_input`=False)."""
    nb, nsc, nfi = _null_tensors(null_fit, device)
    N = int(G.shape[1])
    chis = _fit_blocks(
        G, Mmask, cached, device, _SCORE_PLANES * N * 8, 0, most,
        lambda Gb, Mb, n: glm_score_batch(Gb, Mb, Covd, yd, nb, nsc, nfi,
                                          link))
    (chi2,) = _stacked_fetch([chis]) if chis else (np.zeros(0),)
    if cached:
        # int8 entries are always finite; only all-missing rows are NaN-input
        nan_in = (Mmask > 0).all(dim=1).cpu().numpy()
    else:
        nan_in = (Mmask.all(axis=1)
                  | (~np.isfinite(np.where(Mmask, 0.0, G))).any(axis=1))
    return dict(chi_sq_stat=chi2, valid=np.isfinite(chi2) | nan_in,
                nan_input=nan_in)


_NEWTON_OUT = ('b', 'score', 'fisher', 'n_iter', 'll', 'status')


def _newton_device(G, Mmask, Covd, yd, null_fit, test: str,
                   max_iterations: int, tolerance: float, link: str,
                   most: int, cached: bool, dev, keep) -> dict:
    """The wald/lrt Newton fits over blocks: the outputs of
    glm_newton_batch named in `keep` and, for wald, se and z, fetched to
    one host array each."""
    nb, nsc, nfi = _null_tensors(null_fit, dev)
    names = list(keep) + (['se', 'z'] if test == 'wald' else [])

    def fit(Gb, Mb, n):
        out = dict(zip(_NEWTON_OUT, glm_newton_batch(
            Gb, Mb, Covd, yd, nb, nsc, nfi, max_iterations, tolerance,
            link)))
        if test == 'wald':
            out['se'], out['z'] = wald_stats_batch(out['b'], out['fisher'])
        return [out[n] for n in names]
    row_bytes, fixed_bytes = _newton_bytes(int(G.shape[1]), Covd.shape[1])
    return dict(zip(names, _stacked_fetch(list(zip(*_fit_blocks(
        G, Mmask, cached, dev, row_bytes, fixed_bytes, most, fit))))))


def logistic_rows_device(G, Mmask, Cov, y, null_fit, test: str,
                         max_iterations: int, tolerance: float,
                         block_rows: Optional[int] = None,
                         cached: bool = False, device=None):
    """Run one logistic test over a (R, N) block; returns a dict of numpy
    per-variant arrays shaped like stats/glmfit's outputs (None-able fields
    as (value_array, valid_mask)).

    `cached=True` means (G, Mmask) are the device-resident int8 (gz8, m8)
    pair from ops/devcache.py, the same buffers linear_regression_rows
    stages, so a warm logistic call moves nothing host-to-device and does
    one stacked device-to-host copy per partition. Otherwise (G, Mmask) are
    host arrays, copied block by block to `device` (default: the CPU).
    Blocks are sized from N, k and the device's budget (module doc);
    `block_rows` caps them."""
    dev = _device_of(G, device)
    N = int(G.shape[1])
    most = block_rows or _MAX_BLOCK
    k = Cov.shape[1]
    Covd = torch.as_tensor(np.asarray(Cov, np.float64), device=dev)
    yd = torch.as_tensor(np.asarray(y, np.float64), device=dev)
    out = {}

    if test == 'score':
        return _score_device(G, Mmask, Covd, yd, null_fit, 'logistic',
                             most, cached, dev)

    if test == 'firth':
        nb = _null_tensors(null_fit, dev)[0]

        def fit(Gb, Mb, n):
            Gid = _impute_mean_nan(Gb, Mb)
            b_n, it_n, ll_n, st_n = firth_fit_batch(
                Gid, Covd, yd, nb.expand(n, k), k, max_iterations, tolerance)
            # full fit warm-started from the improved null (reference
            # firth_test, statgen.py:1257); non-converged nulls run too and
            # are masked by the caller
            b_f0 = torch.cat([b_n, torch.zeros((n, 1), dtype=_F64,
                                               device=dev)], dim=1)
            return (b_n, it_n, ll_n, st_n) + firth_fit_batch(
                Gid, Covd, yd, b_f0, k + 1, max_iterations, tolerance)
        # the block stays at the workspace-bounded size even when cached:
        # the (R, M, N) triangular-solve workspace sits next to the
        # resident entry cache
        blocks = _fit_blocks(G, Mmask, cached, dev,
                             (3 * (k + 1) + 8) * N * 8, 0,
                             min(most, _firth_row_block(N, k + 1)), fit)
        (out['null_b'], out['null_n_iter'], out['null_ll'],
         out['null_status'], out['full_b'], out['full_n_iter'],
         out['full_ll'], out['full_status']) = _stacked_fetch(
             list(zip(*blocks)))
        return out

    # wald / lrt: full Newton fit per variant
    return _newton_device(G, Mmask, Covd, yd, null_fit, test,
                          max_iterations, tolerance, 'logistic', most,
                          cached, dev, ('b', 'n_iter', 'll', 'status'))


def poisson_rows_device(G, Mmask, Cov, y, null_fit, test: str,
                        max_iterations: int, tolerance: float,
                        block_rows: Optional[int] = None,
                        cached: bool = False, device=None):
    """Poisson wald/lrt/score on the device (reference
    _lowered_poisson_regression_rows, statgen.py:1747). `block_rows`,
    `cached` and `device` as in logistic_rows_device."""
    dev = _device_of(G, device)
    most = block_rows or _MAX_BLOCK
    Covd = torch.as_tensor(np.asarray(Cov, np.float64), device=dev)
    yd = torch.as_tensor(np.asarray(y, np.float64), device=dev)
    if test == 'score':
        return _score_device(G, Mmask, Covd, yd, null_fit, 'poisson',
                             most, cached, dev)
    return _newton_device(G, Mmask, Covd, yd, null_fit, test,
                          max_iterations, tolerance, 'poisson', most, cached,
                          dev, _NEWTON_OUT)
