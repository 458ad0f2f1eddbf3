"""Device/host-split matrix decompositions (port of hail_tpu/ops/decomp.py).

The reference's split, kept here: the big products run where the input
lives (a `torch.Tensor` on the session's device, or a numpy array on the
host), and every small factorization (the l x l Cholesky and eigh, the
driver-side SVD) runs in host LAPACK, as the reference runs it
(`hail/python/hail/methods/pca.py:345-404`, `linalg/BlockMatrix.scala`
svd). The l x l matrices are tiny (l = k + oversample), and the same LAPACK
call on the same l x l input gives the same eigenvector signs as the
reference's, so the scores keep the reference's signs. Only l x l (or
k-column) matrices cross between the device and the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['chol_qr', 'randomized_svd', 'gramian_svd', 'host_svd']


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _like(x: np.ndarray, ref):
    """`x` on the backend of `ref`: a tensor on its device, or numpy."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(x)).to(ref.device, ref.dtype)
    return x


def _orthonormalizer(G: np.ndarray) -> np.ndarray:
    """Given G = Y^T Y (host, l x l), return host R^{-1} with Y @ R^{-1}
    orthonormal. Cholesky when G is PD; symmetric (eigh) orthogonalization
    as the rank-deficient fallback."""
    l = G.shape[0]
    try:
        L = np.linalg.cholesky(G)
        return np.linalg.inv(L).T          # R^{-1} = (L^T)^{-1}
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(G)
        tol = max(np.max(w), 0.0) * l * np.finfo(G.dtype).eps
        inv_sqrt = np.where(w > tol, 1.0 / np.sqrt(np.maximum(w, tol)), 0.0)
        return (V * inv_sqrt[None, :]) @ V.T


def chol_qr(Y, rounds: int = 2):
    """Tall-skinny orthonormalization via CholeskyQR^2.

    Y: (m, l) with small l. Each round is one product Y^T Y where Y lives,
    one host l x l factorization, and one product Y @ R^{-1}. Two rounds
    give orthogonality to machine precision for any reasonably conditioned
    Y (CholeskyQR2, Yamamoto et al.). Returns Q on the same backend as Y."""
    Q = Y
    for _ in range(rounds):
        Rinv = _orthonormalizer(_host(Q.T @ Q))
        Q = Q @ _like(Rinv, Q)
    return Q


def randomized_svd(A, k: int, q: int = 2, oversample: int = 10,
                   seed: int = 0):
    """Halko randomized SVD (the reference's Blanczos scheme, pca.py:345)
    with only products where A lives. Ω is drawn on the host from
    `np.random.default_rng(seed & 0xFFFFFFFF)`, the reference's draw.

    Returns (U (m, k) on the backend of A, s (k,) host float64,
    Vt (k, n) on the backend of A)."""
    m, n = A.shape
    l = min(k + oversample, min(m, n))
    rng = np.random.default_rng(seed & 0xFFFFFFFF)
    np_dtype = (torch.empty((), dtype=A.dtype).numpy().dtype
                if isinstance(A, torch.Tensor) else np.dtype(A.dtype))
    Omega = _like(rng.normal(size=(n, l)).astype(np_dtype), A)
    Y = A @ Omega
    Q = chol_qr(Y)
    for _ in range(q):
        Z = A.T @ Q
        Qz = chol_qr(Z)
        Y = A @ Qz
        Q = chol_qr(Y)
    B = Q.T @ A                              # (l, n), where A lives
    BBt = _host(B @ B.T)                     # l x l to the host
    w, V = np.linalg.eigh(BBt)               # host, ascending
    w = w[::-1]
    V = V[:, ::-1]
    s = np.sqrt(np.maximum(w, 0.0))
    tol = s[0] * max(m, n) * np.finfo(s.dtype).eps if s.size else 0.0
    sinv = np.where(s > tol, 1.0 / np.maximum(s, tol if tol > 0 else 1.0), 0.0)
    W = sinv[:, None] * V.T                  # diag(1/s) @ V^T, host l x l
    Vt = _like(W, A) @ B                     # (l, n)
    U = Q @ _like(V, A)                      # (m, l)
    return U[:, :k], s[:k], Vt[:k]


def gramian_svd(A, compute_uv: bool = True):
    """Exact SVD of a matrix (a tensor on its device, or numpy) via the
    smaller gramian: the product A^T A (or A A^T) where A lives, host eigh,
    and one more product to recover the long factor. Mirrors the reference
    BlockMatrix svd path above its complexity bound
    (`linalg/BlockMatrix.scala` svd)."""
    m, n = A.shape
    if n <= m:
        G = _host(A.T @ A)                   # n x n to the host
        w, V = np.linalg.eigh(G)
        w, V = w[::-1], V[:, ::-1]
        s = np.sqrt(np.maximum(w, 0.0))
        if not compute_uv:
            return s
        tol = (s[0] * max(m, n) * np.finfo(s.dtype).eps) if s.size else 0.0
        sinv = np.where(s > tol, 1.0 / np.maximum(s, max(tol, 1e-300)), 0.0)
        U = (A @ _like(V, A)) * _like(sinv, A)[None, :]
        return _host(U), s, V.T
    G = _host(A @ A.T)                       # m x m to the host
    w, U = np.linalg.eigh(G)
    w, U = w[::-1], U[:, ::-1]
    s = np.sqrt(np.maximum(w, 0.0))
    if not compute_uv:
        return s
    tol = (s[0] * max(m, n) * np.finfo(s.dtype).eps) if s.size else 0.0
    sinv = np.where(s > tol, 1.0 / np.maximum(s, max(tol, 1e-300)), 0.0)
    Vt = _like(sinv, A)[:, None] * (_like(U, A).T @ A)
    return U, s, _host(Vt)


def host_svd(A, full_matrices: bool = False):
    """Driver-side LAPACK SVD of a small matrix (copied to the host if it is
    a tensor on a device)."""
    return np.linalg.svd(_host(A), full_matrices=full_matrices)
