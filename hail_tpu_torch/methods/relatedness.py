"""Relatedness: KING, PC-Relate, PLINK-style IBD, maximal_independent_set
(the port of hail_tpu/methods/relatedness.py).

Capability parity with reference `hail/python/hail/methods/relatedness/`
(`king.py`, `pc_relate.py:38`, `identity_by_descent` → C++ SIMD IBS kernel
`hail/c/ibs.cpp` + `methods/IBSFFI.scala`). The pairwise work runs on the
session's device: IBD's IBS counts in the hand-written CUDA kernel on a
card (ops/ibs.py), or, with `_use_pallas=False`, plain f64 indicator
products; KING's and PC-Relate's products as f64 torch products. The pair
tables are built column by column from the (n, n) results (`_pair_table`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import types as ht
from ..context import Env
from ..expr import functions as F
from ..expr.expression import to_expr
from ..genetics.call import calls_is_het, calls_is_hom_ref, calls_is_hom_var
from ..ir import columns as C
from ..ir.columns import Batch, ObjectColumn, PrimitiveColumn, StructColumn
from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
from ..table import Table, TableStage
from ..utils.structs import Struct
from .statgen import _entry_expr_to_blocks


def _gt_indicator_matrices(call_expr):
    """(het, hom_ref, hom_var, called) float64 (m, n) indicator matrices."""
    e = to_expr(call_expr)
    mt = e._indices.source
    packeds, misses = [], []
    for i, ctx in enumerate(mt._stage.contexts):
        mb = mt._stage.partition_fn(ctx)
        env = mt._entry_env(mb, i)
        col = e._ir.evaluate(env)
        packeds.append(np.asarray(col.values))
        misses.append(col.missing_mask())
    packed = np.concatenate(packeds, axis=0)
    miss = np.concatenate(misses, axis=0)
    called = ~miss
    het = (calls_is_het(packed) & called)
    hom_ref = (calls_is_hom_ref(packed) & called)
    hom_var = (calls_is_hom_var(packed) & called)
    return het, hom_ref, hom_var, called, mt


def _to_device_f64(*arrays) -> tuple:
    """Host arrays as f64 tensors on the session's device (a bool array
    crosses as one byte per entry and widens there)."""
    dev = Env.device()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 .to(torch.float64) for a in arrays)


def _pair_table(mt: MatrixTable, keep: torch.Tensor, fields: dict,
                key_struct: bool) -> Table:
    """The pair table of the reference's per-pair loops, built by column:
    one row per pair (i, j) where `keep` holds (an (n, n) bool tensor, false
    on and below the diagonal unless the pair loop includes i = j), in the
    loops' order (i, then j, ascending). `i` and `j` are the column key: a
    struct of its fields with `key_struct` (pc_relate), else its first
    field typed tstr (identity_by_descent). `fields` maps each further field
    to (type, (n, n) tensor or array), or to a dict of those for a struct
    field; each is taken at the kept pairs and copied to the host."""
    st = mt._stage
    ij = torch.nonzero(keep).cpu().numpy()
    n_pairs = len(ij)
    kt = ht.tstruct(**{kf: st.col_type[kf] for kf in st.col_key})
    keys = C.to_object(st.cols.columns[st.col_key[0]]).values
    cols = {}
    for name, ix in (('i', ij[:, 0]), ('j', ij[:, 1])):
        if key_struct:
            cols[name] = StructColumn(
                kt, {kf: st.cols.columns[kf].gather(ix) for kf in st.col_key},
                None, (n_pairs,))
        else:
            cols[name] = ObjectColumn(ht.tstr, keys[ix])

    def column(spec):
        if isinstance(spec, dict):
            sub = {k: column(v) for k, v in spec.items()}
            return StructColumn(ht.tstruct(**{k: c.typ for k, c in sub.items()}),
                                sub, None, (n_pairs,))
        typ, mat = spec
        if isinstance(mat, np.ndarray):
            mat = torch.from_numpy(mat)
        vals = mat.to(keep.device)[keep].cpu().numpy()
        return PrimitiveColumn(typ, vals.astype(typ.numpy_dtype))

    for name, spec in fields.items():
        cols[name] = column(spec)
    b = Batch(cols, n_pairs)
    return Table(TableStage.from_batches(Batch({}, 1), ['i', 'j'], b.row_type,
                                         [b]))


def _upper(n: int, include_self: bool, device) -> torch.Tensor:
    """The (n, n) mask of the pairs a reference pair loop visits."""
    return torch.ones((n, n), dtype=torch.bool, device=device).triu(
        0 if include_self else 1)


def _king_kernel(H, R, A, Cl):
    """KING-robust kinship via products. All args (m, n) f64 indicators on
    one device; returns the (n, n) φ there."""
    both_het = H.T @ H                      # N_Aa,Aa
    opp = R.T @ A
    opp = opp + opp.T                       # N_AA,aa
    het_shared = H.T @ Cl                   # N_Aa^i over sites where j called
    n_i = het_shared
    n_j = het_shared.T
    min_het = torch.minimum(n_i, n_j)
    # KING between-family estimator (Manichaikul eq. 11; reference king.py):
    # phi = 1/2 + (2 N_AaAa - 4 N_AAaa - N_Aa^i - N_Aa^j) / (4 min(N_Aa^i, N_Aa^j))
    phi = 0.5 + (2.0 * both_het - 4.0 * opp - n_i - n_j) / torch.clamp(
        4.0 * min_het, min=1e-300)
    return phi


def king(call_expr, *, block_size: Optional[int] = None) -> MatrixTable:
    """KING-robust kinship (reference `methods/relatedness/king.py`); returns
    a sample×sample MatrixTable with entry `phi`. The products run on the
    session's device in f64."""
    het, hom_ref, hom_var, called, mt = _gt_indicator_matrices(call_expr)
    phi = _king_kernel(*_to_device_f64(het, hom_ref, hom_var, called))
    return _pairwise_mt(mt, {'phi': phi.cpu().numpy()})


def _pairwise_mt(mt: MatrixTable, entries_np: Dict[str, np.ndarray]) -> MatrixTable:
    """Build a sample×sample MatrixTable from (n, n) matrices."""
    st = mt._stage
    n = st.n_cols
    col_key_fields = st.col_key
    row_cols = {}
    for kf in col_key_fields:
        row_cols[kf] = st.cols.columns[kf]
    rows = Batch(row_cols, n)
    row_t = ht.tstruct(**{kf: st.col_type[kf] for kf in col_key_fields})
    ents = {k: PrimitiveColumn(ht.tfloat64, v) for k, v in entries_np.items()}
    entry_t = ht.tstruct(**{k: ht.tfloat64 for k in entries_np})
    mb = MatrixBatch(rows, ents)
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), st.cols.select(col_key_fields), col_key_fields, col_key_fields,
        row_t, ht.tstruct(**{kf: st.col_type[kf] for kf in col_key_fields}),
        entry_t, [mb]))


def _pc_relate_kernel(G, M, mu, min_individual_maf: float):
    """PC-Relate's moments from the (m, n) f64 genotypes G, their missing
    mask M and the individual-specific allele frequencies mu, all on one
    device: the six (n, n) f64 products and the elementwise kin, k2 and k0
    (reference `relatedness.py:132-167`, PCRelate.scala:267, :287)."""
    # mu is invalid (no contribution) when outside (maf, 1-maf) / (0, 1) or
    # when the genotype is missing (reference pc_relate.py:385 _bad_mu)
    bad = (mu <= min_individual_maf) | (mu >= 1 - min_individual_maf) | \
        (mu <= 0.0) | (mu >= 1.0) | M
    ok = ~bad
    variance = torch.where(ok, mu * (1 - mu), 0.0)
    centered_af = torch.where(ok, G - 2 * mu, 0.0)
    stddev = torch.sqrt(variance)

    def gram(A):
        return A.T @ A

    kin = gram(centered_af) / (4 * gram(stddev))
    del centered_af, stddev

    # IBD2 (reference PCRelate.scala:267 k2): dominance-coded genotypes with
    # an inbreeding correction from the kinship diagonal
    f_i = 2.0 * torch.diagonal(kin) - 1.0
    gd = torch.where(~ok, 0.0,
                     torch.where(G == 0.0, mu,
                                 torch.where(G == 1.0, 0.0, 1.0 - mu)))
    normalized_gd = gd - variance * (1.0 + f_i)[None, :]
    del gd
    k2 = gram(normalized_gd) / gram(variance)
    del normalized_gd, variance

    # IBD0 (reference PCRelate.scala:287 k0): IBS0 ratio for close relatives,
    # 1 - 4*phi + k2 otherwise; cutoff 2^(-5/2)
    hom_alt = (ok & (G == 2.0)).to(torch.float64)
    hom_ref = (ok & (G == 0.0)).to(torch.float64)
    tmp = hom_alt.T @ hom_ref
    ibs0 = tmp + tmp.T
    del hom_alt, hom_ref
    mu2 = torch.where(ok, mu * mu, 0.0)
    om2 = torch.where(ok, (1 - mu) * (1 - mu), 0.0)
    tmp2 = mu2.T @ om2
    k0_den = tmp2 + tmp2.T
    k0cutoff = 2.0 ** (-5.0 / 2.0)
    k0 = torch.where(kin <= k0cutoff, 1.0 - 4.0 * kin + k2, ibs0 / k0_den)
    return kin, k2, k0


def pc_relate(call_expr, min_individual_maf: float, *, k: Optional[int] = None,
              scores_expr=None, min_kinship: Optional[float] = None,
              statistics: str = 'all', block_size: Optional[int] = None,
              include_self_kinship: bool = False) -> Table:
    """PC-Relate kinship + IBD (reference `relatedness/pc_relate.py:38`,
    `is/hail/methods/PCRelate.scala:18-180`): individual-specific allele
    frequencies from PC regression, then product moments. The (m, n) work
    and the (n, n) products run on the session's device in f64; the (p, p)
    solve for the regression coefficients runs on the host."""
    e = to_expr(call_expr)
    mt = e._indices.source
    if (k is None) == (scores_expr is None):
        raise ValueError('specify exactly one of k or scores_expr')
    if scores_expr is not None:
        col = mt._eval_col_expr(to_expr(scores_expr))
        scores = np.asarray([list(v) for v in C.to_object(col).values])
    else:
        from .pca import hwe_normalized_pca
        _, scores_t, _ = hwe_normalized_pca(e, k=k, compute_loadings=False)
        scores = np.asarray([list(r.scores) for r in scores_t.collect()])

    ne = e.n_alt_alleles() if e.dtype == ht.tcall else e
    G, M = _entry_expr_to_blocks(ne)          # (m, n)
    m, n = G.shape
    X = np.concatenate([np.ones((n, 1)), scores], axis=1)   # (n, p)
    dev = Env.device()
    Gd, Xd = _to_device_f64(G, X)
    Md = torch.from_numpy(M).to(dev)
    del G, M
    cnt = (~Md).sum(dim=1)
    # beta per variant: solve (X^T X) beta = X^T g, missing calls imputed by
    # the variant's mean (reference: the same host solve)
    mean = torch.where(Md, 0.0, Gd).sum(dim=1) / torch.clamp(cnt, min=1)
    rhs = Xd.T @ torch.where(Md, mean[:, None], Gd).T       # (p, m)
    B = np.linalg.solve(X.T @ X, rhs.cpu().numpy()).T       # (m, p)
    mu = (torch.from_numpy(B).to(dev) @ Xd.T) / 2.0         # (m, n) individual-specific af
    kin, k2, k0 = _pc_relate_kernel(Gd, Md, mu, min_individual_maf)
    del Gd, Md, mu

    pairs = _upper(n, include_self_kinship, dev)
    # a NaN kin passes the bound, as in the reference's pair loop
    if min_kinship is not None:
        pairs &= ~(kin < min_kinship)
    # i/j are STRUCTS of the col key fields, even for a single key
    # (reference pc_relate returns key fields typed tstruct(col_key))
    fields = {'kin': (ht.tfloat64, kin)}
    if statistics in ('kin2', 'kin20', 'all'):
        fields['ibd2'] = (ht.tfloat64, k2)
    if statistics in ('kin20', 'all'):
        fields['ibd0'] = (ht.tfloat64, k0)
    if statistics == 'all':
        fields['ibd1'] = (ht.tfloat64, 1.0 - (k2 + k0))
    return _pair_table(mt, pairs, fields, key_struct=True)


def identity_by_descent(dataset: MatrixTable, maf=None, bounded: bool = True,
                        min: Optional[float] = None, max: Optional[float] = None,
                        *, _use_pallas: bool = True) -> Table:
    """PLINK-style method-of-moments IBD (reference `methods/IBD` + C++ SIMD
    IBS kernel `hail/c/ibs.cpp:13-77`): IBS counts on the session's device,
    then PLINK's E[IBS|IBD] inversion on the host. `_use_pallas=True` runs
    ops/ibs.ibs_counts (the CUDA kernel on a card, which runs or raises);
    False runs plain f64 indicator products."""
    mt = dataset
    het, hom_ref, hom_var, called, mt = _gt_indicator_matrices(mt.GT)
    if maf is not None:
        mafe = to_expr(maf)
        vals = []
        for i, ctx in enumerate(mt._stage.contexts):
            mb = mt._stage.partition_fn(ctx)
            env = mt._row_env(mb, i)
            col = mafe._ir.evaluate(env)
            vals.append(np.asarray(col.values, dtype=np.float64))
        p = np.concatenate(vals)
    else:
        n_alt = het + 2 * hom_var
        with np.errstate(all='ignore'):
            p = n_alt.sum(axis=1) / np.maximum(2 * called.sum(axis=1), 1)
    keep = (p > 0) & (p < 1)
    device = Env.device()
    het_d, hom_ref_d, hom_var_d, called_d = (
        torch.from_numpy(np.ascontiguousarray(a[keep])).to(device)
        for a in (het, hom_ref, hom_var, called))
    p = p[keep]
    q = 1 - p

    if _use_pallas:
        from ..ops.ibs import ibs_counts
        ibs0, ibs1, ibs2 = (c.cpu().numpy() for c in ibs_counts(
            het_d, hom_ref_d, hom_var_d, called_d))
    else:
        H, R, A, Cl = (a.to(torch.float64)
                       for a in (het_d, hom_ref_d, hom_var_d, called_d))
        ibs0 = (R.T @ A + A.T @ R).cpu().numpy()
        ibs1 = (H.T @ (R + A) + (R + A).T @ H).cpu().numpy()
        shared = (Cl.T @ Cl).cpu().numpy()
        ibs2 = shared - ibs0 - ibs1
    shared = ibs0 + ibs1 + ibs2

    # PLINK expected IBS given IBD state (Purcell et al. 2007)
    m_v = p.size
    e00 = float(np.sum(2 * p * p * q * q))                    # P(IBS0 | IBD0)
    e10 = float(np.sum(4 * p ** 3 * q + 4 * p * q ** 3))      # P(IBS1 | IBD0)
    e11 = float(np.sum(2 * p * p * q + 2 * p * q * q))        # P(IBS1 | IBD1)
    e20 = float(np.sum(p ** 4 + q ** 4 + 4 * p * p * q * q))  # P(IBS2 | IBD0)
    e21 = float(np.sum(p ** 3 + q ** 3 + p * p * q + p * q * q))
    with np.errstate(all='ignore'):
        z0 = ibs0 / e00 * m_v / np.maximum(shared, 1)
        z1 = (ibs1 - z0 * e10 * shared / m_v) / (e11 * shared / m_v + 1e-300)
        z2 = 1 - z0 - z1
        if bounded:
            z0 = np.clip(z0, 0, 1)
            z1 = np.clip(z1, 0, 1)
            z2 = np.clip(1 - z0 - z1, 0, 1)
            s = z0 + z1 + z2
            z0, z1, z2 = z0 / s, z1 / s, z2 / s
        pi_hat = z1 / 2 + z2

    ph = torch.from_numpy(np.asarray(pi_hat, np.float64))
    pairs = _upper(mt._stage.n_cols, False, ph.device)
    # a NaN PI_HAT passes both bounds, as in the reference's pair loop
    if min is not None:
        pairs &= ~(ph < min)
    if max is not None:
        pairs &= ~(ph > max)
    return _pair_table(mt, pairs, {
        'ibd': {'Z0': (ht.tfloat64, z0), 'Z1': (ht.tfloat64, z1),
                'Z2': (ht.tfloat64, z2), 'PI_HAT': (ht.tfloat64, ph)},
        'ibs0': (ht.tint64, ibs0), 'ibs1': (ht.tint64, ibs1),
        'ibs2': (ht.tint64, ibs2)}, key_struct=False)


def maximal_independent_set(i_expr, j_expr, keep: bool = True,
                            tie_breaker=None, keyed: bool = True) -> Table:
    """Greedy maximal independent set over an edge table (reference
    `methods/relatedness/maximal_independence.py` → Graph.scala)."""
    ie = to_expr(i_expr)
    je = to_expr(j_expr)
    if ie.dtype != je.dtype:
        raise ValueError(
            "'maximal_independent_set' expects arguments `i` and `j` to have "
            f"same type. Found {ie.dtype} and {je.dtype}.")
    src = ie._indices.source
    from ..table import Table as _Table
    if not isinstance(src, _Table):
        raise ValueError(
            "'maximal_independent_set' expects an expression of 'Table'. Found {}".format(
                f"expression of '{src.__class__}'" if src is not None
                else 'scalar expression'))
    if je._indices.source is not src:
        raise ValueError(
            "'maximal_independent_set' expects arguments `i` and `j` to be "
            "expressions of the same Table.")
    edges = list(zip(src._collect_expr(ie), src._collect_expr(je)))
    # greedy removal of max-degree nodes (reference methods/misc.py:16 →
    # ArrayMaximalIndependentSet): when degrees tie, remove the node that is
    # LARGEST under tie_breaker's ordering.
    from collections import defaultdict
    adj = defaultdict(set)
    for a, b in edges:
        if a != b:
            adj[a].add(b)
            adj[b].add(a)
    tb_cache = {}

    def tb(u, v):
        key = (repr(u), repr(v))
        if key not in tb_cache:
            lu = F.literal(u, ie.dtype)
            lv = F.literal(v, ie.dtype)
            tb_cache[key] = float(F.eval_expr(F.float64(tie_breaker(lu, lv))))
        return tb_cache[key]

    removed = set()
    while True:
        best, best_deg = None, 0
        for v, ns in adj.items():
            if v in removed:
                continue
            deg = sum(1 for u in ns if u not in removed)
            if deg > best_deg:
                best, best_deg = v, deg
            elif deg == best_deg and deg > 0 and tie_breaker is not None:
                if tb(v, best) > 0:
                    best = v
        if best is None or best_deg == 0:
            break
        removed.add(best)
    all_nodes = set(adj.keys())
    kept = all_nodes - removed
    out_nodes = sorted(kept, key=lambda v: (v is None, str(v))) if keep else \
        sorted(removed, key=lambda v: (v is None, str(v)))
    row_t = ht.tstruct(node=ie.dtype)
    b = Batch.from_pylist(row_t, [Struct(node=v) for v in out_nodes])
    return Table(TableStage.from_batches(Batch({}, 1), ['node'] if keyed else [],
                                         row_t, [b]))
