"""Relatedness: PLINK-style IBD (the port's slice of hail_tpu/methods/relatedness.py).

Capability parity with reference `hail/python/hail/methods/relatedness/`
(`identity_by_descent` → C++ SIMD IBS kernel `hail/c/ibs.cpp` +
`methods/IBSFFI.scala`). The pairwise IBS counts run on the session's
device: the hand-written CUDA kernel on a card (ops/ibs.py), or, with
`_use_pallas=False`, plain f64 indicator products.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import types as ht
from ..context import Env
from ..expr.expression import to_expr
from ..genetics.call import calls_is_het, calls_is_hom_ref, calls_is_hom_var
from ..ir.columns import Batch
from ..matrixtable import MatrixTable
from ..table import Table, TableStage
from ..utils.structs import Struct


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

    st = mt._stage
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    n = len(samples)
    rows = []
    for i in range(n):
        for j in range(i + 1, n):
            ph = float(pi_hat[i, j])
            if min is not None and ph < min:
                continue
            if max is not None and ph > max:
                continue
            rows.append(Struct(
                i=samples[i], j=samples[j],
                ibd=Struct(Z0=float(z0[i, j]), Z1=float(z1[i, j]),
                           Z2=float(z2[i, j]), PI_HAT=ph),
                ibs0=int(ibs0[i, j]), ibs1=int(ibs1[i, j]), ibs2=int(ibs2[i, j])))
    row_t = ht.tstruct(
        i=ht.tstr, j=ht.tstr,
        ibd=ht.tstruct(Z0=ht.tfloat64, Z1=ht.tfloat64, Z2=ht.tfloat64, PI_HAT=ht.tfloat64),
        ibs0=ht.tint64, ibs1=ht.tint64, ibs2=ht.tint64)
    b = Batch.from_pylist(row_t, rows)
    return Table(TableStage.from_batches(Batch({}, 1), ['i', 'j'], row_t, [b]))
