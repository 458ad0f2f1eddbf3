"""`dryrun_multichip`: the distributed steps of the GWAS engine on an
n-slot mesh, each held to its one-device result (port of
`__graft_entry__.dryrun_multichip`, which checks only shapes).

    python -c "import hail_tpu_torch as hl; hl.init(); \\
        from hail_tpu_torch.parallel.dryrun import dryrun_multichip; \\
        print(dryrun_multichip(4))"

The steps, on tiny shapes (R = 8n variant rows, N = 16n samples):
- the mean-imputed OLS step, variant rows over every slot, the covariate
  basis and the phenotype copied to each;
- the 2-D sharded Zᵀ·Z of the centred genotypes (`_sharded_matmul`);
- the per-sample counters, samples over every slot;
- the per-variant entry sums, samples over every slot, their partials
  added on the first slot;
- the range exchange of `ops/device_sort`.
Integers must equal the one-device result, f64 values lie within 1e-12 of
it relative to its largest entry (a product's blocks sum in another order
than the whole). The reference's batched logistic step is left out: it
calls `glm_per_variant_fit`, which no method of the port reaches.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import P, Sharded, get_mesh, replicate, shard

F64_RTOL = 1e-12


def _ols_step(G, missing, Q, y_r, yty_r, d_free):
    """(beta, se, centred Gi) of one block of variant rows."""
    cnt = (~missing).sum(dim=1)
    s = torch.where(missing, 0.0, G).sum(dim=1)
    mean = torch.where(cnt > 0, s / cnt.clamp(min=1), 0.0)
    Gi = torch.where(missing, mean[:, None], G)
    GQ = Gi @ Q
    Gy = Gi @ y_r
    gg = torch.clamp((Gi * Gi).sum(dim=1) - (GQ * GQ).sum(dim=1), min=1e-12)
    beta = Gy / gg[:, None]
    se2 = (yty_r[None, :] / gg[:, None] - beta * beta) / d_free
    return beta, torch.sqrt(torch.clamp(se2, min=0)), \
        Gi - Gi.mean(dim=1, keepdim=True)


def _sample_counts(G, missing):
    called = ~missing
    return torch.stack([called.sum(dim=0), (called & (G == 1.0)).sum(dim=0),
                        (called & (G == 2.0)).sum(dim=0)])


def _entry_sums(G, missing):
    g = torch.where(missing, 0.0, G)
    return torch.stack([(~missing).sum(dim=1).to(G.dtype), g.sum(dim=1),
                        (g * g).sum(dim=1)], dim=1)


def _check(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f'{what}: shape {got.shape}, want {want.shape}')
    if want.dtype.kind in 'iub':
        if not np.array_equal(got, want):
            raise AssertionError(f'{what}: differs from one device')
        return 0.0
    err = float(np.max(np.abs(got - want)))
    if not np.isfinite(got).all() or err > F64_RTOL * np.max(np.abs(want)):
        raise AssertionError(f'{what}: {err:.3e} from one device')
    return err


def dryrun_multichip(n_devices: int) -> str:
    """Run the steps on a mesh of the default mesh's first `n_devices`
    slots and on its first device alone; raise if any differs. Returns a
    one-line summary."""
    from ..linalg.blockmatrix import _sharded_matmul
    from ..ops.device_sort import device_range_sort

    devs = get_mesh().flat
    if n_devices < 2:
        raise ValueError('the dry run shards over at least 2 mesh slots')
    if len(devs) < n_devices:
        raise ValueError(f'need {n_devices} mesh slots, have {len(devs)}')
    mesh = get_mesh(devs[:n_devices])
    home = devs[0]

    R, N, K = 8 * n_devices, 16 * n_devices, 2
    rng = np.random.default_rng(0)
    G = rng.integers(0, 3, (R, N)).astype(np.float64)
    missing = rng.random((R, N)) < 0.01
    cov = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, K - 1))], axis=1)
    Qm, _ = np.linalg.qr(cov)
    y = rng.normal(size=(N, 1))
    y_r = y - Qm @ (Qm.T @ y)
    yty_r = (y_r * y_r).sum(axis=0)
    d_free = float(N - K - 1)
    Gt, Mt = torch.from_numpy(G), torch.from_numpy(missing)
    errs = {}

    # the OLS step: variant rows over every slot, Q and y_r on each
    rows = [shard(x, P(('x', 'y'), None), mesh) for x in (Gt, Mt)]
    Qs, ys = replicate(Qm, mesh), replicate(y_r, mesh)
    yty = torch.from_numpy(yty_r)
    parts = [_ols_step(g, m, q, yr, yty.to(g.device), d_free)
             for g, m, q, yr in zip(rows[0].shards, rows[1].shards,
                                    Qs.shards, ys.shards)]
    beta1, se1, Z1 = _ols_step(Gt.to(home), Mt.to(home), torch.from_numpy(Qm)
                               .to(home), torch.from_numpy(y_r).to(home),
                               yty.to(home), d_free)
    errs['beta'] = _check(torch.cat([b.cpu() for b, _, _ in parts]),
                          beta1.cpu(), 'OLS beta')
    errs['se'] = _check(torch.cat([s.cpu() for _, s, _ in parts]),
                        se1.cpu(), 'OLS se')

    # the 2-D sharded Zᵀ·Z from the row-sharded centred genotypes
    Z = Sharded((R, N), rows[0].spec, mesh, [z for _, _, z in parts])
    grm = _sharded_matmul(Z.T, Z, mesh)
    if not isinstance(grm, Sharded) or grm.spec != P('x', 'y'):
        raise AssertionError(f'ZᵀZ laid out as {getattr(grm, "spec", None)}')
    errs['grm'] = _check(grm.to_numpy(), (Z1.T @ Z1).cpu(), 'ZᵀZ')

    # per-sample counters and per-variant entry sums, samples over every slot
    cols = [shard(x, P(None, ('x', 'y')), mesh) for x in (Gt, Mt)]
    counts = torch.cat([_sample_counts(g, m).cpu() for g, m in
                        zip(cols[0].shards, cols[1].shards)], dim=1)
    _check(counts, _sample_counts(Gt.to(home), Mt.to(home)).cpu(),
           'per-sample counters')
    sums = sum(_entry_sums(g, m).to(home) for g, m in
               zip(cols[0].shards, cols[1].shards))
    errs['entry_sums'] = _check(sums.cpu(),
                                _entry_sums(Gt.to(home), Mt.to(home)).cpu(),
                                'entry sums')

    # the range exchange
    keys = rng.permutation(n_devices * 16).astype(np.float32)
    order = device_range_sort(keys, True, mesh=mesh)
    if order is None:
        raise AssertionError('the device range sort did not run')
    _check(order, np.argsort(keys, kind='stable'), 'range exchange')

    return (f'dryrun_multichip({n_devices}): ok on {mesh}; beta, se, ZᵀZ '
            f'{grm.spec}, per-sample counters, entry sums and the range '
            'exchange equal one device (largest f64 difference '
            f'{max(errs.values()):.2e})')
