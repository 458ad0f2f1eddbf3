"""A cell's inputs, made from its seed.

Genotype calls, column fields (covariates) and a pool of phenotypes are
drawn on the device with one `torch.Generator` in a few large calls, and
copied to the host once: the program is handed host arrays, as it would be
by a reader of VCF or BGEN. The same seed gives the same inputs on the same
kind of device; every seed gives the same sizes.

Calls are packed as Hail packs unphased diploid calls: ploidy 2 in bits 0-1,
the first allele index from bit 3 and the second from bit 17 (0/0, 0/1,
1/1). `decode_n_alt` reads them back for the reference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

PLOIDY_DIPLOID = 2
J_SHIFT = 3
K_SHIFT = 17
J_MASK = (1 << 14) - 1
K_MASK = (1 << 15) - 1


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    """A host generator for the choices that are not data (which phenotypes
    a call combines, which rows are checked), one stream per purpose."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def make_calls(gen: torch.Generator, device: torch.device, n_rows: int,
               n_samples: int, maf_min: float, missing: float):
    """(packed int32 (R, N), missing bool (R, N)) on the host: per variant an
    alternate allele frequency drawn log-uniformly from [maf_min, 0.5],
    Hardy-Weinberg genotypes, and each call missing with probability
    `missing`."""
    lo, hi = np.log(maf_min), np.log(0.5)
    u_f = torch.rand((n_rows, 1), generator=gen, device=device,
                     dtype=torch.float64)
    p = torch.exp(lo + (hi - lo) * u_f)
    hom = (p * p).float()
    het = (p * p + 2 * p * (1 - p)).float()
    u = torch.rand((n_rows, n_samples), generator=gen, device=device)
    two = u < hom
    alt = u < het                  # one alternate allele or two
    del u
    miss = torch.rand((n_rows, n_samples), generator=gen, device=device) \
        < missing
    packed = (PLOIDY_DIPLOID | (two.to(torch.int32) << J_SHIFT)
              | (alt.to(torch.int32) << K_SHIFT))
    return packed.cpu().numpy(), miss.cpu().numpy()


def decode_n_alt(packed: np.ndarray) -> np.ndarray:
    """The number of alternate alleles of each packed diploid call."""
    j = (packed >> J_SHIFT) & J_MASK
    k = (packed >> K_SHIFT) & K_MASK
    return (j != 0).astype(np.int8) + (k != 0).astype(np.int8)


def make_columns(gen: torch.Generator, device: torch.device, n: int,
                 fields: Sequence[dict], pool: int) -> Dict[str, np.ndarray]:
    """The column fields of a configuration (`bernoulli` 0/1, `integers` in
    [low, high), `normal` times `scale`, `count` of them numbered from 1),
    and `pool` phenotypes `y0`.. : a standard normal plus a small seeded
    effect of each standardized column field. All float64."""
    cols: Dict[str, torch.Tensor] = {}
    for f in fields:
        kind = f['kind']
        if kind == 'bernoulli':
            cols[f['name']] = (torch.rand(n, generator=gen, device=device,
                                          dtype=torch.float64) < f['p']).double()
        elif kind == 'integers':
            cols[f['name']] = torch.randint(
                f['low'], f['high'], (n,), generator=gen,
                device=device).double()
        elif kind == 'normal':
            x = torch.randn((f['count'], n), generator=gen, device=device,
                            dtype=torch.float64) * f['scale']
            for i in range(f['count']):
                cols[f"{f['name']}{i + 1}"] = x[i]
        else:
            raise ValueError(f'unknown column field kind {kind!r}')
    z = torch.stack([(v - v.mean()) / v.std() for v in cols.values()])
    effects = torch.randn((pool, z.shape[0]), generator=gen, device=device,
                          dtype=torch.float64) * 0.1
    y = torch.randn((pool, n), generator=gen, device=device,
                    dtype=torch.float64) + effects @ z
    out = {name: v.cpu().numpy() for name, v in cols.items()}
    for i, v in enumerate(y.cpu().numpy()):
        out[f'y{i}'] = v
    return out


def covariate_terms(spec: Sequence[str]) -> List[List[str]]:
    """Covariates as written in a configuration: '1' for the intercept, else
    a product of column fields such as 'sex*age*age'."""
    return [[] if s == '1' else s.split('*') for s in spec]


def covariate_matrix(terms, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """The covariates as an (n, k) float64 matrix, products taken left to
    right as the program's expressions take them."""
    out = []
    for t in terms:
        v = np.ones(n)
        if t:
            v = cols[t[0]]
            for name in t[1:]:
                v = v * cols[name]
        out.append(v)
    return np.stack(out, axis=1)


def covariate_exprs(mt, terms) -> list:
    """The same covariates as the program's column expressions."""
    out = []
    for t in terms:
        if not t:
            out.append(1.0)
            continue
        e = mt[t[0]]
        for name in t[1:]:
            e = e * mt[name]
        out.append(e)
    return out


def column_batch(cols: Dict[str, np.ndarray]):
    """The columns of a cohort, keyed by `s` ('s<i>'), with the float64
    fields of `cols`: (Batch, its types). Made once, shared by the
    MatrixTables of one cohort."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.ir.columns import Batch, ObjectColumn, PrimitiveColumn
    n = len(next(iter(cols.values())))
    fields = {'s': ObjectColumn(
        ht.tstr, np.asarray([f's{i}' for i in range(n)], object))}
    types = {'s': ht.tstr}
    for name, v in cols.items():
        fields[name] = PrimitiveColumn(ht.tfloat64, v)
        types[name] = ht.tfloat64
    return Batch(fields, n), types


def matrix_table(parts, columns, first_pos: int = 10_000):
    """A MatrixTable of packed GT calls, one partition per (packed, missing)
    pair of `parts`, rows keyed by consecutive positions on chromosome 1
    from `first_pos` and alleles A/T, over the cohort `columns` that
    `column_batch` made. Its partitions are new objects on every call, so
    the program has seen none of them."""
    from hail_tpu_torch import types as ht
    from hail_tpu_torch.genetics.reference_genome import default_reference
    from hail_tpu_torch.ir.columns import (Batch, LocusColumn, ObjectColumn,
                                           PrimitiveColumn)
    from hail_tpu_torch.matrixtable import (MatrixBatch, MatrixStage,
                                            MatrixTable)
    rg = default_reference()
    col_batch, col_t = columns
    mbs, pos = [], first_pos
    for packed, miss in parts:
        R = packed.shape[0]
        alleles = np.empty(R, dtype=object)
        alleles[:] = [['A', 'T']] * R
        rows = {'locus': LocusColumn(ht.tlocus(rg), np.zeros(R, np.int32),
                                     np.arange(pos, pos + R, dtype=np.int32)),
                'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles)}
        pos += R
        mbs.append(MatrixBatch(Batch(rows, R), {
            'GT': PrimitiveColumn(ht.tcall, packed, miss)}))
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), col_batch, ['locus', 'alleles'],
        ['s'], ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr)),
        ht.tstruct(**col_t), ht.tstruct(GT=ht.tcall), mbs))
