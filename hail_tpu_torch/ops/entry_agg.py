"""Device tier for generic entry aggregations (port of hail_tpu/ops/entry_agg.py).

`MatrixTable.aggregate_entries` expressions built from primitive
arithmetic over entry, row and column fields (and `GT.n_alt_alleles()`)
are lowered here to one reduction per partition over tensors on the
session's device, in place of the host numpy evaluator. The reference
compiles the same closures into one jitted XLA reduction; here they are
eager torch ops (ROADMAP queue 2 lists this tier as torch ops until the
card shows that it dominates its slice).

Missingness is explicit: every compiled node returns (values, mask), with
Kleene logic for `&` and `|`, as the host evaluator has it. Types follow
the IR: every literal and missing value takes the dtype of its IR type,
and each arithmetic result is cast to its node's type, so `/` and `**`
are f64 as on the host. Integer `//` and `%` read a divisor of 1 where it
is 0 or masked (torch raises on 0); where a defined divisor is 0 the
results are the reference device tier's (jnp under XLA: x // 0 is -1 for
x = 0 and -2 otherwise, x % 0 is 0). An IR the planner cannot lower
(`plan_device_entry_agg` returns None) goes to the host evaluator, as in
the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import types as ht
from ..ir import columns as C
from ..ir.nodes import (NA, AggOp, Apply, ApplyBinaryOp, ApplyUnaryOp, Cast,
                        Coalesce, GetField, If, IsMissing, Literal, Ref)


class _Unsupported(Exception):
    pass


_NUMERIC = (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64, ht.tbool)
_INTEGRAL = (ht.tint32, ht.tint64, ht.tbool)

# genetics.call packed layout (genetics/call.py)
_PLOIDY_MASK = 3
_J_SHIFT = 3
_K_SHIFT = 17

_DEVICE = '__device__'   # the env key of the device the leaves live on

_CMP = {'==': torch.eq, '!=': torch.ne, '<': torch.lt, '<=': torch.le,
        '>': torch.gt, '>=': torch.ge}


def _dtype(t) -> torch.dtype:
    return {ht.tint32: torch.int32, ht.tint64: torch.int64,
            ht.tfloat32: torch.float32, ht.tfloat64: torch.float64,
            ht.tbool: torch.bool}[t]


def _const(env, value, dtype):
    return torch.tensor(value, dtype=dtype, device=env[_DEVICE])


def _int_floordiv(a, b, masked):
    """Floor division of integer tensors. A divisor that is 0 or masked is
    read as 1; where a defined divisor is 0 the result is the reference
    device tier's: -1 - (a != 0), what jnp.floor_divide gives from XLA's
    x / 0 = -1 and x rem 0 = x."""
    zero = b == 0
    q = torch.div(a, torch.where(zero | masked, 1, b), rounding_mode='floor')
    return torch.where(zero, -1 - (a != 0).to(q.dtype), q)


def _arith(op, a, b, masked, out_dtype):
    if op == '/':
        return torch.true_divide(a.to(out_dtype), b.to(out_dtype))
    if op == '**':
        return torch.pow(a.to(out_dtype), b.to(out_dtype))
    if a.dtype == torch.bool:
        a = a.to(torch.int32)
    if b.dtype == torch.bool:
        b = b.to(torch.int32)
    if op == '+':
        return a + b
    if op == '-':
        return a - b
    if op == '*':
        return a * b
    dt = torch.result_type(a, b)
    a, b = a.to(dt), b.to(dt)
    if dt.is_floating_point:
        return torch.floor_divide(a, b) if op == '//' else torch.remainder(a, b)
    if op == '//':
        return _int_floordiv(a, b, masked)
    # jnp.remainder reads an integer divisor of 0 as 1, so x % 0 is 0
    return torch.remainder(a, torch.where((b == 0) | masked, 1, b))


def _compile(ir, leaves: Dict[str, Tuple[str, str, str]]):
    """IR → closure(env: dict name→tensor) → (values, mask) tensors.

    `leaves` records the required fields as key '<axis>.<field>.<kind>' →
    (axis, field, kind); masks are bool tensors broadcastable with the
    values."""

    def leaf(axis, field, kind='value'):
        key = f'{axis}.{field}.{kind}'
        leaves[key] = (axis, field, kind)
        return lambda env: env[key]

    def rec(node):
        if isinstance(node, GetField) and isinstance(node.struct, Ref) \
                and node.struct.name in ('g', 'va', 'sa'):
            axis = node.struct.name
            if node.typ == ht.tcall:
                raise _Unsupported('bare call field')
            if node.typ not in _NUMERIC:
                raise _Unsupported(f'field type {node.typ}')
            v = leaf(axis, node.name, 'value')
            m = leaf(axis, node.name, 'mask')
            return lambda env: (v(env), m(env))
        if isinstance(node, Apply) and node.name == 'n_alt_alleles' \
                and len(node.args) == 1:
            a = node.args[0]
            if isinstance(a, GetField) and isinstance(a.struct, Ref) \
                    and a.typ == ht.tcall:
                v = leaf(a.struct.name, a.name, 'value')
                m = leaf(a.struct.name, a.name, 'mask')

                def f(env):
                    packed = v(env)
                    ploidy = packed & _PLOIDY_MASK
                    aj = (packed >> _J_SHIFT) & ((1 << 14) - 1)
                    ak = (packed >> _K_SHIFT) & ((1 << 15) - 1)
                    nalt = (((aj != 0) & (ploidy >= 1)).to(torch.int32)
                            + ((ak != 0) & (ploidy == 2)).to(torch.int32))
                    return nalt, m(env)
                return f
            raise _Unsupported('n_alt_alleles of non-field')
        if isinstance(node, NA):
            if node.typ not in _NUMERIC:
                raise _Unsupported('missing non-primitive')
            dt = _dtype(node.typ)
            return lambda env: (_const(env, 0, dt), _const(env, True, torch.bool))
        if isinstance(node, Literal):
            if node.typ not in _NUMERIC or node.value is None:
                raise _Unsupported('non-primitive literal')
            val, dt = node.value, _dtype(node.typ)
            return lambda env: (_const(env, val, dt),
                                _const(env, False, torch.bool))
        if isinstance(node, Cast):
            inner = rec(node.x)
            if node.typ not in _NUMERIC:
                raise _Unsupported(f'cast to {node.typ}')
            dt = _dtype(node.typ)

            def f(env):
                v, m = inner(env)
                return v.to(dt), m
            return f
        if isinstance(node, IsMissing):
            inner = rec(_only_child(node))

            def f(env):
                _, m = inner(env)
                return m, _const(env, False, torch.bool)
            return f
        if isinstance(node, Coalesce):
            subs = [rec(c) for c in _children(node)]

            def f(env):
                v, m = subs[0](env)
                for s in subs[1:]:
                    v2, m2 = s(env)
                    v = torch.where(m, v2.to(v.dtype), v)
                    m = m & m2
                return v, m
            return f
        if isinstance(node, If):
            c, t, f_ = (rec(x) for x in _children(node))

            def f(env):
                cv, cm = c(env)
                tv, tm = t(env)
                fv, fm = f_(env)
                cv = cv.to(torch.bool)
                out = torch.where(cv, tv, fv.to(tv.dtype))
                return out, cm | torch.where(cv, tm, fm)
            return f
        if isinstance(node, ApplyUnaryOp):
            op = node.op
            if op not in ('-', '!'):
                raise _Unsupported(op)
            inner = rec(_only_child(node))

            def f(env):
                v, m = inner(env)
                if op == '!':
                    return torch.logical_not(v), m
                return -(v.to(torch.int32) if v.dtype == torch.bool else v), m
            return f
        if isinstance(node, ApplyBinaryOp):
            lc, rc = _children(node)
            lf, rf = rec(lc), rec(rc)
            op = node.op
            if op in ('&', '|'):
                def f(env):
                    lv, lm = lf(env)
                    rv, rm = rf(env)
                    lv, rv = lv.to(torch.bool), rv.to(torch.bool)
                    if op == '&':
                        # false wins over missing
                        lt, rt = lm | lv, rm | rv
                        out = lt & rt
                        m = (lm & rt) | (rm & lt)
                    else:
                        # true wins over missing
                        lt, rt = ~lm & lv, ~rm & rv
                        out = lt | rt
                        m = (lm & ~rt) | (rm & ~lt)
                    return out, m
                return f
            if op in _CMP:
                cmp = _CMP[op]

                def f(env):
                    lv, lm = lf(env)
                    rv, rm = rf(env)
                    return cmp(lv, rv), lm | rm
                return f
            if op not in ('+', '-', '*', '/', '//', '%', '**') \
                    or node.typ not in _NUMERIC:
                raise _Unsupported(op)
            dt = _dtype(node.typ)

            def f(env):
                lv, lm = lf(env)
                rv, rm = rf(env)
                m = lm | rm
                return _arith(op, lv, rv, m, dt).to(dt), m
            return f
        raise _Unsupported(type(node).__name__)

    return rec(ir)


def _children(node):
    ch = node.children() if callable(node.children) else node.children
    return [c for c in ch if c is not None and not isinstance(c, (str, int, float))]


def _only_child(node):
    return _children(node)[0]


_SUPPORTED = {'count', 'count_where', 'sum', 'mean', 'stats', 'min', 'max',
              'fraction', 'any', 'all'}


def plan_device_entry_agg(agg_nodes: List[AggOp]):
    """Compile each AggOp's args/filter; returns (leaves, per-agg plans) or
    None when any aggregator/expression is unsupported."""
    leaves: Dict[str, Tuple[str, str, str]] = {}
    plans = []
    try:
        for node in agg_nodes:
            name = node.aggregator.name
            if name not in _SUPPORTED or node.init_args:
                return None
            if name == 'min' or name == 'max':
                if node.args[0].typ not in (ht.tint32, ht.tint64,
                                            ht.tfloat32, ht.tfloat64):
                    return None
            args = [_compile(a, leaves) for a in node.args]
            filt = _compile(node.filter_ir, leaves) \
                if node.filter_ir is not None else None
            plans.append((node, name, args, filt))
    except _Unsupported:
        return None
    return leaves, plans


def make_kernel(plans, order):
    """ONE function shared by every partition of an aggregate call: (leaf
    tensors in `order`, filtered-entry mask) → per-agg tuples of 0-dim
    tensors, the partial states."""

    def kernel(arrs, filt_mask):
        e = dict(zip(order, arrs))
        e[_DEVICE] = filt_mask.device
        shape = torch.broadcast_shapes(filt_mask.shape,
                                       *[a.shape for a in arrs])
        inf = _const(e, float('inf'), torch.float64)
        out = []
        for node, name, args, filt in plans:
            base_ok = torch.logical_not(filt_mask).expand(shape)
            if filt is not None:
                fv, fm = filt(e)
                base_ok = base_ok & ~fm & fv.to(torch.bool)
            if name == 'count':
                out.append((base_ok.sum(),))
                continue
            v, m = args[0](e)
            v = v.expand(shape)
            ok = base_ok & ~m.expand(shape)
            if name == 'count_where':
                out.append(((ok & v.to(torch.bool)).sum(),))
            elif name == 'sum':
                dt = torch.int64 if node.args[0].typ in _INTEGRAL \
                    else torch.float64
                out.append((torch.where(ok, v, 0).to(dt).sum(),))
            elif name == 'mean':
                out.append((torch.where(ok, v, 0).to(torch.float64).sum(),
                            ok.sum()))
            elif name == 'stats':
                vf = torch.where(ok, v, 0).to(torch.float64)
                vd = v.to(torch.float64)
                out.append((vf.sum(), (vf * vf).sum(), ok.sum(),
                            torch.where(ok, vd, inf).amin(),
                            torch.where(ok, vd, -inf).amax()))
            elif name in ('min', 'max'):
                vf = v.to(torch.float64)
                ok2 = ok & ~torch.isnan(vf)
                if name == 'min':
                    red = torch.where(ok2, vf, inf).amin()
                else:
                    red = torch.where(ok2, vf, -inf).amax()
                out.append((red, ok2.sum() > 0))
            elif name == 'fraction':
                out.append(((ok & v.to(torch.bool)).sum(), ok.sum()))
            elif name == 'any':
                out.append(((ok & v.to(torch.bool)).any(),))
            else:   # all
                out.append(((~ok | v.to(torch.bool)).all(),))
        return out

    return kernel


_KERNEL_CACHE: Dict[tuple, object] = {}


def cached_kernel(agg_nodes, plans, order):
    """Kernels cache on the aggregation's semantic hash, as in the
    reference (its Compile cache keyed on (aggSigs, body),
    ir/Compile.scala:26-77)."""
    from ..ir.semhash import semhash
    try:
        key = tuple(
            (n.aggregator.name,
             tuple(semhash(a) for a in n.args),
             semhash(n.filter_ir) if n.filter_ir is not None else None)
            for n in agg_nodes) + (tuple(order),)
    except Exception:
        return make_kernel(plans, order)
    hit = _KERNEL_CACHE.get(key)
    if hit is None:
        hit = make_kernel(plans, order)
        if len(_KERNEL_CACHE) > 256:
            _KERNEL_CACHE.clear()
        _KERNEL_CACHE[key] = hit
    return hit


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def partition_tensors(mt, mb, leaves, dev: torch.device):
    """One partition's leaves on `dev`, in sorted key order (entry leaves
    (R, C), row leaves (R, 1), column leaves (1, C)), and its
    filtered-entry mask (R, C); None when a leaf is not a primitive
    column."""
    R, Cn = mb.n_rows, mt._stage.n_cols
    host = {}
    for key, (axis, field, kind) in leaves.items():
        if axis == 'g':
            col = mb.entries.get(field)
            shape = (R, Cn)
        elif axis == 'va':
            col = mb.rows.columns.get(field)
            shape = (R, 1)
        else:
            col = mt._stage.cols.columns.get(field)
            shape = (1, Cn)
        if not isinstance(col, C.PrimitiveColumn):
            return None
        host[f'{axis}.{field}.value'] = np.asarray(col.values).reshape(shape)
        host[f'{axis}.{field}.mask'] = col.missing_mask().reshape(shape)
    env = [_put(host[k], dev) for k in sorted(host)]
    include = mb.entry_missing   # filtered entries excluded from every agg
    filt = (torch.zeros((R, Cn), dtype=torch.bool, device=dev)
            if include is None else _put(include, dev))
    return env, filt


def run_device_entry_agg(mt, mb, part_idx, leaves, plans, kernel):
    """One partition → {agg uid: host-format partial state}, computed on the
    session's device. None when a leaf is not a primitive column (the
    caller then runs the host evaluator on this partition, as the
    reference does)."""
    from ..context import current_device
    tensors = partition_tensors(mt, mb, leaves, current_device())
    if tensors is None:
        return None
    res = kernel(*tensors)
    states = {}
    for (node, name, _a, _f), partial_ in zip(plans, res):
        vals = [x.cpu().numpy() for x in partial_]
        if name in ('count', 'count_where', 'sum'):
            states[node.uid] = vals[0]
        elif name in ('mean', 'fraction'):
            states[node.uid] = (vals[0], vals[1])
        elif name == 'stats':
            states[node.uid] = tuple(vals)
        elif name in ('min', 'max'):
            states[node.uid] = (vals[0], vals[1], node.args[0].typ)
        else:
            states[node.uid] = vals[0]
    return states
