"""Carry state from the reference package into the port.

The reference keeps per-call device constants (`_exact_consts_cached`) and
the cached `(gz8, m8)` entry pair (`ops/devcache`) as its own arrays. These
helpers take them as numpy arrays (the caller converts with `np.asarray`,
so this module imports nothing of the reference) and return the port's
tensors on `device`, with the dtypes the port's kernels require. The parity
tests use them to hand `_exact_core` in both packages identical operands.
"""

from __future__ import annotations

import numpy as np
import torch


def consts_from_reference(Wdig, scales, Qty, yyp, dof, device):
    """(ExactOperand of Wdig int8, scales f64, Qty f64, yyp f64, dof float)
    as the port's `linreg_i8.exact_consts` returns them."""
    from .ops.linreg_i8 import exact_operand

    def to(a, dtype):
        # a copy: the reference's arrays are read-only views of its buffers
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    return (exact_operand(to(Wdig, np.int8)), to(scales, np.float64), to(Qty, np.float64),
            to(yyp, np.float64), float(np.asarray(dof)))


def entry_pair_from_reference(gz8, m8, device):
    """A cached (gz8, m8) int8 pair as tensors on `device`."""
    return tuple(torch.from_numpy(np.array(a, dtype=np.int8)).to(device)
                 for a in (gz8, m8))
