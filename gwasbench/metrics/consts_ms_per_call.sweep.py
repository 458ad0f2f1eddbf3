"""consts_ms_per_call.sweep: the milliseconds of a traced call in which the
program made the phenotype group's device constants (the key, the digit
planes of [Q | Ys] and their copy): the union of the call's `linreg.consts`
spans, which `hail_tpu_torch.utils.timer` records (program span), averaged
over the calls (`trace.union_ms_per_call`)."""

from gwasbench.trace import union_ms_per_call


def read(run):
    return union_ms_per_call(run, 'linreg.consts')
