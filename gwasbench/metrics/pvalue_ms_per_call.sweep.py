"""pvalue_ms_per_call.sweep: the milliseconds of a traced call in which the
program worked out p-values on the host (scipy's t survival function over
every row and phenotype): the union of the call's `linreg.pvalues` spans,
which `hail_tpu_torch.utils.timer` records from whichever thread runs them
(program span), averaged over the calls (`trace.union_ms_per_call`)."""

from gwasbench.trace import union_ms_per_call


def read(run):
    return union_ms_per_call(run, 'linreg.pvalues')
