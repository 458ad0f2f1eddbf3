"""null_ms_per_call.logistic: the milliseconds of a traced call in which
the program fitted the covariates-only null model on the host: the union
of the call's `glm.null` spans, which `hail_tpu_torch.utils.timer` records
(program span), averaged over the calls (`trace.union_ms_per_call`)."""

from gwasbench.trace import union_ms_per_call


def read(run):
    return union_ms_per_call(run, 'glm.null')
