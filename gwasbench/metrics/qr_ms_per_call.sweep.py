"""qr_ms_per_call.sweep: the milliseconds of a traced call in which the
program took the QR decomposition of the kept samples' covariates: the
union of the call's `linreg.qr` spans, which `hail_tpu_torch.utils.timer`
records (program span), averaged over the calls
(`trace.union_ms_per_call`)."""

from gwasbench.trace import union_ms_per_call


def read(run):
    return union_ms_per_call(run, 'linreg.qr')
