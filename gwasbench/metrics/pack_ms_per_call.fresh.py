"""pack_ms_per_call.fresh: the milliseconds of a traced call in which the
program packed partitions that missed the device cache into 2-bit codes on
the host: the union of the call's `ship.pack` spans, which
`hail_tpu_torch.utils.timer` records on the partitions' threads (program
span), averaged over the calls (`trace.union_ms_per_call`)."""

from gwasbench.trace import union_ms_per_call


def read(run):
    return union_ms_per_call(run, 'ship.pack')
