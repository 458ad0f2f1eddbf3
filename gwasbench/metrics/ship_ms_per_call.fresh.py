"""ship_ms_per_call.fresh: the milliseconds of a traced call in which the
program shipped partitions that missed the device cache: their 2-bit
packing on the host, the copy and K4's unpacking on the card: the union of
the call's `part.ship` spans, which `hail_tpu_torch.utils.timer` records on
the partitions' threads (program span), averaged over the calls
(`trace.union_ms_per_call`)."""

from gwasbench.trace import union_ms_per_call


def read(run):
    return union_ms_per_call(run, 'part.ship')
