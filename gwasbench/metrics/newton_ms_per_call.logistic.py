"""newton_ms_per_call.logistic: the milliseconds of a traced call in which
the program ran its blocks' batched Newton loops (`ops/glm_device`): the
union of the call's `glm.newton` spans, which `hail_tpu_torch.utils.timer`
records on the partitions' threads (program span), averaged over the
calls (`trace.union_ms_per_call`)."""

from gwasbench.trace import union_ms_per_call


def read(run):
    return union_ms_per_call(run, 'glm.newton')
