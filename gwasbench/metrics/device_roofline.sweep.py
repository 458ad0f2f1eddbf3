"""device_roofline.sweep: the least time of a call's device work on one
H100 (`roofline.least_time_s`) as a share of the device's busy time per
traced call, in percent (device trace). Nothing where the trace shows no
device time."""

from gwasbench import roofline


def read(run):
    tl = run.timeline
    if not tl or not tl['busy_s'] or not run.calls:
        return None
    busy_per_call = tl['busy_s'] / len(run.calls)
    return 100.0 * roofline.least_time_s(run.R, run.N, run.k, run.P) \
        / busy_per_call
