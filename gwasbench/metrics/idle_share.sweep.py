"""idle_share.sweep: the share of the traced window in which no operation
ran on the device, in percent (device trace)."""


def read(run):
    tl = run.timeline
    if not tl or not tl['window_s']:
        return None
    return 100.0 * (1 - tl['busy_s'] / tl['window_s'])
