"""driver_ms_per_call.sweep: the method driver's milliseconds per call: a
traced call's wall time less the backend stages' walls inside it, which
`hail_tpu_torch.utils.timer` records (program span)."""


def read(run):
    calls = [r for r in run.calls if 'stage_s' in r]
    if not calls:
        return None
    return 1e3 * sum(r['t1'] - r['t0'] - r['stage_s'] for r in calls) \
        / len(calls)
