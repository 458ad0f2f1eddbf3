"""stage_ms_per_call.sweep: the backend stages' walls per traced call, in
milliseconds, as `hail_tpu_torch.utils.timer` records them (program
span)."""


def read(run):
    calls = [r for r in run.calls if 'stage_s' in r]
    if not calls:
        return None
    return 1e3 * sum(r['stage_s'] for r in calls) / len(calls)
