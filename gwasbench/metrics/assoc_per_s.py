"""assoc_per_s: variant x phenotype association tests whose every output
field reached host memory, summed over the calls completed in the window,
per second from the window's start to the end of the last of them (host
clock)."""


def read(run):
    if not run.completed:
        return None
    return (sum(r['tests'] for r in run.completed)
            / (run.completed[-1]['t1'] - run.window_start))
