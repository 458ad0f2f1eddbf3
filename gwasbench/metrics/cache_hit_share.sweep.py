"""cache_hit_share.sweep: of the device-cache lookups the traced calls made,
the share that found the genotypes' int8 pair resident, in percent
(`hail_tpu_torch.ops.devcache` counters, program counter). Nothing where no
call looked up."""


def read(run):
    hits = sum(r.get('hits', 0) for r in run.calls)
    misses = sum(r.get('misses', 0) for r in run.calls)
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
