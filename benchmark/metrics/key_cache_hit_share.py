"""key_cache_hit_share (program counter): the runs fetch's key cache, the
counters `key_hits` over `key_lookups` (a batch's distinct keys looked
up) summed over the window's jobs, in %. None where no key was looked
up."""

from benchmark.stages import total, traced


def read(run):
    n = total(run, "key_lookups")
    return 100.0 * total(run, "key_hits") / n if traced(run) and n else None
