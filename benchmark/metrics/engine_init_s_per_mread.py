"""engine_init_s_per_mread (program counter): the tracing span
`engine.init` timed inside QueryEngine's constructor (its decode, probe
budget and table upload), carried in the stats of each engine's first
job, summed over the window's jobs, seconds a million reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "engine_init_sec")
