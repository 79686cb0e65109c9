"""host_and_s_per_mread (program counter): the tracing span `colour.and`,
the runs fetch's segmented AND of the keys its cache missed, summed over
the window's jobs, seconds a million reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "colour_and_sec")
