"""parse_wait_s_per_mread (program counter): the tracing span
`parse.wait`, the main thread waiting for the parse thread's next chunk,
summed over the window's jobs, seconds a million reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "parse_wait_sec")
