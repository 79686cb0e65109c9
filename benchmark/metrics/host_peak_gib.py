"""host_peak_gib: the run's process's peak resident set (getrusage), read
at the end of the window, before the reference runs; the index build runs
in a process of its own."""


def read(run):
    return run["host_peak_gib"]
