"""sys_cpu_s_per_mread (program counter): the process's system CPU inside
its jobs (the counter `sys_ns`, getrusage RUSAGE_SELF over each job: every
thread, the native pools and the harness's own threads included), summed
over the window's jobs, seconds a million reads."""

from benchmark.stages import per_mread


def read(run):
    v = per_mread(run, "sys_ns")
    return None if v is None else v / 1e9
