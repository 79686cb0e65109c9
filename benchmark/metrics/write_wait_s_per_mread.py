"""write_wait_s_per_mread (program counter): the main thread blocked on the
writer: the tracing spans `write.put` (a batch handed to the writer's full
queue, from the main path and the redo) and `write.close` (the queue
drained at a job's end), summed over the window's jobs, seconds a million
reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "write_put_sec", "write_close_sec")
