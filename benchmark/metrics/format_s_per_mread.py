"""format_s_per_mread (program counter): the tracing span `write.format`,
the native ascii formatting on the writer thread (without the sink's
write, `write.emit`), summed over the window's jobs, seconds a million
reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "write_format_sec")
