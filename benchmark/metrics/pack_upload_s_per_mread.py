"""pack_upload_s_per_mread (program counter): the tracing span `dispatch`
on the main thread (a sub-batch padded, packed 2 bits a base on the host,
uploaded through pinned memory, its kernels launched and its fetch set
up), summed over the window's jobs, seconds a million reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "dispatch_sec")
