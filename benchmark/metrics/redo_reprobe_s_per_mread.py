"""redo_reprobe_s_per_mread (program counter): the tracing span
`redo.reprobe`, the deferred reads' (8, 4) re-probe dispatched and
resolved on the card, summed over the window's jobs, seconds a million
reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "redo_reprobe_sec")
