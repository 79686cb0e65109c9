"""redo_lists_s_per_mread (program counter): the tracing span `redo.lists`,
the redone reads' colour lists made on the host from their csids
(`_fi_lists_from_csids_many`; TU with no dense matrix: `_tu_from_csids`),
summed over the window's jobs, seconds a million reads."""

from benchmark.stages import per_mread


def read(run):
    return per_mread(run, "redo_lists_sec")
