"""redo_read_share (program counter): the reads the deferred redo wrote
(`num_redo`) as a share of all reads of the window's jobs, in %."""


def read(run):
    s = sum(j["stats"]["num_redo"] for j in run["jobs"])
    return 100.0 * s / run["reads"] if run["reads"] else None
