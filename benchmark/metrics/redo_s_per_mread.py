"""redo_s_per_mread (program counter): the engine stats' `redo_sec` summed over the
window's jobs, seconds a million reads. The deferred re-probe and host mirror, on the main thread."""


def read(run):
    s = sum(j["stats"]["redo_sec"] for j in run["jobs"])
    return s / (run["reads"] / 1e6) if run["reads"] else None
