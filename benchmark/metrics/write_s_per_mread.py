"""write_s_per_mread (program counter): the engine stats' `write_sec` summed over the
window's jobs, seconds a million reads. Busy time of the writer thread (formatting and writing), which overlaps the others."""


def read(run):
    s = sum(j["stats"]["write_sec"] for j in run["jobs"])
    return s / (run["reads"] / 1e6) if run["reads"] else None
