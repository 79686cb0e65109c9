"""parse_s_per_mread (program counter): the engine stats' `parse_sec` summed over the
window's jobs, seconds a million reads. Busy time of the parse thread, which overlaps the others."""


def read(run):
    s = sum(j["stats"]["parse_sec"] for j in run["jobs"])
    return s / (run["reads"] / 1e6) if run["reads"] else None
