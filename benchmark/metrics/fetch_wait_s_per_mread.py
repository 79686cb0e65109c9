"""fetch_wait_s_per_mread (program counter): the engine stats' `query_sec` summed over the
window's jobs, seconds a million reads. The main thread's wait for the card's results."""


def read(run):
    s = sum(j["stats"]["query_sec"] for j in run["jobs"])
    return s / (run["reads"] / 1e6) if run["reads"] else None
