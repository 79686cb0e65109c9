"""engine_s_per_mread (host clock): the harness's span around
`QueryEngine(...)`, made fresh for each job (tables uploaded, strategy
chosen), summed over the window's jobs, seconds a million reads."""


def read(run):
    s = sum(j["engine_s"] for j in run["jobs"])
    return s / (run["reads"] / 1e6) if run["reads"] else None
