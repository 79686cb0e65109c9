"""host_colour_s_per_mread (program counter): the engine stats'
`host_sec` summed over the window's jobs, seconds a million reads: the
runs fetch's host AND and key cache (or the no-dense TU's scoring). None
where the path has no host colour step (host_sec 0 in every job)."""


def read(run):
    s = sum(j["stats"]["host_sec"] for j in run["jobs"])
    return s / (run["reads"] / 1e6) if run["reads"] and s > 0 else None
