"""reads_per_s (host clock): every read of every job completed in the
window over the summed wall time of those jobs, engine construction
included."""


def read(run):
    return run["reads"] / run["wall"] if run["wall"] > 0 else None
