"""The program's stage totals as the per-layer metrics of the stage split
read them: each job's stats dict carries its tracing totals
(fulgor_tpu_torch.tracing; a span's seconds as `<name>_sec`, dots as
underscores, and each counter under its name). A program without the
tracer has no `job_sec` in its stats, and the metrics read nothing
there."""


def traced(run) -> bool:
    """Whether every job of the window carries the tracer's totals."""
    return bool(run["reads"]) and all("job_sec" in j["stats"]
                                      for j in run["jobs"])


def total(run, *keys) -> float:
    """The stats keys summed over the window's jobs (0 where a job's path
    did not open the span)."""
    return sum(j["stats"].get(k, 0) for j in run["jobs"] for k in keys)


def per_mread(run, *keys):
    """The stats keys summed over the window's jobs, a million reads; None
    where the program keeps no such totals."""
    return total(run, *keys) / (run["reads"] / 1e6) if traced(run) else None
