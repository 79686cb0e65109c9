"""kernel_ms_per_mread (device trace): the profiler's device time of every
kernel (copies and sets left out) over the traced window, milliseconds a
million reads. The profiler may drop launches; the run's log says how many
of each counter's it missed."""


def read(run):
    tr = run["trace"]
    if tr is None or not run["reads"] or tr["kernel_s"] <= 0:
        return None
    return 1e3 * tr["kernel_s"] / (run["reads"] / 1e6)
