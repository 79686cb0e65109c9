"""device_idle_share (device trace): 100 (1 - busy / window) in %, busy
the union of the card's kernel and copy intervals (trace.busy_union) over
the traced window, the window the host clock's."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
