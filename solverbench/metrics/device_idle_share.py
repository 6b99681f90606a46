"""device_idle_share: 1 − (union of the device's activity intervals ÷
the traced slice), in %."""


def read(run):
    sl = run.slice
    if sl is None or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
