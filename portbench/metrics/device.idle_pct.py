"""100 x (1 - the union of the device's busy intervals over the traced
stretch's length), both from the one trace."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
