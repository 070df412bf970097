"""The device's idle share (%) of the traced SLAM window: 1 - the union of
the device's activity intervals over the window's wall time. The
profiler's own host overhead raises it."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("driver") != "slam" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
