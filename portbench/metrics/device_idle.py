"""Device: the share of the profiled steps' wall time in which no
operation ran on the device, in %."""


def read(rec):
    p = rec.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
