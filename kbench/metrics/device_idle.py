"""device_idle: the share of the profiled drains' time in which no
operation ran on the device, in percent."""


def read(rec):
    t = rec["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
