"""stream_overlap: the share of the profiled drains' device-busy time in
which kernels of two or more streams ran at once, in percent. Only where
two or more tenants share the queue."""


def read(rec):
    t = rec["trace"]
    if len(rec["tenants"]) < 2 or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * t["overlap_s"] / t["busy_s"]
