"""drain_p90_s: the 90th percentile, by nearest rank, of the window's
``drain()`` call times (host clock around each whole call)."""
import math


def read(rec):
    times = sorted(d["call_s"] for d in rec["drains"])
    if not times:
        return None
    return times[math.ceil(0.9 * len(times)) - 1]
