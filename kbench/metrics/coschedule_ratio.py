"""coschedule_ratio: the median over the traced run's passes of a drain's
``wall_s`` over the serial sum next to it (the dispatch times of drains
that each hold one tenant's slices alone, one tenant after another). Below
1, co-scheduling pays. Only where two or more tenants share the queue."""
import statistics


def read(rec):
    pairs = [p for p in rec["serial"] if p["drain_wall_s"] is not None]
    if len(rec["tenants"]) < 2 or not pairs:
        return None
    return statistics.median(p["drain_wall_s"] / p["total_s"] for p in pairs)
