"""sched_ms: the median over the window's drains of the ``drain()`` call
time less the dispatch time it reports (``wall_s``): planning on the
engine and the scheduler's decisions, in milliseconds."""
import statistics


def read(rec):
    if not rec["drains"]:
        return None
    return 1e3 * statistics.median(d["call_s"] - d["wall_s"]
                                   for d in rec["drains"])
