"""decode_step_ms: the median over the traced run's serial passes of a
decode slice's share of the dispatch time of a drain that holds the decode
tenant's slices alone (each drain synchronises at its end)."""
import statistics


def read(rec):
    times = [s for p in rec["serial"] for phase, s in p["slices"]
             if phase == "decode"]
    return 1e3 * statistics.median(times) if times else None
