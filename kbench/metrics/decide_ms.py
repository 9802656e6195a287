"""decide_ms: the scheduler's host time a drain, where it runs: the time
inside the port's ``serve.plan`` span (the engine's plan) and its
``serve.decide`` spans (each ``find_coschedule``) in the profiled drains,
over the count of their ``serve.drain`` spans, in milliseconds."""
from kbench import spans

spans.install()

NAMES = ("serve.plan", "serve.decide")


def read(rec):
    got = (rec["trace"] or {}).get("spans") or {}
    drains = got.get("serve.drain")
    if not drains:
        return None
    return 1e3 * sum(got[n]["host_s"] for n in NAMES if n in got) \
        / drains["count"]
