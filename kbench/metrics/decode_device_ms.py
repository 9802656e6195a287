"""decode_device_ms: the device work a decode step queues in the profiled
drains: the union of the device operations launched inside the port's
``serve.step.decode`` spans over the count of those spans, in
milliseconds. Only where the trace holds device work. Listed for cells
where the decode runs alone: beside another tenant's kernels the union
also holds the stretch their contention adds."""
from kbench import spans

spans.install()

STEP = "serve.step.decode"


def read(rec):
    t = rec["trace"]
    step = ((t or {}).get("spans") or {}).get(STEP)
    if not step or t["busy_s"] <= 0:
        return None
    return 1e3 * step["device_s"] / step["count"]
