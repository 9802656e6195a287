"""decode_launches: the host's launch calls a decode step in the profiled
drains: the runtime or driver calls inside the port's ``serve.step.decode``
spans that ran one or more device operations (a graph launch counts once),
over the count of those spans. Only where the trace holds device work."""
from kbench import spans

spans.install()

STEP = "serve.step.decode"


def read(rec):
    t = rec["trace"]
    step = ((t or {}).get("spans") or {}).get(STEP)
    if not step or t["busy_s"] <= 0:
        return None
    return step["launches"] / step["count"]
