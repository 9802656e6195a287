"""route_idle_ms: the device's idle time inside a MoE model's route in a
prefill step: the device-idle time inside the port's ``model.route`` spans
(the router's scores, the top-k, the sort and any read of the experts'
counts back to the host) over the count of ``serve.step.prefill`` spans,
in milliseconds. A read of the counts stops the host until the device has
caught up, and the device then waits for the launches after it: that wait
shows here. Only where the trace holds device work and the program marks
its route."""
from kbench import spans

spans.install()

ROUTE = "model.route"
STEP = "serve.step.prefill"


def read(rec):
    t = rec["trace"]
    found = (t or {}).get("spans") or {}
    route, step = found.get(ROUTE), found.get(STEP)
    if not route or not step or t["busy_s"] <= 0:
        return None
    return 1e3 * route["idle_s"] / step["count"]
