"""experts_prefill_ms: the device time of a MoE model's routed experts in
a prefill step: the union of the device operations launched inside the
port's ``model.experts`` spans (the pairs' rows gathered, the experts'
products, the combine) over the count of ``serve.step.prefill`` spans, in
milliseconds. ``model.*`` spans exist in eager steps only, and a decode
step replays as a graph, so only the prefill's experts are counted. Only
where the trace holds device work and the program marks its experts."""
from kbench import spans

spans.install()

EXPERTS = "model.experts"
STEP = "serve.step.prefill"


def read(rec):
    t = rec["trace"]
    found = (t or {}).get("spans") or {}
    experts, step = found.get(EXPERTS), found.get(STEP)
    if not experts or not step or t["busy_s"] <= 0:
        return None
    return 1e3 * experts["device_s"] / step["count"]
