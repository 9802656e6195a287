"""window_prefill_ms: the device time of the sliding-window layers'
attention in a prefill step: the union of the device operations launched
inside the port's ``model.window`` spans (a window layer's attention,
projections and cache writes aside) over the count of
``serve.step.prefill`` spans, in milliseconds. ``model.*`` spans exist in
eager steps only, and a decode step replays as a graph, so only the
prompt's window layers are counted. Only where the trace holds device work
and the program marks its window layers."""
from kbench import spans

spans.install()

WINDOW = "model.window"
STEP = "serve.step.prefill"


def read(rec):
    t = rec["trace"]
    found = (t or {}).get("spans") or {}
    window, step = found.get(WINDOW), found.get(STEP)
    if not window or not step or t["busy_s"] <= 0:
        return None
    return 1e3 * window["device_s"] / step["count"]
