"""prefill_graph_share: the share of prompt steps that ran as one CUDA
graph replay in the profiled drains: 100 x the count of the port's
``serve.replay.prefill`` spans over the count of its
``serve.step.prefill`` spans, in percent. Nothing where the trace holds no
prefill step span."""
from kbench import spans

spans.install()

STEP = "serve.step.prefill"
REPLAY = "serve.replay.prefill"


def read(rec):
    got = (rec["trace"] or {}).get("spans") or {}
    step = got.get(STEP)
    if not step:
        return None
    return 100.0 * got.get(REPLAY, {}).get("count", 0) / step["count"]
