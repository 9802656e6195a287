"""idle_in_step: the share of the profiled drains' time in which the
device is idle while the host issues a model step, in percent: the
device-idle time inside the port's ``serve.step.*`` spans over the
drains' time. The steps run one after another on the drain's thread, so
the sum over the step names is the idle time of their union."""
from kbench import spans

spans.install()

PREFIX = "serve.step."


def read(rec):
    t = rec["trace"]
    steps = [v for k, v in ((t or {}).get("spans") or {}).items()
             if k.startswith(PREFIX)]
    if not steps or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * sum(v["idle_s"] for v in steps) / t["window_s"]
