"""tokens_per_s: every token the window's drains served (a prefill slice's
batch x prompt length, a decode slice's batch), over the window's seconds,
from the first drain's start to the last one's end."""


def read(rec):
    if not rec["drains"] or rec["window_s"] <= 0:
        return None
    return sum(d["tokens"] for d in rec["drains"]) / rec["window_s"]
